"""Kernels 3 (int_attention) and 4 (conv_block) on a GPU: build, hold each
against its plain version bit for bit (chip_smoke.py's phase-3 checks of
the two kernels, of the requant device functions and of the Conformer's
integer device functions), then, with --time, time each kernel against its
plain version at the flagship's serving shapes (B=32 x 15 s: T=375, d=256,
4 heads of 64), and Kernel 3's streaming form at B=4 T=1500.

With --sass DIR, writes the SASS of both kernels (cuobjdump -sass of the
built library) to DIR, one file per kernel, and counts the instructions of
each by opcode, and of each loop (a backward branch) by opcode: the
integer instructions an element or a score costs (PERF.md's CUDA-core
floor) are read from those loops.

    python3 experiments/torch_conformer_sites.py [--time] [--sass DIR] [--out PATH]
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def sass_loops(block):
    """The loops of one function's SASS (a backward branch and its target):
    [(first address, last address, instructions, {opcode: count})]."""
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", block)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (a, text) in enumerate(ins):
        m = re.search(r"BRA (?:!?U?P\w+, )?0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in at:
            body = ins[at[int(m.group(1), 16)]:i + 1]
            ops = collections.Counter(t.split()[1 if t.startswith("@") else 0].split(".")[0]
                                      for _, t in body)
            loops.append((body[0][0], a, len(body), dict(ops.most_common())))
    return loops


def dump_sass(lib_path, out_dir, kernels=("conv_block_stage", "int_attention")):
    """cuobjdump -sass of the library, split per function into out_dir;
    returns {function: {"ops": {opcode: count}, "loops": sass_loops}} for
    the functions whose names hold one of ``kernels`` (Kernels 3 and 4 by
    default)."""
    from qasr_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    counts = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = block.split("\n", 1)[0].strip()
        if not any(s in name for s in kernels):
            continue
        with open(os.path.join(out_dir, f"{name[:120]}.sass"), "w") as f:
            f.write(block)
        ops = collections.Counter()
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", block):
            ops[m.group(1).split(".")[0]] += 1
        counts[name] = {"ops": dict(ops.most_common()), "loops": sass_loops(block)}
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="also time the design alternatives")
    ap.add_argument("--sass", help="write the two kernels' SASS to this directory")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build
    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain
    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain

    dev = require_cuda(0)
    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    report = {"card": card, "ptxas": _build.BuildInfo.log}
    if args.sass:
        report["sass_ops"] = dump_sass(_build.BuildInfo.path, args.sass)
        for name, fn in report["sass_ops"].items():
            print(f"sass {name[:90]}: {sum(fn['ops'].values())} instructions; "
                  f"{dict(list(fn['ops'].items())[:12])}", flush=True)
            for a, b, n, ops in fn["loops"]:
                print(f"    loop {a:#x}-{b:#x}: {n} instructions; {dict(list(ops.items())[:14])}",
                      flush=True)
    model = golden.conformer16x256_w8a8()
    tables = model.freeze(dev)
    chk = cs.Checker()
    cs.phase_requant(chk, dev)
    cs.phase_int_fns(chk, dev)
    cs.phase_int_attention(chk, dev, tables)
    cs.phase_conv_block(chk, dev, tables)
    tbl = tables["encoder"]["layers"][0]
    rng = np.random.default_rng(0)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    b, t, h, d_k, d = 32, 375, 4, 64, 256
    full = torch.full((b,), 374, dtype=torch.int32, device=dev)
    c8, x8 = t8(b, t, d), t8(b, t, d)
    pad = model.ccfg.dw_padding
    kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=-1, right=-1,
              nbits=8)
    att = {}
    for bb, tt in ((b, t), (4, 1500)):
        qu, qv, k, v = (t8(bb, tt, h, d_k) for _ in range(4))
        p = t8(2 * tt - 1, h, d_k)
        ln = torch.full((bb,), tt - 1, dtype=torch.int32, device=dev)
        chk.equal("int_attention", f"int_attention B={bb} T={tt}",
                  int_attention(qu, qv, k, v, p, ln, **kw),
                  int_attention_plain(qu, qv, k, v, p, ln, **kw))
        att[(bb, tt)] = (qu, qv, k, v, p, ln)
    print(f"{chk.n} comparisons exact; max |d| {chk.max_err}", flush=True)
    rows = []
    if args.time:
        for (bb, tt), a in att.items():
            cs.timed_pair(chk, "int_attention", f"int_attention B={bb} T={tt}",
                          lambda a=a: int_attention(*a, **kw),
                          lambda a=a: int_attention_plain(*a, **kw), card, rows)
        cs.timed_pair(chk, "conv_block", f"conv_block B={b} T={t} d={d}",
                      lambda: conv_block(c8, x8, full, tbl, pad, nbits=8),
                      lambda: conv_block_plain(c8, x8, full, tbl, pad, nbits=8), card, rows)
    report.update(rows=rows, comparisons=chk.n, max_err=chk.max_err)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)


if __name__ == "__main__":
    main()
