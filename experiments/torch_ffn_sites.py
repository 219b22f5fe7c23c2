"""Kernel 6 (ffn_ln) on a GPU: hold it against its plain version, then
time it at the flagship Conformer's serving shape (B=32 x 15 s: T=375,
d=256, f=1024) in its three forms (FFN1 + ln_att, FFN2 + ln_out, the last
layer's FFN2 without a tail), and the Conformer B=32 x 15 s step under the
default plan.

    python3 experiments/torch_ffn_sites.py [--root DIR] [--checks] [--step] \
        [--sass DIR] [--out PATH]

--root imports qasr_tpu_torch from another checkout (a parent commit
unpacked with git archive), so that one chip call can time parent and
change in turns, one process each.  --checks first runs chip_smoke.py's phase-3
checks of Kernel 6 and of the requant device functions (the change only).
--sass writes the kernel's SASS (cuobjdump), as
experiments/torch_conformer_sites.py does for Kernels 3 and 4, and prints
each loop and each straight-line block that holds FP64 requants (the
FP64 forms of the epilogues and the i-LN rows) with its instructions and
integer-pipe instructions (PERF.md's CUDA-core floor);
--count-sass FILE prints the same for a SASS file written by an earlier
--sass run, with no GPU.  The timing helpers are this checkout's
chip_smoke.py.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# opcodes that issue to the CUDA cores' integer pipe (PERF.md's CUDA-core floor)
INT_OPS = {"IMAD", "IADD3", "VIADD", "LOP3", "SHF", "SEL", "ISETP", "VIMNMX", "IMNMX", "IABS",
           "PRMT", "LEA", "PLOP3", "MOV", "IMUL", "BMSK", "POPC", "FLO", "VIADDMNMX"}


def fp64_blocks(sass: str):
    """The straight-line blocks (split at branches and branch targets) of
    one function's SASS that hold a DFMA: [(first address, instructions,
    integer-pipe instructions, {opcode: count})]."""
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", sass)]
    targets = {int(t, 16) for _, x in ins for t in re.findall(r"BRA[^;]*?0x([0-9a-f]+)", x)}

    def opcode(x):
        w = x.split()
        return (w[1] if w[0].startswith("@") else w[0]).split(".")[0]
    blocks, cur = [], []
    for a, x in ins:
        if a in targets and cur:
            blocks.append(cur)
            cur = []
        cur.append(opcode(x))
        if cur[-1] in ("BRA", "EXIT", "RET"):
            blocks.append(cur)
            cur = []
    out, start = [], 0
    for b in blocks + [cur]:
        ops = collections.Counter(b)
        if ops.get("DFMA"):
            out.append((ins[start][0], len(b), sum(n for o, n in ops.items() if o in INT_OPS),
                        dict(ops.most_common())))
        start += len(b)
    return out


def print_floor_counts(sass: str) -> None:
    """Each loop's and each FP64 block's instructions and integer-pipe
    instructions (the loops by experiments/torch_conformer_sites.py's
    sass_loops)."""
    sites = _load("conformer_sites", os.path.join(HERE, "experiments", "torch_conformer_sites.py"))
    for a, b, n, ops in sites.sass_loops(sass):
        n_int = sum(v for o, v in ops.items() if o in INT_OPS)
        print(f"    loop {a:#x}-{b:#x}: {n} instructions, {n_int} on the integer pipe; "
              f"{dict(list(ops.items())[:12])}", flush=True)
    for a, n, n_int, ops in fp64_blocks(sass):
        print(f"    fp64 block {a:#x}: {n} instructions, {n_int} on the integer pipe, "
              f"{ops.get('DFMA', 0)} DFMA; {dict(list(ops.items())[:14])}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose qasr_tpu_torch to time")
    ap.add_argument("--checks", action="store_true", help="run the phase-3 checks first")
    ap.add_argument("--step", action="store_true", help="also time the Conformer step")
    ap.add_argument("--sass", help="write the kernel's SASS to this directory")
    ap.add_argument("--out", help="write the rows as JSON here")
    ap.add_argument("--count-sass", help="only count a SASS file of an earlier --sass run")
    args = ap.parse_args()
    if args.count_sass:
        with open(args.count_sass) as f:
            print_floor_counts(f.read())
        return
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _load("smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build
    from qasr_tpu_torch.kernels import ffn_ln as k6

    dev = require_cuda(0)
    card = cs.card_line()
    tag = "change" if root == HERE else f"tree {os.path.relpath(root, HERE)}"
    print(f"{card} [{tag}]", flush=True)
    _build.library()
    print(f"build {_build.BuildInfo.seconds:.2f} s", flush=True)
    lines = _build.BuildInfo.log.splitlines()
    for i, line in enumerate(lines):   # ptxas -v: the entry line, then its properties
        if "Compiling entry" in line and "ffn_ln" in line:
            for ln in lines[i:i + 5]:
                print(f"ptxas: {ln.strip()}", flush=True)
    report = {"card": card, "root": root, "ptxas": _build.BuildInfo.log, "rows": []}
    if args.sass:
        sites = _load("conformer_sites", os.path.join(HERE, "experiments",
                                                       "torch_conformer_sites.py"))
        report["sass_ops"] = sites.dump_sass(_build.BuildInfo.path, args.sass, ("ffn_ln",))
        for name, fn in report["sass_ops"].items():
            print(f"sass {name[:90]}: {sum(fn['ops'].values())} instructions; "
                  f"{dict(list(fn['ops'].items())[:14])}", flush=True)
            with open(os.path.join(args.sass, f"{name[:120]}.sass")) as f:
                print_floor_counts(f.read())
    model = golden.conformer16x256_w8a8()
    tables = model.freeze(dev)
    chk = cs.Checker()
    if args.checks:
        cs.phase_requant(chk, dev)
        cs.phase_ffn_ln(chk, dev, tables)
        print(f"{chk.n} comparisons exact; max |d| {chk.max_err}", flush=True)
    rng = np.random.default_rng(0)
    b, t, d = 32, 375, model.ccfg.d_model
    x8 = torch.from_numpy(rng.integers(-64, 64, (b, t, d)).astype(np.int8)).to(dev)
    layers = tables["encoder"]["layers"]
    for form, lt, half, stream, tail in cs.ffn_forms(layers):
        f = lt[f"{half}_l1"]["wt"].shape[0]
        a = (x8, lt[f"ln_{half}"], lt[f"{half}_l1"], lt[f"{half}_grid"], lt[f"{half}_prod"],
             lt[f"{half}_l2"], lt[stream], tail)
        got, want = k6.ffn_ln(*a, nbits=8), k6.ffn_ln_plain(*a, nbits=8)
        for i in range(1 if tail is None else 2):
            chk.equal("ffn_ln", f"{form} output {i}", got[i], want[i])
        row = cs.timed_pair(chk, "ffn_ln", f"ffn_ln B={b} T={t} d={d} f={f} {form}",
                            lambda a=a: k6.ffn_ln(*a, nbits=8)[0],
                            lambda a=a: k6.ffn_ln_plain(*a, nbits=8)[0], card, report["rows"])
        row["tree"] = tag
    if args.step:
        from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn

        n = 16000 * 15
        audio = torch.from_numpy((rng.normal(size=(b, n)) * 0.1).astype(np.float32)).to(dev)
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        fns = {"kernel": make_conformer_frozen_fn(model, tables, argmax=True)}
        report["step_ms"] = cs.step_times(fns, (audio, lens), card, "Conformer", b, 15.0, {})
    report.update(comparisons=chk.n, max_err=chk.max_err)
    print(f"{chk.n} comparisons exact [{tag}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)


if __name__ == "__main__":
    main()
