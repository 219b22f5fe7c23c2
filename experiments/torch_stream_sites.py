"""The stream step's cache forms of Kernels 3 and 4 on a GPU, on the
causal flagship Conformer-CTC 16 x 256 W8A8 of chip_smoke.py phase 12:
12a's exact checks of both against their plain versions (--checks), both
timed at (B, n) (1, 4), (32, 4) and (32, 16) beside their bounds and
latency floors (--time), and frozen_stream_step's device / event / host
ms at the same (B, n) (--step).

    python3 experiments/torch_stream_sites.py [--root DIR] [--checks] [--time] [--step] \
        [--out PATH]

--root imports qasr_tpu_torch from another checkout (a parent commit
unpacked with git archive into a .gitignore'd directory), so that one
chip call times parent and change in turns, one process each.  The
helpers are this checkout's chip_smoke.py.  A tree whose
conv_block_cached does not report its plan (``last_config``) is timed
without the latency floors and takes no --checks.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose qasr_tpu_torch to run")
    ap.add_argument("--checks", action="store_true", help="run phase 12a's checks")
    ap.add_argument("--time", action="store_true", help="time both cache forms")
    ap.add_argument("--step", action="store_true", help="time frozen_stream_step")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    cs = _load("smoke_helpers", os.path.join(HERE, "chip_smoke.py"))

    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build
    from qasr_tpu_torch.kernels.conv_block import conv_block_cached

    dev = require_cuda(0)
    card = cs.card_line()
    tag = "change" if root == HERE else f"tree {os.path.relpath(root, HERE)}"
    print(f"{card} [{tag}]", flush=True)
    _build.library()
    print(f"build {_build.BuildInfo.seconds:.2f} s {getattr(_build.BuildInfo, 'per_source', {})}",
          flush=True)
    lines = _build.BuildInfo.log.splitlines()
    for i, line in enumerate(lines):   # ptxas -v: the entry line, then its properties
        if "Compiling entry" in line and ("_cached" in line or "empty_kernel" in line):
            for ln in lines[i:i + 4]:
                print(f"ptxas: {ln.strip()}", flush=True)
    plans = hasattr(conv_block_cached, "last_config")
    report = {"card": card, "root": root, "tag": tag}
    model, tables = cs.causal_flagship(dev)
    chk = cs.Checker()
    if args.checks:
        if not plans:
            raise SystemExit("--checks needs a tree whose conv_block_cached reports its plan")
        report["plans"] = {f"B={b} n={n}": c for (b, n), c in
                           cs.phase_stream_kernels(chk, model, tables, dev).items()}
    if args.time:
        report["rows"] = cs.time_stream_kernels(chk, model, tables, dev, card, report,
                                                floors=plans)
    if args.step:
        report["step"] = cs.stream_step_times(model, tables, dev, card)
    print(f"{chk.n} comparisons exact; max |d| {chk.max_err}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
