"""The grouped forms of Kernels 2 (pw_gemm) and 8 (dense_conv) and
hardtanh's ceiling on a GPU.

    python3 experiments/torch_grouped_sites.py [--root DIR] [--checks] [--time] [--phase11] \
        [--steps] [--out PATH]

--checks builds the kernels, prints ptxas's lines for pw_gemm_kernel and
dense_conv_kernel, and runs chip_smoke.py's phase 11a (Kernels 2 and 8
grouped, and the hardtanh ceilings of Kernels 1, 2, 7 and 8, against their
plain versions, exact).  --time times phase 11's grouped sites (chip_smoke
.py's ``time_grouped_sites``: QuartzNet15x5-g4's grouped pointwise convs and
the Jasper-width grouped block's K 25 conv, B=64 x 15 s) beside their
bounds, their plain versions and their yardsticks.  --phase11 runs the
whole of chip_smoke.py's phase 11 (the checks, the golden records, the
served paths, calibration, the steps beside QuartzNet15x5 W6A6 static_e,
the sites and vad_infer).  --steps times the frozen steps of the grouped
kernels' paths and of the ungrouped ones that share their wrappers
(QuartzNet15x5-g4 W6A6 static_e, the Jasper-width grouped block W6A6
static_e, QuartzNet15x5 W6A6 static_e and per_channel, Jasper10x5Dr W6A6
static_e; B=64 x 15 s, median of 10, CUDA events) with the
qasr_tpu_torch of --root (a parent commit unpacked with git archive into
a .gitignore'd directory), so that parent and change run in one chip
call, one process each.  The helpers are this checkout's chip_smoke.py.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--phase11", action="store_true")
    ap.add_argument("--steps", action="store_true")
    ap.add_argument("--root", default=HERE, help="checkout whose qasr_tpu_torch to use")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_grouped_sites: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qasr_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    for line in _build.BuildInfo.log.splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling entry", "C75")):
            print("ptxas:", line.strip())
    out = {"card": card, "root": os.path.abspath(args.root)}
    if args.steps:
        import statistics

        from qasr_tpu_torch import golden
        from qasr_tpu_torch.models.ctc_model import make_frozen_fn

        audio, lens = cs.noise_batch(64, 15.0, dev)
        steps = {}
        for name, mode in (("quartznet15x5_g4", "static_e"), ("jasper_grouped_block", "static_e"),
                           ("quartznet15x5", "static_e"), ("quartznet15x5", "per_channel"),
                           ("jasper10x5dr", "static_e")):
            m = (cs.grouped_block_model(dev) if name == "jasper_grouped_block"
                 else golden.flagship(name, 6))
            fn = make_frozen_fn(m, m.freeze(mode, dev), argmax=True)
            steps[f"{name} W6A6 {mode}"] = statistics.median(
                cs.cuda_ms(lambda: fn(audio, lens), reps=10))
            print(f"step {name} W6A6 {mode} B=64 x 15 s: {steps[f'{name} W6A6 {mode}']:.3f} ms "
                  f"(median of 10) [{card}] root={args.root}", flush=True)
        out["steps"] = steps
    if args.checks:
        chk = cs.Checker()
        out["checks"] = cs.phase_grouped_kernels(chk, dev)
        out["max_err"] = chk.max_err
    if args.time:
        out["rows"] = cs.time_grouped_sites(cs.Checker(), dev, card)
    if args.phase11:
        from qasr_tpu_torch import golden

        qn = golden.quartznet15x5_w6a6()
        chk = cs.Checker()
        rows, counts = cs.phase_grouped(chk, dev, card, out, (qn, qn.freeze("static_e", dev)))
        out.update(rows=rows, launches=counts, checks_n=chk.n, max_err=chk.max_err)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
