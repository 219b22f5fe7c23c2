"""Kernels 1 (dw_conv) and 7 (requant) on a GPU: build, hold each against its
plain version bit for bit (chip_smoke.py's phase-3 checks of the two
kernels and of the requant device functions they share, the per-channel
exponent modes included), then, with --time,
time both at every serving site (chip_smoke.time_dw_sites and
time_requant_sites: device time by torch.profiler over 10 calls, the
per-call event time, the plain version's, the bound, and cuDNN's float32
depthwise conv as Kernel 1's yardstick).

    python3 experiments/torch_dw_sites.py [--time] [--out PATH]

QuartzNet15x5's B=64 x 15 s shapes (T=768 after the stride-2 site).
Faster to run than chip_smoke.py when only these two kernels change.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true", help="also time every serving site")
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    import numpy as np

    import chip_smoke as cs
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build

    dev = require_cuda(0)
    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)
    chk = cs.Checker()
    cs.phase_requant(chk, dev)
    cs.phase_dw(chk, dev)
    cs.phase_requant_kernel(chk, dev)
    rows = []
    if args.time:
        rng = np.random.default_rng(0)
        sites = cs.dw_serving_sites(golden.quartznet15x5_w6a6().plan)
        cs.time_dw_sites(chk, rows, rng, dev, card, sites)
        cs.time_requant_sites(chk, rows, rng, dev, card)
        for r in rows:
            print(f"{r['shape']}: {r['device_ms']:.4f} ms device, bound {r['bound'][0]:.5f} "
                  f"({r['bound'][1]}), plain {r['plain_ms']:.4f}"
                  + (f", library {r['library_device_ms']:.4f}"
                     if r["library_device_ms"] is not None else ""), flush=True)
    print(f"{chk.n} comparisons exact; max |d| {chk.max_err} [{card}]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
