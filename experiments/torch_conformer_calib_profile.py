"""Where the Conformer's calibrating forward's time goes on the GPU.

    python3 experiments/torch_conformer_calib_profile.py [--reps 5] [--out PATH]

The flagship Conformer-CTC (16 x 256, random weights from seed 0) with
every integer flag and static attention, calibrated once on the asset's
recipe (chip_smoke.recipe_noise: 4 x 15 s of seed-0 noise x 0.1);
"calibrate": ``conformer_encoder_apply_ptq(update=True)`` on those
features (T' = 375), Kernels 1 and 2 for its integer convs and linears,
with min / max ranges and with percentile 99.9; "dynamic": ``forward`` in
the dynamic mode on B=32 x 15 s.  For each (torch_calib_profile's
helpers): the per-call time by CUDA events (median of ``--reps`` after 2
warm-ups), and torch.profiler's device time, kernel count and top CUDA
kernels over 3 calls; the busy share (device time over event time) says
how far the host holds the forward back.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "experiments"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()

    import dataclasses

    import torch

    import chip_smoke as cs
    from qasr_tpu_torch.golden import conformer_flagship_configs
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
    from qasr_tpu_torch.models.ctc_model import _pcm_f32
    from qasr_tpu_torch.quantize.ranges import qstate_to_device
    from qasr_tpu_torch.quantize.conformer_ptq import (conformer_encoder_apply_ptq,
                                                       quantize_conformer_weights)
    from torch_calib_profile import device_profile, event_ms

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    model = ConformerCTC.from_config(*conformer_flagship_configs(), seed=0)
    model.quantize_encoder([cs.recipe_noise(0)], device=dev, **cs.CONF_FLAGS)
    a4, l4 = (torch.from_numpy(v).to(dev) for v in cs.recipe_noise(0))
    feats, fl = model.frontend(_pcm_f32(a4), l4, dither=0.0)
    qp = quantize_conformer_weights(model.params["encoder"], model.ccfg, 8, dev)
    qs = qstate_to_device(model.enc_qstate, dev)
    a32, l32 = (torch.from_numpy(v).to(dev) for v in cs.recipe_noise(0, batch=32))

    def calibrating(qcfg):
        return lambda: conformer_encoder_apply_ptq(qp, model.ccfg, qcfg, qs, feats, fl,
                                                   update=True)

    res = {"card": card}
    base = model.enc_qcfg
    runs = [("calibrate B=4 x 15 s percentile=None", calibrating(base)),
            ("calibrate B=4 x 15 s percentile=99.9",
             calibrating(dataclasses.replace(base, percentile=99.9)))]
    for name, fn in runs:
        r = {"event_ms": event_ms(fn, args.reps)}
        r.update(device_profile(fn))
        r["busy_share"] = r["device_ms"] / r["event_ms"]
        res[name] = r
    model.quantize_encoder([cs.recipe_noise(0)], device=dev, dynamic=True, **cs.CONF_FLAGS)

    def dynamic():
        model.forward(a32, l32, device=dev)

    r = {"event_ms": event_ms(dynamic, args.reps)}
    r.update(device_profile(dynamic))
    r["busy_share"] = r["device_ms"] / r["event_ms"]
    res["dynamic B=32 x 15 s"] = r
    for name, r in res.items():
        if name == "card":
            continue
        print(f"{name}: {r['event_ms']:.3f} ms a call (CUDA events, median of {args.reps}); "
              f"device {r['device_ms']:.3f} ms in {r['kernels']:.0f} kernels, busy "
              f"{r['busy_share']:.1%} [{card}]")
        for k, c, ms in r["top"]:
            print(f"  {ms:8.3f} ms  x{c:6.0f}  {k}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
