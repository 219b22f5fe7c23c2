"""Where the calibrating and dynamic forwards' time goes on the GPU.

    python3 experiments/torch_calib_profile.py [--reps 5] [--out PATH]

Full-width QuartzNet15x5 (random weights, seed 0) at W6A6, BN folded.
"calibrate": ``encode_decode_quant(update_ranges=True)`` on seeded
features at calibration's batch (8 x 500 frames x 64 mels), with min /
max ranges and with percentile 99.9; "dynamic": ``forward`` in the
dynamic mode on B=64 x 15 s of seeded noise.  For each: the per-call time
by CUDA events (median of ``--reps`` after 2 warm-ups), and
torch.profiler's device time, kernel count and top CUDA kernels over 3
calls.  The device's busy share (device time over event time) says how
far the host holds the forward back.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def event_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_profile(fn, calls=3):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        rows.append((ev.self_cuda_time_total if us is None else us, ev.count, ev.key))
    rows.sort(reverse=True)
    return {"device_ms": sum(r[0] for r in rows) / (calls * 1e3),
            "kernels": sum(r[1] for r in rows) / calls,
            "top": [(k[:90], c / calls, us / (calls * 1e3)) for us, c, k in rows[:8]]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out")
    args = ap.parse_args()

    import numpy as np
    import torch

    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.ranges import qstate_to_device

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    model = ASRModel.from_pretrained("QuartzNet15x5Base-En", allow_random_weights=True)
    model.set_quant_bit(6, "all")
    model.bn_folding()
    model.qstate = init_qstate(model.plan)
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(8, 500, 64)).astype(np.float32)).to(dev)
    lens = torch.full((8,), 500, dtype=torch.int32, device=dev)
    model.calibrate([(feats, lens)], device=dev)
    qs = qstate_to_device(model.qstate, dev)
    audio = torch.from_numpy(rng.normal(size=(64, 16000 * 15)).astype(np.float32) * 0.1).to(dev)
    alens = torch.full((64,), 16000 * 15, dtype=torch.int32, device=dev)

    def calibrating():
        model.encode_decode_quant(feats, lens, qs, update_ranges=True)

    def dynamic():
        model.forward(audio, alens, device=dev)

    res = {"card": card}
    for name, setup, fn in (("calibrate percentile=None", dict(percentile=None), calibrating),
                            ("calibrate percentile=99.9", dict(percentile=99.9), calibrating),
                            ("dynamic B=64 x 15 s", dict(percentile=None, dynamic=True),
                             dynamic)):
        model.set_percentile(setup["percentile"])
        model.set_dynamic(setup.get("dynamic", False))
        r = {"event_ms": event_ms(fn, args.reps)}
        r.update(device_profile(fn))
        r["busy_share"] = r["device_ms"] / r["event_ms"]
        res[name] = r
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
