"""Where the time goes in one step of the PyTorch port's frozen QuartzNet
path on a GPU: torch.profiler over the B=64 x 15 s serving step, for each
dyadic mode asked for (static_e: FrozenExecFused, every requant in a
prologue or epilogue of Kernels 1-2; per_channel: FrozenExecKernels,
convs in Kernels 1-2, the requants next to a depthwise conv in Kernel 1's
prologue and epilogue, the rest in the requant kernel).

    python3 experiments/torch_step_profile.py [--batch 64] [--seconds 15]
        [--dyadic static_e,per_channel] [--fused 1] [--out PATH]

Groups CUDA kernel time into the hand-written kernels, the frontend's
float work, and the other elementwise kernels (the first site's float
quantization, casts, the log-softmax; plain integer requant glue on the
plain path); reports the device-busy share of the profiled wall time and
the launches per step of each group.  Needs a GPU; measures nothing on the
CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def group_of(name: str) -> str:
    n = name.lower()
    if "dw_conv_kernel" in n:
        return "dw_conv kernel"
    if "pw_gemm_kernel" in n:
        return "pw_gemm kernel"
    if "requant_kernel" in n:
        return "requant kernel"
    if "dense_conv_kernel" in n:
        return "dense_conv kernel"
    if "fft" in n or "reflection_pad" in n or "gemm" in n or "sgemm" in n \
            or "cutlass" in n or "ampere" in n or "sm90" in n or "reduce" in n:
        return "frontend float (fft, mel matmul, reductions)"
    return "other elementwise (first-site quantize, casts, log-softmax; plain glue)"


def profile_path(model, dyadic, fused, batch, seconds, dev, steps=3):
    """Profile ``steps`` serving steps after 3 warm-ups: (wall ms per step,
    {group: [ms per step, launches per step]}, kernels)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    fn = make_frozen_fn(model, model.freeze(dyadic, device=dev), argmax=True, fused=fused)
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(size=(batch, n)).astype(np.float32) * 0.1).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    for _ in range(3):
        fn(audio, lens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(audio, lens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    groups, kernels = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = dev_us / 1e3 / steps
        g = group_of(ev.key)
        acc = groups.setdefault(g, [0.0, 0.0])
        acc[0] += ms
        acc[1] += ev.count / steps
        kernels.append({"name": ev.key[:120], "group": g, "ms_per_step": ms,
                        "calls_per_step": ev.count / steps})
    kernels.sort(key=lambda k: -k["ms_per_step"])
    return wall_ms, groups, kernels


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--dyadic", default="static_e,per_channel",
                    help="comma-separated dyadic modes to profile")
    ap.add_argument("--fused", type=int, default=1)
    ap.add_argument("--out", help="also write the numbers as JSON here")
    args = ap.parse_args()

    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.golden import quartznet15x5_w6a6

    dev = require_cuda(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    model = quartznet15x5_w6a6()
    report = {"card": card, "batch": args.batch, "seconds": args.seconds,
              "fused": bool(args.fused), "paths": {}}
    for dyadic in args.dyadic.split(","):
        wall_ms, groups, kernels = profile_path(model, dyadic, bool(args.fused), args.batch,
                                                args.seconds, dev)
        busy = sum(ms for ms, _ in groups.values())
        launches = sum(n for _, n in groups.values())
        print(f"{card}; B={args.batch} x {args.seconds} s, {dyadic}, "
              f"{'kernel' if args.fused else 'plain'} path")
        print(f"profiled wall {wall_ms:.3f} ms/step, device busy {busy:.3f} ms/step "
              f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%), "
              f"{launches:.0f} device kernels per step")
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"  {g:72s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{n:.0f}")
        for k in kernels[:15]:
            print(f"    {k['ms_per_step']:8.3f} ms  x{k['calls_per_step']:6.1f}  {k['name']}")
        if busy <= 0:
            raise SystemExit("profiler recorded no device time")
        report["paths"][dyadic] = {"wall_ms": wall_ms, "busy_ms": busy,
                                   "launches_per_step": launches, "groups": groups,
                                   "kernels": kernels}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
