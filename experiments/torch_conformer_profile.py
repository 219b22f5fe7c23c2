"""Where the time goes in one step of the PyTorch port's frozen Conformer-CTC
on a GPU: torch.profiler over the B=32 x 15 s serving step of the flagship
(16 x 256, W8A8, the committed ranges).

    python3 experiments/torch_conformer_profile.py [--batch 32] [--seconds 15]
        [--kernels 1] [--out PATH]

Groups CUDA kernel time into the two hand-written Conformer kernels, the
int8 GEMMs (torch._int_mm), the float front (STFT, mel, subsampler
convolutions), the integer elementwise glue (requants, i-LayerNorm,
i-swish, masks, casts) and the rest; reports the device-busy share of the
profiled wall time.  Needs a GPU; measures nothing on the CPU.
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
    if "int_attention_kernel" in n:
        return "int_attention kernel"
    if "conv_block_stage" in n:
        return "conv_block kernel (stages A + B)"
    if any(k in n for k in ("i8", "s8", "imma", "int8", "igemm")):
        return "int8 GEMMs (torch._int_mm)"
    if any(k in n for k in ("fft", "reflection_pad", "conv", "cudnn", "implicit",
                            "xmma", "sgemm", "dgemm", "gemm", "cutlass", "reduce")):
        return "float front and float GEMMs (STFT, mel, subsampler, head)"
    return "integer elementwise glue (requants, i-LN, i-swish, masks, casts)"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--kernels", type=int, default=1)
    ap.add_argument("--out", help="also write the numbers as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.golden import conformer16x256_w8a8
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn

    dev = require_cuda(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    model = conformer16x256_w8a8()
    fn = make_conformer_frozen_fn(model, model.freeze(dev), argmax=True,
                                  kernels=bool(args.kernels))
    n = int(16000 * args.seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.normal(size=(args.batch, n)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((args.batch,), n, dtype=torch.int32, device=dev)
    for _ in range(3):
        fn(audio, lens)
    torch.cuda.synchronize()
    steps = 3
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
        groups[g] = groups.get(g, 0.0) + ms
        kernels.append({"name": ev.key[:120], "group": g, "ms_per_step": ms,
                        "calls_per_step": ev.count / steps})
    kernels.sort(key=lambda k: -k["ms_per_step"])
    busy = sum(groups.values())
    print(f"{card}; Conformer-CTC 16x256 W8A8, B={args.batch} x {args.seconds} s, "
          f"{'kernel' if args.kernels else 'plain'} path")
    print(f"profiled wall {wall_ms:.3f} ms/step, device busy {busy:.3f} ms/step "
          f"({100 * busy / wall_ms:.1f}%, idle {100 * (1 - busy / wall_ms):.1f}%)")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:66s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%")
    for k in kernels[:25]:
        print(f"    {k['ms_per_step']:8.3f} ms  x{k['calls_per_step']:6.1f}  {k['name']}")
    if busy <= 0:
        raise SystemExit("profiler recorded no device time")
    if not args.out:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "batch": args.batch, "seconds": args.seconds,
                   "kernels_path": bool(args.kernels), "wall_ms": wall_ms, "busy_ms": busy,
                   "groups_ms": groups, "kernels": kernels}, f, indent=1)


if __name__ == "__main__":
    main()
