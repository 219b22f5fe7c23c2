"""Where a synthesis iteration's time goes on the GPU: the eager loop and
its CUDA graph.

    python3 experiments/torch_synth_profile.py [--iters 10] [--out PATH]

Full-width QuartzNet15x5 (random weights, seed 0), one distillation
problem at the reference recipe's batch (8 x 500 frames x 64 mels).
"eager": a loop of ``quantize.synth.loss_and_backward`` (forward and
backward, TF32 off) and Adam step, its mean time by CUDA events over
``--iters`` iterations after 3 warm-ups, and torch.profiler's device time,
top CUDA kernels and any TF32 kernel (a name with "tf32" or "s1688") over
3 iterations.
"graph": ``quantize.synth.synthesize_batch``, which replays one captured
iteration (plus the loss read back and the plateau schedule), its time an
iteration as the difference of a 3 * iters and an iters run over 2 * iters.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.quantize.synth import (
        bn_targets, loss_and_backward, start_points, synthesize_batch,
    )

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    model = ASRModel.from_pretrained("QuartzNet15x5Base-En", allow_random_weights=True)
    params = model.device_params(dev)["encoder"]
    targets = bn_targets(model.plan, params)
    x0 = start_points(1, 8, 500, 64, seed=0)[0].to(dev)
    x = x0.clone().requires_grad_(True)
    lens = torch.full((8,), 500, dtype=torch.int32, device=dev)
    opt = torch.optim.Adam([x], lr=0.01)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_and_backward(model.plan, params, x, lens, targets)
        opt.step()
        return loss.item()

    res = {"card": card}
    for _ in range(3):
        step()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(args.iters):
        step()
    b.record()
    b.synchronize()
    res["eager_ms"] = a.elapsed_time(b) / args.iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        rows.append((ev.self_cuda_time_total if us is None else us, ev.count, ev.key))
    rows.sort(reverse=True)
    res["eager_device_ms"] = sum(r[0] for r in rows) / 3e3
    res["eager_kernels_per_iter"] = sum(r[1] for r in rows) / 3
    res["top_kernels"] = [(k[:90], c // 3, us / 3e3) for us, c, k in rows[:12]]
    res["tf32_kernels"] = [(k[:90], c // 3) for _, c, k in rows
                           if "tf32" in k.lower() or "s1688" in k.lower()]

    def graph_run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synthesize_batch(model.plan, params, x0, train_iter=n, lr=0.01, targets=targets)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    graph_run(2)
    short, long_ = graph_run(args.iters), graph_run(3 * args.iters)
    res["graph_ms"] = (long_ - short) / (2 * args.iters) * 1e3
    print(f"eager: {res['eager_ms']:.2f} ms an iteration (CUDA events, mean of {args.iters}); "
          f"device {res['eager_device_ms']:.2f} ms in {res['eager_kernels_per_iter']:.0f} "
          f"kernels [{card}]")
    for name, c, ms in res["top_kernels"]:
        print(f"  {ms:8.3f} ms  x{c:5d}  {name}")
    print(f"TF32 kernels an iteration: {res['tf32_kernels'] or 'none'}")
    print(f"graph: {res['graph_ms']:.2f} ms an iteration (synthesize_batch, loss read and "
          f"schedule included) [{card}]")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
