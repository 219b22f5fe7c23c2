"""Kernel 8 (dense_conv) on a GPU: time it at each of Jasper10x5Dr's 11
distinct dense conv sites at the serving shape (B=64 x 15 s: 768 frames
after the first conv's stride), in the W8A8 in-block form (uint8 in,
requant + ReLU -> uint8 codes; int8 in at the first conv), beside its
bound and two yardsticks used nowhere in the port: float64 conv1d (one
call, exact here) and im2col + torch._int_mm (two calls: F.pad + unfold +
a copy, then cuBLAS's int8 tensor-core product, on int8 operands of the
same shapes, since _int_mm takes no uint8).  A forward's Kernel 8 time is
the sites' device times weighted by their launches (52).

    python3 experiments/torch_dense_sites.py [--root DIR] [--checks] [--time] \\
        [--step] [--scan] [--sass DIR] [--out PATH]

--root imports qasr_tpu_torch from another checkout (a parent commit
unpacked with git archive), so that one chip call can time parent and
change in turns, one process each.  --checks first runs chip_smoke.py's
phase 10a (the uint8 kernels' checks and every Kernel 8 check, the
tiling's edges included).  --time times the sites.  --step profiles the
Jasper10x5Dr W6A6 static_e step at B=64 x 15 s with torch.profiler
(experiments/torch_step_profile.py's groups: Kernels 8, 2 and 7, the
float front, host gaps, the busy share) and times the W6A6 static_e, W8A8
static_e and W8A8 per_channel steps with CUDA events.  --sass DIR writes
the kernel's SASS (cuobjdump) and counts its tensor-core instructions
(IGMMA: wgmma; IMMA: mma.sync) in the whole function and in each loop.
At the K=25 768 -> 768 site --time also reads the SM clock and power draw
(nvidia-smi) while the kernel runs back to back.  --scan times the
kernel against K at Cin = Cout in {256, 768}, with and without the requant
epilogue, and fits the fixed cost of a launch and the cost of a K step.
The timing helpers are this checkout's chip_smoke.py.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, T_ENC = 64, 768


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def site_counts():
    """{(K, Cin, Cout, stride, dilation): launches a forward} of
    Jasper10x5Dr's dense convs, in walk order."""
    from qasr_tpu_torch.models.config import jasper10x5dr
    from qasr_tpu_torch.models.jasper import build_encoder_plan, is_dense

    counts = collections.Counter()
    for bp in build_encoder_plan(jasper10x5dr().encoder).blocks:
        for s in bp.convs:
            if is_dense(s):
                counts[s.kernel, s.in_ch, s.out_ch, s.stride, s.dilation] += 1
    return dict(counts)


def im2col(x, k, s, pad, d):
    """(B * T_out, K * Cin) rows of x (B, T, Cin), tap-major as w's (Cout,
    K, Cin) rows: F.pad, unfold, and the copy that lays them out."""
    import torch.nn.functional as F

    cin = x.shape[2]
    win = F.pad(x, (0, 0, pad, pad)).unfold(1, (k - 1) * d + 1, s)[..., ::d]
    return win.permute(0, 1, 3, 2).reshape(-1, k * cin).contiguous()


def clocks_under(fn, seconds=2.0):
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 100 ms
    while fn() runs back to back for ``seconds`` (the first 3 samples, the
    ramp, dropped): {"sm_mhz": median, "sm_mhz_max": the card's maximum,
    "power_w": median, "samples": n}."""
    import subprocess
    import time

    import torch

    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
            if line.strip() and "N/A" not in line][3:]
    if not rows:
        return {"samples": 0}
    return {"sm_mhz": statistics.median(r[0] for r in rows), "sm_mhz_max": rows[0][1],
            "power_w": statistics.median(r[2] for r in rows), "samples": len(rows)}


def time_sites(cs, dev, card, tag):
    """Each site: Kernel 8 (device ms by torch.profiler over 10 calls, and
    per-call CUDA events), its bound, float64 conv1d and im2col + _int_mm
    (events); returns (rows, forward totals)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dense_conv import dense_conv
    from qasr_tpu_torch.models.jasper import get_same_padding, out_frames

    rng = np.random.default_rng(11)

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    full = torch.full((BATCH,), T_ENC, dtype=torch.int32, device=dev)
    rows = []
    for (k, cin, cout, s, d), n in site_counts().items():
        pad = get_same_padding(k, s, d)
        t_in = T_ENC * s
        t_out = out_frames(t_in, k, s, pad, d)
        first = cin == 64   # the quantized features: int8
        x = t(-64, 64, (BATCH, t_in, cin), np.int8) if first else \
            t(0, 256, (BATCH, t_in, cin), np.uint8)
        w = t(-127, 128, (cout, k, cin), np.int8)
        kw = dict(stride=s, padding=pad, dilation=d,
                  bias=t(-3000, 3000, cout, np.int32), relu=True, lens=full,
                  m=t(2**29, 2**31, cout, np.int32),
                  e=cs.spread_e(k * cin, 40 if first else 147, 73), bits=9)
        label = (f"dense_conv B={BATCH} T={t_out} K={k} {cin}->{cout} s={s} d={d} "
                 f"{'int8' if first else 'u8'} in, requant+relu u8 out")
        kern = statistics.median(cs.cuda_ms(lambda: dense_conv(x, w, **kw), reps=10))
        dev_ms, dev_by = cs.device_ms(lambda: dense_conv(x, w, **kw), "dense_conv_kernel")
        bound_ms, bound_by = cs.bound(x.numel() + w.numel() + 4 * 2 * cout + 4 * BATCH
                                      + BATCH * t_out * cout,
                                      2 * BATCH * t_out * k * cin * cout)
        xf = x.to(torch.float64).transpose(1, 2).contiguous()
        wf = w.to(torch.float64).permute(0, 2, 1).contiguous()
        conv = statistics.median(cs.cuda_ms(lambda: F.conv1d(xf, wf, None, s, pad, d), reps=1,
                                            warmup=1))
        del xf, wf
        x8 = x if first else t(-128, 128, (BATCH, t_in, cin), np.int8)
        w2 = w.reshape(cout, k * cin).t()
        cols = im2col(x8, k, s, pad, d)
        col_ms = statistics.median(cs.cuda_ms(lambda: im2col(x8, k, s, pad, d), reps=3))
        mm_ms = statistics.median(cs.cuda_ms(lambda: torch._int_mm(cols, w2), reps=3))
        del cols, x8
        rows.append({"site": [k, cin, cout, s, d], "launches": n, "shape": label,
                     "device_ms": dev_ms, "device_ms_by": dev_by, "call_ms": kern,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "conv1d_f64_ms": conv, "im2col_ms": col_ms, "int_mm_ms": mm_ms,
                     "tree": tag})
        if cin == cout == 768:
            # the card's clock under Kernel 8's heaviest site (the 1,979 TOP/s
            # peak is 132 SMs x 4,096 int8 multiply-adds x 2 at 1,830 MHz)
            rows[-1]["clocks"] = clk = clocks_under(lambda: dense_conv(x, w, **kw))
            print(f"  under it: {clk} [{card}; {tag}]", flush=True)
        print(f"{label} x{n}: kernel {dev_ms:.4f} ms device ({dev_by}; {kern:.4f} ms call), "
              f"bound {bound_ms:.4f} ({bound_by}, {100 * bound_ms / dev_ms:.0f}%), float64 "
              f"conv1d {conv:.3f}, im2col {col_ms:.4f} + _int_mm {mm_ms:.4f} = "
              f"{col_ms + mm_ms:.4f} ms [{card}; {tag}]", flush=True)
        del x, w
    fwd = {"kernel_ms": sum(r["device_ms"] * r["launches"] for r in rows),
           "bound_ms": sum(r["bound_ms"] * r["launches"] for r in rows),
           "im2col_int_mm_ms": sum((r["im2col_ms"] + r["int_mm_ms"]) * r["launches"]
                                   for r in rows),
           "int_mm_ms": sum(r["int_mm_ms"] * r["launches"] for r in rows),
           "launches": sum(r["launches"] for r in rows)}
    print(f"a forward's {fwd['launches']} launches: Kernel 8 {fwd['kernel_ms']:.3f} ms, bound "
          f"{fwd['bound_ms']:.3f} ms ({100 * fwd['bound_ms'] / fwd['kernel_ms']:.1f}%), "
          f"im2col + _int_mm {fwd['im2col_int_mm_ms']:.3f} ms (_int_mm alone "
          f"{fwd['int_mm_ms']:.3f}) [{card}; {tag}]", flush=True)
    return rows, fwd


def scan_k(cs, dev, card, tag):
    """Kernel 8's device time against K at B=64 x 768 frames, Cin = Cout in
    {256, 768}, with no epilogue (int32 out) and with the requant epilogue
    (uint8 out): a least-squares line ms = fixed + per_step * K * Cin / 128
    splits each launch into what K steps cost and what does not scale with
    them (filling the rows, the ring's ramp, the epilogue, the waves)."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dense_conv import dense_conv, plan
    from qasr_tpu_torch.models.jasper import get_same_padding

    rng = np.random.default_rng(12)
    full = torch.full((BATCH,), T_ENC, dtype=torch.int32, device=dev)
    rows = []
    for c in (256, 768):
        x = torch.from_numpy(rng.integers(0, 256, (BATCH, T_ENC, c)).astype(np.uint8)).to(dev)
        bias = torch.from_numpy(rng.integers(-3000, 3000, c).astype(np.int32)).to(dev)
        m = torch.from_numpy(rng.integers(2**29, 2**31, c).astype(np.int32)).to(dev)
        for mode in ("none", "requant"):
            pts = []
            for k in (1, 3, 5, 11, 21, 41):
                w = torch.from_numpy(rng.integers(-127, 128, (c, k, c)).astype(np.int8)).to(dev)
                kw = dict(padding=get_same_padding(k, 1, 1), bias=bias, relu=True)
                if mode == "requant":
                    kw.update(lens=full, m=m, e=cs.spread_e(k * c, 147, 73), bits=9)
                ms, by = cs.device_ms(lambda: dense_conv(x, w, **kw), "dense_conv_kernel")
                p = plan(BATCH, T_ENC, c, c, k, 1, 1)
                steps = -(-c // p["bn"]) * k * p["nc"]   # K steps a block
                bound = cs.bound(0, 2 * BATCH * T_ENC * k * c * c)[0]
                pts.append((steps, ms))
                rows.append({"cin": c, "mode": mode, "k": k, "steps": steps, "device_ms": ms,
                             "device_ms_by": by, "bound_ms": bound, "tree": tag})
                print(f"scan Cin=Cout={c} {mode} K={k}: {steps} K steps a block, {ms:.4f} ms "
                      f"({by}), bound {bound:.4f} ({100 * bound / ms:.0f}%) [{card}; {tag}]",
                      flush=True)
            per_step, fixed = np.polyfit([s_ for s_, _ in pts], [t_ for _, t_ in pts], 1)
            print(f"scan Cin=Cout={c} {mode}: {fixed:.4f} ms fixed + {1e3 * per_step:.3f} us a "
                  f"K step of every block [{card}; {tag}]", flush=True)
            rows.append({"cin": c, "mode": mode, "fixed_ms": fixed, "per_step_us": 1e3 * per_step,
                         "tree": tag})
    return rows


def profile_step(cs, dev, card, tag):
    """The Jasper10x5Dr W6A6 static_e step under torch.profiler, and the
    event-timed steps of W6A6 static_e, W8A8 static_e and W8A8 per_channel."""
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    sp = _load("step_profile", os.path.join(HERE, "experiments", "torch_step_profile.py"))
    out = {}
    models = {bits: golden.flagship("jasper10x5dr", bits) for bits in (6, 8)}
    wall, groups, kernels = sp.profile_path(models[6], "static_e", True, BATCH, 15.0, dev)
    busy = sum(ms for ms, _ in groups.values())
    print(f"Jasper10x5Dr W6A6 static_e B={BATCH} x 15 s, profiled: wall {wall:.3f} ms/step, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), host gaps "
          f"{wall - busy:.3f} ms [{card}; {tag}]", flush=True)
    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:72s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{n:.0f}", flush=True)
    if busy <= 0:
        raise SystemExit("profiler recorded no device time")
    out["profile"] = {"wall_ms": wall, "busy_ms": busy, "groups": groups,
                      "kernels": kernels[:20]}
    audio, lens = cs.noise_batch(BATCH, 15.0, dev)
    fns = {f"W{b}A{b} {m}": make_frozen_fn(models[b], models[b].freeze(m, device=dev),
                                           argmax=True)
           for b, m in ((6, "static_e"), (8, "static_e"), (8, "per_channel"))}
    out["step_ms"] = cs.step_times(fns, (audio, lens), card, f"Jasper10x5Dr {tag}", BATCH,
                                   15.0, {})
    del audio
    torch.cuda.synchronize()
    return out


def sass_counts(cs_sites, lib, out_dir):
    """Kernel 8's SASS into out_dir; prints each instantiation's tensor-core
    instructions and its loops that hold them."""
    counts = cs_sites.dump_sass(lib, out_dir, ("dense_conv",))
    for name, fn in counts.items():
        ops = fn["ops"]
        print(f"sass {name[:100]}: {sum(ops.values())} instructions; IGMMA "
              f"{ops.get('IGMMA', 0)}, IMMA {ops.get('IMMA', 0)}, LDSM {ops.get('LDSM', 0)}, "
              f"BAR {ops.get('BAR', 0)}, SYNCS {ops.get('SYNCS', 0)}", flush=True)
        for a, b, n, lops in fn["loops"]:
            if "IGMMA" in lops or "IMMA" in lops:
                print(f"    loop {a:#x}-{b:#x}: {n} instructions; "
                      f"{dict(list(lops.items())[:14])}", flush=True)
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose qasr_tpu_torch to time")
    ap.add_argument("--checks", action="store_true", help="run phase 10a's checks first")
    ap.add_argument("--time", action="store_true", help="time the 11 sites")
    ap.add_argument("--step", action="store_true", help="profile and time the Jasper steps")
    ap.add_argument("--scan", action="store_true", help="time Kernel 8 against K (fixed cost)")
    ap.add_argument("--sass", help="write the kernel's SASS to this directory")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import qasr_tpu_torch  # noqa: F401  (from root, before any helper puts HERE on the path)

    cs = _load("smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build

    dev = require_cuda(0)
    card = cs.card_line()
    tag = "change" if root == HERE else f"tree {os.path.relpath(root, HERE)}"
    print(f"{card} [{tag}]", flush=True)
    _build.library()
    print(f"build {_build.BuildInfo.seconds:.2f} s (compiled={_build.BuildInfo.compiled})",
          flush=True)
    lines = _build.BuildInfo.log.splitlines()
    for i, line in enumerate(lines):   # ptxas -v: the entry line, then its properties
        if ("dense_conv" in line and "Compiling entry" in line) or "arning" in line:
            for ln in lines[i:i + 5]:
                print(f"ptxas: {ln.strip()}", flush=True)
    report = {"card": card, "root": root, "tree": tag, "ptxas": _build.BuildInfo.log}
    if args.sass:
        sites = _load("conformer_sites", os.path.join(HERE, "experiments",
                                                       "torch_conformer_sites.py"))
        report["sass_ops"] = sass_counts(sites, _build.BuildInfo.path, args.sass)
    if args.checks:
        chk = cs.Checker()
        cs.phase_u8_kernels(chk, dev)
        print(f"{chk.n} comparisons exact; max |d| {chk.max_err} [{tag}]", flush=True)
        report["checks"] = chk.n
    if args.time:
        report["rows"], report["forward"] = time_sites(cs, dev, card, tag)
    if args.step:
        report["step"] = profile_step(cs, dev, card, tag)
    if args.scan:
        report["scan"] = scan_k(cs, dev, card, tag)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)


if __name__ == "__main__":
    main()
