#!/usr/bin/env python3
"""Smoke test of the PyTorch port (qasr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Drives the port's serving paths on the card, the frozen W6A6 QuartzNet15x5
in its dyadic modes (static_e and static_e16 on FrozenExecFused,
every requant in a prologue or epilogue of Kernels 1-2; per_channel on
FrozenExecKernels, convs in Kernels 1-2, the requants next to a depthwise
conv in Kernel 1's prologue and epilogue with per-channel exponents, the
rest in Kernel 7) and
the frozen W8A8 Conformer-CTC (16 x 256), and QuartzNet15x5's zero-shot
workflow (synthesis, calibration, the dynamic forward, the CLIs) and the
Conformer-CTC's (synthesis, calibration, freeze and serve, dynamic), with
nothing that falls back: no CUDA, a failed kernel build or any failed
phase exits non-zero before the result line.  Phases:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from qasr_tpu_torch/kernels/csrc (one nvcc per
   source, in parallel; timed);
3. each kernel against its plain torch version on the card, bit for bit
   (torch.equal): dw_conv and pw_gemm at every QuartzNet shape and
   epilogue mode, and with the input-requant prologue (int8 and int32
   inputs, producer bias and ReLU on and off, 31- and 16-bit mantissas,
   per-channel or scalar, bits1 6/7/8, ragged input lengths, with every
   epilogue mode; dw_conv also with per-channel exponents e / e1 spread
   over 1-31 plus 0, 62, 63 and 70 in six prologue / epilogue modes),
   pw_gemm at N in {1, 37, 609} (a ragged last row tile),
   Cin 64 (a single K chunk) to 1024 and 24 / 40 (the wrapper zero-pads
   them to a multiple of 16), Cout 29 (one 32-column tile, rows of
   29 or 116 bytes) to 1024 (the prologue's resident A tile reused over 8
   column tiles); the
   requant kernel at C in {64, 256, 512, 1024, 29, 24} with int8 and int32
   inputs, scalar and per-channel mantissas and exponents (1, 31, 62, 63,
   70), identity and mask on and off, every row masked, and a view that
   starts off a 16-byte boundary; the requant device functions
   (qasr_requant, and qasr_rq with its constants hoisted, as Kernels 1, 4
   and 7 use it) over a boundary grid and 2 x 2^20 random triples, z over
   all of int32 in one half, and qasr_rq_f64 (Kernel 3's score requants)
   on the triples in its domain plus 2^20 at |z| <= 2^21; the Conformer's
   integer device functions over their whole domains (i_exp, and i_exp >> 4
   from the table of its quadratic as Kernel 3 reads it; i_sigmoid_grid,
   and Kernel 4's GLU-gate forms, the table lookup and the reciprocal
   division, on [-N_IN-64, N_IN+64] and +-2^26; the invariant-divisor
   division Kernel 3 divides by the row sum with, over every divisor in
   [1, 2^20] against ten numerators each and 2 x 2^20 random pairs below
   2^31; the LN square root, also as the float root Kernel 4 uses, on
   [0, 2^22) and 2^20 random n < 2^30; floor_div; the i-LN row core in
   both forms); int_attention at T in {1, 37, 128, 129, 375, 500} with ragged
   lengths and contexts -1, (8, 0), (4, 2), at d_k in {16, 96, 128}
   besides the flagship's 64, at T in {1300, 1500, 2600} on its
   streaming form, and with score requants outside qasr_rq_f64's domain
   at T 129 and 1300; conv_block at d in {64, 256, 512}, T in {1, 31, 375}
   with ragged lengths; lin_epilogue in its three modes at every (K, D) of
   the Conformer path (K = 4864 is 38 chunks of K), with and without bias,
   at N in {1, 37, 609, 12000}, on the flagship's sites and on seeded sites
   with exponents above 31; ffn_ln
   at d in {64, 256, 512} x T in {1, 31, 375}, tail on and off, its
   per-column requants on the FP64 pipe, and at T = 375 also with every
   site, and with l1 alone, pushed out of qasr_rq_f64's domain (so that
   the host sends them to qasr_rq);
4. the golden checks: full-width QuartzNet15x5 reproduces the JAX static_e
   record exactly on FrozenExecFused, FrozenExecKernels and the plain path,
   and the JAX per_channel record on FrozenExecKernels and the plain path;
   the flagship Conformer-CTC's x8 is within 0.1% of codes at +-1 of the
   JAX record (float32 subsampler) and its integer stack from the golden x8
   reproduces the encodings' hash, ids and lengths exactly under the plans
   ("1", True) (the default), ("conv", True), ("conv", False) and on the
   plain path;
5. serve 4 seeded int16 PCM requests (4.0, 7.3, 11.6, 15.0 s) through
   ASRModel.transcribe in the static_e and per_channel modes (the
   flagship's static_e16 freeze raises, as the JAX package's does) and
   through
   ConformerCTC.transcribe_greedy (the default plan), and the same batch
   once more under ("conv", True), with every launch count set to 0 just
   before each and read just after: each path launches its own kernels as
   kernel_launches predicts for its tables or plan (QuartzNet 77 dw_conv +
   94 pw_gemm, and under per_channel 32 requant: the residual branches'
   and C3's inputs, the joins and the decoder's input; the
   Conformer 16 int_attention + 16 conv_block + 32 ffn_ln + 81
   lin_epilogue, and 16 + 16 + 145 lin_epilogue under ("conv", True)) and
   gives the ids of its plain executor;
6. time the QuartzNet B=64 x 15 s step (static_e and per_channel kernel
   paths, and both plain) and the Conformer B=32 x 15 s step (default
   plan; ("conv", False), the attention and conv-module kernels with plain
   glue; plain), median of 10 after 3 warm-ups, CUDA events, in turns; and
   each kernel against its plain version at its path's shapes (Kernel 1 at
   every depthwise site of the walk in its static_e and its per_channel
   form, the static prologue sites, and the epilogue-off function at C=512
   K=75 and C2 beside cuDNN's float32 depthwise conv; Kernel 7 at every
   kind of site the per_channel path still runs in it; Kernel 2's sites;
   int_attention's streaming form at T=1500; ffn_ln as FFN1 + ln_att, FFN2
   + ln_out and the last layer's FFN2 without a tail), with its bound
   (bytes over 3.35 TB/s or int8 operations over 1,979 TOP/s, from this
   run's inputs) and, where one PyTorch call
   computes the same function, that call's time: each as CUDA events
   around one call (call_ms, the wrapper's host time included) and as
   device time (device_ms: torch.profiler over 10 calls, the named
   kernels' device time per call);
7. the zero-shot workflow on full-width QuartzNet15x5 at W6A6: (a)
   ``get_synthetic_data`` at the reference recipe (8 x 500 frames, 200
   Adam iterations, lr 0.01; a CUDA graph replay an iteration) for 2
   problems: every loss finite, each problem's last below its first, and
   the first 3 losses of one start point on the card within SYNTH_RTOL of
   the CPU's (eager) at 2 x 200 frames; distill_loss's input gradient at
   8 x 500 frames within GRAD_RTOL (norm-wise) of the CPU's, which the
   same backward under TF32 must exceed; (b) ``calibrate`` on those
   batches, min / max and percentile 99.9 (histogram_quantile at the
   sites above 2^18 elements): 77 dw_conv + 94 pw_gemm launches a forward,
   and the range state equal bit for bit to the plain QuantExec's on the
   card; the calibrating forward (B=8 x 500 frames) timed; (d) the dynamic
   forward's ids equal the plain QuantExec's (77 + 94 launches), and the
   dynamic forward at B=64 x 15 s timed; (e) ``cli.synthesize`` then
   ``cli.inference --weight_bit 6 --act_bit 6 --percentile 99.9`` on a
   manifest of 4 seeded wavs: a finite WER and the hypotheses of the plain
   frozen executor; (c) ``calibrate_on_noise(2, 2, 4 s, seed 0)`` against
   the committed noise ranges (the JAX package's seed-0 recipe): the
   first site (the features alone) within 1e-4 of its range, every site
   within 15% of its range; beside them, how far the CPU's features, or
   the card's times (1 + 1e-5 N(0, 1)), move the port's own ranges, and
   what planted faults of the recipe read (another seed and percentile
   99.9 must read above 15%); how many frozen table entries differ from
   the golden record's tables;
8. the Conformer-CTC's zero-shot workflow at full width (16 x 256, W8A8,
   every integer flag and static attention): (a) synthesis at
   ``quantize_encoder_synthetic``'s recipe (2 problems of 8 x 128 frames,
   200 Adam iterations, lr 0.02; a CUDA graph replay an iteration): every
   loss finite, each problem's last below its first, the first 3 losses of
   one start point within CONF_SYNTH_RTOL of the CPU's (2 x 128 frames),
   conformer_distill_loss's input gradient at 8 x 128 within
   CONF_GRAD_RTOL (norm-wise) of the CPU's, which the same backward under
   TF32 must exceed; (b) ``quantize_encoder`` on those batches: 16 dw_conv
   + 178 pw_gemm launches a forward (pre_out's 4,864-wide contraction in
   two) and the range state equal bit for bit to the plain path's, and
   at momentum 0.9 equal to the plain path's and moved off 0.95's (the
   EMA over the 2 batches); then ``freeze`` and 4 seeded requests through ``transcribe_greedy``: 16 + 16
   + 32 + 81 launches and the plain frozen executor's ids; (c) the
   committed asset's recipe (one batch of 4 x 15 s of seed-0 noise x 0.1)
   against its ranges: pre_out within 1e-4 and every site within
   CONF_RANGE_L of its range, planted faults (another noise seed,
   percentile 99.9) above it, momentum 0.9 printed (one batch never
   applies the EMA), and how many frozen table entries differ from the
   golden record's tables; (d) the dynamic forward at B=32 x 15 s: the
   plain path's log-probs bit for bit (and so its ids), 16 + 179
   launches, and its time; Kernels 1 and 2 against their plain versions
   at its shapes (B=32 T'=375; N=12,000, the K-split included); (e) the calibrating forward at B=4 x 15 s and Kernels 1 and
   2 at its shapes against their plain versions, cuDNN's depthwise conv
   and torch._int_mm.

Prints the card line, a {"kernels": [...]} line (each kernel's "ms" and
"library_ms" are device times at the site "shape" names, "call_ms" and
"library_call_ms" the per-call event times), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the slice's depthwise sites: (C, K, stride, dilation)
DW_SITES = ([(64, 33, 2, 1)]
            + [(c, k, 1, 1) for c in (256, 512) for k in (33, 39, 51, 63, 75)]
            + [(512, 87, 1, 2)])
# 24 and 40: the tiny test preset's widths, below / off a multiple of 16
# (the wrapper zero-pads the contraction)
PW_CIN = (64, 256, 512, 1024, 24, 40)
PW_COUT = (256, 512, 1024, 29)
# the Conformer kernels' check grid
ATT_T = (1, 37, 128, 129, 375, 500)
ATT_CTX = ((-1, -1), (8, 0), (4, 2))
ATT_DK = (16, 96, 128)             # the other head widths the kernel takes (d_k 64 above)
ATT_T_LONG = (1300, 1500, 2600)    # above the resident form's shared memory: streaming
# the requant kernel's channel counts: QuartzNet's widths, the decoder's 29
# and 24 (int8 output on the element path, int32 on 8-channel vectors)
RQ_C = (64, 256, 512, 1024, 29, 24)
# the flagship's dyadic modes; its ranges give static_e16 an exponent above
# 31, so its freeze raises, in the JAX package as here
QUARTZNET_MODES = ("static_e", "per_channel")
CONV_D, CONV_T = (64, 256, 512), (1, 31, 375)
FFN_D, FFN_T = (64, 256, 512), (1, 31, 375)
LIN_N = (1, 37, 609, 12000)
# pw_gemm's (B, T) in phase 3: N = 609, 1 and 37 rows (ragged last row tiles)
PW_BT = ((3, 203), (1, 1), (1, 37))
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12
KERNELS = ("dw_conv", "pw_gemm", "requant", "int_attention", "conv_block", "lin_epilogue",
           "ffn_ln")
# the device kernels each wrapper launches (a substring of their names)
KERNEL_SYMBOLS = {"dw_conv": "dw_conv_kernel", "pw_gemm": "pw_gemm_kernel",
                  "requant": "requant_kernel", "int_attention": "int_attention",
                  "conv_block": "conv_block_stage", "lin_epilogue": "lin_epilogue_kernel",
                  "ffn_ln": "ffn_ln_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 3):
    """Per-call device times (ms) of fn(): CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_ms(fn, symbol=None, calls: int = 10):
    """(device time in ms per call of fn(), how it was read): torch.profiler
    (CPU and CUDA activities) over ``calls`` calls, the sum of the CUDA
    kernels' device time (of the kernels whose names hold ``symbol``, or of
    all) divided by the calls.  A trace that holds fewer than ``calls`` of
    those kernels (the profiler drops kernel records now and then) is taken
    again, up to three times; after that CUDA events around the ``calls``
    calls in a row stand in, and the second value says "events"."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, kernels = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if symbol is not None and symbol not in ev.key:
                continue
            us = getattr(ev, "self_device_time_total", None)
            total_us += ev.self_cuda_time_total if us is None else us
            kernels += ev.count
        if total_us > 0 and kernels >= calls:
            return total_us / 1e3 / calls, "profiler"
    return sum(cuda_ms(lambda: [fn() for _ in range(calls)], reps=1, warmup=0)) / calls, "events"


class Checker:
    """Counts kernel-vs-plain comparisons and their largest |difference|."""

    def __init__(self):
        self.n = 0
        self.max_err = {k: 0 for k in KERNELS + ("requant_fn", "conformer_int")}

    def equal(self, kind: str, what: str, got, want) -> None:
        import torch

        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                                 f"{want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max_err[kind] = max(self.max_err[kind], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from plain (max |d| = {err})")
        self.n += 1


def bound(nbytes: float, int8_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the int8 operations over the tensor-core peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, int8_ops / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def wrappers():
    from qasr_tpu_torch.kernels.conv_block import conv_block
    from qasr_tpu_torch.kernels.dw_conv import dw_conv
    from qasr_tpu_torch.kernels.ffn_ln import ffn_ln
    from qasr_tpu_torch.kernels.int_attention import int_attention
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm
    from qasr_tpu_torch.kernels.requant import requant

    return {"dw_conv": dw_conv, "pw_gemm": pw_gemm, "requant": requant,
            "int_attention": int_attention, "conv_block": conv_block,
            "lin_epilogue": lin_epilogue, "ffn_ln": ffn_ln}


def planned(counts):
    """Every kernel's expected count: 0 unless ``counts`` names it."""
    return {**{k: 0 for k in KERNELS}, **counts}


def reset_counts() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    import torch

    torch.cuda.synchronize()
    return {k: w.launches for k, w in wrappers().items()}


def phase_requant(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant_device
    from qasr_tpu_torch.ops.quant_prims import Dyadic, dyadic_requant

    zs = [0, 1, -1, 2, -2, 3, 2**29 - 1, -(2**29 - 1), 12345678, -98765432, 777,
          2**31 - 1, -2**31, 2**30 + 1, -(2**30 + 3)]
    ms = [1, 2, 3, 2**15, 2**16 - 1, 2**30, 2**31 - 1, 3 << 29]
    es = list(range(1, 71))
    z, m, e = (a.reshape(-1) for a in np.meshgrid(np.asarray(zs), np.asarray(ms),
                                                  np.asarray(es), indexing="ij"))
    rng = np.random.default_rng(0)
    n = 1 << 20
    z = np.concatenate([z, rng.integers(-(2**29) + 1, 2**29, n),
                        rng.integers(-2**31, 2**31, n)]).astype(np.int32)
    m = np.concatenate([m, rng.integers(1, 2**31, 2 * n)]).astype(np.int32)
    e = np.concatenate([e, rng.integers(1, 71, 2 * n)]).astype(np.int32)
    zt, mt, et = (torch.from_numpy(a).to(dev) for a in (z, m, e))
    want = dyadic_requant(zt, Dyadic(mt, et))
    chk.equal("requant_fn", "requant device function (boundary grid + fuzz)",
              requant_device(zt, mt, et), want)
    chk.equal("requant_fn", "hoisted requant qasr_rq (boundary grid + fuzz)",
              requant_device(zt, mt, et, fast=True), want)
    # qasr_rq_f64 on its domain: the triples above inside it, and Kernel 3's
    # score requants (|z| <= d_k 2^14, e from 26)
    za, mm = np.abs(z.astype(np.int64)), m.astype(np.int64)
    lim = np.left_shift(np.int64(1), np.minimum(e.astype(np.int64) + 26, 62))
    ok = (za * mm < lim) & (e <= 62)
    zf = np.concatenate([z[ok], rng.integers(-(2**21), 2**21 + 1, n)]).astype(np.int32)
    mf = np.concatenate([m[ok], rng.integers(1, 2**31, n)]).astype(np.int32)
    ef = np.concatenate([e[ok], rng.integers(26, 63, n)]).astype(np.int32)
    zt, mt, et = (torch.from_numpy(a).to(dev) for a in (zf, mf, ef))
    chk.equal("requant_fn", "qasr_rq_f64 on its domain (grid + fuzz)",
              requant_device(zt, mt, et, f64=True), dyadic_requant(zt, Dyadic(mt, et)))
    log(f"[3] requant device functions (qasr_requant, qasr_rq) == plain on {z.size} "
        f"(z, m, e) triples; qasr_rq_f64 on {zf.size} in its domain")


def _tables(rng, c, m16, dev):
    import torch

    if m16:
        m, e = rng.integers(2**14, 2**16, c), 22
    else:
        m, e = rng.integers(2**29, 2**31 - 1, c), 37
    return torch.from_numpy(m.astype("int32")).to(dev), e


def _vector_tables(rng, c, shift, dev):
    """Per-channel (m, e): exponents 0, 62, 63, 70 and the rest in 1-31 (in
    a random channel order), each mantissa ~2^(e - shift) so that inputs of
    about 2^shift come out near 1 (saturating where e < shift)."""
    import numpy as np
    import torch

    e = rng.permutation(np.concatenate([[0, 62, 63, 70], rng.integers(1, 32, c - 4)]))
    m = np.where(e >= 62, rng.integers(2**29, 2**31, c),
                 np.clip(np.round(2.0 ** (e - shift) * rng.uniform(0.5, 2.0, c)), 1, 2**31 - 1))
    return (torch.from_numpy(m.astype(np.int32)).to(dev),
            torch.from_numpy(e.astype(np.int32)).to(dev))


def _vector_prologue(rng, c, shift, dev):
    m1, e1 = _vector_tables(rng, c, shift, dev)
    return dict(m1=m1, e1=e1)


def phase_dw(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.models.jasper import get_same_padding, out_frames

    rng = np.random.default_rng(1)
    for c, k, s, d in DW_SITES:
        b, t_in = 3, 300 * s + 7
        pad = get_same_padding(k, s, d)
        x = torch.from_numpy(rng.integers(-64, 64, (b, t_in, c)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-31, 32, (k, c)).astype(np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-3000, 3000, c).astype(np.int32)).to(dev)
        t_out = out_frames(t_in, k, s, pad, d)
        lens = torch.from_numpy(rng.integers(1, t_out + 1, b).astype(np.int32)).to(dev)
        conv = dict(stride=s, padding=pad, dilation=d)
        modes = {"int32": {}, "int32+bias+relu": dict(bias=bias, relu=True)}
        for m16 in (False, True):
            m, e = _tables(rng, c, m16, dev)
            modes[f"int8 m{16 if m16 else 31}"] = dict(out_len=lens, m=m, e=e, bits=7)
            modes[f"int8 m{16 if m16 else 31}+bias+relu"] = dict(
                bias=bias, relu=True, out_len=lens, m=m, e=e, bits=6)
        for name, kw in modes.items():
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(x, w, **conv, **kw), dw_conv_plain(x, w, **conv, **kw))
        # the input-requant prologue: int8 / int32 inputs, producer bias and
        # ReLU on and off, 31- and 16-bit mantissas, bits1 6/7/8, ragged
        # input lengths, with the epilogue on and off
        in_len = torch.from_numpy(rng.integers(1, t_in + 1, b).astype(np.int32)).to(dev)
        n_pro = 0
        for x32 in (False, True):
            xi = (torch.from_numpy(rng.integers(-2**20, 2**20, (b, t_in, c)).astype(np.int32))
                  .to(dev) if x32 else x)
            for bias_relu in (False, True):
                for m16 in (False, True):
                    bits1 = (6, 7, 8)[n_pro % 3]
                    m1, e1 = _tables(rng, c, m16, dev)
                    if n_pro % 4 == 3:  # one mantissa for all channels, as after a join
                        m1 = np.asarray(m1[0].item(), np.int32)
                    # exponents that spread the requant over the clamp range
                    pro = dict(in_len=in_len, m1=m1, e1=e1 + (6 if x32 else -8), bits1=bits1)
                    if bias_relu:
                        hb = 2**18 if x32 else 64
                        pro.update(in_bias=torch.from_numpy(
                            rng.integers(-hb, hb, c).astype(np.int32)).to(dev), in_relu=True)
                    epi = modes["int8 m31+bias+relu"] if n_pro % 2 else modes["int32"]
                    name = (f"prologue {'int32' if x32 else 'int8'} bias+relu={bias_relu} "
                            f"m{16 if m16 else 31}{' scalar' if m1.ndim == 0 else ''} "
                            f"bits1={bits1} epilogue={bool(n_pro % 2)}")
                    chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                              dw_conv(xi, w, **conv, **pro, **epi),
                              dw_conv_plain(xi, w, **conv, **pro, **epi))
                    n_pro += 1
        # per-channel exponents (the per_channel path's prologue and
        # epilogue): 1-31 with mantissas that keep most results inside
        # the clamp, plus 0 (counts as 1), 62, 63 and 70 (give 0)
        x32 = torch.from_numpy(rng.integers(-2**20, 2**20, (b, t_in, c)).astype(np.int32)).to(dev)
        in_bias = torch.from_numpy(rng.integers(-2**18, 2**18, c).astype(np.int32)).to(dev)
        m_v, e_v = _vector_tables(rng, c, 8, dev)
        epi_v = dict(bias=bias, relu=True, out_len=lens, m=m_v, e=e_v, bits=6)
        vector_modes = {
            "epilogue e[c]": dict(out_len=lens, m=m_v, e=e_v, bits=7),
            "epilogue e[c]+bias+relu": epi_v,
            "prologue int32 e1[c]+bias+relu, epilogue off": dict(
                _vector_prologue(rng, c, 16, dev), in_bias=in_bias, in_relu=True,
                in_len=in_len, bits1=7),
            "prologue int8 e1[c], epilogue e[c]": dict(
                _vector_prologue(rng, c, 2, dev), in_len=in_len, bits1=6, **epi_v),
            "prologue int32 e1[c]+relu, epilogue e[c] (the per_channel form)": dict(
                _vector_prologue(rng, c, 16, dev), in_relu=True, in_len=in_len, bits1=7,
                **epi_v),
            "prologue int32 0-d m1 and e1, epilogue e[c]": dict(
                m1=np.asarray(int(rng.integers(2**14, 2**15)), np.int32),
                e1=np.asarray(31, np.int32), in_relu=True, in_len=in_len, bits1=7, **epi_v),
        }
        for name, kw in vector_modes.items():
            xi = x if name.startswith("prologue int8") or name.startswith("epilogue") else x32
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(xi, w, **conv, **kw), dw_conv_plain(xi, w, **conv, **kw))
    # one channel a thread in the staging: C not a multiple of 4, and x
    # off a 16-byte boundary (a contiguous view)
    for c, x32, view in ((30, False, False), (30, True, False), (256, True, True)):
        b, t_in, k = 2, 203, 33
        n = b * t_in * c
        flat = torch.from_numpy((rng.integers(-2**20, 2**20, n + 1) if x32 else
                                 rng.integers(-64, 64, n + 1)).astype(
                                     np.int32 if x32 else np.int8)).to(dev)
        x = (flat[1:] if view else flat[:n]).view(b, t_in, c)
        w = torch.from_numpy(rng.integers(-31, 32, (k, c)).astype(np.int8)).to(dev)
        m, e = _vector_tables(rng, c, 8, dev)
        kw = dict(padding=16, out_len=torch.tensor([t_in, 150], dtype=torch.int32, device=dev),
                  m=m, e=e, bits=7)
        if x32:
            kw.update(_vector_prologue(rng, c, 16, dev), in_relu=True, bits1=7,
                      in_len=torch.tensor([t_in, 101], dtype=torch.int32, device=dev))
        chk.equal("dw_conv", f"dw_conv C={c} {'int32 prologue' if x32 else 'int8'} "
                  f"{'misaligned view' if view else ''} (one channel a thread)",
                  dw_conv(x, w, **kw), dw_conv_plain(x, w, **kw))
    log(f"[3] dw_conv == plain at {len(DW_SITES)} sites x (6 epilogue modes + 8 prologue "
        f"modes: int8/int32 input, bias+relu on/off, m31/m16, per-channel or one m1, "
        f"bits1 6/7/8, ragged in_len; 6 modes with per-channel exponents e / e1 in 1-31 "
        f"and 0, 62, 63, 70, or a 0-d m1 and e1), and one channel a thread at C=30 and on a "
        f"misaligned view")


def phase_pw(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(2)
    for (b, t), cin, cout in ((bt, ci, co) for bt in PW_BT for ci in PW_CIN for co in PW_COUT):
        x = torch.from_numpy(rng.integers(-64, 64, (b, t, cin)).astype(np.int8)).to(dev)
        wt = torch.from_numpy(rng.integers(-31, 32, (cout, cin)).astype(np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-3000, 3000, cout).astype(np.int32)).to(dev)
        lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
        res = torch.from_numpy(
            rng.integers(-2**20, 2**20, (b, t, cout)).astype(np.int32)).to(dev)
        modes = {"none": dict(bias=bias), "none+relu": dict(bias=bias, relu=True)}
        for m16 in (False, True):
            m, e = _tables(rng, cout, m16, dev)
            m_r, e_r = _tables(rng, cout, m16, dev)
            tag = f"m{16 if m16 else 31}"
            modes[f"requant {tag}"] = dict(bias=bias, lens=lens, m=m, e=e, bits=7)
            modes[f"requant+relu {tag}"] = dict(bias=bias, relu=True, lens=lens,
                                                 m=m, e=e, bits=7)
            modes[f"join {tag}"] = dict(bias=bias, m=m, e=e, bits=6, res=res,
                                        m_r=m_r, e_r=e_r + 3)
        for name, kw in modes.items():
            chk.equal("pw_gemm", f"pw_gemm N={b * t} {cin}->{cout} {name}",
                      pw_gemm(x, wt, **kw), pw_gemm_plain(x, wt, **kw))
        # the prologue with every epilogue mode: int8 / int32 inputs,
        # bias and ReLU on and off, 31- and 16-bit mantissas, bits1
        # 6/7/8, ragged in_len or no mask (the decoder's input)
        n_pro = 0
        for x32 in (False, True):
            xi = (torch.from_numpy(rng.integers(-2**20, 2**20, (b, t, cin)).astype(np.int32))
                  .to(dev) if x32 else x)
            for mode in ("none", "requant m31", "join m16"):
                m16 = n_pro % 2 == 1
                bits1 = (6, 7, 8)[n_pro % 3]
                m1, e1 = _tables(rng, cin, m16, dev)
                if n_pro % 4 == 3:  # one mantissa for all channels, as after a join
                    m1 = np.asarray(m1[0].item(), np.int32)
                pro = dict(m1=m1, e1=e1 + (6 if x32 else -8), bits1=bits1,
                           in_len=None if mode == "none" else lens)
                if n_pro % 3 != 2:
                    hb = 2**18 if x32 else 64
                    pro.update(in_bias=torch.from_numpy(
                        rng.integers(-hb, hb, cin).astype(np.int32)).to(dev), in_relu=True)
                name = (f"prologue {'int32' if x32 else 'int8'} {mode} m{16 if m16 else 31}"
                        f"{' scalar' if m1.ndim == 0 else ''} bits1={bits1} "
                        f"bias+relu={'in_bias' in pro} "
                        f"mask={pro['in_len'] is not None}")
                chk.equal("pw_gemm", f"pw_gemm N={b * t} {cin}->{cout} {name}",
                          pw_gemm(xi, wt, **pro, **modes[mode]),
                          pw_gemm_plain(xi, wt, **pro, **modes[mode]))
                n_pro += 1
    log(f"[3] pw_gemm == plain at {len(PW_CIN) * len(PW_COUT)} (Cin, Cout) pairs "
        f"x N in {[b * t for b, t in PW_BT]} x (8 epilogue modes + 6 prologue modes: "
        f"int8/int32 input x none/requant/join, bias+relu on/off, m31/m16, per-channel or "
        f"one m1, bits1 6/7/8, ragged in_len or none)")


def phase_requant_kernel(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant, requant_plain

    rng = np.random.default_rng(12)
    b, t = 3, 203
    lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
    n = 0
    for c in RQ_C:
        def vec(lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

        # per-channel exponents over the boundary values 1, 31, 62, 63 and beyond
        e_vec = torch.from_numpy(np.resize(np.asarray([1, 31, 62, 63, 70, 36, 44], np.int32),
                                           c)[rng.permutation(c)]).to(dev)
        for x32 in (False, True):
            z = torch.from_numpy((rng.integers(-2**28, 2**28, (b, t, c)) if x32 else
                                  rng.integers(-128, 128, (b, t, c)))
                                 .astype(np.int32 if x32 else np.int8)).to(dev)
            for vector in (False, True):
                if vector:
                    m, e = vec(1, 2**31), e_vec
                else:
                    # a 0-d mantissa as the per_channel tables hold one; an
                    # exponent that spreads the result over the clamp range
                    m, e = np.asarray(int(rng.integers(2**29, 2**31)), np.int32), 51 if x32 else 30
                for identity in (False, True):
                    for mask in (False, True):
                        kw = dict(lens=lens if mask else None, relu=bool(n % 2))
                        if identity:
                            kw.update(identity=torch.from_numpy(
                                rng.integers(-2**24, 2**24, (b, t, c)).astype(np.int32)).to(dev),
                                m_r=vec(2**29, 2**31) if vector else 2**30 + 3,
                                e_r=e_vec.flip(0).contiguous() if vector else 63)
                        bits = (6, 7, 8, 9)[n % 4]
                        name = (f"requant C={c} {'int32' if x32 else 'int8'} "
                                f"{'vector' if vector else 'scalar'} m/e identity={identity} "
                                f"mask={mask} relu={kw['relu']} bits={bits}")
                        chk.equal("requant", name, requant(z, m, e, bits, **kw),
                                  requant_plain(z, m, e, bits, **kw))
                        n += 1
            # every row masked: written 0 without being read
            m = vec(1, 2**31)
            kw = dict(lens=torch.zeros(b, dtype=torch.int32, device=dev), identity=z.to(
                torch.int32), m_r=vec(1, 2**31), e_r=e_vec, relu=True)
            for bits in (7, 9):
                chk.equal("requant", f"requant C={c} {'int32' if x32 else 'int8'} all rows "
                          f"masked bits={bits}", requant(z, m, e_vec, bits, **kw),
                          requant_plain(z, m, e_vec, bits, **kw))
                n += 1
    # a contiguous view that starts off a 16-byte boundary (the element path)
    c = 512
    flat = torch.from_numpy(rng.integers(-2**28, 2**28, b * t * c + 1).astype(np.int32)).to(dev)
    z = flat[1:].view(b, t, c)
    m = torch.from_numpy(rng.integers(1, 2**31, c).astype(np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(36, 44, c).astype(np.int32)).to(dev)
    chk.equal("requant", "requant C=512 int32 misaligned view", requant(z, m, e, 7, lens=lens),
              requant_plain(z, m, e, 7, lens=lens))
    n += 1
    log(f"[3] requant == plain at {n} cases: C in {RQ_C}, int8/int32 input, scalar and "
        f"per-channel m/e (exponents 1, 31, 62, 63, 70), identity and mask on/off, "
        f"bits 6-9, every row masked, a misaligned view")


def phase_golden(dev):
    """Full-width QuartzNet15x5 against both JAX golden records: static_e
    on FrozenExecFused, FrozenExecKernels and the plain executor;
    per_channel on FrozenExecKernels and the plain executor."""
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.freeze import (
        FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest, tables_to_device,
    )

    model = golden.quartznet15x5_w6a6()
    feats, lens = golden.golden_features(model.plan.feat_in)
    tables = {}
    for mode, executors in (("static_e", (FrozenExecFused, FrozenExecKernels, FrozenExec)),
                            ("per_channel", (FrozenExecKernels, FrozenExec))):
        host = model.freeze_host(mode)
        want = golden.load_golden(mode)
        digest = tables_digest(host)
        if digest != want["tables_sha256"]:
            raise AssertionError(f"{mode} table digest {digest} != golden "
                                 f"{want['tables_sha256']}")
        tables[mode] = tables_to_device(host, dev)
        for ex in executors:
            bad = golden.compare_golden(
                golden.port_record(model, tables[mode], feats, lens, executor=ex), want)
            if bad:
                raise AssertionError(f"{mode} golden mismatch on {ex.__name__} in {bad}")
        log(f"[4] golden {mode}: tables {digest[:16]}, ids/enc_lens/decoder-input/logits "
            f"hashes equal the JAX record on {[ex.__name__ for ex in executors]} "
            f"(enc_lens {want['enc_lens']})")
    return model, tables


def phase_serve(model, dev):
    """4 requests through transcribe in each dyadic mode, with the launch
    counts read around each; returns {mode: counts}."""
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    utts, secs = seeded_requests(7)
    batch, lens = pad_batch(utts)
    try:
        model.freeze("static_e16", dev)
        raise AssertionError("the flagship's static_e16 freeze was expected to raise")
    except ValueError as err:
        if "static_e16 exponent out of range" not in str(err):
            raise
        log(f"[5] QuartzNet static_e16: freeze raises as in the JAX package ({err})")
    all_counts = {}
    for mode in QUARTZNET_MODES:
        tables = model.freeze(mode, dev)
        model.transcribe(utts[:1], device=dev, dyadic_mode=mode)  # builds and caches
        reset_counts()
        texts = model.transcribe(utts, batch_size=4, device=dev, dyadic_mode=mode)
        counts = read_counts()
        expect = planned(kernel_launches(model.plan, tables))
        if counts != expect:
            raise AssertionError(f"QuartzNet {mode} launch counts {counts} != plan {expect}")
        ids_k, el_k = make_frozen_fn(model, tables, argmax=True)(batch, lens)
        ids_p, el_p = make_frozen_fn(model, tables, argmax=True, fused=False)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"{mode}: kernel path ids differ from the plain executor's")
        if texts != model.ids_to_text(ids_p, el_p):
            raise AssertionError(f"{mode}: transcribe() differs from the plain executor's "
                                 f"transcripts")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError("degenerate ids")
        for s_, txt in zip(secs, texts):
            log(f"[5] QuartzNet {mode} {s_:5.1f} s -> {txt[:80]!r}")
        log(f"[5] QuartzNet {mode} (dyadic16={bool(tables.get('dyadic16'))}) served 4 "
            f"requests; launches {counts} == plan; ids == plain executor")
        all_counts[mode] = counts
    return all_counts


def seeded_requests(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    secs = (4.0, 7.3, 11.6, 15.0)
    return [np.clip(rng.normal(size=int(16000 * s)) * 0.1 * 32767, -32768, 32767)
            .astype(np.int16) for s in secs], secs


def pad_batch(utts):
    import numpy as np

    lens = np.asarray([len(u) for u in utts], np.int32)
    batch = np.zeros((len(utts), lens.max()), np.int16)
    for i, u in enumerate(utts):
        batch[i, :len(u)] = u
    return batch, lens


def timed_pair(chk, kind, label, kern, plain, card, rows, library=None):
    """Hold kern() against plain() (exact), then time both (and the
    library call, if any) with CUDA events around each call (median of
    10), and the kernel and the library call in device time (torch.profiler
    over 10 calls)."""
    chk.equal(kind, label, kern(), plain())
    pk = statistics.median(cuda_ms(plain, reps=5) + cuda_ms(plain, reps=5))
    kk = statistics.median(cuda_ms(kern, reps=10))
    kd, kd_by = device_ms(kern, KERNEL_SYMBOLS[kind])
    lib = lib_d = lib_by = None
    if library is not None:
        lib = statistics.median(cuda_ms(library, reps=10))
        lib_d, lib_by = device_ms(library)
    rows.append({"shape": label, "kernel": kind, "call_ms": kk, "device_ms": kd,
                 "device_ms_by": kd_by, "plain_ms": pk, "library_call_ms": lib,
                 "library_device_ms": lib_d, "library_device_ms_by": lib_by})
    log(f"[6] {label}: kernel {kd:.4f} ms device ({kd_by}; {kk:.4f} ms call), plain "
        f"{pk:.4f} ms"
        + (f", library {lib_d:.4f} ms device ({lib_by}; {lib:.4f} ms call)"
           if lib is not None else "")
        + f", equal [{card}]")
    return rows[-1]


def step_times(fns, args, card, tag, batch, seconds, report):
    steps = {}
    for name in list(fns) + list(fns)[::-1]:  # in turns, 2 x 5 each
        steps.setdefault(name, []).extend(cuda_ms(lambda fn=fns[name]: fn(*args), reps=5))
    step = {k: statistics.median(v) for k, v in steps.items()}
    for k in fns:
        log(f"[6] {tag} B={batch} x {seconds:g} s step, {k} path: median {step[k]:.3f} ms "
            f"of {len(steps[k])} ({batch * seconds / step[k] * 1e3:.1f} audio-s/s) [{card}]")
    report[f"{tag.lower()}_step_ms"] = step
    report[f"{tag.lower()}_step_samples_ms"] = steps
    return step


def dw_serving_sites(plan):
    """(C, K, stride, dilation) of every depthwise conv of a QuartzNet plan,
    once each, in walk order."""
    from qasr_tpu_torch.models.jasper import is_depthwise

    sites = []
    for bp in plan.blocks:
        for spec in bp.convs:
            key = (spec.in_ch, spec.kernel, spec.stride, spec.dilation)
            if is_depthwise(spec) and key not in sites:
                sites.append(key)
    return sites


def time_dw_sites(chk, rows, rng, dev, card, sites, batch=64, t_enc=768):
    """Kernel 1 at every depthwise site of the serving path, in the form
    each dyadic mode runs it most: static_e on an int8 input with the
    epilogue (static exponent); per_channel on a pointwise conv's int32
    output through the prologue and the epilogue, per-channel exponents (at
    the stride-2 C1 site the input is the quantized features: int8, the
    epilogue only).  Then the static path's two prologue sites (#8, #9),
    and the epilogue-off function at C=512 K=75 and at C2 beside cuDNN's
    float32 depthwise conv (TF32 off; exact while |acc| < 2^24, which
    torch.equal checks), its yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.models.jasper import get_same_padding

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    def pair(label, x, w, kw, vec_bytes, library=None):
        r = timed_pair(chk, "dw_conv", label, lambda: dw_conv(x, w, **kw),
                       lambda: dw_conv_plain(x, w, **kw), card, rows, library)
        c, k = x.shape[2], w.shape[0]
        out_bytes = (1 if "m" in kw else 4) * batch * t_enc * c
        r["bound"] = bound(x.numel() * x.element_size() + w.numel() + vec_bytes + out_bytes,
                           2 * k * batch * t_enc * c)
        return r

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    for c, k, s_, d in sites:
        conv = dict(stride=s_, padding=get_same_padding(k, s_, d), dilation=d)
        shape = f"B={batch} T={t_enc * s_} C={c} K={k} s={s_} d={d}"
        w = t8(k, c)
        pair(f"dw_conv {shape} int8", t8(batch, t_enc * s_, c), w,
             dict(conv, out_len=full, m=vec(c, 2**29, 2**31 - 1), e=37, bits=7),
             4 * (c + batch))
        m, e = _vector_tables(rng, c, 8, dev)
        kw = dict(conv, out_len=full, m=m, e=e, bits=6)
        if s_ == 1:
            m1, e1 = _vector_tables(rng, c, 16, dev)
            kw.update(in_relu=True, in_len=full, m1=m1, e1=e1, bits1=7)
            pair(f"dw_conv per_channel {shape} int32 in e1[c], e[c] out", t32(batch, t_enc, c), w,
                 kw, 4 * (4 * c + 2 * batch))
        else:
            pair(f"dw_conv per_channel {shape} int8 in, e[c] out", t8(batch, t_enc * s_, c), w,
                 kw, 4 * (2 * c + batch))
    # the static path's prologue sites: a block's first depthwise conv on a
    # block end's raw int32 accumulator (C1 -> B1.1, the #8 form) and on a
    # join's int8 output (the #9 form), each with its consumer epilogue
    for c, k, x32 in [(256, 33, True), (512, 63, False)]:
        kw = dict(padding=get_same_padding(k, 1, 1), in_len=full, m1=vec(c, 2**29, 2**31 - 1),
                  e1=43 if x32 else 29, bits1=7, in_relu=True, out_len=full,
                  m=vec(c, 2**29, 2**31 - 1), e=37, bits=6)
        if x32:
            kw["in_bias"] = vec(c, -2**18, 2**18)
        pair(f"dw_conv prologue B={batch} T={t_enc} C={c} K={k} "
             f"{'int32+bias' if x32 else 'int8'}+relu in, int8 out",
             t32(batch, t_enc, c) if x32 else t8(batch, t_enc, c), t8(k, c), kw,
             4 * (3 * c + 2 * batch))
    # the epilogue-off function beside cuDNN (used nowhere in the port)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for c, k, d in [(512, 75, 1), (512, 87, 2)]:
            pad = get_same_padding(k, 1, d)
            x, w = t8(batch, t_enc, c), t8(k, c)
            xf = x.permute(0, 2, 1).contiguous().float()
            wf = w.t().contiguous().float()[:, None, :]

            def library(xf=xf, wf=wf, c=c, pad=pad, d=d):
                return F.conv1d(xf, wf, groups=c, padding=pad, dilation=d)

            exact = torch.equal(library().round().to(torch.int32).permute(0, 2, 1),
                                dw_conv(x, w, padding=pad, dilation=d))
            r = pair(f"dw_conv B={batch} T={t_enc} C={c} K={k} s=1 d={d} epilogue off (cuDNN "
                     f"{'exact' if exact else 'inexact'})", x, w, dict(padding=pad, dilation=d),
                     0, library if exact else None)
            r["library_exact"] = exact
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def time_requant_sites(chk, rows, rng, dev, card, batch=64, t_enc=768):
    """Kernel 7 at the sites the per_channel path still runs in it: a
    residual branch's input (int8 after a join, int32 after a block end),
    C3's input (int32, ReLU), the residual joins and the decoder's input
    (unmasked)."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant, requant_plain

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    e_pc = torch.from_numpy(rng.integers(36, 44, 1024).astype(np.int32)).to(dev)
    for c, what, x32 in [(256, "input", False), (512, "input", False), (256, "input", True),
                         (512, "input", True), (256, "join", True), (512, "join", True),
                         (1024, "decoder", True)]:
        z = t32(batch, t_enc, c) if x32 else t8(batch, t_enc, c)
        kw = dict(lens=full if what == "input" else None,
                  relu=what == "decoder" or (what == "input" and x32))
        if what == "join":
            kw.update(identity=t32(batch, t_enc, c), m_r=vec(c, 2**29, 2**31 - 1),
                      e_r=e_pc[:c].flip(0).contiguous())
        args = (z, vec(c, 2**29, 2**31 - 1), e_pc[:c].contiguous(), 6)
        r = timed_pair(chk, "requant", f"requant N={batch * t_enc} C={c} "
                       f"{'int32' if x32 else 'int8'} per-channel {what}",
                       lambda a=args, kw=kw: requant(*a, **kw),
                       lambda a=args, kw=kw: requant_plain(*a, **kw), card, rows)
        r["bound"] = bound(z.numel() * (z.element_size() + 1 + 4 * (what == "join"))
                           + 4 * c * (2 + 2 * (what == "join"))
                           + (4 * batch if what == "input" else 0), 0)


def phase_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    batch, seconds = 64, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(size=(batch, n)).astype(np.float32) * 0.1).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    st, pc = tables["static_e"], tables["per_channel"]
    fns = {"kernel": make_frozen_fn(model, st, argmax=True),
           "kernel_per_channel": make_frozen_fn(model, pc, argmax=True),
           "plain": make_frozen_fn(model, st, argmax=True, fused=False),
           "plain_per_channel": make_frozen_fn(model, pc, argmax=True, fused=False)}
    step = step_times(fns, (audio, lens), card, "QuartzNet", batch, seconds, report)

    # each kernel against its plain version at the main path's shapes
    t_enc = 768  # 15 s -> 1501 frames -> padded 1536 -> stride 2
    rows = []

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    time_dw_sites(chk, rows, rng, dev, card, dw_serving_sites(model.plan), batch, t_enc)
    for cin, cout, mode in [(64, 256, "requant"), (256, 256, "requant"), (512, 512, "requant"),
                            (512, 512, "join"), (512, 1024, "none"), (1024, 29, "none")]:
        x = t8(batch, t_enc, cin)
        wt = t8(cout, cin)
        kw = dict(bias=vec(cout, -3000, 3000))
        if mode != "none":
            kw.update(m=vec(cout, 2**29, 2**31 - 1), e=37, bits=6)
        if mode == "requant":
            kw.update(relu=True, lens=full)
        if mode == "join":
            kw.update(res=torch.from_numpy(rng.integers(-2**20, 2**20, (batch, t_enc, cout))
                                           .astype(np.int32)).to(dev),
                      m_r=vec(cout, 2**29, 2**31 - 1), e_r=40)
        x2, wt_t = x.reshape(-1, cin), wt.t()
        lib = (lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t)) if cout % 8 == 0 else None
        r = timed_pair(chk, "pw_gemm", f"pw_gemm N={batch * t_enc} {cin}->{cout} {mode}",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows, lib)
        out_bytes = (4 if mode == "none" else 1) * batch * t_enc * cout
        res_bytes = 4 * batch * t_enc * cout if mode == "join" else 0
        vec_bytes = 4 * cout * (1 + (mode != "none") + (mode == "join")) \
            + (4 * batch if mode == "requant" else 0)
        r["bound"] = bound(x.numel() + wt.numel() + vec_bytes + out_bytes + res_bytes,
                           2 * batch * t_enc * cin * cout)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    # the prologue sites of Kernel 2: a residual pointwise conv on a join's
    # int8 output, C3 and the decoder on a raw int32 accumulator (the
    # decoder's input is not masked)
    for cin, cout, x32, mask in [(256, 256, False, True), (512, 1024, True, True),
                                 (1024, 29, True, False)]:
        x = t32(batch, t_enc, cin) if x32 else t8(batch, t_enc, cin)
        wt = t8(cout, cin)
        kw = dict(bias=vec(cout, -3000, 3000), m1=vec(cin, 2**29, 2**31 - 1),
                  e1=43 if x32 else 29, bits1=7 if mask else 6, in_relu=True,
                  in_len=full if mask else None)
        if x32:
            kw["in_bias"] = vec(cin, -2**18, 2**18)
        x8 = t8(batch * t_enc, cin)
        wt_t = wt.t()
        lib = (lambda x8=x8, wt_t=wt_t: torch._int_mm(x8, wt_t)) if cout % 8 == 0 else None
        r = timed_pair(chk, "pw_gemm", f"pw_gemm prologue N={batch * t_enc} {cin}->{cout} "
                       f"{'int32+bias' if x32 else 'int8'}+relu in, none",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows, lib)
        r["bound"] = bound(x.numel() * x.element_size() + wt.numel() + 4 * (3 * cin + cout)
                           + (4 * batch if mask else 0) + 4 * batch * t_enc * cout,
                           2 * batch * t_enc * cin * cout)
    time_requant_sites(chk, rows, rng, dev, card, batch, t_enc)
    report["quartznet_per_kernel"] = rows
    return step, rows


# ---------------------------------------------------------------------------
# the Conformer-CTC path
# ---------------------------------------------------------------------------


def phase_int_fns(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import int_fn_device, ln_core_device
    from qasr_tpu_torch.ops import integer_layernorm as iln
    from qasr_tpu_torch.ops import integer_sigmoid as isg
    from qasr_tpu_torch.ops import integer_softmax as ism

    q = torch.arange(-ism.N_IN, 1, dtype=torch.int32, device=dev)
    chk.equal("conformer_int", "i_exp on [-N_IN, 0]", int_fn_device("i_exp", q), ism.i_exp(q))
    chk.equal("conformer_int", "i_exp >> 4 from the quadratic's table on [-N_IN, 0]",
              int_fn_device("i_exp_tab", q), ism.i_exp(q) >> 4)
    q = torch.arange(-ism.N_IN - 64, ism.N_IN + 65, dtype=torch.int32, device=dev)
    chk.equal("conformer_int", "i_sigmoid_grid on [-N_IN-64, N_IN+64]",
              int_fn_device("i_sigmoid_grid", q), isg.i_sigmoid_grid(q))
    # Kernel 4's GLU gate: the table lookup, over the whole domain and the
    # requant's extremes
    from qasr_tpu_torch.kernels.conv_block import sigmoid_table

    qx = torch.cat([q, torch.tensor([-(1 << 26), -(1 << 26) + 1, (1 << 26) - 1, 1 << 26],
                                    dtype=torch.int32, device=dev)])
    chk.equal("conformer_int", "i_sigmoid_tab on [-N_IN-64, N_IN+64] and +-2^26",
              int_fn_device("i_sigmoid_tab", qx, sigmoid_table(dev)), isg.i_sigmoid_grid(qx))
    # Kernel 3's division by the row sum: every divisor in [1, 2^20] against
    # a grid of numerators, then random pairs up to the numerator bound 2^31
    dd = torch.arange(1, (1 << 20) + 1, dtype=torch.int64, device=dev)
    top = (1 << 31) - 1
    mult = top - top % dd
    n_div = 0
    for num in (torch.zeros_like(dd), torch.ones_like(dd), dd - 1, dd, dd + 1, 2 * dd - 1,
                mult, mult - 1, torch.full_like(dd, top), 116_970 * 127 + dd // 2):
        chk.equal("conformer_int", "div over den in [1, 2^20]",
                  int_fn_device("div", num.to(torch.int32), dd.to(torch.int32)),
                  torch.div(num, dd, rounding_mode="floor").to(torch.int32))
        n_div += dd.numel()
    drng = np.random.default_rng(4)
    for dmax in (300_000_000, top):
        num = torch.from_numpy(drng.integers(0, 1 << 31, 1 << 20)).to(dev)
        den = torch.from_numpy(drng.integers(1, dmax + 1, 1 << 20)).to(dev)
        chk.equal("conformer_int", f"div on random pairs, den up to {dmax}",
                  int_fn_device("div", num.to(torch.int32), den.to(torch.int32)),
                  torch.div(num, den, rounding_mode="floor").to(torch.int32))
        n_div += num.numel()
    v = torch.arange(0, 2**16 + 1, dtype=torch.int32, device=dev) << 12
    chk.equal("conformer_int", "isqrt on var << 12, var in [0, 2^16]",
              int_fn_device("isqrt", v), iln.i_sqrt(v))
    v = torch.cat([v, torch.arange(0, 1 << 22, dtype=torch.int32, device=dev),
                   torch.randint(0, 1 << 30, (1 << 20,), dtype=torch.int32, device=dev)])
    chk.equal("conformer_int", "isqrt_f on var << 12, [0, 2^22) and random n < 2^30",
              int_fn_device("isqrt_f", v), iln.i_sqrt(v))
    rng = np.random.default_rng(3)
    n = np.arange(-70_000, 70_001, dtype=np.int32)
    a = np.concatenate([n, n, n, rng.integers(-2**30, 2**30, 1 << 20)]).astype(np.int32)
    b = np.concatenate([np.full(n.size, ism.Q_LN2), np.full(n.size, 568), np.full(n.size, 7),
                        rng.integers(1, 2**20, 1 << 20) * rng.choice([-1, 1], 1 << 20)])
    at, bt = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (a, b))
    chk.equal("conformer_int", "floor_div on signed grids", int_fn_device("floor_div", at, bt),
              torch.div(at, bt, rounding_mode="floor"))
    for d in (64, 256, 512):
        x = rng.integers(-128, 128, (4096, d)).astype(np.int8)
        x[0], x[1], x[2, : d // 2] = 0, -3, 5
        xt = torch.from_numpy(x).to(dev)
        want = iln.i_layernorm_core(xt)
        chk.equal("conformer_int", f"i-LN row core d={d}", ln_core_device(xt), want)
        chk.equal("conformer_int", f"i-LN row core, divide form, d={d}",
                  ln_core_device(xt, div=True), want)
    log(f"[3] Conformer integer device functions == plain over their domains "
        f"(i_exp {ism.N_IN + 1}, i_sigmoid_grid {2 * ism.N_IN + 129}, i_sigmoid_tab "
        f"{qx.numel()}, i_exp from its table {ism.N_IN + 1}, div {n_div}, isqrt 65537, "
        f"isqrt_f {v.numel()}, floor_div {a.size}, i-LN 3 x 4096 rows in both forms)")


def small_conformer(dev, d_model):
    """A one-layer Conformer table built without jax: seed-0 weights,
    seeded ranges (the conv_block check at widths other than 256)."""
    import numpy as np

    from qasr_tpu_torch.golden import conformer_flagship_configs
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
    from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig, init_conformer_qstate

    cfg, ccfg = conformer_flagship_configs(layers=1, d_model=d_model)
    m = ConformerCTC.from_config(cfg, ccfg, seed=0)
    m.enc_qcfg = ConformerQuantConfig(quantize_attention=True, integer_softmax=True,
                                      integer_layernorm=True, integer_activations=True,
                                      static_attention=True)
    qs = init_conformer_qstate(ccfg, m.enc_qcfg)
    qs["dec_in"] = {"x_min": np.float32(0), "x_max": np.float32(0)}
    rng = np.random.default_rng(11)
    for site in [qs["pre_out"], qs["dec_in"]] + [x for layer in qs["layers"]
                                                 for x in layer.values()]:
        site["x_min"], site["x_max"] = np.float32(-rng.uniform(0.5, 8)), np.float32(rng.uniform(0.5, 8))
    m.enc_qstate = qs
    return m.freeze(dev)["encoder"]["layers"][0]


def phase_int_attention(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain

    tbl = tables["encoder"]["layers"][0]
    rng = np.random.default_rng(5)
    h, d_k, n = 4, 64, 0
    for t in ATT_T:
        b = 4 if t >= 375 else 3
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.from_numpy(np.concatenate([[t], rng.integers(1, t + 1, b - 1)])
                                .astype(np.int32)).to(dev)
        for left, right in ATT_CTX:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention B={b} T={t} ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    t, b = 129, 2
    for d_k in ATT_DK:
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, 77], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention d_k={d_k} T={t} ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    # the streaming form (no score rows in shared memory): long inputs
    from qasr_tpu_torch.kernels.int_attention import resident

    for t in ATT_T_LONG:
        b = 2
        if resident(t, d_k):
            raise AssertionError(f"T={t} was meant to take the streaming form")
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, int(rng.integers(1, t))], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention streaming B={b} T={t} "
                      f"ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    # score requants outside qasr_rq_f64's domain take qasr_rq, both forms
    for t in (129, ATT_T_LONG[0]):
        qu, qv, k, v = (torch.from_numpy(rng.integers(-128, 128, (2, t, h, 64)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-128, 128, (2 * t - 1, h, 64)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, t // 2], dtype=torch.int32, device=dev)
        kw = dict(ac=(2**30 + 5, 22), bd=(2**29 + 3, 21), ctx_rq=tbl["ctx_rq"], left=-1,
                  right=-1, nbits=8)
        chk.equal("int_attention", f"int_attention T={t} with score requants on qasr_rq",
                  int_attention(qu, qv, k, v, p, lens, **kw),
                  int_attention_plain(qu, qv, k, v, p, lens, **kw))
        n += 1
    # lengths past T count as T (the plain version's arange(T) < lens), both
    # forms, with T off the 64-key chunk so the padded keys [T, Tp) exist
    for t in (37, 375, ATT_T_LONG[0]):
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (2, t, h, 64)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, 64)).astype(np.int8)).to(dev)
        lens = torch.tensor([t + 1, t + 100], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention T={t} lens={lens.tolist()} "
                      f"ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    log(f"[3] int_attention == plain at {n} (T, d_k, context, requant) cases, ragged "
        f"lengths and lengths past T, T in {ATT_T_LONG} on the streaming form")


def phase_conv_block(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import _packed, conv_block, conv_block_plain

    rng = np.random.default_rng(6)
    layers = {64: small_conformer(dev, 64), 256: tables["encoder"]["layers"][3],
              512: small_conformer(dev, 512)}
    for d in CONV_D:
        for t in CONV_T:
            b = (32 if d == 256 else 4) if t == 375 else 3
            c8, x8 = (torch.from_numpy(rng.integers(-127, 127, (b, t, d)).astype(np.int8)).to(dev)
                      for _ in range(2))
            lens = torch.from_numpy(np.concatenate([[t], rng.integers(1, t + 1, b - 1)])
                                    .astype(np.int32)).to(dev)
            want = conv_block_plain(c8, x8, lens, layers[d], (15, 15), nbits=8)
            chk.equal("conv_block", f"conv_block d={d} B={b} T={t}",
                      conv_block(c8, x8, lens, layers[d], (15, 15), nbits=8), want)
            if d == 256 and t == 375:
                # the same layer with every requant on qasr_rq (the form for
                # tables outside qasr_rq_f64's domain)
                rq_only = dict(layers[d], _conv_block={**_packed(layers[d]), "f64": False})
                chk.equal("conv_block", f"conv_block d={d} B={b} T={t}, requants on qasr_rq",
                          conv_block(c8, x8, lens, rq_only, (15, 15), nbits=8), want)
    log(f"[3] conv_block == plain at d in {CONV_D} x T in {CONV_T}, ragged lengths, and "
        f"with every requant on qasr_rq at d=256 T=375")


def _lin_sites(tables):
    """The Conformer path's Kernel 5 sites on the flagship's layer 0:
    (label, mode, site, epilogue kwargs, K)."""
    from qasr_tpu_torch.quantize.conformer_freeze import _pos_tables

    enc = tables["encoder"]
    tbl = enc["layers"][0]
    pos = _pos_tables(enc, 375)[1][0]
    sites = [("q_u", "rq", tbl["att_q_u"], {}), ("pre", "rq", enc["pre"], {}),
             ("pos", "rq", pos, {}),
             ("ff1 l1", "swish", tbl["ff1_l1"], dict(swish=(tbl["ff1_grid"], tbl["ff1_prod"]))),
             ("ff1 l2", "join", tbl["ff1_l2"], dict(stream_rq=tbl["j1_stream"]))]
    return [(f"{name} {s['wt'].shape[1]}->{s['wt'].shape[0]}" + ("" if "b" in s else " no bias"),
             mode, s, kw) for name, mode, s, kw in sites]


def phase_lin_epilogue(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain

    rng = np.random.default_rng(9)
    sites = _lin_sites(tables)
    # seeded sites with exponents above 31 in every requant of each mode
    for mode, (k, d) in (("rq", (256, 256)), ("swish", (256, 1024)), ("join", (1024, 256))):
        site = {"wt": torch.from_numpy(rng.integers(-127, 127, (d, k)).astype(np.int8)).to(dev),
                "b": torch.from_numpy(rng.integers(-2**15, 2**15, d).astype(np.int32)).to(dev),
                "m": torch.from_numpy(rng.integers(2**29, 2**31 - 1, d).astype(np.int32)).to(dev),
                "e": 37}
        kw = {"rq": {}, "swish": dict(swish=((2**30 + 7, 36), (1234567, 40))),
              "join": dict(stream_rq=(2**31 - 1, 33))}[mode]
        sites.append((f"seeded {k}->{d} e>31", mode, site, kw))
    n_cases = 0
    for label, mode, site, kw in sites:
        d, k = site["wt"].shape
        for bias in (True, False):
            s_ = site if bias else {n: v for n, v in site.items() if n != "b"}
            for n in LIN_N:
                x = torch.from_numpy(rng.integers(-127, 127, (n, k)).astype(np.int8)).to(dev)
                args = dict(kw, nbits=8)
                if mode == "join":
                    args["stream8"] = torch.from_numpy(
                        rng.integers(-127, 127, (n, d)).astype(np.int8)).to(dev)
                chk.equal("lin_epilogue", f"lin_epilogue {label} {mode} bias={bias} N={n}",
                          lin_epilogue(x, s_, **args), lin_epilogue_plain(x, s_, **args))
                n_cases += 1
    log(f"[3] lin_epilogue == plain at {n_cases} cases: every path (K, D) in rq / swish / "
        f"join, with and without bias, N in {LIN_N}, and seeded e > 31")


def out_of_f64(site):
    """A copy of a requant site pushed out of qasr_rq_f64's domain: its
    mantissas rescaled to e = 20 (about the same function) and column 0's
    made 2^30, so that some |z| m reaches 2^(e + 26) and the kernel has to
    requant the site with qasr_rq (saturating column 0)."""
    e = int(site["e"])
    if e < 20:
        raise AssertionError(f"out_of_f64 needs e >= 20, got {e}")
    m = (site["m"] >> (e - 20)).clone()
    m[0] = 2 ** 30
    return {**{k: v for k, v in site.items() if not k.startswith("_")}, "m": m, "e": 20}


def ffn_forms(layers):
    """Kernel 6's three forms on the Conformer path: (label, layer table,
    half, stream requant, tail): FFN1 with the ln_att tail, FFN2 with the
    ln_out tail (the next layer's stream), the last layer's FFN2 without."""
    first, last = layers[0], layers[-1]
    return [("ff1 + ln_att", first, "ff1", "j1_stream", first["ln_att"]),
            ("ff2 + ln_out", first, "ff2", "j4_stream", first["ln_out"]),
            ("ff2 no tail", last, "ff2", "j4_stream", None)]


def phase_ffn_ln(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.ffn_ln import _packed, ffn_ln, ffn_ln_plain

    rng = np.random.default_rng(10)
    layers = {64: small_conformer(dev, 64), 256: tables["encoder"]["layers"][0],
              512: small_conformer(dev, 512)}
    n = 0
    for d in FFN_D:
        tbl = layers[d]
        sites = {"ln": tbl["ln_ff1"], "l1": tbl["ff1_l1"], "l2": tbl["ff1_l2"],
                 "tail": tbl["ln_att"]}
        # the layer as it is (the flagship's sites all on the FP64 pipe);
        # then all four sites, and l1 alone, pushed onto qasr_rq
        variants = [("as frozen", sites),
                    ("qasr_rq", {k: out_of_f64(v) for k, v in sites.items()}),
                    ("l1 on qasr_rq", {**sites, "l1": out_of_f64(sites["l1"])})]
        for label, st in variants:
            on_f64 = {k: _packed(v)["mf"] is not None for k, v in st.items()}
            if any(on_f64[k] for k, v in st.items() if v is not sites[k]) or \
                    (d == 256 and label == "as frozen" and not all(on_f64.values())):
                raise AssertionError(f"d={d} {label}: the host's requant choice {on_f64}")
            if label == "as frozen":
                log(f"[3] ffn_ln d={d}: sites on the FP64 pipe {on_f64}")
            for t in FFN_T:
                if label != "as frozen" and t != FFN_T[-1]:
                    continue
                b = (32 if d == 256 else 4) if t == 375 else 3
                x = torch.from_numpy(rng.integers(-127, 127, (b, t, d)).astype(np.int8)).to(dev)
                for tail in (st["tail"], None):
                    args = (x, st["ln"], st["l1"], tbl["ff1_grid"], tbl["ff1_prod"], st["l2"],
                            tbl["j1_stream"], tail)
                    (got, got_t), (want, want_t) = (ffn_ln(*args, nbits=8),
                                                    ffn_ln_plain(*args, nbits=8))
                    what = f"ffn_ln d={d} B={b} T={t} tail={tail is not None} {label}"
                    chk.equal("ffn_ln", what, got, want)
                    if tail is not None:
                        chk.equal("ffn_ln", what + " (tail)", got_t, want_t)
                    elif got_t is not None:
                        raise AssertionError(f"{what}: a tail without a tail table")
                    n += 1
    log(f"[3] ffn_ln == plain at {n} cases: d in {FFN_D} x T in {FFN_T} (N ragged against "
        f"32-row tiles), tail on and off, the layers as frozen; at "
        f"T={FFN_T[-1]} also every site, and l1 alone, pushed onto qasr_rq")


def conformer_plans():
    from qasr_tpu_torch.quantize.conformer_freeze import DEFAULT_PLAN, ConformerPlan

    return DEFAULT_PLAN, ConformerPlan("conv", True), ConformerPlan("conv", False)


def phase_conformer_golden(dev):
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.conformer_freeze import conformer_tables_digest

    model = golden.conformer16x256_w8a8()
    tables = model.freeze(dev)
    plans = conformer_plans()
    runs = [(True, plan) for plan in plans] + [(False, plans[0])]
    for kernels, plan in runs:
        res = golden.check_conformer_golden(model, tables, kernels=kernels, plan=plan)
        if res["bad"]:
            raise AssertionError(f"Conformer golden mismatch ({plan if kernels else 'plain'} "
                                 f"path) in {res['bad']}: {res}")
    log(f"[4] Conformer golden: tables {conformer_tables_digest(tables['encoder'])[:16]}; x8 "
        f"{res['x8_flips']} of {res['x8_size']} codes flipped (max |d| {res['x8_max_diff']}, "
        f"limit 0.1% at 1); from the golden x8 the encodings' hash, ids and enc_lens "
        f"{res['enc_lens']} equal the JAX record under the plans "
        f"{[(p.mod, p.fused) for p in plans]} and on the plain path, log-probs "
        f"within {res['log_prob_max_err']:.2e}")
    return model, tables, res


def phase_conformer_serve(model, tables, dev):
    import torch

    from qasr_tpu_torch.decode.ctc import ctc_collapse
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches

    utts, secs = seeded_requests(8)
    batch, lens = pad_batch(utts)
    ids_p, el_p = make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)(batch, lens)
    plain_texts = ctc_collapse(ids_p.cpu().numpy(), model.blank_id, model.vocabulary,
                               el_p.cpu().numpy())
    default, conv_fused, _ = conformer_plans()
    main_counts = None
    for plan in (default, conv_fused):
        model.transcribe_greedy(batch[:1, :len(utts[0])], lens[:1], device=dev,
                                plan=plan)  # build + cache
        reset_counts()
        texts = model.transcribe_greedy(batch, lens, device=dev, plan=plan)
        counts = read_counts()
        expect = planned(kernel_launches(model.ccfg, plan))
        if counts != expect:
            raise AssertionError(f"Conformer launch counts under {plan}: {counts} != {expect}")
        main_counts = main_counts or counts
        ids_k, el_k = make_conformer_frozen_fn(model, tables, argmax=True, plan=plan)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"Conformer ids under {plan} differ from the plain executor's")
        if texts != plain_texts:
            raise AssertionError(f"transcribe_greedy under {plan} differs from the plain "
                                 f"executor's transcripts")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError("degenerate Conformer ids")
        log(f"[5] Conformer served 4 requests under ({plan.mod!r}, {plan.fused}) (enc_lens "
            f"{el_k.tolist()}); launches {counts} == plan; ids == plain executor")
    for s_, txt in zip(secs, plain_texts):
        log(f"[5] Conformer {s_:5.1f} s -> {txt[:100]!r}")
    return main_counts


def phase_conformer_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain
    from qasr_tpu_torch.kernels.ffn_ln import ffn_ln, ffn_ln_plain
    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn

    batch, seconds = 32, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.normal(size=(batch, n)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    default, _, conv_only = conformer_plans()
    fns = {"kernel": make_conformer_frozen_fn(model, tables, argmax=True, plan=default),
           "kernel_conv_only": make_conformer_frozen_fn(model, tables, argmax=True,
                                                        plan=conv_only),
           "plain": make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)}
    step = step_times(fns, (audio, lens), card, "Conformer", batch, seconds, report)

    # each kernel at the serving shapes (15 s -> T = 375, 374 valid frames)
    t = valid = 1 + n // 160                           # frames, then padded to 16
    t = -(-t // 16) * 16
    for _ in range(2):                                  # two stride-2 k=3 convs
        t, valid = (t - 3) // 2 + 1, (valid - 3) // 2 + 1
    h, d = model.ccfg.n_heads, model.ccfg.d_model
    d_k = d // h
    tbl = tables["encoder"]["layers"][0]
    full = torch.full((batch,), valid, dtype=torch.int32, device=dev)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    rows = []
    qu, qv, k, v = (t8(batch, t, h, d_k) for _ in range(4))
    p = t8(2 * t - 1, h, d_k)
    kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=-1, right=-1,
              nbits=8)
    r = timed_pair(chk, "int_attention", f"int_attention B={batch} T={t} h={h} d_k={d_k}",
                   lambda: int_attention(qu, qv, k, v, p, full, **kw),
                   lambda: int_attention_plain(qu, qv, k, v, p, full, **kw), card, rows)
    # q/k/v/pos in, context out; ac, the bd diagonal and a8.v as int8 products
    r["bound"] = bound(4 * qu.numel() + p.numel() + 4 * batch + batch * t * d,
                       3 * 2 * batch * h * t * t * d_k)
    # the streaming form at a 60 s input (T = 1500 after subsampling), B=4
    tl, bl = 1500, 4
    qul, qvl, kl, vl = (t8(bl, tl, h, d_k) for _ in range(4))
    pl_ = t8(2 * tl - 1, h, d_k)
    fl = torch.full((bl,), tl, dtype=torch.int32, device=dev)
    r = timed_pair(chk, "int_attention", f"int_attention streaming B={bl} T={tl} h={h} d_k={d_k}",
                   lambda: int_attention(qul, qvl, kl, vl, pl_, fl, **kw),
                   lambda: int_attention_plain(qul, qvl, kl, vl, pl_, fl, **kw), card, rows)
    r["bound"] = bound(4 * qul.numel() + pl_.numel() + 4 * bl + bl * tl * d,
                       3 * 2 * bl * h * tl * tl * d_k)
    c8, x8 = t8(batch, t, d), t8(batch, t, d)
    k_size = tbl["dw_w"].shape[0]
    pad = model.ccfg.dw_padding
    r = timed_pair(chk, "conv_block", f"conv_block B={batch} T={t} d={d} K={k_size}",
                   lambda: conv_block(c8, x8, full, tbl, pad, nbits=8),
                   lambda: conv_block_plain(c8, x8, full, tbl, pad, nbits=8), card, rows)
    weights = 4 * d * d + k_size * d + 14 * 4 * d + 16 * 4
    r["bound"] = bound(3 * batch * t * d + weights + 4 * batch,
                       2 * batch * t * d * (4 * d + k_size))
    # Kernel 5 at each of its path's sites (the pos projection has 2T-1 rows)
    for label, mode, site, kw in _lin_sites(tables):
        dout, kin = site["wt"].shape
        rows_ = 2 * t - 1 if label.startswith("pos") else batch * t
        x = t8(rows_, kin)
        args = dict(kw, nbits=8)
        if mode == "join":
            args["stream8"] = t8(rows_, dout)
        wt_t = site["wt"].t()
        r = timed_pair(chk, "lin_epilogue", f"lin_epilogue N={rows_} {label} {mode}",
                       lambda x=x, s_=site, a=args: lin_epilogue(x, s_, **a),
                       lambda x=x, s_=site, a=args: lin_epilogue_plain(x, s_, **a), card, rows,
                       lambda x=x, w=wt_t: torch._int_mm(x, w))
        vec_bytes = 4 * dout * (1 + ("b" in site))
        r["bound"] = bound(x.numel() + site["wt"].numel() + vec_bytes
                           + rows_ * dout * (1 + (mode == "join")), 2 * rows_ * kin * dout)
    # Kernel 6 in its three forms; the first is the kernels line's
    layers = tables["encoder"]["layers"]
    for form, lt, half, stream, tail in ffn_forms(layers):
        f = lt[f"{half}_l1"]["wt"].shape[0]
        args = (x8, lt[f"ln_{half}"], lt[f"{half}_l1"], lt[f"{half}_grid"], lt[f"{half}_prod"],
                lt[f"{half}_l2"], lt[stream], tail)
        pick = 0 if tail is None else 1
        r = timed_pair(chk, "ffn_ln", f"ffn_ln B={batch} T={t} d={d} f={f} {form}",
                       lambda a=args, i=pick: ffn_ln(*a, nbits=8)[i],
                       lambda a=args, i=pick: ffn_ln_plain(*a, nbits=8)[i], card, rows)
        if tail is not None:
            chk.equal("ffn_ln", f"ffn_ln {form} at the serving shape (joined stream)",
                      ffn_ln(*args, nbits=8)[0], ffn_ln_plain(*args, nbits=8)[0])
        # x in, stream (and tail) out; both weights; the (3, d) / (2, f) / (2, d) rows
        outs = 1 if tail is None else 2
        r["bound"] = bound((1 + outs) * batch * t * d + 2 * d * f
                           + 4 * (3 * d + 2 * f + 2 * d + (0 if tail is None else 3 * d)),
                           2 * 2 * batch * t * d * f)
    report["conformer_per_kernel"] = rows
    return step, rows


# ---------------------------------------------------------------------------
# phase 7: the zero-shot workflow (synthesis, calibration, dynamic, CLIs)
# ---------------------------------------------------------------------------

# card vs CPU, the first 3 losses from one start point (~3 float32 ulps at
# their 4.2e7)
SYNTH_RTOL = 3e-7
# card vs CPU, distill_loss's input gradient at the recipe's shape (norm-wise);
# the same backward with TF32 on must read above it
GRAD_RTOL = 2e-5
# noise ranges vs the committed ones (the JAX package's seed-0 recipe): of
# each site's range (above what the port reads from features perturbed at
# the committed ranges' own first-site offset, below what another noise
# seed or percentile 99.9 reads), and at the first site, which sees the
# features alone
NOISE_RANGE_TOL = 0.15
FIRST_SITE_TOL = 1e-4
FRONT_PERTURBATION = 1e-5
PERTURBATION_SEEDS = (1, 2, 3)


def qstate_sites(qstate, path=""):
    """[(site, x_min, x_max)] of every activation site, in one fixed order."""
    if isinstance(qstate, dict) and "x_min" in qstate:
        return [(path, float(qstate["x_min"]), float(qstate["x_max"]))]
    if isinstance(qstate, dict):
        return [s for k in sorted(qstate) for s in qstate_sites(qstate[k], f"{path}.{k}")]
    return [s for i, q in enumerate(qstate) for s in qstate_sites(q, f"{path}[{i}]")]


def table_entries_differing(a, b) -> int:
    """Elements (array entries, or static scalars) that differ between two
    host table trees of the same structure."""
    import numpy as np

    if isinstance(a, dict):
        return sum(table_entries_differing(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(table_entries_differing(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return int(np.sum(a != b)) if a.shape == b.shape else int(max(a.size, b.size))
    return int(a != b)


def write_manifest(root, rng, sr=16000):
    """4 seeded wavs (tone + noise) and their JSON-lines manifest."""
    import numpy as np

    from qasr_tpu_torch.data.audio import write_wav

    texts = ("hello world", "the quick brown fox", "zero shot quantization",
             "integer only speech recognition")
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        for i, text in enumerate(texts):
            n = int(sr * (1.5 + 0.5 * i))
            t = np.arange(n) / sr
            x = (0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t)
                 + 0.05 * rng.normal(size=n)).astype(np.float32)
            wav = os.path.join(root, f"utt{i}.wav")
            write_wav(wav, x, sr)
            f.write(json.dumps({"audio_filepath": wav, "duration": n / sr, "text": text}) + "\n")
    return path


def phase_workflow(chk, dev, card, report, name="QuartzNet15x5Base-En"):
    import math
    import tempfile

    import numpy as np
    import torch

    from qasr_tpu_torch.cli import inference as cli_inference
    from qasr_tpu_torch.cli import synthesize as cli_synthesize
    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.ranges import qstate_to_device
    from qasr_tpu_torch.quantize.freeze import kernel_launches
    from qasr_tpu_torch.quantize.synth import get_synthetic_data, start_points

    out = report.setdefault("workflow", {})
    model = ASRModel.from_pretrained(name, allow_random_weights=True)
    per_fwd = kernel_launches(model.plan)
    dim = model.plan.feat_in

    # (a) synthesis at the reference recipe's shapes, 2 problems
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, losses = get_synthetic_data(model.plan, model.params["encoder"], batch_size=8,
                                      dim=dim, seqlen=500, train_iter=200, num_batch=2,
                                      lr=0.01, seed=0, device=dev, verbose=False,
                                      return_losses=True)
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / 400
    for i, ls in enumerate(losses):
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"synthesis problem {i}: losses {ls[0]} -> {ls[-1]} "
                                 f"(finite={all(math.isfinite(v) for v in ls)})")
    x0 = start_points(1, 2, 200, dim, seed=1)
    kw = dict(batch_size=2, dim=dim, seqlen=200, train_iter=3, lr=0.01, x0=x0, verbose=False,
              return_losses=True)
    l_card = get_synthetic_data(model.plan, model.params["encoder"], device=dev, **kw)[1][0]
    l_cpu = get_synthetic_data(model.plan, model.params["encoder"], device="cpu", **kw)[1][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if rel > SYNTH_RTOL:
        raise AssertionError(f"synthesis losses card {l_card} vs CPU {l_cpu}: rel {rel}")
    log(f"[7a] synthesis 2 x (8 x 500 x {dim}), 200 iterations: losses {losses[0][0]:.2f} -> "
        f"{losses[0][-1]:.2f}, {losses[1][0]:.2f} -> {losses[1][-1]:.2f}, all finite; "
        f"{s_iter * 1e3:.2f} ms an iteration [{card}]; first 3 losses at 2 x 200 card "
        f"{l_card} vs CPU {l_cpu}, max rel {rel:.2e} <= {SYNTH_RTOL}")
    t0 = time.perf_counter()
    g_rel, g_rel_tf32 = synthesis_grad_rel(model.plan, model.params["encoder"], dev, dim)
    if g_rel > GRAD_RTOL or not g_rel_tf32 > GRAD_RTOL:
        raise AssertionError(f"distill_loss gradient card vs CPU: rel {g_rel:.3e} (TF32 on: "
                             f"{g_rel_tf32:.3e}), tolerance {GRAD_RTOL:g}")
    log(f"[7a] distill_loss gradient at 8 x 500 x {dim}, card vs CPU: norm-wise rel "
        f"{g_rel:.3e} <= {GRAD_RTOL:g}; the backward with TF32 on reads {g_rel_tf32:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    out.update(synth_ms_per_iter=s_iter * 1e3, synth_losses=[[ls[0], ls[-1]] for ls in losses],
               synth_cpu_rel=rel, synth_grad_rel=g_rel, synth_grad_rel_tf32=g_rel_tf32)

    # (b) calibration on the synthetic batches, kernels against plain
    model.set_quant_bit(6, "all")
    model.bn_folding()
    for pct in (None, 99.9):
        model.set_percentile(pct)
        model.qstate = init_qstate(model.plan)
        reset_counts()
        model.calibrate(data, device=dev)
        counts = read_counts()
        expect = planned({k: 2 * v for k, v in per_fwd.items()})
        if counts != expect:
            raise AssertionError(f"calibration launches {counts} != {expect} (2 forwards)")
        q_kernel = model.qstate
        model.qstate = init_qstate(model.plan)
        model.calibrate(data, device=dev, kernels=False)
        a, b = qstate_sites(q_kernel), qstate_sites(model.qstate)
        bad = sum(x != y for x, y in zip(a, b))
        if bad or len(a) != len(b):
            raise AssertionError(f"calibration (percentile {pct}): {bad} of {len(a)} sites' "
                                 f"ranges differ from the plain QuantExec's")
        log(f"[7b] calibrate on 2 synthetic batches, percentile {pct}: the {len(a)} sites' "
            f"ranges equal the plain QuantExec's bit for bit; launches {counts} (a forward: "
            f"{per_fwd})")
    feats = data[0]
    lens = torch.full((8,), 500, dtype=torch.int32, device=dev)
    qs = qstate_to_device(model.qstate, dev)
    calib = {}
    for pct in (None, 99.9):
        model.set_percentile(pct)
        # the plain path once (it ran in the comparison above), the kernels' median of 3
        for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
            calib[f"{path} percentile={pct}"] = statistics.median(cuda_ms(
                lambda kern=kern: model.encode_decode_quant(feats, lens, qs, update_ranges=True,
                                                            kernels=kern), reps=reps, warmup=0))
    log(f"[7b] calibrating forward B=8 x 500 frames, ms (kernels: median of 3; plain: one call): "
        f"{ {k: round(v, 3) for k, v in calib.items()} } [{card}]")
    out["calibrate_forward_ms"] = calib

    time_workflow_sites(chk, report.setdefault("workflow_per_kernel", []), dev, card)

    # (d) the dynamic forward, kernels against plain
    model.set_percentile(None)
    model.set_dynamic(True)
    utts, _ = seeded_requests(7)
    batch, blens = pad_batch(utts)
    reset_counts()
    _, el_k, ids_k = model.forward(batch, blens, device=dev)
    counts = read_counts()
    _, el_p, ids_p = model.forward(batch, blens, device=dev, kernels=False)
    if counts != planned(per_fwd):
        raise AssertionError(f"dynamic forward launches {counts} != {per_fwd}")
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
        raise AssertionError("dynamic forward: kernel ids differ from the plain QuantExec's")
    log(f"[7d] dynamic forward of 4 requests: ids == plain QuantExec, launches {counts}")
    b64, n64 = 64, 16000 * 15
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(b64, n64))
                             .astype(np.float32) * 0.1).to(dev)
    alens = torch.full((b64,), n64, dtype=torch.int32, device=dev)
    dyn = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        dyn[path] = statistics.median(cuda_ms(
            lambda kern=kern: model.forward(audio, alens, device=dev, kernels=kern), reps=reps,
            warmup=1))
    log(f"[7d] dynamic forward B=64 x 15 s: kernel {dyn['kernel']:.3f} ms (median of 3), plain "
        f"{dyn['plain']:.3f} ms (one call after one) [{card}]")
    out["dynamic_forward_ms"] = dyn
    del audio

    # (e) the CLIs on a manifest of 4 seeded wavs
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_manifest(tmp, np.random.default_rng(5))
        pkl = cli_synthesize.main(["--asr_model", name, "--num_batch", "1",
                                   "--batch_size", "4", "--seqlen", "300", "--train_iter",
                                   "50", "--dump_path", tmp, "--allow_random_weights", "--device", str(dev)])
        wer, hyps, refs, cal = cli_inference.run(
            ["--asr_model", name, "--dataset", manifest, "--load", pkl,
             "--weight_bit", "6", "--act_bit", "6", "--percentile", "99.9",
             "--allow_random_weights", "--batch_size", "4", "--device", str(dev)])
        if not math.isfinite(wer):
            raise AssertionError(f"cli.inference WER {wer}")
        ds = AudioToCharDataset(manifest, labels=list(cal.vocabulary))
        plain_fn = make_frozen_fn(cal, cal.freeze("static_e", dev), argmax=True, fused=False)
        want = []
        for audio_b, alens_b, _, _ in DataLoader(ds, batch_size=4):
            want += cal.ids_to_text(*plain_fn(audio_b, alens_b))
        if hyps != want:
            raise AssertionError(f"cli.inference hypotheses {hyps} != plain frozen {want}")
    log(f"[7e] cli.synthesize -> cli.inference W6A6 percentile 99.9: WER {wer:.4f}; "
        f"hypotheses == plain frozen executor's: {[h[:40] for h in hyps]}")
    out.update(cli_wer=wer, cli_hypotheses=hyps)

    # (c) the noise recipe of the committed ranges; how far a float front's
    # rounding alone moves them; and what faults of the recipe read
    phase_noise_ranges(model, dev, out)


def phase_noise_ranges(model, dev, out):
    """calibrate_on_noise(2, 2, 4 s, seed 0), the recipe of the committed
    ranges, against them at a fixed tolerance.  Witnesses of how far the
    float front's rounding moves a random stack's deep ranges: the same
    recipe from the features computed on the CPU, and from the card's
    features times (1 + 1e-5 N(0, 1)) for a few seeds.  Planted faults of
    the recipe (another seed, one batch, percentile 99.9, momentum 0.9,
    exact calibration requants) and what each reads against the
    committed ranges; another seed's and percentile 99.9's must read
    above the tolerance.  Prints how many frozen table entries differ
    from the golden record's tables."""
    import dataclasses

    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.jasper import init_qstate

    model.set_dynamic(False)
    model.set_percentile(None)
    base_qcfg = model.qcfg
    ref_model = golden.quartznet15x5_w6a6()
    ref = ref_model.qstate

    def calibrated(feats=None, seed=0, batches=2, **qcfg):
        model.qcfg = dataclasses.replace(base_qcfg, **qcfg)
        model.qstate = init_qstate(model.plan)
        if feats is None:
            model.calibrate_on_noise(batches=batches, batch_size=2, seconds=4.0, seed=seed,
                                     device=dev)
        else:
            model.calibrate(feats, device=dev)
        model.qcfg = base_qcfg
        return model.qstate

    def worst(q, against=ref):
        return site_deviations(q, against)[0][0]

    port_q = calibrated()
    devs = site_deviations(port_q, ref)
    first = next(d for d in devs if d[1] == ".blocks[0].convs[0]")[0]
    # the recipe's audio, as calibrate_on_noise draws it
    rng = np.random.default_rng(0)
    n = 16000 * 4
    audio = [torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32) * 0.1)
             for _ in range(2)]
    lens = torch.full((2,), n, dtype=torch.int32)
    card_feats = [model.frontend(a.to(dev), lens.to(dev), dither=0.0) for a in audio]
    cpu_feats = [tuple(v.to(dev) for v in model.frontend(a, lens, dither=0.0)) for a in audio]
    witness = {"cpu front": site_deviations(calibrated(cpu_feats), port_q)}
    for seed in PERTURBATION_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        feats = [(f * (1 + FRONT_PERTURBATION * torch.randn(f.shape, generator=gen, device=dev)),
                  fl) for f, fl in card_feats]
        witness[f"perturbed seed {seed}"] = site_deviations(calibrated(feats), port_q)
    moves = {}
    for devs_w in witness.values():
        for d in devs_w:
            moves[d[1]] = max(moves.get(d[1], 0.0), d[0])
    faults = {"seed 1": calibrated(seed=1), "one batch": calibrated(batches=1),
              "percentile 99.9": calibrated(percentile=99.9),
              "act_momentum 0.9": calibrated(act_momentum=0.9),
              "calib_exact": calibrated(calib_exact=True)}
    fault_worst = {k: worst(q) for k, q in faults.items()}
    model.qstate = port_q
    differ = table_entries_differing(model.freeze_host("static_e"),
                                     ref_model.freeze_host("static_e"))
    med = statistics.median(d[0] for d in devs)
    out.update(noise_range_worst=devs[0][0], noise_range_median=med, noise_first_site=first,
               noise_witness_worst={k: v[0][0] for k, v in witness.items()},
               noise_fault_worst=fault_worst, noise_table_entries_differing=differ,
               noise_site_deviation=[list(d) + [moves[d[1]]] for d in devs])
    for d in devs[:8]:
        log(f"[7c]   {d[1]}: ({d[2]:.6g}, {d[3]:.6g}) vs committed ({d[4]:.6g}, {d[5]:.6g}): "
            f"{d[0]:.3%} of its range; the witnesses move it up to {moves[d[1]]:.3%}")
    log(f"[7c] calibrate_on_noise(2, 2, 4 s, seed 0): {len(devs)} sites against the committed "
        f"ranges: worst {devs[0][0]:.3%}, median {med:.3%} of a site's range (tolerance "
        f"{NOISE_RANGE_TOL:.0%}), the first site (features only) {first:.2e} (tolerance "
        f"{FIRST_SITE_TOL:g}); the port's own ranges move, worst site: "
        f"{ {k: f'{v[0][0]:.3%}' for k, v in witness.items()} }; planted faults read "
        f"{ {k: f'{v:.3%}' for k, v in fault_worst.items()} }; {differ} frozen table entries "
        f"differ from the golden record's tables")
    if devs[0][0] > NOISE_RANGE_TOL or first > FIRST_SITE_TOL:
        raise AssertionError(f"noise ranges off the committed ones: worst site {devs[0][0]:.3%} "
                             f"(tolerance {NOISE_RANGE_TOL:.0%}), first site {first:.2e} "
                             f"(tolerance {FIRST_SITE_TOL:g})")
    blind = [k for k in ("seed 1", "percentile 99.9") if not fault_worst[k] > NOISE_RANGE_TOL]
    if blind:
        raise AssertionError(f"the noise-range tolerance cannot see the planted faults {blind}")


def synthesis_grad_rel(plan, enc_params, dev, dim):
    """Norm-wise relative difference of distill_loss's input gradient on the
    card from the CPU's, at the recipe's shape (8 x 500) from one start
    point: through ``loss_and_backward``, as synthesis steps, and with the
    backward under TF32 (PyTorch's cuDNN default), the fault the gate must
    see."""
    import torch

    from qasr_tpu_torch.quantize.ranges import params_to_device
    from qasr_tpu_torch.quantize.synth import (bn_targets, distill_loss, loss_and_backward,
                                               start_points)

    x0 = start_points(1, 8, 500, dim, seed=2)[0]

    def grad(device, tf32=False):
        params = params_to_device(enc_params, device)
        targets = bn_targets(plan, params)
        x = x0.to(device, copy=True).requires_grad_(True)
        lens = torch.full((8,), 500, dtype=torch.int32, device=device)
        if not tf32:
            loss_and_backward(plan, params, x, lens, targets)
            return x.grad.double().cpu()
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            distill_loss(plan, params, x, lens, targets).backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return x.grad.double().cpu()

    g_cpu = grad("cpu")

    def rel(g):
        return float(torch.linalg.vector_norm(g - g_cpu) / torch.linalg.vector_norm(g_cpu))

    return rel(grad(dev)), rel(grad(dev, tf32=True))


def time_workflow_sites(chk, rows, dev, card):
    """Kernels 1 and 2 in the forms QuantExec runs them (int8 in, int32 out,
    no epilogue) at the calibrating forward's shapes (B=8, T=250 after the
    stride-2 site) and the dynamic forward's (B=64 x 15 s: T=751), against
    their plain versions; beside cuDNN's float32 depthwise conv (TF32 off,
    exact here) and torch._int_mm."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(9)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-32, 32, shape).astype(np.int8)).to(dev)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, t in ((8, 250), (64, 751)):
            c, k = 512, 75
            x, w = t8(b, t, c), t8(k, c)
            xf = x.permute(0, 2, 1).contiguous().float()
            wf = w.t().contiguous().float()[:, None, :]
            r = timed_pair(chk, "dw_conv", f"dw_conv QuantExec B={b} T={t} C={c} K={k} int8 in, "
                           f"int32 out", lambda x=x, w=w: dw_conv(x, w, padding=k // 2),
                           lambda x=x, w=w: dw_conv_plain(x, w, padding=k // 2), card, rows,
                           lambda xf=xf, wf=wf: F.conv1d(xf, wf, groups=c, padding=k // 2))
            r["bound"] = bound(x.numel() + w.numel() + 4 * b * t * c, 2 * k * b * t * c)
            x, wt = t8(b, t, c), t8(c, c)
            bias = torch.from_numpy(rng.integers(-3000, 3000, c).astype(np.int32)).to(dev)
            x2, wt_t = x.reshape(-1, c), wt.t()
            r = timed_pair(chk, "pw_gemm", f"pw_gemm QuantExec N={b * t} {c}->{c} int8 in, "
                           f"int32 + bias out", lambda x=x, wt=wt: pw_gemm(x, wt, bias=bias),
                           lambda x=x, wt=wt: pw_gemm_plain(x, wt, bias=bias), card, rows,
                           lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t))
            r["bound"] = bound(x.numel() + wt.numel() + 4 * c + 4 * b * t * c, 2 * b * t * c * c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# phase 8: the Conformer's zero-shot workflow (synthesis, calibration,
# freeze and serve, the asset's recipe, dynamic)
# ---------------------------------------------------------------------------

CONF_FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
                  integer_activations=True, static_attention=True)
# quantize_encoder_synthetic's recipe (the JAX package's defaults)
CONF_SYNTH = dict(num_batch=2, batch_size=8, seqlen=128, train_iter=200, lr=0.02, seed=0)
CONF_SECONDS = 15.0
# card vs CPU, the first 3 synthesis losses of one start point (2 x 128 frames)
CONF_SYNTH_RTOL = 1e-5
# card vs CPU, conformer_distill_loss's input gradient at 8 x 128 (norm-wise);
# the same backward with TF32 on must read above it
CONF_GRAD_RTOL = 1e-4
# the committed asset's recipe (one batch of 4 x 15 s of seed-0 noise x 0.1)
# against its ranges, as a share of each site's range: every site within
# CONF_RANGE_L, pre_out within CONF_PRE_OUT_TOL.  L sits above what the
# port reads on the CPU against the asset (5.9%) and how far a 1e-5
# perturbation of the features moves the port's own ranges (up to 9.7%),
# below the planted faults (another noise seed 27.8%, percentile 99.9
# 52.3%): experiments/torch_conformer_asset_ranges.py --device cpu
CONF_RANGE_L = 0.15
CONF_PRE_OUT_TOL = 1e-4


def conformer_synth_grad_rel(model, dev):
    """Norm-wise relative difference of conformer_distill_loss's input
    gradient on the card from the CPU's at the recipe's 8 x 128 frames from
    one start point: through ``backward_no_tf32``, as synthesis steps, and
    with the backward under TF32 (the fault the gate must see)."""
    import torch

    from qasr_tpu_torch.models.conformer import encoder_params_to_device
    from qasr_tpu_torch.quantize.conformer_synth import (conformer_bn_targets,
                                                         conformer_distill_loss)
    from qasr_tpu_torch.quantize.synth import backward_no_tf32, start_points

    b, t = CONF_SYNTH["batch_size"], CONF_SYNTH["seqlen"]
    x0 = start_points(1, b, t, model.ccfg.feat_in, seed=2)[0]

    def grad(device, tf32=False):
        params = encoder_params_to_device(model.params["encoder"], device)
        targets = conformer_bn_targets(params)
        x = x0.to(device, copy=True).requires_grad_(True)
        lens = torch.full((b,), t, dtype=torch.int32, device=device)

        def loss(v):
            return conformer_distill_loss(params, model.ccfg, v, lens, targets)
        if not tf32:
            backward_no_tf32(loss, x)
            return x.grad.double().cpu()
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            loss(x).backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return x.grad.double().cpu()

    g_cpu = grad("cpu")

    def rel(g):
        return float(torch.linalg.vector_norm(g - g_cpu) / torch.linalg.vector_norm(g_cpu))

    return rel(grad(dev)), rel(grad(dev, tf32=True))


def recipe_noise(seed, batch=4, seconds=CONF_SECONDS):
    """The asset's recipe audio: default_rng(seed).normal((32, n)) x 0.1,
    the first ``batch`` rows (experiments/torch_conformer_golden.py)."""
    import numpy as np

    n = int(16000 * seconds)
    audio = (np.random.default_rng(seed).normal(size=(32, n)) * 0.1).astype(np.float32)
    return audio[:batch], np.full((batch,), n, np.int32)


def phase_conformer_workflow(chk, dev, card, report):
    """Phase 8: the flagship Conformer-CTC's zero-shot workflow."""
    import torch

    from qasr_tpu_torch.golden import conformer_flagship_configs
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC, make_conformer_frozen_fn
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches
    from qasr_tpu_torch.quantize.conformer_ptq import ptq_kernel_launches
    from qasr_tpu_torch.quantize.conformer_synth import get_synthetic_conformer_data
    from qasr_tpu_torch.quantize.synth import start_points

    t_phase = time.perf_counter()
    out = report.setdefault("conformer_workflow", {})
    model = ConformerCTC.from_config(*conformer_flagship_configs(), seed=0)
    ccfg = model.ccfg
    enc = model.params["encoder"]

    # (a) synthesis at quantize_encoder_synthetic's recipe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, losses = get_synthetic_conformer_data(enc, ccfg, device=dev, **CONF_SYNTH)
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / (CONF_SYNTH["num_batch"] * CONF_SYNTH["train_iter"])
    for i, ls in enumerate(losses):
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"Conformer synthesis problem {i}: losses {ls[0]} -> {ls[-1]}")
    x0 = start_points(1, 2, CONF_SYNTH["seqlen"], ccfg.feat_in, seed=1)
    kw = dict(batch_size=2, seqlen=CONF_SYNTH["seqlen"], train_iter=3, lr=CONF_SYNTH["lr"],
              x0=x0)
    l_card = get_synthetic_conformer_data(enc, ccfg, device=dev, **kw)[1][0]
    l_cpu = get_synthetic_conformer_data(enc, ccfg, device="cpu", **kw)[1][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if rel > CONF_SYNTH_RTOL:
        raise AssertionError(f"Conformer synthesis losses card {l_card} vs CPU {l_cpu}: rel {rel}")
    g_rel, g_rel_tf32 = conformer_synth_grad_rel(model, dev)
    if g_rel > CONF_GRAD_RTOL or not g_rel_tf32 > CONF_GRAD_RTOL:
        raise AssertionError(f"conformer_distill_loss gradient card vs CPU: rel {g_rel:.3e} "
                             f"(TF32 on: {g_rel_tf32:.3e}), tolerance {CONF_GRAD_RTOL:g}")
    log(f"[8a] Conformer synthesis {CONF_SYNTH['num_batch']} x ({CONF_SYNTH['batch_size']} x "
        f"{CONF_SYNTH['seqlen']} x {ccfg.feat_in}), "
        f"{CONF_SYNTH['train_iter']} iterations: losses "
        f"{[(round(ls[0], 3), round(ls[-1], 3)) for ls in losses]}, all finite; "
        f"{s_iter * 1e3:.2f} ms an iteration [{card}]; first 3 losses at 2 x 128 card {l_card} "
        f"vs CPU {l_cpu}, max rel {rel:.2e} <= {CONF_SYNTH_RTOL:g}; input gradient at the recipe's "
        f"norm-wise rel {g_rel:.3e} <= {CONF_GRAD_RTOL:g}, with a TF32 backward {g_rel_tf32:.3e}")
    out.update(synth_ms_per_iter=s_iter * 1e3, synth_losses=[[ls[0], ls[-1]] for ls in losses],
               synth_cpu_rel=rel, synth_grad_rel=g_rel, synth_grad_rel_tf32=g_rel_tf32)

    # (b) calibration on the synthetic batches, kernels against plain; then
    # freeze and serve from the port's own ranges
    per_fwd = ptq_kernel_launches(ccfg)
    reset_counts()
    model.quantize_encoder(data, features=True, device=dev, **CONF_FLAGS)
    calib_counts = read_counts()
    expect = planned({k: len(data) * v for k, v in per_fwd.items()})
    if calib_counts != expect:
        raise AssertionError(f"Conformer calibration launches {calib_counts} != {expect}")
    q_kernel = model.enc_qstate
    model.quantize_encoder(data, features=True, device=dev, kernels=False, **CONF_FLAGS)
    a, b = qstate_sites(q_kernel), qstate_sites(model.enc_qstate)
    bad = sum(x != y for x, y in zip(a, b))
    if bad or len(a) != len(b):
        raise AssertionError(f"Conformer calibration: {bad} of {len(a)} sites' ranges differ "
                             f"from the plain path's")
    log(f"[8b] Conformer calibration on the {len(data)} synthetic batches, every integer flag "
        f"and static attention: the {len(a)} sites' ranges equal the plain path's bit for bit; "
        f"launches {calib_counts} (a forward: {per_fwd})")
    tables = model.freeze(dev)
    utts, secs = seeded_requests(10)
    batch, lens = pad_batch(utts)
    ids_p, el_p = make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)(batch, lens)
    plain_texts = model.ids_to_text(ids_p, el_p)
    model.transcribe_greedy(batch[:1, :len(utts[0])], lens[:1], device=dev)  # build + cache
    reset_counts()
    texts = model.transcribe_greedy(batch, lens, device=dev)
    counts = read_counts()
    if counts != planned(kernel_launches(ccfg)):
        raise AssertionError(f"frozen Conformer from the port's ranges: launches {counts}")
    ids_k, el_k = make_conformer_frozen_fn(model, tables, argmax=True)(batch, lens)
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)) or texts != plain_texts:
        raise AssertionError("frozen Conformer from the port's ranges: kernel ids differ from "
                             "the plain executor's")
    log(f"[8b] froze on those ranges and served 4 requests ({secs} s): launches {counts}; ids "
        f"== plain executor; {[t_[:40] for t_ in texts]}")
    out.update(calib_launches=calib_counts, served_launches=counts, served_texts=texts)

    # the EMA: over these 2 batches momentum 0.9 must move the ranges off
    # 0.95's, kernels and plain alike (the asset's one-batch recipe in (c)
    # never applies the EMA)
    m90 = {}
    for kern in (True, False):
        model.quantize_encoder(data, features=True, device=dev, kernels=kern, momentum=0.9,
                               **CONF_FLAGS)
        m90[kern] = qstate_sites(model.enc_qstate)
    if m90[True] != m90[False]:
        raise AssertionError("Conformer calibration at momentum 0.9: kernel ranges differ from "
                             "the plain path's")
    moved = sum(x != y for x, y in zip(m90[True], a))
    if not moved:
        raise AssertionError("Conformer calibration: momentum 0.9 gave momentum 0.95's ranges")
    log(f"[8b] at momentum 0.9 the ranges equal the plain path's and {moved} of {len(a)} sites "
        f"moved off momentum 0.95's")
    out["calib_momentum_sites_moved"] = moved

    # (c) the committed asset's recipe, and planted faults of it
    conformer_asset_ranges(model, dev, out)

    # (d) the dynamic forward at B=32 x 15 s, kernels against plain
    a4, l4 = recipe_noise(0)
    model.quantize_encoder([(a4, l4)], dynamic=True, device=dev, **CONF_FLAGS)
    audio32, lens32 = recipe_noise(0, batch=32)
    audio32 = torch.from_numpy(audio32).to(dev)
    lens32 = torch.from_numpy(lens32).to(dev)
    model.forward(audio32[:2], lens32[:2], device=dev)
    reset_counts()
    lp_k, el_k = model.forward(audio32, lens32, device=dev)
    counts = read_counts()
    lp_p, el_p = model.forward(audio32, lens32, device=dev, kernels=False)
    if counts != planned(ptq_kernel_launches(ccfg, head=True)):
        raise AssertionError(f"dynamic Conformer forward launches {counts}")
    # the same int32 products, then the same float ops: the log-probs agree
    # bit for bit
    if not (torch.equal(lp_k, lp_p) and torch.equal(lp_k.argmax(-1), lp_p.argmax(-1))
            and torch.equal(el_k, el_p)):
        raise AssertionError(f"dynamic Conformer forward: kernel log-probs differ from the plain "
                             f"path's (max |d| {float((lp_k - lp_p).abs().max()):.3e})")
    check_dynamic_shapes(chk, dev, ccfg, lp_k.shape[0], lp_k.shape[1])
    dyn = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        dyn[path] = statistics.median(cuda_ms(
            lambda kern=kern: model.forward(audio32, lens32, device=dev, kernels=kern),
            reps=reps, warmup=1))
    log(f"[8d] dynamic Conformer forward B=32 x 15 s: log-probs == plain path bit for bit, "
        f"launches {counts}; "
        f"kernel {dyn['kernel']:.3f} ms (median of 3), plain {dyn['plain']:.3f} ms (one call "
        f"after one) [{card}]")
    out["dynamic_forward_ms"] = dyn
    del audio32, lp_k, lp_p

    # (e) the calibrating forward at B=4 x 15 s and Kernels 1 and 2 at its shapes
    time_conformer_calibration(chk, model, dev, card, report)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[8] phase 8 took {out['seconds']:.1f} s")


def check_dynamic_shapes(chk, dev, ccfg, b, t):
    """Kernels 1 and 2 against their plain versions on seeded int8 at the
    dynamic forward's shapes: the depthwise at B=b, T=t, and the linears
    and pre_out's K-split at N = b * t."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.quantize.conformer_ptq import pre_out_width

    rng = np.random.default_rng(13)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    c, k, d_ff = ccfg.d_model, ccfg.conv_kernel_size, ccfg.d_ff
    x, w = t8(b, t, c), t8(k, c)
    chk.equal("dw_conv", f"dw_conv dynamic Conformer B={b} T={t} C={c} K={k}",
              dw_conv(x, w, padding=k // 2), dw_conv_plain(x, w, padding=k // 2))
    n = b * t
    for cin, cout in ((c, c), (c, d_ff), (d_ff, c), (c, 2 * c), (pre_out_width(ccfg), c)):
        x3, wt = t8(1, n, cin), t8(cout, cin)
        chk.equal("pw_gemm", f"pw_gemm dynamic Conformer N={n} {cin}->{cout}",
                  pw_gemm(x3, wt), pw_gemm_plain(x3, wt))
    log(f"[8d] Kernels 1 and 2 at the dynamic forward's shapes (B={b} T={t}; N={n}, pre_out's "
        f"K-split {pre_out_width(ccfg)}->{c} included) equal their plain versions")


def conformer_asset_ranges(model, dev, out):
    """quantize_encoder on the committed asset's recipe (one batch of 4 x
    15 s of seed-0 noise x 0.1, every integer flag, static attention)
    against its ranges: pre_out within CONF_PRE_OUT_TOL of its range, every
    site within CONF_RANGE_L.  Planted faults of the recipe (another noise
    seed, percentile 99.9: must read above L; momentum 0.9: one batch
    initializes every range, so it reads as the recipe does) and what each
    reads; how many frozen table entries differ from the golden record's
    tables."""
    from qasr_tpu_torch import golden

    ref = golden.conformer16x256_w8a8()

    def calibrated(seed=0, **kw):
        model.quantize_encoder([recipe_noise(seed)], device=dev, **dict(CONF_FLAGS, **kw))
        return model.enc_qstate

    port_q = calibrated()
    devs = site_deviations(port_q, ref.enc_qstate)
    pre = next(d for d in devs if d[1] == ".pre_out")[0]
    faults = {"seed 1": calibrated(seed=1), "percentile 99.9": calibrated(percentile=99.9),
              "momentum 0.9": calibrated(momentum=0.9)}
    fault_worst = {k: site_deviations(q, ref.enc_qstate)[0][0] for k, q in faults.items()}
    model.enc_qstate = port_q
    differ = table_entries_differing(model.freeze_host(), ref.freeze_host())
    med = statistics.median(d[0] for d in devs)
    out.update(asset_range_worst=devs[0][0], asset_range_median=med, asset_pre_out=pre,
               asset_fault_worst=fault_worst, asset_table_entries_differing=differ,
               asset_site_deviation=[list(d) for d in devs])
    for d in devs[:6]:
        log(f"[8c]   {d[1]}: ({d[2]:.6g}, {d[3]:.6g}) vs committed ({d[4]:.6g}, {d[5]:.6g}): "
            f"{d[0]:.4%} of its range")
    log(f"[8c] the asset's recipe: {len(devs)} sites against the committed ranges: worst "
        f"{devs[0][0]:.4%}, median {med:.4%} of a site's range (L = {CONF_RANGE_L:.0%}), pre_out "
        f"{pre:.2e} (tolerance {CONF_PRE_OUT_TOL:g}); planted faults read "
        f"{ {k: f'{v:.3%}' for k, v in fault_worst.items()} }; {differ} frozen table entries "
        f"differ from the golden record's tables")
    if devs[0][0] > CONF_RANGE_L or pre > CONF_PRE_OUT_TOL:
        raise AssertionError(f"the asset's recipe off its ranges: worst site {devs[0][0]:.4%} "
                             f"(L {CONF_RANGE_L:.0%}), pre_out {pre:.2e}")
    blind = [k for k in ("seed 1", "percentile 99.9") if not fault_worst[k] > CONF_RANGE_L]
    if blind:
        raise AssertionError(f"L cannot see the planted faults {blind}")


def time_conformer_calibration(chk, model, dev, card, report):
    """The calibrating forward (every flag, static attention) at B=4 x 15 s,
    kernels and plain, and Kernels 1 and 2 at its shapes (Kernel 1: C 256,
    K 31, T 375; Kernel 2 at N = 1,500: 256->256, 256->1024, 1024->256,
    256->512 and pre_out's K-split 4,864->256), each against its plain
    version, cuDNN's float32 depthwise conv (TF32 off, exact here) or
    torch._int_mm."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.models.ctc_model import _pcm_f32
    from qasr_tpu_torch.quantize.ranges import qstate_to_device
    from qasr_tpu_torch.quantize.conformer_ptq import (conformer_encoder_apply_ptq,
                                                       quantize_conformer_weights)

    out = report["conformer_workflow"]
    model.quantize_encoder([recipe_noise(0)], device=dev, **CONF_FLAGS)
    a4, l4 = (torch.from_numpy(v).to(dev) for v in recipe_noise(0))
    feats, fl = model.frontend(_pcm_f32(a4), l4, dither=0.0)
    qp = quantize_conformer_weights(model.params["encoder"], model.ccfg,
                                    model.enc_qcfg.weight_bit, dev)
    qs = qstate_to_device(model.enc_qstate, dev)
    calib = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        calib[path] = statistics.median(cuda_ms(
            lambda kern=kern: conformer_encoder_apply_ptq(qp, model.ccfg, model.enc_qcfg, qs,
                                                          feats, fl, update=True, kernels=kern),
            reps=reps, warmup=1))
    log(f"[8e] calibrating Conformer forward B=4 x 15 s (T'=375): kernel {calib['kernel']:.3f} "
        f"ms (median of 3), plain {calib['plain']:.3f} ms (one call after one) [{card}]")
    out["calibrate_forward_ms"] = calib

    rows = report.setdefault("conformer_workflow_per_kernel", [])
    rng = np.random.default_rng(12)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    b, t, c, k = 4, 375, model.ccfg.d_model, model.ccfg.conv_kernel_size
    x, w = t8(b, t, c), t8(k, c)
    xf = x.permute(0, 2, 1).contiguous().float()
    wf = w.t().contiguous().float()[:, None, :]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = timed_pair(chk, "dw_conv", f"dw_conv Conformer calibration B={b} T={t} C={c} K={k} "
                       f"int8 in, int32 out", lambda: dw_conv(x, w, padding=k // 2),
                       lambda: dw_conv_plain(x, w, padding=k // 2), card, rows,
                       lambda: F.conv1d(xf, wf, groups=c, padding=k // 2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    r["bound"] = bound(x.numel() + w.numel() + 4 * b * t * c, 2 * k * b * t * c)
    n = b * t
    for cin, cout in ((256, 256), (256, 1024), (1024, 256), (256, 512), (4864, 256)):
        x3, wt = t8(1, n, cin), t8(cout, cin)
        x2, wt_t = x3[0], wt.t()
        r = timed_pair(chk, "pw_gemm", f"pw_gemm Conformer calibration N={n} {cin}->{cout} "
                       f"int8 in, int32 out" + (" (K-split)" if cin > 2944 else ""),
                       lambda x3=x3, wt=wt: pw_gemm(x3, wt),
                       lambda x3=x3, wt=wt: pw_gemm_plain(x3, wt), card, rows,
                       lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t))
        r["bound"] = bound(x3.numel() + wt.numel() + 4 * n * cout, 2 * n * cin * cout)


def site_deviations(q, ref):
    """[(deviation / the reference site's range, site, lo, hi, ref lo, ref hi)]
    of every activation site, largest first."""
    devs = []
    for (site, lo, hi), (_, rlo, rhi) in zip(qstate_sites(q), qstate_sites(ref)):
        mag = max(abs(rlo), abs(rhi))
        d = max(abs(lo - rlo), abs(hi - rhi))
        devs.append((d / mag if mag else (0.0 if d == 0 else math.inf), site, lo, hi, rlo, rhi))
    return sorted(devs, reverse=True)


def main() -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke test on one GPU")
    ap.add_argument("--report", help="also write a JSON report of every number here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    dev = require_cuda(0)
    card = card_line()
    log(f"[1] {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = _build.BuildInfo
    log(f"[2] kernels built from csrc in {build_s:.2f} s (nvcc {info.seconds:.2f} s, "
        f"compiled={info.compiled}) -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"    ptxas: {line.strip()}")
    report.update(build_s=build_s, nvcc_s=info.seconds, ptxas=info.log)

    chk = Checker()
    phase_requant(chk, dev)
    phase_dw(chk, dev)
    phase_pw(chk, dev)
    phase_requant_kernel(chk, dev)
    phase_int_fns(chk, dev)
    conf_model, conf_tables, conf_golden = phase_conformer_golden(dev)
    phase_int_attention(chk, dev, conf_tables)
    phase_conv_block(chk, dev, conf_tables)
    phase_lin_epilogue(chk, dev, conf_tables)
    phase_ffn_ln(chk, dev, conf_tables)
    log(f"[3] {chk.n} kernel-vs-plain comparisons pass at tolerance exact "
        f"(torch.equal); max |d| {chk.max_err}")
    report["conformer_golden"] = conf_golden

    model, tables = phase_golden(dev)
    q_counts = phase_serve(model, dev)
    conf_counts = phase_conformer_serve(conf_model, conf_tables, dev)
    # launches on each kernel's own main path: Kernels 1-2 on the static
    # QuartzNet path, Kernel 7 on the per_channel one, the rest on the
    # Conformer's default plan
    counts = {"dw_conv": q_counts["static_e"]["dw_conv"],
              "pw_gemm": q_counts["static_e"]["pw_gemm"],
              "requant": q_counts["per_channel"]["requant"]}
    counts.update({k: conf_counts[k] for k in
                   ("int_attention", "conv_block", "lin_epilogue", "ffn_ln")})
    report["launches"] = {"quartznet": q_counts, "conformer": conf_counts}
    phase_time(chk, model, tables, dev, card, report)
    phase_conformer_time(chk, conf_model, conf_tables, dev, card, report)
    log(f"[6] {chk.n} kernel-vs-plain comparisons in all, the main paths' shapes included, "
        f"exact; max |d| {chk.max_err}")
    phase_workflow(chk, dev, card, report)
    phase_conformer_workflow(chk, dev, card, report)

    rows = report["quartznet_per_kernel"] + report["conformer_per_kernel"]
    kernels = []
    for kind, replaces, label in [
            ("dw_conv", "qasr_tpu/kernels/cm_fused.py:248 (#1); qasr_tpu/kernels/depthwise.py:104 "
             "(#2); qasr_tpu/kernels/depthwise.py:409 (#3); qasr_tpu/kernels/cm_fused.py:575 "
             "(#6); qasr_tpu/kernels/cm_fused.py:486 (#7); qasr_tpu/kernels/cm_fused.py:374 "
             "(#8); qasr_tpu/kernels/depthwise.py:284 (#9)", "C=512 K=75 s=1 d=1 epilogue off"),
            ("pw_gemm", "qasr_tpu/kernels/cm_fused.py:131 (#4); qasr_tpu/kernels/cm_fused.py:704 "
             "(#5); qasr_tpu/kernels/pw_matmul.py:51 (#11)", "512->512 requant"),
            ("requant", "qasr_tpu/kernels/requant.py:65,74 (#10)", "C=512 int32 per-channel input"),
            ("int_attention", "qasr_tpu/kernels/int_attention.py:170", "int_attention B="),
            ("conv_block", "qasr_tpu/kernels/conf_module.py:341", "conv_block B="),
            ("lin_epilogue", "qasr_tpu/kernels/gemm_fused.py:159", "q_u 256->256"),
            ("ffn_ln", "qasr_tpu/kernels/conf_module.py:206", "ff1 + ln_att")]:
        r = next(r for r in rows if label in r["shape"])
        kernels.append({"name": kind, "route": "cuda", "shape": r["shape"],
                        "source": f"qasr_tpu_torch/kernels/csrc/{kind}.cu",
                        "replaces": replaces, "launches": counts[kind],
                        "max_abs_err": chk.max_err[kind], "ms": r["device_ms"],
                        "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                        "library_ms": r["library_device_ms"],
                        "library_call_ms": r["library_call_ms"]})
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"[6] whole smoke run {report['seconds']:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
