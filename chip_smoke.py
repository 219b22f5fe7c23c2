#!/usr/bin/env python3
"""Smoke test of the PyTorch port (qasr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH]

Drives the port's two serving paths on the card, the frozen W6A6
QuartzNet15x5 and the frozen W8A8 Conformer-CTC (16 x 256), with nothing
that falls back: no CUDA, a failed kernel build or any failed phase exits
non-zero before the result line.  Phases:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from qasr_tpu_torch/kernels/csrc (one nvcc per
   source, in parallel; timed);
3. each kernel against its plain torch version on the card, bit for bit
   (torch.equal): dw_conv and pw_gemm at every QuartzNet shape and
   epilogue mode, the requant device function over its boundary grid; the
   Conformer's integer device functions over their whole domains (i_exp,
   i_sigmoid_grid, the LN square root, floor_div, the i-LN row core);
   int_attention at T in {1, 37, 128, 129, 375, 500} with ragged lengths
   and contexts -1, (8, 0), (4, 2), and at d_k in {16, 96, 128} besides
   the flagship's 64; conv_block at d in {64, 256, 512}, T in {1, 31, 375}
   with ragged lengths;
4. the golden checks, on the kernel path and on the plain path:
   full-width QuartzNet15x5 reproduces the JAX record exactly; the
   flagship Conformer-CTC's x8 is within 0.1% of codes at +-1 of the JAX
   record and its integer stack from the golden x8 reproduces the
   encodings' hash, ids and lengths exactly;
5. serve 4 seeded int16 PCM requests (4.0, 7.3, 11.6, 15.0 s) through
   ASRModel.transcribe and through ConformerCTC.transcribe_greedy, with
   every launch count set to 0 just before each and read just after: each
   path launches its own kernels as its plan predicts (QuartzNet 77
   dw_conv + 94 pw_gemm, the Conformer 16 int_attention + 16 conv_block)
   and gives the ids of its plain executor;
6. time the QuartzNet B=64 x 15 s step and the Conformer B=32 x 15 s step
   (kernel path and plain path, median of 10 after 3 warm-ups, CUDA
   events), and each kernel against its plain version at its path's
   shapes, with its bound (bytes over 3.35 TB/s or int8 operations over
   1,979 TOP/s, from this run's inputs) and, where one PyTorch call
   computes the same function, that call's time.

Prints the card line, a {"kernels": [...]} line, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
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
PW_CIN = (64, 256, 512, 1024)
PW_COUT = (256, 512, 1024, 29)
# the Conformer kernels' check grid
ATT_T = (1, 37, 128, 129, 375, 500)
ATT_CTX = ((-1, -1), (8, 0), (4, 2))
ATT_DK = (16, 96, 128)             # the other head widths the kernel takes (d_k 64 above)
CONV_D, CONV_T = (64, 256, 512), (1, 31, 375)
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12
KERNELS = ("dw_conv", "pw_gemm", "int_attention", "conv_block")


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


class Checker:
    """Counts kernel-vs-plain comparisons and their largest |difference|."""

    def __init__(self):
        self.n = 0
        self.max_err = {k: 0 for k in KERNELS + ("requant", "conformer_int")}

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
    from qasr_tpu_torch.kernels.int_attention import int_attention
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm

    return {"dw_conv": dw_conv, "pw_gemm": pw_gemm, "int_attention": int_attention,
            "conv_block": conv_block}


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

    zs = [0, 1, -1, 2, -2, 3, 2**29 - 1, -(2**29 - 1), 12345678, -98765432, 777]
    ms = [1, 2, 3, 2**15, 2**16 - 1, 2**30, 2**31 - 1, 3 << 29]
    es = list(range(1, 71))
    z, m, e = (a.reshape(-1) for a in np.meshgrid(np.asarray(zs), np.asarray(ms),
                                                  np.asarray(es), indexing="ij"))
    rng = np.random.default_rng(0)
    n = 1 << 20
    z = np.concatenate([z, rng.integers(-(2**29) + 1, 2**29, n)]).astype(np.int32)
    m = np.concatenate([m, rng.integers(1, 2**31, n)]).astype(np.int32)
    e = np.concatenate([e, rng.integers(1, 71, n)]).astype(np.int32)
    zt, mt, et = (torch.from_numpy(a).to(dev) for a in (z, m, e))
    chk.equal("requant", "requant device function (boundary grid + fuzz)",
              requant_device(zt, mt, et), dyadic_requant(zt, Dyadic(mt, et)))
    log(f"[3] requant device function == plain on {z.size} (z, m, e) triples")


def _tables(rng, c, m16, dev):
    import torch

    if m16:
        m, e = rng.integers(2**14, 2**16, c), 22
    else:
        m, e = rng.integers(2**29, 2**31 - 1, c), 37
    return torch.from_numpy(m.astype("int32")).to(dev), e


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
    log(f"[3] dw_conv == plain at {len(DW_SITES)} sites x 6 epilogue modes")


def phase_pw(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(2)
    b, t = 3, 203
    for cin in PW_CIN:
        x = torch.from_numpy(rng.integers(-64, 64, (b, t, cin)).astype(np.int8)).to(dev)
        for cout in PW_COUT:
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
                chk.equal("pw_gemm", f"pw_gemm {cin}->{cout} {name}",
                          pw_gemm(x, wt, **kw), pw_gemm_plain(x, wt, **kw))
    log(f"[3] pw_gemm == plain at {len(PW_CIN) * len(PW_COUT)} (Cin, Cout) pairs "
        f"x 8 epilogue modes")


def phase_golden(dev):
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.freeze import tables_digest, tables_to_device

    model = golden.quartznet15x5_w6a6()
    host = model.freeze_host("static_e")
    want = golden.load_golden()
    digest = tables_digest(host)
    if digest != want["tables_sha256"]:
        raise AssertionError(f"table digest {digest} != golden {want['tables_sha256']}")
    tables = tables_to_device(host, dev)
    feats, lens = golden.golden_features(model.plan.feat_in)
    for fused in (True, False):
        bad = golden.compare_golden(
            golden.port_record(model, tables, feats, lens, fused=fused), want)
        if bad:
            raise AssertionError(f"golden mismatch ({'kernel' if fused else 'plain'} "
                                 f"path) in {bad}")
    log(f"[4] golden: tables {digest[:16]}, ids/enc_lens/decoder-input/logits "
        f"hashes equal the JAX record on the kernel and plain paths "
        f"(enc_lens {want['enc_lens']})")
    return model, tables


def phase_serve(model, tables, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    utts, secs = seeded_requests(7)
    model.transcribe(utts[:1], device=dev)  # builds and caches the serving fn
    reset_counts()
    texts = model.transcribe(utts, batch_size=4, device=dev)
    counts = read_counts()
    expect = dict(kernel_launches(model.plan), int_attention=0, conv_block=0)
    if counts != expect:
        raise AssertionError(f"QuartzNet launch counts {counts} != plan {expect}")
    batch, lens = pad_batch(utts)
    ids_k, el_k = make_frozen_fn(model, tables, argmax=True)(batch, lens)
    ids_p, el_p = make_frozen_fn(model, tables, argmax=True, fused=False)(batch, lens)
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
        raise AssertionError("kernel path ids differ from the plain executor's")
    if texts != model.ids_to_text(ids_p, el_p):
        raise AssertionError("transcribe() differs from the plain executor's transcripts")
    if len(torch.unique(ids_k)) < 2:
        raise AssertionError("degenerate ids")
    for s_, txt in zip(secs, texts):
        log(f"[5] QuartzNet {s_:5.1f} s -> {txt[:100]!r}")
    log(f"[5] QuartzNet served 4 requests; launches {counts} == plan; ids == plain executor")
    return counts


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
    library call, if any) with CUDA events."""
    chk.equal(kind, label, kern(), plain())
    pk = statistics.median(cuda_ms(plain, reps=5) + cuda_ms(plain, reps=5))
    kk = statistics.median(cuda_ms(kern, reps=10))
    lib = statistics.median(cuda_ms(library, reps=10)) if library is not None else None
    rows.append({"shape": label, "kernel": kind, "ms": kk, "plain_ms": pk, "library_ms": lib})
    log(f"[6] {label}: kernel {kk:.4f} ms, plain {pk:.4f} ms"
        + (f", library {lib:.4f} ms" if lib is not None else "") + f", equal [{card}]")
    return rows[-1]


def step_times(fns, args, card, tag, batch, seconds, report):
    steps = {}
    for name in ("plain", "kernel", "kernel", "plain"):  # in turns, 2 x 5 each
        steps.setdefault(name, []).extend(cuda_ms(lambda fn=fns[name]: fn(*args), reps=5))
    step = {k: statistics.median(v) for k, v in steps.items()}
    for k in ("kernel", "plain"):
        log(f"[6] {tag} B={batch} x {seconds:g} s step, {k} path: median {step[k]:.3f} ms "
            f"of {len(steps[k])} ({batch * seconds / step[k] * 1e3:.1f} audio-s/s) [{card}]")
    report[f"{tag.lower()}_step_ms"] = step
    report[f"{tag.lower()}_step_samples_ms"] = steps
    return step


def phase_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.models.jasper import get_same_padding

    batch, seconds = 64, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(size=(batch, n)).astype(np.float32) * 0.1).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    fns = {"kernel": make_frozen_fn(model, tables, argmax=True),
           "plain": make_frozen_fn(model, tables, argmax=True, fused=False)}
    step = step_times(fns, (audio, lens), card, "QuartzNet", batch, seconds, report)

    # each kernel against its plain version at the main path's shapes
    t_enc = 768  # 15 s -> 1501 frames -> padded 1536 -> stride 2
    rows = []

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    for c, k, s_, d in [(64, 33, 2, 1), (256, 33, 1, 1), (512, 75, 1, 1), (512, 87, 1, 2)]:
        x = t8(batch, t_enc * s_, c)
        w = t8(k, c)
        kw = dict(stride=s_, padding=get_same_padding(k, s_, d), dilation=d,
                  out_len=full, m=vec(c, 2**29, 2**31 - 1), e=37, bits=7)
        r = timed_pair(chk, "dw_conv", f"dw_conv B=64 T={t_enc * s_} C={c} K={k} s={s_} d={d} int8",
                       lambda x=x, w=w, kw=kw: dw_conv(x, w, **kw),
                       lambda x=x, w=w, kw=kw: dw_conv_plain(x, w, **kw), card, rows)
        r["bound"] = bound(x.numel() + w.numel() + 4 * (c + batch) + batch * t_enc * c,
                           2 * k * batch * t_enc * c)
    for cin, cout, mode in [(256, 256, "requant"), (512, 512, "requant"),
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
    q = torch.arange(-ism.N_IN - 64, ism.N_IN + 65, dtype=torch.int32, device=dev)
    chk.equal("conformer_int", "i_sigmoid_grid on [-N_IN-64, N_IN+64]",
              int_fn_device("i_sigmoid_grid", q), isg.i_sigmoid_grid(q))
    v = torch.arange(0, 2**16 + 1, dtype=torch.int32, device=dev) << 12
    chk.equal("conformer_int", "isqrt on var << 12, var in [0, 2^16]",
              int_fn_device("isqrt", v), iln.i_sqrt(v))
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
        chk.equal("conformer_int", f"i-LN row core d={d}", ln_core_device(xt),
                  iln.i_layernorm_core(xt))
    log(f"[3] Conformer integer device functions == plain over their domains "
        f"(i_exp {ism.N_IN + 1}, i_sigmoid_grid {2 * ism.N_IN + 129}, isqrt 65537, "
        f"floor_div {a.size}, i-LN 3 x 4096 rows)")


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
    log(f"[3] int_attention == plain at {n} (T, d_k, context) cases, ragged lengths")


def phase_conv_block(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain

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
            chk.equal("conv_block", f"conv_block d={d} B={b} T={t}",
                      conv_block(c8, x8, lens, layers[d], (15, 15), nbits=8),
                      conv_block_plain(c8, x8, lens, layers[d], (15, 15), nbits=8))
    log(f"[3] conv_block == plain at d in {CONV_D} x T in {CONV_T}, ragged lengths")


def phase_conformer_golden(dev):
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.conformer_freeze import conformer_tables_digest

    model = golden.conformer16x256_w8a8()
    tables = model.freeze(dev)
    for kernels in (True, False):
        res = golden.check_conformer_golden(model, tables, kernels=kernels)
        if res["bad"]:
            raise AssertionError(f"Conformer golden mismatch ({'kernel' if kernels else 'plain'}"
                                 f" path) in {res['bad']}: {res}")
    log(f"[4] Conformer golden: tables {conformer_tables_digest(tables['encoder'])[:16]}; x8 "
        f"{res['x8_flips']} of {res['x8_size']} codes flipped (max |d| {res['x8_max_diff']}, "
        f"limit 0.1% at 1); from the golden x8 the encodings' hash, ids and enc_lens "
        f"{res['enc_lens']} equal the JAX record on the kernel and plain paths, log-probs "
        f"within {res['log_prob_max_err']:.2e}")
    return model, tables, res


def phase_conformer_serve(model, tables, dev):
    import torch

    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches

    utts, secs = seeded_requests(8)
    batch, lens = pad_batch(utts)
    model.transcribe_greedy(batch[:1, :len(utts[0])], lens[:1], device=dev)  # build + cache
    reset_counts()
    texts = model.transcribe_greedy(batch, lens, device=dev)
    counts = read_counts()
    expect = dict(kernel_launches(model.ccfg), dw_conv=0, pw_gemm=0)
    if counts != expect:
        raise AssertionError(f"Conformer launch counts {counts} != plan {expect}")
    ids_k, el_k = make_conformer_frozen_fn(model, tables, argmax=True)(batch, lens)
    ids_p, el_p = make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)(batch, lens)
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
        raise AssertionError("Conformer kernel path ids differ from the plain executor's")
    from qasr_tpu_torch.decode.ctc import ctc_collapse

    if texts != ctc_collapse(ids_p.cpu().numpy(), model.blank_id, model.vocabulary,
                             el_p.cpu().numpy()):
        raise AssertionError("transcribe_greedy differs from the plain executor's transcripts")
    if len(torch.unique(ids_k)) < 2:
        raise AssertionError("degenerate Conformer ids")
    for s_, txt in zip(secs, texts):
        log(f"[5] Conformer {s_:5.1f} s -> {txt[:100]!r}")
    log(f"[5] Conformer served 4 requests (enc_lens {el_k.tolist()}); launches {counts} == "
        f"plan; ids == plain executor")
    return counts


def phase_conformer_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain
    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn

    batch, seconds = 32, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.normal(size=(batch, n)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    fns = {"kernel": make_conformer_frozen_fn(model, tables, argmax=True),
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
    c8, x8 = t8(batch, t, d), t8(batch, t, d)
    k_size = tbl["dw_w"].shape[0]
    pad = model.ccfg.dw_padding
    r = timed_pair(chk, "conv_block", f"conv_block B={batch} T={t} d={d} K={k_size}",
                   lambda: conv_block(c8, x8, full, tbl, pad, nbits=8),
                   lambda: conv_block_plain(c8, x8, full, tbl, pad, nbits=8), card, rows)
    weights = 4 * d * d + k_size * d + 14 * 4 * d + 16 * 4
    r["bound"] = bound(3 * batch * t * d + weights + 4 * batch,
                       2 * batch * t * d * (4 * d + k_size))
    report["conformer_per_kernel"] = rows
    return step, rows


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
    phase_int_fns(chk, dev)
    conf_model, conf_tables, conf_golden = phase_conformer_golden(dev)
    phase_int_attention(chk, dev, conf_tables)
    phase_conv_block(chk, dev, conf_tables)
    log(f"[3] {chk.n} kernel-vs-plain comparisons pass at tolerance exact "
        f"(torch.equal); max |d| {chk.max_err}")
    report["conformer_golden"] = conf_golden

    model, tables = phase_golden(dev)
    counts = phase_serve(model, tables, dev)
    conf_counts = phase_conformer_serve(conf_model, conf_tables, dev)
    counts.update({k: conf_counts[k] for k in ("int_attention", "conv_block")})
    phase_time(chk, model, tables, dev, card, report)
    phase_conformer_time(chk, conf_model, conf_tables, dev, card, report)
    log(f"[6] {chk.n} kernel-vs-plain comparisons in all, the main paths' shapes included, "
        f"exact; max |d| {chk.max_err}")

    rows = report["quartznet_per_kernel"] + report["conformer_per_kernel"]
    kernels = []
    for kind, replaces, label in [
            ("dw_conv", "qasr_tpu/kernels/cm_fused.py:248", "C=512 K=75"),
            ("pw_gemm", "qasr_tpu/kernels/cm_fused.py:131", "512->512 requant"),
            ("int_attention", "qasr_tpu/kernels/int_attention.py:170", "int_attention B="),
            ("conv_block", "qasr_tpu/kernels/conf_module.py:341", "conv_block B=")]:
        r = next(r for r in rows if label in r["shape"])
        kernels.append({"name": kind, "route": "cuda",
                        "source": f"qasr_tpu_torch/kernels/csrc/{kind}.cu",
                        "replaces": replaces, "launches": counts[kind],
                        "max_abs_err": chk.max_err[kind], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
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
