"""Kernel 1's per-channel exponents, the per_channel fold into Kernel 1, and
the tile plans of Kernels 1 and 7.

(a) dw_conv_plain with (C,) exponents e / e1 (0, 1, 62 and 63 among them:
    below 1 counts as 1, above 62 gives 0) in its prologue and epilogue
    equals the JAX composition on the same inputs: the JAX package's
    dyadic_requant around its depthwise conv (_depthwise_conv_int), with
    the FrozenExec order bias -> ReLU -> mask -> requant -> clamp.
(b) On the flagship QuartzNet15x5 per_channel tables, FrozenExecKernels
    sends 76 depthwise inputs through Kernel 1's prologue and 77 pointwise
    inputs through its epilogue, all with per-channel exponents, and
    launches the requant kernel 32 times; the result equals the plain
    FrozenExec.  (The folded executor against the JAX FrozenExec and
    FrozenExec(use_pallas=True) on the small plan with every site kind:
    tests/test_torch_slice_requant.py.)
(c) Every Kernel 1 and Kernel 7 launch of both QuartzNet modes, recorded on
    the CPU, passes the wrappers' check_launch and fits the plans (shared
    memory for three Kernel 1 blocks an SM, time tiles of at most 256
    outputs); at the serving shape (B=64, T=768) the halo is at most 1.3x at
    K=75 and 1.7x at the dilated C2 site.  A numpy model of csrc/dw_conv.cu's
    tiling (output phases, stride sub-planes, byte-shifted tap copies, the
    4-word window) reproduces dw_conv_plain at odd shapes, and the shapes the
    kernels do not take raise in check_launch.
Tolerance: exact.  The CUDA kernels are held to the plain versions on the
card by chip_smoke.py.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models.jasper import _depthwise_conv_int, get_same_padding
from qasr_tpu.models.jasper import mask_values as jax_mask_values
from qasr_tpu.ops.quant_prims import Dyadic as JaxDyadic
from qasr_tpu.ops.quant_prims import dyadic_requant as jax_dyadic_requant
from qasr_tpu.ops.quant_prims import requant_clamp as jax_requant_clamp
from qasr_tpu_torch import golden
from qasr_tpu_torch.kernels import dw_conv as port_dw
from qasr_tpu_torch.kernels import requant as port_rq
from qasr_tpu_torch.models.ctc_model import frozen_executor, make_frozen_fn
from qasr_tpu_torch.models.jasper import out_frames
from qasr_tpu_torch.quantize import freeze as port_freeze
from qasr_tpu_torch.quantize.freeze import FrozenExec, FrozenExecKernels

SM_SMEM = 233472       # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # the system's share of it per resident block


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The flagship's plain int64 walk on one intra-op thread: with several
    test workers on the same cores, torch's default thread pool makes each
    forward ~100x slower (about 2 minutes against 1.5 s); the results are
    integers and do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seed(*parts) -> int:
    return zlib.crc32(repr(parts).encode())


def _vector_e(rng, c, center):
    """(C,) exponents around ``center`` with 0, 1, 62 and 63 among them."""
    e = rng.integers(center - 3, center + 4, c)
    e[rng.permutation(c)[:4]] = [0, 1, 62, 63]
    return e.astype(np.int32)


def _jax_requant(v, m, e, bits):
    return jax_requant_clamp(jax_dyadic_requant(v, JaxDyadic(jnp.asarray(m), jnp.asarray(e))),
                             bits).astype(jnp.int8)


def _jax_dw(x, w, stride, pad, dil, *, bias=None, relu=False, out_len=None, m=None, e=None,
            bits=None, in_bias=None, in_relu=False, in_len=None, m1=None, e1=None, bits1=None):
    """The JAX FrozenExec composition around the JAX depthwise conv."""
    x = jnp.asarray(x)
    if m1 is not None:
        v = x.astype(jnp.int32)
        if in_bias is not None:
            v = v + jnp.asarray(in_bias)
        if in_relu:
            v = jnp.maximum(v, 0)
        if in_len is not None:
            v = jax_mask_values(v, jnp.asarray(in_len))
        x = _jax_requant(v, m1, e1, bits1)
    acc = _depthwise_conv_int(x, jnp.asarray(w)[:, None, :], stride, pad, dil)
    if bias is not None:
        acc = acc + jnp.asarray(bias)
    if relu:
        acc = jnp.maximum(acc, 0)
    if m is None:
        return np.asarray(acc)
    if out_len is not None:
        acc = jax_mask_values(acc, jnp.asarray(out_len))
    return np.asarray(_jax_requant(acc, m, e, bits))


# (B, T, C, K, stride, dilation): QuartzNet's site kinds at small widths
SHAPES = [(2, 64, 16, 7, 1, 1), (2, 96, 24, 11, 2, 1), (3, 80, 16, 9, 1, 2)]
MODES = ["epilogue", "prologue_int32", "prologue_int8_epilogue", "scalar_m1_e1_epilogue"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_dw_conv_plain_vector_exponents_match_jax(shape, mode):
    b, t, c, k, s, d = shape
    rng = np.random.default_rng(_seed(shape, mode))
    pad = get_same_padding(k, s, d)
    t_out = out_frames(t, k, s, pad, d)
    w = rng.integers(-31, 32, (k, c)).astype(np.int8)
    bias = rng.integers(-3000, 3000, c).astype(np.int32)
    kw = dict(bias=bias, relu=True)
    if mode != "prologue_int32":   # the consumer's requant, per channel
        kw.update(out_len=np.asarray([t_out] + [int(rng.integers(1, t_out + 1))] * (b - 1),
                                     np.int32),
                  m=rng.integers(2**30, 2**31 - 1, c).astype(np.int32),
                  e=_vector_e(rng, c, 37), bits=6 if s == 1 else 7)
    if mode == "epilogue":
        x = rng.integers(-64, 64, (b, t, c)).astype(np.int8)
    else:
        x32 = mode == "prologue_int32"
        x = (rng.integers(-2**20, 2**20, (b, t, c)).astype(np.int32) if x32
             else rng.integers(-128, 128, (b, t, c)).astype(np.int8))
        kw.update(in_len=np.asarray([t] + [int(rng.integers(1, t + 1))] * (b - 1), np.int32),
                  in_relu=True, bits1=7)
        if x32:
            kw["in_bias"] = rng.integers(-2**18, 2**18, c).astype(np.int32)
        if mode == "scalar_m1_e1_epilogue":   # one scale for all channels, after a join
            kw.update(m1=np.asarray(2**30 + 12345, np.int32), e1=np.asarray(33, np.int32))
        else:
            kw.update(m1=rng.integers(2**30, 2**31 - 1, c).astype(np.int32),
                      e1=_vector_e(rng, c, 45 if x32 else 31))
    want = _jax_dw(x, w, s, pad, d, **kw)
    port_kw = {n: (_t(v) if isinstance(v, np.ndarray) and v.ndim else v) for n, v in kw.items()}
    got = port_dw.dw_conv(_t(x), _t(w), stride=s, padding=pad, dilation=d, **port_kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == (torch.int32 if mode == "prologue_int32" else torch.int8)
    # the exponents spread the results: some in the clamp, some at its ends
    if got.dtype == torch.int8:
        lo = -2 ** (kw["bits"] - 1)
        assert (got > lo).any() and (got < -lo - 1).any() and (got == 0).any()


# ---------------------------------------------------------------------------
# (b) the per_channel fold on the flagship
# ---------------------------------------------------------------------------


def _record(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, recording)
    return calls


@pytest.fixture(scope="module")
def quartznet():
    return golden.quartznet15x5_w6a6()


@pytest.fixture(scope="module")
def quartznet_tables(quartznet):
    return {mode: quartznet.freeze(mode, device="cpu") for mode in ("static_e", "per_channel")}


def _is_vector(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dim() == 1


def test_per_channel_fold_into_kernel1(quartznet, quartznet_tables, monkeypatch):
    model, tables = quartznet, quartznet_tables["per_channel"]
    assert frozen_executor(tables) is FrozenExecKernels
    feats, lens = golden.golden_features(model.plan.feat_in)
    want = golden.frozen_from_features(model, tables, feats, lens, executor=FrozenExec)
    got = golden.frozen_from_features(model, tables, feats, lens, executor=FrozenExecKernels)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the serving function's calls (the record above also asks for the
    # decoder's input on its own)
    dw_calls = _record(monkeypatch, port_freeze, "dw_conv")
    rq_calls = _record(monkeypatch, port_freeze, "requant")
    make_frozen_fn(model, tables)(np.zeros((1, 4000), np.int16), np.asarray([4000]))
    assert len(dw_calls) == 77 and len(rq_calls) == 32
    prologue = [kw for _, kw in dw_calls if kw.get("m1") is not None]
    epilogue = [kw for _, kw in dw_calls if kw.get("m") is not None]
    # every depthwise conv but C1 (its input is the quantized features)
    # requantizes its input in the prologue, and every one hands its
    # pointwise consumer int8 through the epilogue
    assert len(prologue) == 76 and len(epilogue) == 77
    assert all(_is_vector(kw["e"]) and _is_vector(kw["m"]) for kw in epilogue)
    # per-channel exponents, except the 15 block inputs after a residual join
    # (one scale for the tensor: 0-d m1 and e1)
    assert sum(_is_vector(kw["e1"]) and _is_vector(kw["m1"]) for kw in prologue) == 61
    assert all(kw["in_len"] is not None and kw["bits1"] <= 8 for kw in prologue)
    # what stays in the requant kernel: residual-branch and C3 inputs (masked),
    # the joins (an identity), the decoder's input (unmasked)
    joins = [kw for _, kw in rq_calls if kw.get("identity") is not None]
    masked = [kw for _, kw in rq_calls if kw.get("identity") is None and kw.get("lens") is not None]
    assert (len(joins), len(masked)) == (15, 16)
    assert port_freeze.kernel_launches(model.plan, tables) == {
        "dw_conv": 77, "pw_gemm": 94, "requant": 32}


# ---------------------------------------------------------------------------
# (c) the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dyadic", ["static_e", "per_channel"])
def test_kernel1_and_kernel7_plans_take_every_quartznet_launch(quartznet, quartznet_tables,
                                                               monkeypatch, dyadic):
    model, tables = quartznet, quartznet_tables[dyadic]
    dw_calls = _record(monkeypatch, port_freeze, "dw_conv")
    rq_calls = _record(monkeypatch, port_freeze, "requant")
    pcm = (np.random.default_rng(5).normal(size=(2, 16000)) * 3000).astype(np.int16)
    make_frozen_fn(model, tables)(pcm, np.asarray([16000, 11000]))
    counts = port_freeze.kernel_launches(model.plan, tables)
    assert len(dw_calls) == counts["dw_conv"] == 77
    assert len(rq_calls) == counts.get("requant", 0)
    sites = set()
    for (x, w), kw in dw_calls:
        b, t_in, c = x.shape
        k, s, pad, d = w.shape[0], kw["stride"], kw["padding"], kw["dilation"]
        p = port_dw.check_launch(b, t_in, c, k, s, pad, d, kw.get("m1") is not None, x.dtype)
        assert p == port_dw.plan(b, out_frames(t_in, k, s, pad, d), c, k, s, d)
        assert p["tt"] <= 256 and p["nt"] <= port_dw.MAX_NT
        assert SM_SMEM // (p["smem"] + BLOCK_RESERVED) >= 3, p
        sites.add((c, k, s, d))
    assert {(64, 33, 2, 1), (256, 33, 1, 1), (512, 75, 1, 1), (512, 87, 1, 2)} <= sites
    for (z, m, e, bits), kw in rq_calls:
        b, t, c = z.shape
        p = port_rq.check_launch(b, t, c, bits)
        assert p == port_rq.plan(b, t, c)
        assert p["v"] == 4 and p["block"] == (min(c // 4, 32), 256 // min(c // 4, 32)), (c, p)
    # at the serving shape: a 256-output tile at K=75 (halo 1.3x) and C2's
    # 192 outputs of one phase (halo 1.46x, against 3.7x for 64 frames)
    for (c, k, s, d), tt, halo in [((512, 75, 1, 1), 256, 1.3), ((512, 87, 1, 2), 192, 1.7)]:
        p = port_dw.plan(64, 768, c, k, s, d)
        staged = 4 * (4 * p["nt"] + p["groups"])    # frames a block stages per sub-plane
        assert p["tt"] == tt and staged / tt <= halo, p


def _model_kernel1(x, w, stride, pad, dil):
    """csrc/dw_conv.cu's tiling in numpy: for each block (phase q, tile) and
    thread row, the sub-plane words it stages, the byte-shifted tap copies
    and the 4-word window of its 16 outputs, summed as the dp4a products."""
    b, t_in, c = x.shape
    k = w.shape[0]
    t_out = out_frames(t_in, k, stride, pad, dil)
    p = port_dw.plan(b, t_out, c, k, stride, dil)
    nt, groups, tiles = p["nt"], p["groups"], p["tiles"]
    wp, ng = 4 * nt + groups, groups + 1
    out = np.zeros((b, t_out, c), np.int64)
    seen = np.zeros(t_out, np.int64)
    xp = np.zeros((b, t_in + 1, c), np.int64)
    xp[:, :t_in] = x                        # frame t_in (and beyond) reads as padding
    for blk in range(p["grid"][0]):
        q, tile = divmod(blk, tiles)
        u0 = tile * 16 * nt
        base, step = (q + dil * u0) * stride - pad, dil * stride
        frames = base + np.arange(stride)[:, None] * dil + step * np.arange(4 * wp)[None, :]
        idx = np.where((frames >= 0) & (frames < t_in), frames, t_in)
        planes = xp[:, idx]                                      # (B, s, 4*wp, C)
        kp = 4 * np.arange(ng)[:, None, None] + np.arange(4)[None, None, :] \
            - np.arange(4)[None, :, None]                        # (g, j, i)
        taps = np.arange(stride)[:, None, None, None] + stride * kp[None]
        ok = (kp[None] >= 0) & (taps < k)
        shifted = np.where(ok[..., None], w[np.clip(taps, 0, k - 1)], 0)  # (s, g, j, i, C)
        for ty in range(nt):
            acc = np.zeros((b, 16, c), np.int64)
            for g in range(ng):
                for a in range(4):
                    n = 4 * ty + a + g
                    assert n < wp
                    word = planes[:, :, 4 * n:4 * n + 4]             # (B, s, i, C)
                    for j in range(4):
                        acc[:, 4 * a + j] += (word * shifted[None, :, g, j]).sum(axis=(1, 2))
            ts = q + dil * (u0 + 16 * ty + np.arange(16))
            keep = ts < t_out
            out[:, ts[keep]] = acc[:, keep]
            seen[ts[keep]] += 1
    assert (seen == 1).all(), "every output once"
    return out


@pytest.mark.parametrize("c,k,s,d,t", [(4, 33, 2, 1, 37), (4, 75, 1, 1, 300), (4, 87, 1, 2, 170),
                                       (4, 5, 1, 3, 50), (4, 7, 3, 1, 61), (4, 9, 2, 2, 45),
                                       (4, 3, 1, 1, 1)])
def test_kernel1_tiling_model_matches_plain(c, k, s, d, t):
    rng = np.random.default_rng(k * 100 + s * 10 + d)
    pad = get_same_padding(k, s, d) if min(s, d) == 1 else 3
    x = rng.integers(-128, 128, (2, t, c)).astype(np.int8)
    w = rng.integers(-128, 128, (k, c)).astype(np.int8)
    want = port_dw.dw_conv_plain(_t(x), _t(w), stride=s, padding=pad, dilation=d).numpy()
    got = _model_kernel1(x.astype(np.int64), w.astype(np.int64), s, pad, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("args", [
    (2, 2, 32, 5, 1, 0, 1, True, torch.int8),         # empty output
    (2, 64, 32, 5, 1, 2, 1, False, torch.int32),      # int32 input without the prologue
    (70000, 64, 32, 5, 1, 2, 1, False, torch.int8),   # batch beyond the grid's z
    (2, 64, 32, 0, 1, 0, 1, False, torch.int8),       # no taps
    (2, 64, 32, 20000, 1, 10000, 1, False, torch.int8),  # taps beyond shared memory
])
def test_kernel1_check_launch_refuses(args):
    with pytest.raises(ValueError):
        port_dw.check_launch(*args)


@pytest.mark.parametrize("args", [(2**16, 2**8, 2**8, 7), (2, 64, 32, 1), (2, 64, 32, 33),
                                  (70000, 4, 64, 7)])
def test_kernel7_check_launch_refuses(args):
    with pytest.raises(ValueError):
        port_rq.check_launch(*args)


def test_kernel7_plan_element_path():
    """C = 29 (the decoder's classes) and a tensor off a 16-byte boundary
    take one channel a thread; C = 512 takes 4, a warp's 32 lanes on 128
    channels."""
    assert port_rq.plan(4, 100, 29)["v"] == 1
    assert port_rq.plan(4, 100, 512, aligned=False)["v"] == 1
    p = port_rq.plan(64, 768, 512)
    assert (p["v"], p["block"], p["rows"], p["grid"]) == (4, (32, 8), 32, (24, 4, 64))
