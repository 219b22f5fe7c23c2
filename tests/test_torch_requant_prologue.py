"""The plain versions of Kernel 1's and Kernel 2's input-requant prologues
and of Kernel 7 (the requant kernel) against the JAX package's Pallas
kernels in interpret mode, as the JAX package's own tests run them on the
CPU:

  #9  depthwise_fused_requant   Kernel 1, prologue + epilogue, stride 1
  #8  fused_dw_win_i32          Kernel 1, int32 prologue with the
                                producer's bias and ReLU
  #6  fused_dw_cm               Kernel 1, stride 2 with the epilogue, on
                                windows gathered by dw_mxu.dw_gather_cm
  #7  fused_dw_win_tm           Kernel 1 on the tile-major layout
  #11 requant_pointwise_matmul  Kernel 2, prologue, no epilogue
  #10 requant_pallas            Kernel 7, per-channel exponents, with and
                                without the identity

at tiny shapes (C <= 16, B <= 2, one or two 128-frame tiles).  On CPU
tensors the wrappers run these plain versions.  Tolerance: exact.  The
CUDA kernels are held to the plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.kernels.cm_fused import (
    band_tiles_tm, fused_dw_cm, fused_dw_win_i32, fused_dw_win_tm,
)
from qasr_tpu.kernels.depthwise import depthwise_fused_requant
from qasr_tpu.kernels.dw_mxu import band_tiles_cm, dw_gather_cm, from_cm, to_cm
from qasr_tpu.kernels.pw_matmul import requant_pointwise_matmul
from qasr_tpu.kernels.requant import requant_pallas
from qasr_tpu.models.jasper import get_same_padding
from qasr_tpu.ops.quant_prims import Dyadic
from qasr_tpu.quantize.freeze import cm_mask
from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
from qasr_tpu_torch.kernels.requant import requant, requant_plain


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _m(rng, c):
    return rng.integers(2**29, 2**31 - 1, c).astype(np.int32)


@pytest.mark.parametrize("k,d,x32", [(7, 1, True), (9, 2, False)])
def test_dw_prologue_matches_depthwise_fused_requant(k, d, x32):
    """#9: input requant + mask, stride-1 taps, output requant + mask."""
    rng = np.random.default_rng(k * 10 + d)
    b, t, c = 2, 192, 16
    pad = get_same_padding(k, 1, d)
    x = (rng.integers(-2**20, 2**20, (b, t, c)).astype(np.int32) if x32
         else rng.integers(-100, 100, (b, t, c)).astype(np.int8))
    w = rng.integers(-31, 32, (k, c)).astype(np.int8)
    lens = np.asarray([t, 101], np.int32)
    m1, e1, m2, e2 = _m(rng, c), 43 if x32 else 29, _m(rng, c), 37
    want = np.asarray(depthwise_fused_requant(
        jnp.asarray(x), jnp.asarray(w[:, None, :]), jnp.asarray(lens), m1=jnp.asarray(m1),
        e1=e1, bits1=7, m2=jnp.asarray(m2), e2=e2, bits2=6, padding=pad, dilation=d,
        interpret=True))
    got = dw_conv(_t(x), _t(w), padding=pad, dilation=d, in_len=_t(lens), m1=_t(m1), e1=e1,
                  bits1=7, out_len=_t(lens), m=_t(m2), e=e2, bits=6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int8


@pytest.mark.parametrize("relu_in,relu_out", [(True, False), (False, True)])
def test_dw_prologue_matches_fused_dw_win_i32(relu_in, relu_out):
    """#8: the producer's raw int32 accumulator, its bias and ReLU applied
    by the consumer's prologue, then the taps and the consumer epilogue."""
    rng = np.random.default_rng(3 + relu_in)
    b, n_t, c, k, d = 2, 1, 16, 9, 1
    t = 128 * n_t
    pad = get_same_padding(k, 1, d)
    x = rng.integers(-2**20, 2**20, (b, t, c)).astype(np.int32)
    w = rng.integers(-31, 32, (k, c)).astype(np.int8)
    bias = rng.integers(-2**18, 2**18, c).astype(np.int32)
    lens = np.asarray([t, 77], np.int32)
    m1, m2 = _m(rng, c), _m(rng, c)
    band3, j_min = band_tiles_cm(w[:, None, :], 1, d, pad)
    x32 = to_cm(jnp.asarray(x)).reshape(c, 128, b * n_t)
    mask2 = cm_mask(jnp.asarray(lens), n_t).reshape(128, b * n_t)
    out = fused_dw_win_i32(x32, jnp.asarray(band3.reshape(-1, band3.shape[2])), j_min, b,
                           jnp.asarray(bias), mask2, jnp.asarray(m1), 43, jnp.asarray(m2), 37,
                           7, relu_in, relu_out, interpret=True)
    want = np.asarray(from_cm(out.reshape(c, 128, b, n_t)))
    got = dw_conv_plain(_t(x), _t(w), padding=pad, dilation=d, in_bias=_t(bias),
                        in_relu=relu_in, in_len=_t(lens), m1=_t(m1), e1=43, bits1=7,
                        relu=relu_out, out_len=_t(lens), m=_t(m2), e=37, bits=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dw_stride2_matches_fused_dw_cm():
    """#6: the stride-2 site (QuartzNet's C1) over pre-gathered windows."""
    rng = np.random.default_rng(6)
    b, n_to, c, k = 2, 1, 16, 11
    t_in = 2 * 128 * n_to
    pad = get_same_padding(k, 2, 1)
    x = rng.integers(-64, 64, (b, t_in, c)).astype(np.int8)
    w = rng.integers(-31, 32, (k, c)).astype(np.int8)
    bias = rng.integers(-2000, 2000, c).astype(np.int32)
    m = _m(rng, c)
    out_lens = np.asarray([128, 61], np.int32)
    band3, j_min = band_tiles_cm(w[:, None, :], 2, 1, pad)
    xg = dw_gather_cm(to_cm(jnp.asarray(x)), j_min, band3.shape[2] // 128, 2)
    out = fused_dw_cm(xg, jnp.asarray(band3), jnp.asarray(bias),
                      cm_mask(jnp.asarray(out_lens), n_to), jnp.asarray(m), 37, 7, True,
                      interpret=True)
    want = np.asarray(from_cm(out))
    got = dw_conv_plain(_t(x), _t(w), stride=2, padding=pad, bias=_t(bias), relu=True,
                        out_len=_t(out_lens), m=_t(m), e=37, bits=7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dw_matches_fused_dw_win_tm():
    """#7: the tile-major layout (B * n_t, C, 128), K=87 at dilation 1 (the
    j_min = -1 band)."""
    rng = np.random.default_rng(7)
    b, n_t, c, k, d = 2, 1, 16, 87, 1
    t = 128 * n_t
    pad = get_same_padding(k, 1, d)
    x = rng.integers(-64, 64, (b, t, c)).astype(np.int8)
    w = rng.integers(-31, 32, (k, c)).astype(np.int8)
    bias = rng.integers(-1000, 1000, c).astype(np.int32)
    m = rng.integers(2, 2**15, c).astype(np.int32)
    lens = np.asarray([t, 90], np.int32)
    band3, j_min = band_tiles_cm(w[:, None, :], 1, d, pad)
    x3 = to_cm(jnp.asarray(x)).reshape(c, 128, b * n_t)
    t_idx = 128 * np.arange(n_t)[None, :, None] + np.arange(128)[None, None, :]
    mask_tm = jnp.asarray((t_idx < lens[:, None, None]).reshape(-1, 128))
    out = fused_dw_win_tm(jnp.transpose(x3, (2, 0, 1)),
                          jnp.asarray(band_tiles_tm(band3.reshape(-1, band3.shape[2]))),
                          j_min, b, jnp.asarray(bias), mask_tm, jnp.asarray(m), 17, 7, True,
                          m16=True, interpret=True)
    want = np.asarray(from_cm(jnp.transpose(out, (1, 2, 0)).reshape(c, 128, b, n_t)))
    got = dw_conv_plain(_t(x), _t(w), padding=pad, dilation=d, bias=_t(bias), relu=True,
                        out_len=_t(lens), m=_t(m), e=17, bits=7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bias", [True, False])
def test_pw_prologue_matches_requant_pointwise_matmul(bias):
    """#11: the input requant in the GEMM's row tiles, + bias, int32 out."""
    rng = np.random.default_rng(11 + bias)
    b, t, cin, cout = 2, 70, 16, 24
    z = rng.integers(-2**20, 2**20, (b, t, cin)).astype(np.int32)
    w = rng.integers(-31, 32, (cin, cout)).astype(np.int8)
    bv = rng.integers(-3000, 3000, cout).astype(np.int32) if bias else None
    m = _m(rng, cin)
    want = np.asarray(requant_pointwise_matmul(
        jnp.asarray(z), jnp.asarray(m), 43, 7, jnp.asarray(w),
        None if bv is None else jnp.asarray(bv), interpret=True))
    got = pw_gemm(_t(z), _t(w.T), bias=None if bv is None else _t(bv), m1=_t(m), e1=43,
                  bits1=7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


@pytest.mark.parametrize("identity", [False, True])
def test_requant_matches_requant_pallas(identity):
    """#10 with per-channel exponents over 1, 31, 62, 63 and beyond."""
    rng = np.random.default_rng(10 + identity)
    b, t, c = 2, 40, 16
    z = rng.integers(-2**28, 2**28, (b, t, c)).astype(np.int32)
    m = rng.integers(1, 2**31, c).astype(np.int32)
    e = rng.permutation(np.resize(np.asarray([1, 31, 62, 63, 70, 40, 51, 45], np.int32), c))
    kw, jkw = {}, {}
    if identity:
        ident = rng.integers(-2**24, 2**24, (b, t, c)).astype(np.int32)
        m_r, e_r = _m(rng, c), e[::-1].copy()
        kw = dict(identity=_t(ident), m_r=_t(m_r), e_r=_t(e_r))
        jkw = dict(identity=jnp.asarray(ident),
                   identity_dyadic=Dyadic(jnp.asarray(m_r), jnp.asarray(e_r)))
    want = np.asarray(requant_pallas(jnp.asarray(z), Dyadic(jnp.asarray(m), jnp.asarray(e)), 7,
                                     interpret=True, **jkw))
    got = requant(_t(z), _t(m), _t(e), 7, **kw)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    assert got.dtype == torch.int8


@pytest.mark.parametrize("x32", [False, True])
def test_requant_plain_mask_relu_scalar(x32):
    """Kernel 7's mask and ReLU are the walk's (relu, then zero frames past
    the length, then requant); 0-d mantissas and exponents act as scalars;
    a 9-bit requant of a ReLU'd value is stored uint8 (its clamp [-256,
    255] reads [0, 255]); without the ReLU it is int32."""
    rng = np.random.default_rng(20 + x32)
    b, t, c = 2, 33, 29
    z = _t(rng.integers(-2**20, 2**20, (b, t, c)).astype(np.int32) if x32
           else rng.integers(-128, 128, (b, t, c)).astype(np.int8))
    lens = torch.tensor([33, 12], dtype=torch.int32)
    m0, e0 = np.asarray(2**30 + 11, np.int32), np.asarray(43 if x32 else 29, np.int32)
    got = requant(z, m0, e0, 9, relu=True, lens=lens)
    v = z.to(torch.int64).clamp_min(0) * (torch.arange(t)[None, :, None] < lens[:, None, None])
    p = v * int(m0)
    q = torch.div(p, 2 ** int(e0), rounding_mode="floor")
    rem = p - q * 2 ** int(e0)
    half = 2 ** (int(e0) - 1)
    q = q + ((rem > half) | ((rem == half) & (q % 2 == 1))).to(torch.int64)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), q.clamp(-256, 255).numpy())
    assert requant(z, m0, e0, 9, lens=lens).dtype == torch.int32
    assert torch.equal(requant(z, m0, e0, 9, relu=True, lens=lens),
                       requant_plain(z, int(m0), int(e0), 9, relu=True, lens=lens))


def test_prologue_arguments_validated():
    x = torch.zeros((1, 8, 4), dtype=torch.int8)
    w = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="prologue"):
        dw_conv(x, w, padding=1, in_relu=True)
    with pytest.raises(ValueError, match="prologue"):
        pw_gemm(x, torch.zeros((4, 4), dtype=torch.int8), in_len=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="identity"):
        requant(x, 1, 1, 8, identity=x.to(torch.int32))
