"""The port's integer Conformer ops against the JAX package's, under
QASR_FAST_IDIV=0 (the canonical integer forms the port copies) and under
the default (the f32 forms the JAX package claims exact).  Tolerance:
exact (torch.equal / assert_array_equal), over whole domains where the
domain is small."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qasr_tpu.ops import integer_layernorm as jl
from qasr_tpu.ops import integer_sigmoid as jsig
from qasr_tpu.ops import integer_softmax as jsm
from qasr_tpu.ops import quant_prims as jq
from qasr_tpu_torch.ops import integer_layernorm as pl
from qasr_tpu_torch.ops import integer_sigmoid as psig
from qasr_tpu_torch.ops import integer_softmax as psm
from qasr_tpu_torch.ops import quant_prims as pq

FAST = pytest.mark.parametrize("fast", ["0", "1"])


def _j(x):
    return jnp.asarray(x)


def test_constants_match():
    for name in ("N_IN", "S_IN", "Q_LN2", "Q_B", "Q_C", "_PRESHIFT"):
        assert getattr(psm, name) == getattr(jsm, name), name
    assert psig.K_SIG == jsig.K_SIG and psig._E0 == jsig._E0
    assert (pl._K, pl._SB) == (jl._K, jl._SB)


@FAST
def test_i_exp_exhaustive(monkeypatch, fast):
    """All 16,384 inputs of the i-exp domain [-N_IN, 0]."""
    monkeypatch.setenv("QASR_FAST_IDIV", fast)
    q = np.arange(-psm.N_IN, 1, dtype=np.int32)
    got = psm.i_exp(torch.from_numpy(q))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsm.i_exp(_j(q))))


@FAST
def test_i_sigmoid_grid_whole_grid(monkeypatch, fast):
    """[-N_IN-64, N_IN+64]: the saturated ends included."""
    monkeypatch.setenv("QASR_FAST_IDIV", fast)
    q = np.arange(-psm.N_IN - 64, psm.N_IN + 65, dtype=np.int32)
    np.testing.assert_array_equal(psig.i_sigmoid_grid(torch.from_numpy(q)).numpy(),
                                  np.asarray(jsig.i_sigmoid_grid(_j(q))))


def test_i_sqrt_exhaustive_ln_domain():
    """Every value the i-LN core takes the root of, var << 12 for var in
    [0, 2^16] (65,537 values): the port's integer digit-by-digit root is
    floor(sqrt(n)) and equals the JAX package's float32-seeded Newton
    root and its f32 floor_sqrt."""
    from qasr_tpu.ops.fast_int import floor_sqrt

    v = np.arange(0, 2 ** 16 + 1, dtype=np.int64) << 12
    got = pl.i_sqrt(torch.from_numpy(v.astype(np.int32))).numpy().astype(np.int64)
    assert np.all(got * got <= v) and np.all((got + 1) * (got + 1) > v)
    np.testing.assert_array_equal(got, np.asarray(jl.i_sqrt(_j(v.astype(np.int32)))))
    np.testing.assert_array_equal(got, np.asarray(floor_sqrt(_j(v.astype(np.int32)))))


def test_i_sqrt_fuzz_int32():
    rng = np.random.default_rng(3)
    v = np.concatenate([rng.integers(0, 2 ** 31 - 1, 200_000),
                        np.asarray([0, 1, 2, 3, 4, 2 ** 30, 2 ** 31 - 1, -5])])
    got = pl.i_sqrt(torch.from_numpy(v.astype(np.int32))).numpy().astype(np.int64)
    want = np.asarray([int(np.floor(np.sqrt(max(x, 0)))) for x in v.tolist()], np.int64)
    # float64 sqrt is exact enough to find floor below 2^31 after a fix-up
    want = np.where((want + 1) ** 2 <= np.maximum(v, 0), want + 1, want)
    want = np.where(want ** 2 > np.maximum(v, 0), want - 1, want)
    np.testing.assert_array_equal(got, want)


@FAST
@pytest.mark.parametrize("d", [64, 256])
def test_i_layernorm_core_rows(monkeypatch, fast, d):
    """Random rows, constant rows (var 0), near-constant rows and rows with
    a negative mean: the signed rounded mean and the floor division of
    negative (d << 16) are where C-style truncation would differ."""
    monkeypatch.setenv("QASR_FAST_IDIV", fast)
    rng = np.random.default_rng(d)
    x = rng.integers(-128, 128, size=(64, d)).astype(np.int8)
    x[0] = 0
    x[1] = 5
    x[2] = -128
    x[3, : d // 2], x[3, d // 2:] = -3, -4
    x[4] = rng.integers(-2, 1, size=d)
    x[5] = -rng.integers(0, 128, size=d)
    got = pl.i_layernorm_core(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jl.i_layernorm_core(_j(x))))


@FAST
def test_i_softmax_grid_with_masks(monkeypatch, fast):
    """Masked pairs, a fully masked row (denominator 1, zeros out) and
    scores spread past the N_IN clip."""
    monkeypatch.setenv("QASR_FAST_IDIV", fast)
    rng = np.random.default_rng(5)
    g = rng.integers(-60_000, 60_000, size=(2, 3, 19, 19)).astype(np.int32)
    mask = rng.random((2, 1, 19, 19)) < 0.3
    mask[0, 0, 4, :] = True
    got = psm.i_softmax_grid(torch.from_numpy(g), torch.from_numpy(mask), out_bits=8)
    want = np.asarray(jsm.i_softmax_grid(_j(g), mask=_j(mask), out_bits=8))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0, :, 4].abs().sum()) == 0


def test_floor_div_matches_jnp_on_signed_grids():
    """floor semantics for negative numerators and a negative constant
    divisor (i_exp's Q_LN2)."""
    n = np.arange(-20_000, 20_001, dtype=np.int32)
    for d in (psm.Q_LN2, 568, 7, -3, 1):
        np.testing.assert_array_equal(psm.floor_div(torch.from_numpy(n), d).numpy(),
                                      np.asarray(jnp.floor_divide(_j(n), d)))
    rng = np.random.default_rng(9)
    a = rng.integers(-2 ** 24, 2 ** 24, 100_000).astype(np.int32)
    b = rng.integers(1, 4096, 100_000).astype(np.int32)
    np.testing.assert_array_equal(
        psm.floor_div(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jnp.floor_divide(_j(a), _j(b))))


def test_symmetric_scale_and_quantize_match_jax():
    rng = np.random.default_rng(11)
    w = rng.uniform(-0.3, 0.3, size=(64, 29)).astype(np.float32)
    ps = pq.symmetric_scale(torch.from_numpy(w.min(0)), torch.from_numpy(w.max(0)), 8)
    js = jq.symmetric_scale(_j(w.min(0)), _j(w.max(0)), 8)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pq.quantize(torch.from_numpy(w), ps, 8).numpy(),
                                  np.asarray(jq.quantize(_j(w), js, 8)))
