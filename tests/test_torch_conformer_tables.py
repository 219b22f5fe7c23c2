"""The integer pieces of Kernels 3 and 4 that have no CPU kernel to run,
held against the JAX package on their whole domains, and numpy models of
the kernels' tilings against the plain functions:

- Kernel 4's i-swish table (``conv_block.swish_table``) of every layer of
  a small frozen Conformer, at all 256 int8 inputs, against the JAX
  composition of ``conformer_freeze._conv_tail_mid`` after its BN;
- the GLU gate's sigmoid table (``conv_block.sigmoid_table``), read as
  ``qasr_i_sigmoid_tab`` reads it, against ``qasr_tpu``'s
  ``i_sigmoid_grid`` over its whole domain and the requant's extremes;
- Kernel 3's division by the row sum (``qasr_div``, Granlund-Montgomery)
  over every divisor in [1, 2^20] against a grid of numerators, and over
  random pairs up to the numerator bound 2^31;
- the Toeplitz pos-window index of Kernel 3 at its 32 query rows a block
  against the plain bd gather, and Kernel 4 stage B's halo, tap
  packing (``pack_taps``) and time-packed dp4a walk against
  ``depthwise_int``.

Tolerance: exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qasr_tpu.quantize.conformer_freeze as CF
from qasr_tpu.models.conformer import ConformerConfig, init_conformer_params
from qasr_tpu.ops.integer_sigmoid import i_sigmoid_grid as jax_sigmoid
from qasr_tpu.ops.quant_prims import dyadic_requant_static
from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig, calibrate_conformer
from qasr_tpu_torch.compat.from_jax import conformer_tables_from_jax
from qasr_tpu_torch.kernels import int_attention as port_att
from qasr_tpu_torch.kernels.conv_block import (
    ROWS,
    SIG_TAB,
    _f64_scales,
    pack_taps,
    sigmoid_table,
    swish_table,
    tap_groups,
)
from qasr_tpu_torch.quantize.conformer_int import depthwise_int

N_IN, K_SIG = 16383, 7


@pytest.fixture(scope="module")
def frozen_small():
    cfg = ConformerConfig(feat_in=32, n_layers=2, d_model=64, n_heads=4,
                          subsampling="striding", subsampling_factor=4,
                          subsampling_conv_channels=16, conv_kernel_size=9, dropout=0.0)
    qcfg = ConformerQuantConfig(weight_bit=8, act_bit=8, quantize_attention=True,
                                integer_softmax=True, integer_layernorm=True,
                                integer_activations=True, static_attention=True)
    params = init_conformer_params(0, cfg)
    rng = np.random.default_rng(7)
    batches = [(rng.normal(size=(3, 70, 32)).astype(np.float32),
                np.asarray([70, 55, 61], np.int32)) for _ in range(2)]
    qstate = jax.tree_util.tree_map(np.asarray,
                                    calibrate_conformer(params, cfg, qcfg, batches))
    tables = CF.freeze_conformer(params, cfg, qcfg, qstate)
    return tables, conformer_tables_from_jax(tables, "cpu")


@pytest.mark.parametrize("nbits", [8, 6])
def test_swish_table_matches_jax_every_layer(frozen_small, nbits):
    jt, pt = frozen_small
    bn8 = np.arange(-128, 128, dtype=np.int32)
    n = 2 ** (nbits - 1) - 1
    for layer, (jl, plyr) in enumerate(zip(jt["layers"], pt["layers"])):
        s_grid = dyadic_requant_static(jnp.asarray(bn8), jnp.asarray(jl["bn_grid"][0]),
                                       jl["bn_grid"][1])
        y = jnp.asarray(bn8) * jax_sigmoid(s_grid)
        want = np.clip(np.asarray(dyadic_requant_static(y, jnp.asarray(jl["bn_prod"][0]),
                                                        jl["bn_prod"][1])), -n, n - 1)
        got = swish_table(plyr, nbits)
        assert got.dtype == torch.uint8 and tuple(got.shape) == (256,)
        np.testing.assert_array_equal(got.view(torch.int8).numpy().astype(np.int32), want,
                                      err_msg=f"layer {layer}")


def _sigmoid_tab_model(tab: np.ndarray, q: np.ndarray) -> np.ndarray:
    """qasr_i_sigmoid_tab: the table at min(|q|, SIG_TAB - 1), mirrored for q < 0."""
    s = tab[np.minimum(np.abs(q), SIG_TAB - 1)].astype(np.int64)
    return np.where(q >= 0, s, (1 << K_SIG) - s)


def test_sigmoid_table_matches_jax_whole_domain():
    tab = sigmoid_table("cpu").numpy()
    assert tab.dtype == np.uint8 and tab.shape == (SIG_TAB,) and tab[-1] == 1 << K_SIG
    q = np.concatenate([np.arange(-N_IN - 64, N_IN + 65),
                        [-(1 << 26), -(1 << 26) + 1, (1 << 26) - 1, 1 << 26, -(1 << 30), 1 << 30]
                        ]).astype(np.int32)
    want = np.asarray(jax_sigmoid(jnp.asarray(q)))
    np.testing.assert_array_equal(_sigmoid_tab_model(tab, q), want)


def _div_model(n: np.ndarray, d: np.ndarray) -> np.ndarray:
    """qasr_div_make / qasr_div (conformer_int.cuh) in uint64 arithmetic."""
    n, d = n.astype(np.uint64), d.astype(np.uint64)
    l = _bit_length(d - np.uint64(1))                       # ceil(log2 d)
    m = ((((np.uint64(1) << l) - d) << np.uint64(32)) // d + np.uint64(1)) & np.uint64(0xffffffff)
    s1 = np.minimum(l, np.uint64(1))
    s2 = np.where(l > 1, l - np.uint64(1), np.uint64(0))
    t = (m * n) >> np.uint64(32)
    return ((t + ((n - t) >> s1)) >> s2).astype(np.int64)


def _bit_length(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape, np.uint64)
    for b in range(32):
        out[(x >> np.uint64(b)) > 0] = b + 1
    return out


def test_row_division_model_exact():
    d = np.arange(1, (1 << 20) + 1, dtype=np.int64)
    top = (1 << 31) - 1
    mult = top - top % d
    # the largest numerator the softmax forms: i_exp(0) >> 4 times 127 plus den / 2
    grid = [np.zeros_like(d), np.ones_like(d), d - 1, d, d + 1, 2 * d - 1, mult, mult - 1,
            np.full_like(d, top), 116_970 * 127 + d // 2]
    for n in grid:
        np.testing.assert_array_equal(_div_model(n, d), n // d)
    rng = np.random.default_rng(20)
    for dmax in (300_000_000, (1 << 31) - 1):
        n = rng.integers(0, 1 << 31, 1 << 20)
        dd = rng.integers(1, dmax + 1, 1 << 20)
        np.testing.assert_array_equal(_div_model(n, dd), n // dd)


@pytest.mark.parametrize("t", [1, 31, 33, 37, 64, 96, 129, 200])
def test_pos_window_index_model(t):
    """Per (query tile i0, key chunk j0) the kernel multiplies qv by the
    TQ + 64 pos rows from T-1+i0-j0-63 (zero outside [0, 2T-1)) and reads
    score (il, jl) at window column il - jl + 63: the plain bd gather."""
    tq, kc = port_att.TQ, port_att.KC
    rng = np.random.default_rng(t)
    dk = 8
    qv = rng.integers(-127, 127, (t, dk))
    pos = rng.integers(-127, 127, (2 * t - 1, dk))
    ar = np.arange(t)
    want = (qv @ pos.T)[ar[:, None], (t - 1) + ar[:, None] - ar[None, :]]
    got = np.zeros((t, t), np.int64)
    tp = -(-t // kc) * kc
    for i0 in range(0, t, tq):
        q_tile = np.zeros((tq, dk), np.int64)
        q_tile[:min(tq, t - i0)] = qv[i0:i0 + tq]
        for j0 in range(0, tp, kc):
            pbase = t - 1 + i0 - j0 - (kc - 1)
            win = np.zeros((tq + kc, dk), np.int64)
            for r in range(tq + kc):
                if 0 <= pbase + r < 2 * t - 1:
                    win[r] = pos[pbase + r]
            bd = q_tile @ win.T
            for il in range(min(tq, t - i0)):
                for jl in range(min(kc, t - j0)):
                    got[i0 + il, j0 + jl] = bd[il, il - jl + kc - 1]
    np.testing.assert_array_equal(got, want)


def _dp4a(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    xb = x.astype(np.uint32).view(np.int8).reshape(*x.shape, 4).astype(np.int64)
    wb = w.astype(np.uint32).view(np.int8).reshape(*w.shape, 4).astype(np.int64)
    return (xb * wb).sum(-1)


def _funnel(lo: np.ndarray, hi: np.ndarray, s: int) -> np.ndarray:
    lo, hi = lo.astype(np.uint64), hi.astype(np.uint64)
    return (((hi << np.uint64(s)) | (lo >> np.uint64(32 - s))) & np.uint64(0xffffffff)
            ).astype(np.uint32)


def _stage_b_model(glu8: np.ndarray, dw_p: np.ndarray, k_size: int, pad_l: int) -> np.ndarray:
    """conv_block.cu stage B's depthwise: per 32-frame tile, glu8 frames
    t0 - pad_l + 4w + i staged as words (zero outside [0, T)), then per
    16-frame task the dp4a walk over ng tap groups with the taps shifted by
    j bytes (funnel shifts of P[g - 1], P[g])."""
    b, t, d = glu8.shape
    ng, ngp = tap_groups(k_size)
    nw = ROWS // 4 + ng - 1
    p = dw_p.view(np.uint32)                                   # (d, ngp)
    out = np.zeros((b, t, d), np.int64)
    for t0 in range(0, t, ROWS):
        frames = t0 - pad_l + np.arange(4 * nw)
        ok = (frames >= 0) & (frames < t)
        staged = np.zeros((b, 4 * nw, d), np.int8)
        staged[:, ok] = glu8[:, frames[ok]]
        words = np.ascontiguousarray(staged.transpose(0, 2, 1)).view(np.uint32)  # (b, d, nw)
        for fg in range(ROWS // 16):
            acc = np.zeros((b, d, 16), np.int64)
            for g in range(ng):
                pg, pl = p[:, 1 + g], p[:, g]
                shifted = [pg] + [_funnel(pl, pg, 8 * j) for j in (1, 2, 3)]
                for a in range(4):
                    x = words[:, :, 4 * fg + a + g]
                    for j in range(4):
                        acc[:, :, 4 * a + j] += _dp4a(x, shifted[j][None])
            u0 = t0 + 16 * fg
            n = max(0, min(16, t - u0))
            out[:, u0:u0 + n] = acc[:, :, :n].transpose(0, 2, 1)
    return out


@pytest.mark.parametrize("t", [1, 31, 375])
@pytest.mark.parametrize("d", [64, 256, 512])
def test_stage_b_depthwise_model(t, d):
    k_size, pad = 31, (15, 15)
    rng = np.random.default_rng(t * 7 + d)
    b = 2 if t == 375 else 3
    glu8 = rng.integers(-128, 128, (b, t, d)).astype(np.int8)
    w = torch.from_numpy(rng.integers(-128, 128, (k_size, d)).astype(np.int8))
    dw_p = pack_taps(w)
    ng, ngp = tap_groups(k_size)
    assert tuple(dw_p.shape) == (d, ngp) and ngp % 2 == 1 and dw_p.dtype == torch.int32
    taps = dw_p.numpy().view(np.int8).reshape(d, 4 * ngp)
    assert (taps[:, :4] == 0).all() and (taps[:, 4 + k_size:] == 0).all()
    np.testing.assert_array_equal(taps[:, 4:4 + k_size], w.numpy().T)
    want = depthwise_int(torch.from_numpy(glu8), w, pad).numpy()
    np.testing.assert_array_equal(_stage_b_model(glu8, dw_p.numpy(), k_size, pad[0]), want)


def test_stage_b_model_causal_and_short_kernel():
    """A causal padding (K-1, 0) and the small test model's K=9."""
    rng = np.random.default_rng(9)
    for k_size, pad in ((9, (8, 0)), (9, (4, 4)), (4, (3, 0))):
        glu8 = rng.integers(-128, 128, (2, 45, 64)).astype(np.int8)
        w = torch.from_numpy(rng.integers(-128, 128, (k_size, 64)).astype(np.int8))
        want = depthwise_int(torch.from_numpy(glu8), w, pad).numpy()
        np.testing.assert_array_equal(
            _stage_b_model(glu8, pack_taps(w).numpy(), k_size, pad[0]), want)


@pytest.mark.parametrize("site", ["pw2", "glu_prod"])
def test_f64_domain_needs_exponent_at_least_one(frozen_small, site):
    """Kernel 4 requants on the FP64 pipe only where qasr_rq_f64 equals
    qasr_rq: with a mantissa of 1 the product bound holds at any exponent,
    and an exponent below 1 (which qasr_rq counts as 1 and m 2^-e does
    not) alone sends the layer to qasr_rq."""
    _, pt = frozen_small
    for layer in pt["layers"]:
        assert _f64_scales(layer)[1]
        for e, ok in ((1, True), (0, False), (-3, False)):
            bent = dict(layer)
            if site == "glu_prod":
                bent["glu_prod"] = (1, e)
            else:
                bent[site] = {**layer[site], "m": torch.ones_like(layer[site]["m"]), "e": e}
            assert _f64_scales(bent)[1] is ok, (site, e)
