"""The port's FFN-module and GEMM-epilogue kernels of the frozen Conformer
(Kernel 5 ``lin_epilogue``, Kernel 6 ``ffn_ln``) and the fused plans.

(a) The plain versions, which the wrappers run on CPU tensors, against the
    JAX package's Pallas kernels in interpret mode (``fused_lin_rq`` /
    ``fused_lin_join`` / ``fused_lin_swish``, ``fused_ffn_ln``): on the
    shapes of tests/test_gemm_fused.py (odd K and D, e > 31, several row
    tiles, no bias) and on the sites of small frozen tables (2 layers,
    d=64, 4 heads), tail on and off.
(b) The whole frozen encoder under the plans ("1", True) and ("conv",
    True) against ``frozen_conformer_apply`` with the matching
    QASR_CONF_MOD / QASR_CONF_FUSED / QASR_CONF_ATT flags (a fresh jit per
    setting): exact from the features with ``subsampling=""``, exact from
    JAX's x8 with the striding subsampler.
(c) The plan's values and launch counts; the kernels' packed rows.
Tolerance: exact throughout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qasr_tpu.quantize.conformer_freeze as CF
from qasr_tpu.kernels.conf_module import fused_ffn_ln
from qasr_tpu.kernels.gemm_fused import fused_lin_join, fused_lin_rq, fused_lin_swish
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.models.conformer import init_conformer_params
from qasr_tpu.models.conformer import subsample_convs as jax_subsample
from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig, calibrate_conformer
from qasr_tpu_torch.compat.from_jax import conformer_tables_from_jax
from qasr_tpu_torch.kernels import ffn_ln as port_ffn
from qasr_tpu_torch.kernels.ffn_ln import bm_rows, ffn_ln, ffn_ln_plain, ln_rows
from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.quantize import conformer_freeze as port_cf
from qasr_tpu_torch.quantize.conformer_freeze import ConformerPlan

SMALL = dict(feat_in=32, n_layers=2, d_model=64, n_heads=4, subsampling_factor=4,
             subsampling_conv_channels=16, conv_kernel_size=9, dropout=0.0)
QFLAGS = dict(weight_bit=8, act_bit=8, quantize_attention=True, integer_softmax=True,
              integer_layernorm=True, integer_activations=True, static_attention=True)


def _frozen(subsampling):
    cfg = JConf(subsampling=subsampling, **SMALL)
    params = init_conformer_params(0, cfg)
    rng = np.random.default_rng(7)
    batches = [(rng.normal(size=(3, 70, 32)).astype(np.float32),
                np.asarray([70, 55, 61], np.int32)) for _ in range(3)]
    qstate = jax.tree_util.tree_map(
        np.asarray, calibrate_conformer(params, cfg, ConformerQuantConfig(**QFLAGS), batches))
    tables = CF.freeze_conformer(params, cfg, ConformerQuantConfig(**QFLAGS), qstate)
    return cfg, ConformerConfig(subsampling=subsampling, **SMALL), tables, \
        conformer_tables_from_jax(tables, "cpu")


@pytest.fixture(scope="module")
def frozen_small():
    return _frozen("striding")


@pytest.fixture(scope="module")
def frozen_linear():
    return _frozen("")


def _i8(rng, *shape):
    return rng.integers(-127, 127, size=shape).astype(np.int8)


def _site(rng, k, d, e, bias=True):
    """(JAX (w (K, D), b or None, m, e), the port's linear site)."""
    w = _i8(rng, k, d)
    b = rng.integers(-(1 << 15), 1 << 15, size=(d,)).astype(np.int32) if bias else None
    m = rng.integers(1, 1 << 26, size=(d,)).astype(np.int32)
    site = {"wt": torch.from_numpy(np.ascontiguousarray(w.T)), "m": torch.from_numpy(m), "e": e}
    if bias:
        site["b"] = torch.from_numpy(b)
    return (w, b, m, e), site


def _check_wrapper(got, x8, site, **kw):
    """The wrapper runs the plain version on CPU tensors and counts nothing."""
    before = lin_epilogue.launches
    assert torch.equal(lin_epilogue(x8, site, **kw), got)
    assert lin_epilogue.launches == before


@pytest.mark.parametrize("shape,k,d,e,bias", [
    ((3, 50), 96, 200, 17, True),    # odd K/D: the Pallas padding paths
    ((7,), 128, 64, 35, True),       # e > 31; D below the 128-column tile
    ((2, 300), 256, 256, 8, True),   # several row tiles
    ((3, 50), 96, 200, 17, False),   # no bias (the pos projection)
    ((1,), 256, 256, 40, False),     # one row
])
def test_lin_epilogue_rq_matches_pallas(shape, k, d, e, bias):
    rng = np.random.default_rng(k + d + e)
    x8 = _i8(rng, *shape, k)
    (w, b, m, e), site = _site(rng, k, d, e, bias)
    want = fused_lin_rq(jnp.asarray(x8), w, b, m, e, lo=-127, hi=126, interpret=True)
    got = lin_epilogue_plain(torch.from_numpy(x8), site, nbits=8)
    assert got.dtype == torch.int8 and tuple(got.shape) == shape + (d,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_wrapper(got, torch.from_numpy(x8), site, nbits=8)


@pytest.mark.parametrize("k,d,e,m_s,e_s,bias", [
    (96, 160, 22, 123457, 14, True),
    (128, 64, 35, 2 ** 31 - 1, 33, True),   # e > 31 in both requants
    (96, 160, 22, 123457, 14, False),
])
def test_lin_epilogue_join_matches_pallas(k, d, e, m_s, e_s, bias):
    rng = np.random.default_rng(k + e_s)
    x8, s8 = _i8(rng, 2, 70, k), _i8(rng, 2, 70, d)
    (w, b, m, e), site = _site(rng, k, d, e, bias)
    want = fused_lin_join(jnp.asarray(x8), w, b, m, e, jnp.asarray(s8), m_s, e_s,
                          lo=-127, hi=126, interpret=True)
    kw = dict(stream8=torch.from_numpy(s8), stream_rq=(m_s, e_s), nbits=8)
    got = lin_epilogue_plain(torch.from_numpy(x8), site, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_wrapper(got, torch.from_numpy(x8), site, **kw)


@pytest.mark.parametrize("n,k,d,e,grid,prod", [
    (40, 64, 96, 19, (998877, 12), (445566, 24)),
    (300, 96, 200, 33, (2 ** 30 + 7, 36), (1234567, 40)),   # e > 31, two row tiles
])
def test_lin_epilogue_swish_matches_pallas(n, k, d, e, grid, prod):
    rng = np.random.default_rng(n + k)
    x8 = _i8(rng, n, k)
    (w, b, m, e), site = _site(rng, k, d, e)
    want = fused_lin_swish(jnp.asarray(x8), w, b, m, e, *grid, *prod, lo=-127, hi=126,
                           interpret=True)
    got = lin_epilogue_plain(torch.from_numpy(x8), site, swish=(grid, prod), nbits=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _check_wrapper(got, torch.from_numpy(x8), site, swish=(grid, prod), nbits=8)


def test_lin_epilogue_frozen_sites_match_pallas(frozen_small):
    """The three modes on a frozen layer's own sites: the q_u projection
    (rq), the FFN1 l1 GEMM (swish) and l2 GEMM with the j1 stream (join)."""
    _, _, jt, pt = frozen_small
    tbl, ptbl = jt["layers"][0], pt["layers"][0]
    rng = np.random.default_rng(3)
    x8, s8 = _i8(rng, 2, 37, 64), _i8(rng, 2, 37, 64)
    mid8 = _i8(rng, 2, 37, 256)

    def jsite(t):
        return t["w"], t["b"], t["m"], t["e"]
    want = {
        "rq": fused_lin_rq(jnp.asarray(x8), *jsite(tbl["att_q_u"]), lo=-127, hi=126,
                           interpret=True),
        "swish": fused_lin_swish(jnp.asarray(x8), *jsite(tbl["ff1_l1"]),
                                 int(tbl["ff1_grid"][0]), tbl["ff1_grid"][1],
                                 int(tbl["ff1_prod"][0]), tbl["ff1_prod"][1],
                                 lo=-127, hi=126, interpret=True),
        "join": fused_lin_join(jnp.asarray(mid8), *jsite(tbl["ff1_l2"]), jnp.asarray(s8),
                               int(tbl["j1_stream"][0]), tbl["j1_stream"][1],
                               lo=-127, hi=126, interpret=True)}
    x, s, mid = (torch.from_numpy(a) for a in (x8, s8, mid8))
    got = {"rq": lin_epilogue_plain(x, ptbl["att_q_u"], nbits=8),
           "swish": lin_epilogue_plain(x, ptbl["ff1_l1"], nbits=8,
                                       swish=(ptbl["ff1_grid"], ptbl["ff1_prod"])),
           "join": lin_epilogue_plain(mid, ptbl["ff1_l2"], nbits=8, stream8=s,
                                      stream_rq=ptbl["j1_stream"])}
    for mode in want:
        np.testing.assert_array_equal(got[mode].numpy(), np.asarray(want[mode]), err_msg=mode)


@pytest.mark.parametrize("layer,half,tail,b,t", [
    (0, "ff1", True, 2, 40),     # FFN1 with the ln_att tail
    (0, "ff2", True, 3, 17),     # FFN2 with ln_out into layer 1
    (1, "ff1", False, 1, 130),   # no tail; more rows than one 64-row block
    (1, "ff2", False, 2, 33),    # the last layer's FFN2: ln_out stays float
    (0, "ff1", True, 2, 1),      # T = 1
])
def test_ffn_ln_plain_matches_pallas(frozen_small, layer, half, tail, b, t):
    _, _, jt, pt = frozen_small
    rng = np.random.default_rng(100 * layer + t)
    x8 = _i8(rng, b, t, 64)
    tail_name = "ln_att" if half == "ff1" else "ln_out"
    stream = "j1_stream" if half == "ff1" else "j4_stream"

    def args(tbl):
        return (tbl[f"ln_{half}"], tbl[f"{half}_l1"], tbl[f"{half}_grid"],
                tbl[f"{half}_prod"], tbl[f"{half}_l2"], tbl[stream],
                tbl[tail_name] if tail else None)
    want, want_tail = fused_ffn_ln(jnp.asarray(x8), *args(jt["layers"][layer]), nbits=8,
                                   interpret=True)
    got, got_tail = ffn_ln_plain(torch.from_numpy(x8), *args(pt["layers"][layer]), nbits=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if tail:
        np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))
    else:
        assert got_tail is None and want_tail is None
    before = ffn_ln.launches
    k_out, k_tail = ffn_ln(torch.from_numpy(x8), *args(pt["layers"][layer]), nbits=8)
    assert torch.equal(k_out, got) and (k_tail is None) == (not tail)
    assert ffn_ln.launches == before


def test_ffn_ln_kernel_layout(frozen_small):
    """Kernel 6's packed rows: (sgn, b, m) of an i-LN site, (b, m) of a
    linear site, int32, built once and cached in the site's table."""
    _, _, _, pt = frozen_small
    tbl = pt["layers"][0]
    ln3, bm1, bm2 = ln_rows(tbl["ln_ff1"]), bm_rows(tbl["ff1_l1"]), bm_rows(tbl["ff1_l2"])
    assert tuple(ln3.shape) == (3, 64) and tuple(bm1.shape) == (2, 256) \
        and tuple(bm2.shape) == (2, 64)
    for row, name in enumerate(("sgn", "b", "m")):
        assert torch.equal(ln3[row], tbl["ln_ff1"][name])
    for row, name in enumerate(("b", "m")):
        assert torch.equal(bm1[row], tbl["ff1_l1"][name])
        assert torch.equal(bm2[row], tbl["ff1_l2"][name])
    assert all(v.dtype == torch.int32 and v.is_contiguous() for v in (ln3, bm1, bm2))
    assert ln_rows(tbl["ln_ff1"]) is ln3 and bm_rows(tbl["ff1_l1"]) is bm1
    # the kernels take the device tables' (dout, din) weights as they are
    assert tuple(tbl["ff1_l1"]["wt"].shape) == (256, 64) \
        and tuple(tbl["ff1_l2"]["wt"].shape) == (64, 256)


JAX_FLAGS = {("1", True): {"QASR_CONF_MOD": "1", "QASR_CONF_FUSED": "1", "QASR_CONF_ATT": "1"},
             ("conv", True): {"QASR_CONF_MOD": "conv", "QASR_CONF_FUSED": "1",
                              "QASR_CONF_ATT": "1"}}


@pytest.mark.parametrize("which", ["linear", "striding"])
@pytest.mark.parametrize("plan", list(JAX_FLAGS))
def test_encoder_under_plan_matches_jax_flags(request, monkeypatch, which, plan):
    """The port's encoder under a plan (kernel wrappers, plain on the CPU)
    against frozen_conformer_apply with the plan's flags set."""
    fixture = "frozen_small" if which == "striding" else "frozen_linear"
    jcfg, pcfg, jt, pt = request.getfixturevalue(fixture)
    for k, v in JAX_FLAGS[plan].items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(31)
    feats = rng.normal(size=(2, 44, 32)).astype(np.float32)
    lens = np.asarray([44, 27], np.int32)
    enc_j, el_j = (np.asarray(o) for o in jax.jit(
        lambda f, ln: CF.frozen_conformer_apply(jt, jcfg, f, ln))(jnp.asarray(feats),
                                                                   jnp.asarray(lens)))
    if which == "linear":
        x8, sub_lens = port_cf.conformer_x8(pt, pcfg, torch.from_numpy(feats),
                                            torch.from_numpy(lens))
    else:
        n = 2 ** (jt["act_bit"] - 1) - 1
        y, jl = jax_subsample(jt["subsampler"], jcfg, jnp.asarray(feats), jnp.asarray(lens))
        x8 = torch.from_numpy(np.array(jnp.clip(jnp.round(y / jt["S_pre"]), -n, n - 1)
                                        .astype(jnp.int8)))
        sub_lens = torch.from_numpy(np.array(jl))
    enc, el = port_cf.conformer_encode(pt, pcfg, x8, sub_lens, kernels=True,
                                       plan=ConformerPlan(*plan))
    np.testing.assert_array_equal(el.numpy(), el_j)
    np.testing.assert_array_equal(enc.numpy(), enc_j)


@pytest.mark.parametrize("mod,fused", [("ffn", True), ("0", True), ("", False), (1, True),
                                       ("1", 1), ("conv", "True"), ("1", None)])
def test_invalid_plan_raises(mod, fused):
    with pytest.raises(ValueError):
        ConformerPlan(mod, fused)


def test_kernel_launches_per_plan():
    cfg = ConformerConfig(feat_in=80, n_layers=16, d_model=256, n_heads=4)
    want = {("1", True): (32, 81), ("conv", True): (0, 145), ("conv", False): (0, 0),
            ("1", False): (32, 0)}
    for plan, (n_ffn, n_lin) in want.items():
        assert port_cf.kernel_launches(cfg, ConformerPlan(*plan)) == {
            "int_attention": 16, "conv_block": 16, "ffn_ln": n_ffn, "lin_epilogue": n_lin}
    assert port_cf.kernel_launches(cfg) == port_cf.kernel_launches(cfg, ConformerPlan("1", True))
    assert port_cf.DEFAULT_PLAN == ConformerPlan()


def test_ffn_ln_shared_memory_budget():
    """Kernel 6's block (32 rows): the weight stage, the LN output, the
    swish activation, the stream tile and the swish table.  Three blocks
    share an SM at the flagship d=256; d=512 with ff=4 fits one block."""
    assert port_ffn.smem_bytes(256, 1024) == 4 * (64 * 68 + 32 * (68 + 260)) + 32 * 256 + 256
    assert 3 * (port_ffn.smem_bytes(256, 1024) + 1024) <= port_ffn.SMEM_LIMIT
    assert port_ffn.smem_bytes(512, 2048) <= port_ffn.SMEM_LIMIT
    assert port_ffn.smem_bytes(512, 6144) > port_ffn.SMEM_LIMIT   # ff = 12 at d=512 raises
