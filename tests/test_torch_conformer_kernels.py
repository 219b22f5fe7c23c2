"""The plain versions of the port's Conformer kernels (Kernel 3
``int_attention``, Kernel 4 ``conv_block``) against the JAX package's
Pallas kernels in interpret mode (``fused_int_attention``,
``fused_conv_block``), on small frozen tables built the way
tests/test_conf_module.py and tests/test_int_attention.py build them (2
layers, d=64, 4 heads).  On CPU tensors the kernel wrappers run these
plain versions.  Tolerance: exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qasr_tpu.quantize.conformer_freeze as CF
from qasr_tpu.kernels.conf_module import fused_conv_block
from qasr_tpu.kernels.int_attention import fused_int_attention
from qasr_tpu.models.conformer import ConformerConfig, init_conformer_params
from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig, calibrate_conformer
from qasr_tpu_torch.compat.from_jax import conformer_tables_from_jax
from qasr_tpu_torch.kernels import int_attention as port_att
from qasr_tpu_torch.kernels.conv_block import _packed, conv_block, conv_block_plain
from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain


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
                np.asarray([70, 55, 61], np.int32)) for _ in range(3)]
    qstate = jax.tree_util.tree_map(np.asarray,
                                    calibrate_conformer(params, cfg, qcfg, batches))
    tables = CF.freeze_conformer(params, cfg, qcfg, qstate)
    return cfg, tables, conformer_tables_from_jax(tables, "cpu")


def _i8(rng, *shape):
    return rng.integers(-127, 127, size=shape).astype(np.int8)


@pytest.mark.parametrize("b,t,h,d_k,ctx,lens", [
    (2, 1, 4, 16, (-1, -1), [1, 1]),          # T=1
    (2, 37, 4, 16, (-1, -1), [37, 20]),       # odd T, one chunk
    (1, 65, 2, 32, (-1, -1), [65]),           # T just above the 64-key chunk
    (2, 33, 4, 16, (8, 0), [33, 9]),          # just above the 32-query tile; causal window
    (2, 129, 2, 16, (4, 2), [129, 1]),        # above the Pallas 128-row tile; one-frame row
    (1, 70, 4, 64, (-1, -1), [52]),           # d_k of the flagship
])
def test_int_attention_plain_matches_pallas(b, t, h, d_k, ctx, lens):
    rng = np.random.default_rng(b * 1000 + t)
    qu, qv, k, v = (_i8(rng, b, t, h, d_k) for _ in range(4))
    p = _i8(rng, 2 * t - 1, h, d_k)
    ln = np.asarray(lens, np.int32)
    kw = dict(ac=(9, 12), bd=(7, 13), ctx_rq=(11, 14), left=ctx[0], right=ctx[1], nbits=8)
    want = fused_int_attention(*(jnp.asarray(a) for a in (qu, qv, k, v, p, ln)),
                               interpret=True, **kw)
    args = [torch.from_numpy(a) for a in (qu, qv, k, v, p, ln)]
    got = int_attention_plain(*args, **kw)
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, t, h * d_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # query rows at or past len are fully masked: context 0
    for bi, n in enumerate(lens):
        assert int(got[bi, n:].abs().sum()) == 0
    # the wrapper runs the plain version on CPU tensors and launches nothing
    before = int_attention.launches
    assert torch.equal(int_attention(*args, **kw), got)
    assert int_attention.launches == before


def test_int_attention_plain_matches_frozen_tables(frozen_small):
    """Scales from a real frozen layer (the grid requants the flagship path
    uses), against the XLA composition of conformer_freeze.py."""
    cfg, jt, pt = frozen_small
    tbl, ptbl = jt["layers"][0], pt["layers"][0]
    rng = np.random.default_rng(21)
    b, t, h, d_k = 3, 18, 4, 16
    qu, qv, k, v = (_i8(rng, b, t, h, d_k) for _ in range(4))
    p = _i8(rng, 2 * t - 1, h, d_k)
    ln = np.asarray([18, 5, 11], np.int32)
    want = fused_int_attention(*(jnp.asarray(a) for a in (qu, qv, k, v, p, ln)),
                               ac=(int(tbl["ac_grid"][0]), tbl["ac_grid"][1]),
                               bd=(int(tbl["bd_grid"][0]), tbl["bd_grid"][1]),
                               ctx_rq=(int(tbl["ctx_rq"][0]), tbl["ctx_rq"][1]),
                               left=-1, right=-1, nbits=8, interpret=True)
    got = int_attention_plain(*(torch.from_numpy(a) for a in (qu, qv, k, v, p, ln)),
                              ac=ptbl["ac_grid"], bd=ptbl["bd_grid"], ctx_rq=ptbl["ctx_rq"],
                              left=-1, right=-1, nbits=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layer,b,t,lens", [
    (1, 2, 40, [40, 23]),
    (1, 3, 17, [9, 17, 1]),
    (0, 1, 129, [100]),
    (0, 2, 1, [1, 1]),
])
def test_conv_block_plain_matches_pallas(frozen_small, layer, b, t, lens):
    cfg, jt, pt = frozen_small
    rng = np.random.default_rng(b * 1000 + t)
    c8, x8 = _i8(rng, b, t, cfg.d_model), _i8(rng, b, t, cfg.d_model)
    ln = np.asarray(lens, np.int32)
    want = fused_conv_block(jnp.asarray(c8), jnp.asarray(x8), jnp.asarray(ln),
                            jt["layers"][layer], cfg.dw_padding, nbits=8, interpret=True)
    args = (torch.from_numpy(c8), torch.from_numpy(x8), torch.from_numpy(ln),
            pt["layers"][layer], cfg.dw_padding)
    got = conv_block_plain(*args, nbits=8)
    assert got.dtype == torch.int8 and tuple(got.shape) == (b, t, cfg.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = conv_block.launches
    assert torch.equal(conv_block(*args, nbits=8), got)
    assert conv_block.launches == before


def test_conv_block_plain_matches_xla_composition_causal(frozen_small):
    """A causal (K-1, 0) padding, which the kernel takes as pad_l = K-1."""
    cfg, jt, pt = frozen_small
    tbl, ab = jt["layers"][1], 8
    rng = np.random.default_rng(4)
    b, t, d = 2, 23, cfg.d_model
    c8, x8 = _i8(rng, b, t, d), _i8(rng, b, t, d)
    lens = np.asarray([23, 14], np.int32)
    pad = (cfg.conv_kernel_size - 1, 0)
    n = 2 ** (ab - 1) - 1
    x1 = CF._join_lin(jnp.asarray(c8), tbl["att_out"], jnp.asarray(x8), tbl["j2_stream"], ab)
    yln = CF._apply_affine_rq(CF.i_layernorm_core(x1), tbl["ln_conv"], ab)
    y = CF._glu_int(tbl, yln, ab)
    y = jnp.where((jnp.arange(t)[None, :] >= jnp.asarray(lens)[:, None])[:, :, None], 0, y)
    glu8 = jnp.clip(CF.dyadic_requant_static(y, jnp.asarray(tbl["glu_prod"][0]),
                                             tbl["glu_prod"][1]), -n, n - 1).astype(jnp.int8)
    want = CF._join_lin(CF._conv_tail_mid(tbl, glu8, pad, d, ab), tbl["pw2"], x1,
                        tbl["j3_stream"], ab)
    got = conv_block_plain(torch.from_numpy(c8), torch.from_numpy(x8), torch.from_numpy(lens),
                           pt["layers"][1], pad, nbits=ab)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_conv_block_kernel_layout(frozen_small):
    """The kernel's packed tables: each 64-row GLU chunk holds 16 a-rows
    then the matching 16 g-rows, twice, so that one thread's accumulators
    (j, r) and (j + 2, r) are the a and g halves of the same column; the
    per-channel vectors and static scalars sit where the kernel reads them."""
    cfg, _, pt = frozen_small
    tbl = pt["layers"][0]
    p = _packed(tbl)
    d = cfg.d_model
    wa, wg = tbl["pw1_a"]["wt"], tbl["pw1_g"]["wt"]
    for c in range(d // 32):
        for wc in range(2):
            for u in range(16):
                col = c * 32 + wc * 16 + u
                assert torch.equal(p["w_ag"][c * 64 + wc * 32 + u], wa[col])
                assert torch.equal(p["w_ag"][c * 64 + wc * 32 + 16 + u], wg[col])
    assert tuple(p["vec"].shape) == (14, d) and torch.equal(p["vec"][13], tbl["pw2"]["m"])
    assert torch.equal(p["vec"][9], tbl["dw_bn"]["sgn"])
    sc = p["sc"].tolist()
    assert sc[0] == tbl["att_out"]["e"] and tuple(sc[14:16]) == tuple(tbl["j3_stream"])
    assert tuple(sc[6:8]) == tuple(tbl["glu_prod"]) and sc[13] == tbl["pw2"]["e"]
    assert _packed(tbl) is p  # built once per table


def test_int_attention_shared_memory_budget():
    """The flagship T=375 (and 15 s at any batch) fits one block's shared
    memory on Hopper; a 40 s utterance does not and raises on the card."""
    # Qu, Qv, two K chunks and two pos windows of 20-word rows; bd of the
    # chunk; score rows; int8 probabilities; row maxima; the i_exp
    # quadratic's table
    assert port_att.smem_bytes(375, 64) == 4 * ((64 + 128 + 192) * 20 + 32 * 97
                                               + 32 * 392 + 32 * 100 + 32 + 568)
    assert port_att.smem_bytes(375, 64) < port_att.SMEM_LIMIT
    assert port_att.smem_bytes(1000, 64) < port_att.SMEM_LIMIT
    assert port_att.smem_bytes(4000, 64) > port_att.SMEM_LIMIT
