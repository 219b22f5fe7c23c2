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
(c) The plan's values and launch counts.
(d) What Kernel 6 takes from the host and cannot be run here: its packed
    rows, FP64 scales and weight tiles (read back as the kernel's
    ldmatrix addresses read them), the x-tile swizzle, the per-site choice
    of the FP64 requant against an integer model of the check, a numpy
    model of qasr_rq_f64 against the plain requant over each site's proven
    domain, and the i-swish and stream tables against the JAX package's
    ``_ffn_mid`` / ``_join_int`` pieces over all 256 inputs.
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
from qasr_tpu_torch.kernels.ffn_ln import ffn_ln, ffn_ln_plain
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


def _unpack_as_read(tiles: np.ndarray, nout: int, k: int) -> np.ndarray:
    """W (nout, k) as ffn_ln.cu's consumers read it from the packed tile
    sequence: tile (chunk c0, K offset k0) at byte c0 K + k0 rows, and in
    it, for consumer warp w, fragment pair p, ldmatrix matrix q, lane row
    rr and k32 step ks (gemm_chunk), weight row n = 32 w + 16 p + 8 (q >> 1)
    + rr, 16 bytes at unit (2 ks + (q & 1)) ^ ((rr >> 1) & 3) of the row.
    Checks that the eight rows of each ldmatrix matrix fall on eight
    distinct 16-byte bank groups."""
    cols, kt = port_ffn.COLS, port_ffn.KT
    w = np.zeros((nout, k), np.int8)
    seen = np.zeros((nout, k), bool)
    off = 0
    for c0 in range(0, nout, cols):
        rows = min(cols, nout - c0)
        for k0 in range(0, k, kt):
            assert off == c0 * k + k0 * rows
            stage = tiles[off:off + rows * kt]
            off += rows * kt
            for wp in range(4):
                if 32 * wp >= rows:
                    continue
                for p in range(2):
                    for q in range(4):
                        for ks in range(2):
                            groups = set()
                            for rr in range(8):
                                n = 32 * wp + 16 * p + 8 * (q >> 1) + rr
                                unit = (2 * ks + (q & 1)) ^ ((rr >> 1) & 3)
                                a = n * kt + 16 * unit
                                groups.add((a // 16) % 8)
                                kb = k0 + 32 * ks + 16 * (q & 1)
                                w[c0 + n, kb:kb + 16] = stage[a:a + 16]
                                seen[c0 + n, kb:kb + 16] = True
                            assert len(groups) == 8
    assert off == tiles.size and seen.all()
    return w


def test_ffn_ln_kernel_layout(frozen_small):
    """Kernel 6's packed form of a layer's sites: (sgn, b, m) of an i-LN
    site and (b, m) of a linear site as int32 rows, the FP64 scales m 2^-e
    (every site of the small model is in the FP64 domain), the weights as
    the tile sequence the kernel reads (a 64-row last chunk at f = 256 /
    d = 64 included), built once and cached in the site's table."""
    _, _, _, pt = frozen_small
    tbl = pt["layers"][0]
    p_ln, p1, p2 = (port_ffn._packed(tbl["ln_ff1"]), port_ffn._packed(tbl["ff1_l1"]),
                    port_ffn._packed(tbl["ff1_l2"]))
    ln3, bm1, bm2 = p_ln["rows"], p1["rows"], p2["rows"]
    assert tuple(ln3.shape) == (3, 64) and tuple(bm1.shape) == (2, 256) \
        and tuple(bm2.shape) == (2, 64)
    for row, name in enumerate(("sgn", "b", "m")):
        assert torch.equal(ln3[row], tbl["ln_ff1"][name])
    for row, name in enumerate(("b", "m")):
        assert torch.equal(bm1[row], tbl["ff1_l1"][name])
        assert torch.equal(bm2[row], tbl["ff1_l2"][name])
    assert all(v.dtype == torch.int32 and v.is_contiguous() for v in (ln3, bm1, bm2))
    assert port_ffn._packed(tbl["ln_ff1"]) is p_ln and port_ffn._packed(tbl["ff1_l1"]) is p1
    for p, site in ((p_ln, tbl["ln_ff1"]), (p1, tbl["ff1_l1"]), (p2, tbl["ff1_l2"])):
        assert p["mf"].dtype == torch.float64 and p["mf"].is_contiguous()
        np.testing.assert_array_equal(np.ldexp(p["mf"].numpy(), site["e"]), site["m"].numpy())
    # the kernels take the device tables' (dout, din) weights as they are
    assert tuple(tbl["ff1_l1"]["wt"].shape) == (256, 64) \
        and tuple(tbl["ff1_l2"]["wt"].shape) == (64, 256)
    for p, wt in ((p1, tbl["ff1_l1"]["wt"]), (p2, tbl["ff1_l2"]["wt"])):
        assert p["tiles"].dtype == torch.int8 and p["tiles"].numel() == wt.numel()
        np.testing.assert_array_equal(_unpack_as_read(p["tiles"].numpy(), *wt.shape), wt.numpy())


@pytest.mark.parametrize("nout,k", [(128, 64), (192, 320), (64, 512), (1024, 256)])
def test_ffn_ln_tile_packing_shapes(nout, k):
    """pack_tiles at the widths the kernel takes: one chunk, a 64-row last
    chunk, K of 5 tiles, the flagship's l1."""
    wt = torch.from_numpy(_i8(np.random.default_rng(nout + k), nout, k))
    np.testing.assert_array_equal(_unpack_as_read(port_ffn.pack_tiles(wt).numpy(), nout, k),
                                  wt.numpy())


def test_ffn_ln_x_tile_swizzle():
    """ffn_ln.cu's xat: byte c of row r of the x tile at r d + 16 ((u & ~3)
    | ((u ^ r) & 3)) + (c & 15), u = c >> 4: a permutation of each row, so
    the 16-byte copies in and out and the byte reads see every x once; the
    join's eight rows at one column share a 16-byte bank group at most two
    at a time (eight at once unswizzled, d a multiple of 128)."""
    for d in (64, 192, 256, 512):
        c = np.arange(d)
        for r in range(32):
            u = c >> 4
            a = r * d + 16 * ((u & ~3) | ((u ^ r) & 3)) + (c & 15)
            assert sorted(a.tolist()) == list(range(r * d, (r + 1) * d))
        for o in range(0, d, 2):
            rows = np.arange(8)
            u = o >> 4
            a = rows * d + 16 * ((u & ~3) | ((u ^ rows) & 3))
            assert np.bincount((a // 16) % 8).max() <= 2


def _sites(tbl):
    """The FFN halves' requant sites of one layer table: (name, kind)."""
    out = [("ln_ff1", "affine"), ("ff1_l1", "linear"), ("ff1_l2", "linear"),
           ("ln_att", "affine"), ("ln_ff2", "affine"), ("ff2_l1", "linear"),
           ("ff2_l2", "linear")]
    return out + ([("ln_out", "affine")] if "m" in tbl["ln_out"] else [])


def _zmax_model(site, kind):
    """Per column, in Python integers: 128 |W[o]|_1 + |b[o]| (linear), or
    |sgn[o]| 2^21 + |b[o]| (affine: |i-LN| < 2^21 for an int8 row)."""
    b = [abs(int(v)) for v in site["b"].tolist()]
    if kind == "linear":
        return [128 * sum(abs(int(v)) for v in row) + bb
                for row, bb in zip(site["wt"].tolist(), b)]
    return [abs(int(s_)) * 2 ** 21 + bb for s_, bb in zip(site["sgn"].tolist(), b)]


def _fits_model(zmax, m, e):
    """qasr_rq_f64's domain: 1 <= e <= 62 and |z| m < 2^(e + 26) for every
    column's |z| <= zmax, in Python integers."""
    return 1 <= e <= 62 and all(z * abs(int(mm)) < 2 ** min(62, e + 26)
                                for z, mm in zip(zmax, m.tolist()))


def test_ffn_f64_domain_matches_integer_model(frozen_small):
    """The host's per-site choice of the FP64 requant (``site_f64`` through
    ``checks.f64_fits``) at every FFN site of both layers, against the
    check done in Python integers; every site of the small model takes the
    FP64 path."""
    _, _, _, pt = frozen_small
    for li, tbl in enumerate(pt["layers"]):
        for name, kind in _sites(tbl):
            site = {k: v for k, v in tbl[name].items() if not k.startswith("_")}
            zmax = _zmax_model(site, kind)
            want = _fits_model(zmax, site["m"], site["e"])
            zt = (port_ffn.weight_zmax if kind == "linear" else port_ffn.affine_zmax)(site)
            assert zt.tolist() == zmax, (li, name)
            assert want and (port_ffn.site_f64(site, zt) is not None), (li, name)


@pytest.mark.parametrize("kind", ["affine", "linear"])
def test_ffn_f64_domain_boundary(frozen_small, kind):
    """A column bent onto the domain's edge (the other columns' m set to
    1): the largest m with |z|max m < 2^(e+26) is in it, the next one is
    not; an exponent of 0 or 63 sends the site to qasr_rq, 62 does not.
    The helper agrees with the integer model in each case."""
    _, _, _, pt = frozen_small
    tbl = pt["layers"][0]
    base = {k: v for k, v in tbl["ff1_l1" if kind == "linear" else "ln_ff1"].items()
            if not k.startswith("_")}
    zmax = _zmax_model(base, kind)
    e = 20
    m_in = (2 ** (e + 26) - 1) // zmax[0]
    cases = []
    for m0, want in ((m_in, True), (m_in + 1, False)):
        m = torch.ones_like(base["m"])
        m[0] = m0
        cases.append(({**base, "m": m, "e": e}, want))
    for e_, want in ((0, False), (63, False), (62, True)):
        cases.append(({**base, "m": torch.ones_like(base["m"]), "e": e_}, want))
    for site, want in cases:
        assert _fits_model(zmax, site["m"], site["e"]) == want
        zt = port_ffn.weight_zmax(site) if kind == "linear" else port_ffn.affine_zmax(site)
        assert (port_ffn.site_f64(site, zt) is not None) == want


def _rq_f64_model(z: np.ndarray, m: int, e: int) -> np.ndarray:
    """requant.cuh::qasr_rq_f64 step by step: z made a double by the 2^52 +
    2^31 trick (numpy float64, exact), M = m 2^-e, the fma z M + 1.5 2^52
    rounded once to the nearest double, ties to even (exact integer
    arithmetic: the sum lies in [2^52, 2^53), where the doubles are the
    integers), then the low word of its bits as int32."""
    bits = (np.uint64(0x43300000) << np.uint64(32)) | (
        (z.astype(np.int64) ^ 0x80000000) & 0xffffffff).astype(np.uint64)
    zd = bits.view(np.float64) - 4503601774854144.0
    np.testing.assert_array_equal(zd, z.astype(np.float64))
    assert np.ldexp(np.float64(m) * 2.0 ** -e, e) == m        # M is exact
    out = []
    for zi in zd.astype(np.int64).tolist():
        q, r = divmod(zi * m + 3 * 2 ** (51 + e), 2 ** e)
        half = 2 ** (e - 1)
        q += 1 if r > half or (r == half and q % 2) else 0
        assert 2 ** 52 <= q < 2 ** 53
        low = int(np.array([float(q)]).view(np.uint64)[0]) & 0xffffffff
        out.append(low - 2 ** 32 if low >= 2 ** 31 else low)
    return np.asarray(out, np.int64)


def test_rq_f64_model_on_proven_domain(frozen_small):
    """On every FFN site of both layers, the FP64 requant (numpy model)
    equals the JAX package's plain requant over the site's proven domain:
    for each column, |z| <= its bound at the extremes, around 0 and at 48
    random points (4 columns a site, spread over its width)."""
    from qasr_tpu.ops.quant_prims import dyadic_requant_static as jax_rq

    _, _, _, pt = frozen_small
    rng = np.random.default_rng(44)
    for li, tbl in enumerate(pt["layers"]):
        for name, kind in _sites(tbl):
            site = tbl[name]
            zmax = _zmax_model(site, kind)
            cols = np.linspace(0, len(zmax) - 1, 4).astype(int)
            for o in cols:
                zm = min(zmax[o], 2 ** 29 - 1)
                z = np.concatenate([[zm, -zm, zm - 1, 1 - zm, 0, 1, -1],
                                    rng.integers(-zm, zm + 1, 48)]).astype(np.int64)
                m = int(site["m"][o])
                want = np.asarray(jax_rq(jnp.asarray(z, jnp.int32), jnp.asarray(m), site["e"]))
                np.testing.assert_array_equal(_rq_f64_model(z, m, site["e"]), want,
                                              err_msg=f"layer {li} {name} column {o}")


@pytest.mark.parametrize("nbits", [8, 6])
def test_ffn_tables_match_jax_ffn_mid(frozen_small, nbits):
    """The host's tables over all 256 int8 inputs against the pieces of the
    JAX package's ``_ffn_mid`` / ``_join_int``: the i-swish (grid requant,
    i_sigmoid_grid, product requant, clamp) and the stream requant of the
    join, for both FFN halves of both layers."""
    from qasr_tpu.ops.integer_sigmoid import i_sigmoid_grid as jax_sigmoid
    from qasr_tpu.ops.quant_prims import dyadic_requant_static as jax_rq

    _, _, jt, pt = frozen_small
    v = jnp.arange(-128, 128, dtype=jnp.int32)
    n = 2 ** (nbits - 1) - 1
    for li, (jl, plyr) in enumerate(zip(jt["layers"], pt["layers"])):
        for half, stream in (("ff1", "j1_stream"), ("ff2", "j4_stream")):
            grid, prod = jl[f"{half}_grid"], jl[f"{half}_prod"]
            g = jax_rq(v, jnp.asarray(grid[0]), grid[1])
            want = np.clip(np.asarray(jax_rq(v * jax_sigmoid(g), jnp.asarray(prod[0]), prod[1])),
                           -n, n - 1)
            got = port_ffn.swish_lut(plyr[f"{half}_grid"], plyr[f"{half}_prod"], nbits, "cpu")
            assert got.dtype == torch.uint8 and tuple(got.shape) == (256,)
            np.testing.assert_array_equal(got.view(torch.int8).numpy().astype(np.int32), want,
                                          err_msg=f"layer {li} {half} swish")
            js = jl[stream]
            want_s = np.asarray(jax_rq(v, jnp.asarray(js[0]), js[1]))
            got_s = port_ffn.stream_table(plyr[stream], "cpu")
            assert got_s.dtype == torch.int32 and tuple(got_s.shape) == (256,)
            np.testing.assert_array_equal(got_s.numpy(), want_s, err_msg=f"layer {li} {stream}")


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
    """Kernel 6's block (32 rows): the weight ring, the x tile, the LN
    output, the swish activation, the stream and swish tables and the
    stages' mbarriers.  Three blocks share an SM at the flagship d=256;
    d=512 with ff=4 fits one block."""
    assert port_ffn.smem_bytes(256, 1024) == 3 * 128 * 64 + 32 * (2 * 256 + 16) \
        + 32 * (1024 + 16) + 4 * 256 + 256 + 3 * 2 * 8
    assert 3 * (port_ffn.smem_bytes(256, 1024) + 1024) <= port_ffn.SMEM_LIMIT
    assert port_ffn.smem_bytes(512, 2048) <= port_ffn.SMEM_LIMIT
    assert port_ffn.smem_bytes(512, 6144) > port_ffn.SMEM_LIMIT   # ff = 12 at d=512 raises
