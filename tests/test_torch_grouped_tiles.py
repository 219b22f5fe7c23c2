"""The grouped forms of Kernels 2 and 8 (csrc/pw_gemm_grouped.cu,
csrc/dense_conv_grouped.cu) on the CPU: their plans at the serving and
check shapes, a plain-torch walk of their column tiles in GroupShuffle's
order against grouped_matmul + shuffle_channels, and the host's proof that
a requant site may run on the FP64 pipe.

(a) ``grouped_plan`` of both kernels at every GROUPED_PW / GROUPED_DENSE
    shape of chip_smoke.py's phase 11a and at QuartzNet15x5-g4's three
    grouped pointwise sites: shared memory within a block's, an even A
    ring (a stage a warpgroup), no K step on zero channels where Cin/g is a
    multiple of the step;
(b) Kernel 2's walk: the weights as ``pack_grouped`` lays them out (read
    back through the 128B swizzle), the A tile with each group at a
    32-byte-aligned offset, a column tile's kgc groups x nj columns, each
    group's k32 steps, the accumulators placed at GroupShuffle's positions;
    equal bit for bit at groups 2 / 4 / 8 and Cin/g 16, 48, 64, 192, with
    and without shuffle, Cout/g ragged against the tile;
(c) Kernel 8's walk: a block's halo rows of the full Cin with random bytes
    in the chunks past it, K steps of 64 bytes of each group, the weights
    as ``pack_grouped`` lays them out a step at a time (read back through
    the 64B swizzle, zero past Cin/g and Cout/g); equal to the grouped conv
    bit for bit;
(d) ``checks.f64_site``: accepted at e >= 36 for any int32 z, at a smaller
    e only for the shapes' bound, refused at e > 62 or a non-int e; and
    every accepted (m, e, z) corner gives the exact requant through the
    kernel's FP64 formula (emulated in float64 here).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from qasr_tpu_torch.kernels import dense_conv as dc
from qasr_tpu_torch.kernels import pw_gemm as pg
from qasr_tpu_torch.kernels.checks import f64_site
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# QuartzNet15x5-g4's grouped pointwise sites (B=64 x 15 s: 49,152 rows)
QN_G4 = ((256, 256), (256, 512), (512, 512))


def test_grouped_plans_at_every_check_and_serving_shape():
    cs = _smoke()
    shapes = [(cin, cout, g) for cin, cout, g in cs.GROUPED_PW] + [(c, o, 4) for c, o in QN_G4]
    for cin, cout, g in shapes:
        for n, pro in ((49152, False), (1, True), (609, False)):
            p = pg.check_launch(n, cin, cout, pro, torch.int32 if pro else torch.int8, groups=g)
            assert p == pg.grouped_plan(n, cin, cout, g, pro)
            cg, cog = cin // g, cout // g
            assert p["kgc"] * p["nj"] == pg.GROUPED_BN and g % p["kgc"] == 0
            assert p["cgp"] == -(-cg // 32) * 32 and p["njt"] * p["nj"] >= cog
            assert p["smem"] <= pg.SMEM_LIMIT and p["stages"] in (2, 4)
            assert p["a_tma"] == (not pro and cg % 32 == 0)
            assert p["grid"][0] * 2 >= min(p["row_tiles"], 2) and p["grid"][1] >= 1
    for k, cin, cout, s, d, g in cs.GROUPED_DENSE:
        p = dc.check_launch(64, 768 * s, cin, cout, k, s, k // 2 * d, d, False, torch.int8,
                            groups=g)
        assert p["smem"] <= dc.SMEM_LIMIT and p["stages"] >= 2 and p["kgc"] * p["nj"] == 192
        # an odd row count a chunk; zero chunks past Cin for a step's overrun past a group
        assert p["rpp"] % 2 == 1 and p["rpp"] * s >= p["rows"]
        assert p["nk16"] * 16 - cin >= p["nks"] * dc.GROUPED_KS - cin // g
    # the serving plans
    p = pg.check_launch(49152, 512, 512, False, torch.int8, groups=4)
    assert (p["kgc"], p["nj"], p["n_tiles"], p["t_per"], p["stages"], p["grid"]) == \
        (4, 32, 4, 4, 2, (132, 1))
    p = pg.check_launch(49152, 256, 256, False, torch.int8, groups=4)
    assert (p["cgp"], p["nka"], p["n_tiles"], p["grid"]) == (64, 2, 2, (132, 1))
    p = dc.check_launch(64, 768, 768, 768, 25, 1, 12, 1, True, torch.int32, groups=4)
    assert (p["kgc"], p["nks"], p["nj"], p["n_tiles"], p["grid"]) == (4, 3, 48, 4, (6, 64, 1))
    # a group width the K step does not divide: zero weights past Cin/g
    assert dc.grouped_plan(2, 100, 96, 96, 5, 1, 1, 2)["nks"] == 1   # Cin/g 48, one 64-byte step


def _unswizzle(img, rows):
    """(..., rows, 8, 16) granules as the 128B swizzle stores them ->
    logical order (granule u of row r read at u ^ (r % 8))."""
    r = torch.arange(rows)[:, None]
    return img[..., r, torch.arange(8)[None, :] ^ (r % 8), :]


def pw_grouped_walk(x2, wt, groups, shuffle):
    """Kernel 2 grouped's products on (N, Cin) int x2, as its tiles walk
    them: int32 (N, Cout) in the stored order."""
    n, cin = x2.shape
    cout, cg = wt.shape
    cog = cout // groups
    p = pg.grouped_plan(n, cin, cout, groups, False)
    kgc, nj, njt, cgp, nkb = p["kgc"], p["nj"], p["njt"], p["cgp"], p["nkb"]
    img = pg.pack_grouped(wt, groups, kgc).reshape(p["n_tiles"], kgc, nkb, nj, 8, 16)
    assert img.numel() == p["n_tiles"] * p["tile_bytes"]
    wl = _unswizzle(img, nj).reshape(p["n_tiles"], kgc, nkb, nj, 128)
    wl = wl.permute(0, 1, 3, 2, 4).reshape(p["n_tiles"], kgc, nj, nkb * 128).to(torch.int32)
    # the A tile: group g's channels at bytes g * cgp.., each group's pad zero
    a = torch.zeros(n, p["nka"] * 128, dtype=torch.int32)
    for g in range(groups):
        a[:, g * cgp:g * cgp + cg] = x2[:, g * cg:(g + 1) * cg]
    out = torch.zeros(n, cout, dtype=torch.int32)
    for tt in range(p["n_tiles"]):
        gc, jt = divmod(tt, njt)
        for i in range(kgc):
            grp = gc * kgc + i
            acc = torch.zeros(n, nj, dtype=torch.int32)
            for s in range(cgp // 32):
                kb, kw = grp * cgp + 32 * s, 32 * s
                assert kb // 128 == (kb + 31) // 128   # a step never crosses a 128-byte chunk
                acc += a[:, kb:kb + 32] @ wl[tt, i, :, kw:kw + 32].t()
            for c in range(nj):
                j = jt * nj + c
                if j < cog:
                    out[:, j * groups + grp if shuffle else grp * cog + j] = acc[:, c]
    return out


@pytest.mark.parametrize("groups,cg", [(2, 16), (2, 192), (4, 48), (4, 64), (8, 16), (8, 64),
                                       (4, 192), (2, 48)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_pw_grouped_tile_walk_equals_grouped_matmul(groups, cg, shuffle):
    rng = np.random.default_rng(groups * 1000 + cg)
    cog = {16: 40, 48: 24, 64: 64, 192: 36}[cg]    # ragged against the tile, or whole
    n = 37
    x2 = torch.from_numpy(rng.integers(-128, 128, (n, groups * cg)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-128, 128, (groups * cog, cg)).astype(np.int8))
    want = pg.grouped_matmul(x2, wt, groups)
    if shuffle:
        want = pg.shuffle_channels(want, groups)
    got = pw_grouped_walk(x2.to(torch.int32), wt, groups, shuffle)
    assert torch.equal(got, want)


def dense_grouped_walk(x, w, groups, padding, shuffle, rng):
    """Kernel 8 grouped's products on one batch element's (T, Cin) int8 x
    (stride 1, dilation 1), as its tiles walk them: int32 (T_out, Cout)."""
    t_in, cin = x.shape
    cout, k_size, cg = w.shape
    cog = cout // groups
    t_out = t_in + 2 * padding - k_size + 1
    p = dc.grouped_plan(1, t_out, cin, cout, k_size, 1, 1, groups)
    kgc, ks, nj, njt = p["kgc"], dc.GROUPED_KS, p["nj"], p["njt"]
    # the resident rows: the full Cin, the chunks past it random here (the
    # kernel's are zero; a step reads them times zero weights)
    rows = torch.from_numpy(rng.integers(-128, 128, (t_out + k_size - 1, p["nk16"] * 16))
                            .astype(np.int32))
    rows[:, :cin] = F.pad(x.to(torch.int32), (0, 0, padding, padding))[:t_out + k_size - 1]
    # the packed weight images a K step at a time, read back through the 64B swizzle
    nks = p["nks"]
    img = dc.pack_grouped(w, groups, kgc).reshape(p["n_tiles"], k_size, nks, kgc, nj, 4, 16)
    assert img.numel() == p["n_tiles"] * k_size * nks * dc.GROUPED_BN * ks
    r = torch.arange(nj)[:, None]
    wl = img[..., r, torch.arange(4)[None, :] ^ ((r >> 1) % 4), :]
    wl = wl.reshape(p["n_tiles"], k_size, nks, kgc, nj, ks).to(torch.int32)
    out = torch.zeros(t_out, cout, dtype=torch.int32)
    for tt in range(p["n_tiles"]):
        gc, jt = divmod(tt, njt)
        for i in range(kgc):
            grp = gc * kgc + i
            acc = torch.zeros(t_out, nj, dtype=torch.int32)
            for tap in range(k_size):
                for c in range(nks):
                    ch = grp * cg + c * ks
                    assert ch + ks <= p["nk16"] * 16   # within the row's chunks
                    acc += rows[tap:tap + t_out, ch:ch + ks] @ wl[tt, tap, c, i].t()
            for col in range(nj):
                j = jt * nj + col
                if j < cog:
                    out[:, j * groups + grp if shuffle else grp * cog + j] = acc[:, col]
    return out


@pytest.mark.parametrize("groups,cg", [(2, 48), (4, 64), (4, 192), (8, 16), (2, 80), (8, 48)])
def test_dense_grouped_tile_walk_equals_grouped_conv(groups, cg):
    rng = np.random.default_rng(7 * groups + cg)
    k_size, t_in, cog = 5, 19, {16: 24, 48: 40, 64: 32, 80: 48, 192: 36}[cg]
    x = torch.from_numpy(rng.integers(-128, 128, (1, t_in, groups * cg)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (groups * cog, k_size, cg)).astype(np.int8))
    for shuffle in (True, False):
        want = dc.dense_conv_plain(x, w, padding=2, groups=groups, shuffle=shuffle)[0]
        got = dense_grouped_walk(x[0], w, groups, 2, shuffle, rng)
        assert torch.equal(got, want)


def _rq_f64(z, m, e):
    """The kernel's qasr_rq_f64 in float64: round(z * m 2^-e) half to even."""
    return np.rint(np.float64(z) * (np.float64(m) * 2.0 ** -e)).astype(np.int64)


def test_f64_site_proof():
    assert f64_site(36) and f64_site(62) and not f64_site(35) and not f64_site(63)
    assert not f64_site(None) and not f64_site(0)
    # a shape bound widens the domain: Cin/g 64, int8 x int8, no bias
    zmax = 64 * 128 * 128
    assert f64_site(25, zmax) and not f64_site(24, zmax)     # 2^20 (2^31 - 1) < 2^(e + 26)
    assert f64_site(12, 128) and not f64_site(11, 128)
    # every accepted corner is the exact requant
    for e, zm in ((36, 2 ** 31), (40, 2 ** 31), (25, zmax), (12, 128)):
        assert f64_site(e, zm)
        for m in (1, 3, 2 ** 30 + 1, 2 ** 31 - 1):
            for z in (0, 1, -1, zm - 1, -(zm - 1), -zm, zm // 3, -(zm // 7)):
                if abs(z) > zm or not -2 ** 31 <= z < 2 ** 31:
                    continue
                want = int(dyadic_requant_static(torch.tensor([z], dtype=torch.int32), m, e)[0])
                assert int(_rq_f64(z, m, e)) == want, (e, m, z)

