"""The stream step's cache forms of Kernels 3 and 4 on the CPU, at small
sizes (the JAX tests' causal Conformer: 2 layers, d 64, 4 heads, L 8, K 9):

(a) ``int_attention_cached_plain`` and ``conv_block_cached_plain`` equal
    the JAX stream-step composition over [cache || new] at B = 3 with n
    in {1, 7, 25} new frames (one frame, a ragged tile, a 1 s slice),
    with ``seen`` before and past L;
(b) what the cache-form kernels read from the host: Kernel 3's i_exp
    table (``exp_table``) equals the JAX package's i_exp at every entry
    and gives its i_exp(-a) >> 4 over the whole score grid; Kernel 4's
    per-CTA slices of a layer (``cached_blob``) reassemble w_ao, w_ag, w_2
    and the vectors, scales, taps and tables, CTA q holding the a and g
    rows of its own 64 GLU channels;
(c) a numpy model of Kernel 4's cluster-form depthwise (its time-packed
    windows over [cache || glu8], built in two passes, and its dp4a tasks
    of 4 kNQ frames) equals the direct depthwise, and a model of Kernel
    3's new-cache ownership writes every row once, from a staged slot;
(d) ``_build._SIGNATURES`` of the changed C entries matches the entries'
    parameters in the CUDA source and the wrappers' calls, and the host's
    copies of the kernels' layouts (``conv_block.blob_layout``,
    ``int_attention.cached_smem_bytes``) equal the CUDA source's, read
    from it and evaluated.

The kernels themselves are held to the plain versions on the card in
chip_smoke.py phase 12a.
"""
import ast
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qasr_tpu.ops.integer_softmax import i_exp as jax_i_exp
from qasr_tpu.quantize import conformer_freeze as JCF
from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels import conv_block as K4
from qasr_tpu_torch.kernels import int_attention as K3
from qasr_tpu_torch.quantize import conformer_freeze as port_cf

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "qasr_tpu_torch" / "kernels" / "csrc"


def _streaming_helpers():
    spec = importlib.util.spec_from_file_location(
        "_stream_helpers", ROOT / "tests" / "test_torch_streaming.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pair():
    helpers = _streaming_helpers()
    jm, pm = helpers._conformer_pair()
    return helpers, jm, pm


def _i8(rng, *shape):
    return rng.integers(-127, 127, size=shape).astype(np.int8)


# ---------------------------------------------------------------------------
# (a) the plain cache forms against the JAX composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seen", [(1, 3), (7, 0), (7, 20), (25, 5), (25, 40)])
def test_cache_forms_plain_match_jax_ragged(pair, n, seen):
    helpers, jm, pm = pair
    jt = jm.enc_frozen
    JCF.frozen_stream_init(jt, jm.ccfg, 1)   # builds the JAX stream constants
    tables = pm._tables(torch.device("cpu"))["encoder"]
    p8s = port_cf._stream_p8(tables, pm.ccfg)
    ab = jt["act_bit"]
    rng = np.random.default_rng(100 * n + seen)
    b, h, d_k, left, d, kk = 3, 4, 16, 8, 64, 9
    t = torch.from_numpy
    for li, (jtbl, ptbl) in enumerate(zip(jt["layers"], tables["layers"])):
        qu8, qv8, k8, v8 = (_i8(rng, b, n, h, d_k) for _ in range(4))
        kc, vc = _i8(rng, b, left, h, d_k), _i8(rng, b, left, h, d_k)
        want = helpers._jax_attention(jtbl, qu8, qv8, np.concatenate([kc, k8], 1),
                                      np.concatenate([vc, v8], 1),
                                      np.asarray(jt["_stream_p8"][li]), seen, ab)
        c8, k_new, v_new = K3.int_attention_cached_plain(
            t(qu8), t(qv8), t(k8), t(v8), t(kc), t(vc), p8s[li], seen, ac=ptbl["ac_grid"],
            bd=ptbl["bd_grid"], ctx_rq=ptbl["ctx_rq"], nbits=ab)
        np.testing.assert_array_equal(c8.numpy(), np.asarray(want))
        np.testing.assert_array_equal(k_new.numpy(), np.concatenate([kc, k8], 1)[:, n:])
        np.testing.assert_array_equal(v_new.numpy(), np.concatenate([vc, v8], 1)[:, n:])
        c8, x8, gc = _i8(rng, b, n, d), _i8(rng, b, n, d), _i8(rng, b, kk - 1, d)
        want_x, want_c = helpers._jax_conv(jtbl, c8, x8, gc, d, kk, ab)
        got_x, got_c = K4.conv_block_cached_plain(t(c8), t(x8), t(gc), ptbl, nbits=ab)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


# ---------------------------------------------------------------------------
# (b) host-built tables and packings
# ---------------------------------------------------------------------------


def test_exp_table_matches_jax_i_exp():
    tab = K3.exp_table("cpu")
    assert tab.dtype == torch.int32 and tuple(tab.shape) == (K3.EXP_TAB,) == (568,)
    r = np.arange(K3.EXP_TAB, dtype=np.int32)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jax_i_exp(jnp.asarray(-r))))
    # qasr_i_exp_pre: i_exp(-a) >> 4 = tab[a mod 568] >> (a // 568 + 4), 0 past a shift of 31
    a = np.arange(16384, dtype=np.int64)
    shift = np.minimum(a // K3.EXP_TAB + 4, 31)
    got = tab.numpy().astype(np.int64)[a % K3.EXP_TAB] >> shift
    want = np.asarray(jax_i_exp(jnp.asarray(-a.astype(np.int32)))).astype(np.int64) >> 4
    np.testing.assert_array_equal(got, want)
    assert K3.exp_table("cpu") is tab   # built once a device


@pytest.mark.parametrize("d,k_size", [(64, 9), (256, 31), (512, 31)])
def test_cached_blob_reassembles_the_layer(d, k_size):
    rng = np.random.default_rng(d)
    wa, wg = (torch.from_numpy(_i8(rng, d, d)) for _ in range(2))
    # _packed's interleave: each 64-row chunk of w_ag holds 16 a-rows then 16 g-rows, twice
    w_ag = torch.stack([wa.reshape(d // 16, 16, d), wg.reshape(d // 16, 16, d)],
                       dim=1).reshape(2 * d, d)
    p = {"w_ao": torch.from_numpy(_i8(rng, d, d)), "w_ag": w_ag,
         "w_2": torch.from_numpy(_i8(rng, d, d)),
         "vec": torch.from_numpy(rng.integers(-2 ** 30, 2 ** 30, (14, d)).astype(np.int32)),
         "mf": torch.from_numpy(rng.normal(size=(6, d))),
         "dw_p": K4.pack_taps(torch.from_numpy(_i8(rng, k_size, d))),
         "sig": K4.sigmoid_table("cpu"),
         "sc": torch.from_numpy(rng.integers(0, 60, 16).astype(np.int32))}
    blob = K4.cached_blob(p)
    lay = K4.blob_layout(d, k_size)
    c = d // K4.CTA_COLS
    assert blob.dtype == torch.uint8 and tuple(blob.shape) == (c, lay["bytes"])
    assert blob.is_contiguous() and lay["bytes"] % 16 == 0
    assert all(v % 16 == 0 for v in lay.values())   # every section 16-byte aligned

    def section(q, name, end, dtype, shape):
        return blob[q, lay[name]:lay[end]].view(dtype).reshape(shape)
    row = (-1, d + 16)
    for q in range(c):   # CTA q: columns and GLU channels [64q, 64q + 64)
        own = slice(64 * q, 64 * q + 64)
        w_ao, w_ag, w_2 = (section(q, a, b, torch.int8, row)
                           for a, b in (("ao", "vc"), ("ag", "sig"), ("w2", "pw")))
        assert not any(w[:, d:].any() for w in (w_ao, w_ag, w_2))
        assert torch.equal(w_ao[:, :d], p["w_ao"][own])
        assert torch.equal(w_ag[:, :d], p["w_ag"][2 * 64 * q:2 * 64 * (q + 1)])
        assert torch.equal(w_2[:, :d], p["w_2"][own])
        glu = w_ag[:, :d].reshape(4, 2, 16, d)   # the a and g rows of its own channels
        assert torch.equal(glu[:, 0].reshape(64, d), wa[own])
        assert torch.equal(glu[:, 1].reshape(64, d), wg[own])
        assert torch.equal(section(q, "vc", "mfc", torch.int32, (14, 64)), p["vec"][:, own])
        assert torch.equal(section(q, "mfc", "sc", torch.float64, (5, 64)), p["mf"][:5, own])
        assert torch.equal(section(q, "sc", "lnv", torch.int32, (16,)), p["sc"])
        assert torch.equal(section(q, "lnv", "lnf", torch.int32, (3, d)), p["vec"][2:5])
        assert torch.equal(section(q, "lnf", "ag", torch.float64, (d,)), p["mf"][5])
        assert torch.equal(section(q, "sig", "w2", torch.uint8, (-1,)), p["sig"])
        assert torch.equal(section(q, "pw", "bytes", torch.int32, (64, -1)), p["dw_p"][own])
    assert (lay["b"], lay["c"]) == (lay["lnv"], lay["w2"])


def test_packed_tables_hold_the_blob(pair):
    _, _, pm = pair
    tbl = pm._tables(torch.device("cpu"))["encoder"]["layers"][0]
    p = K4._packed(tbl)
    assert torch.equal(p["blob"], K4.cached_blob(p))
    assert p["blob"].shape[1] == K4.blob_layout(64, 9)["bytes"]


# ---------------------------------------------------------------------------
# (c) numpy models of the kernels' index walks
# ---------------------------------------------------------------------------


def _transpose4(a):
    """qasr_transpose4 on 4 words given as a (4, 4) byte array [word, byte]."""
    return a.T


def _dw_cluster_model(cache, glu, taps, n_new):
    """Kernel 4's cluster-form depthwise of one CTA's channels, as the
    kernel walks it: cache (U, kc, 64), glu (U, n, 64) int8, taps (K, 64)
    -> (U, n, 64) int32 sums."""
    u_n, kc, ch = cache.shape
    k_size = kc + 1
    ng, ngp = K4.tap_groups(k_size)
    nq4 = (n_new + 3) // 4
    nq = 1 if nq4 == 1 else 4
    nqg = -(-nq4 // nq)
    nwu = nqg * nq + ng - 1
    pitch = (u_n * nwu) | 1
    packed = K4.pack_taps(torch.from_numpy(taps)).numpy().view(np.uint8).reshape(ch, 4 * ngp)
    gw = np.zeros((ch, pitch, 4), np.uint8)   # 4 frames a word, byte i = frame 4w + i
    # pass 1: the cache frames (zero where a frame is not a cache frame)
    for u in range(u_n):
        for w in range(nwu):
            a = np.zeros((4, ch), np.uint8)
            for i in range(4):
                f = 4 * w + i
                if f < kc:
                    a[i] = cache[u, f].view(np.uint8)
            for c in range(ch):
                gw[c, u * nwu + w] = a[:, c]
    # pass 2: the glu8 frames or-ed into the words from kc // 4 on
    for u in range(u_n):
        for w in range(kc // 4, nwu):
            for i in range(4):
                f = 4 * w + i - kc
                if 0 <= f < n_new:
                    gw[:, u * nwu + w, i] |= glu[u, f].view(np.uint8)
    out = np.zeros((u_n, n_new, ch), np.int64)
    x = gw.view(np.int8).astype(np.int64)
    p = packed.view(np.int8).astype(np.int64).reshape(ch, ngp, 4)
    for c in range(ch):
        for u in range(u_n):
            for qg in range(nqg):
                acc = np.zeros(4 * nq, np.int64)
                for gi in range(ng):
                    pl, pp = p[c, gi], p[c, gi + 1]
                    # taps shifted by j bytes: byte i of the word is tap 4 gi + i - j
                    shifted = [np.concatenate([pl[4 - j:], pp[:4 - j]]) for j in range(4)]
                    for a in range(nq):
                        word = x[c, u * nwu + qg * nq + a + gi]
                        for j in range(4):
                            acc[4 * a + j] += int(word @ shifted[j])
                for k in range(4 * nq):
                    t = 4 * nq * qg + k
                    if t < n_new:
                        out[u, t, c] = acc[k]
    return out


@pytest.mark.parametrize("n_new,k_size", [(1, 9), (4, 9), (7, 9), (16, 31), (25, 31)])
def test_dw_cluster_walk_equals_the_depthwise(n_new, k_size):
    rng = np.random.default_rng(n_new + k_size)
    u_n, ch = 2, 64
    cache = _i8(rng, u_n, k_size - 1, ch)
    glu = _i8(rng, u_n, n_new, ch)
    taps = _i8(rng, k_size, ch)
    cat = np.concatenate([cache, glu], 1).astype(np.int64)
    want = np.stack([sum(cat[:, t + k] * taps[k].astype(np.int64) for k in range(k_size))
                     for t in range(n_new)], 1)
    np.testing.assert_array_equal(_dw_cluster_model(cache, glu, taps, n_new), want)


@pytest.mark.parametrize("left", [1, 8, 70])
def test_attention_new_cache_rows_written_once_from_staged_slots(left):
    tq = K3.TQ_CACHE
    for n in range(1, 50):
        writes = []
        for tile in range(-(-n // tq)):
            i0 = tile * tq
            nq = min(tq, n - i0)
            lo = 0 if tile == 0 else left + i0 - n
            hi = min(left, left + i0 + tq - n)
            for r in range(max(lo, 0), hi):
                slot = n + r
                assert i0 <= slot < i0 + nq + left   # in the tile's staged window
                writes.append(r)
        assert sorted(writes) == list(range(left)), (n, left)


# ---------------------------------------------------------------------------
# (d) the C entries' prototypes
# ---------------------------------------------------------------------------


def _c_params(src, name):
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", src, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    return [_build._P if "*" in p else _build._I for p in params]


def _call_args(path, name):
    tree = ast.parse(Path(path).read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr == name]
    assert len(calls) == 1, name
    return len(calls[0].args)


@pytest.mark.parametrize("name,source,wrapper", [
    ("qasr_conv_block_cached", "conv_block_cached.cu", "conv_block.py"),
    ("qasr_int_attention_cached", "int_attention.cu", "int_attention.py"),
    ("qasr_empty_launch", "latency_floor.cu", "floor.py")])
def test_signatures_match_the_c_entries(name, source, wrapper):
    params = _c_params((CSRC / source).read_text(), name)
    assert _build._SIGNATURES[name] == params
    assert _call_args(ROOT / "qasr_tpu_torch" / "kernels" / wrapper, name) == len(params)


def _c_layout(src, fn, env):
    """Evaluate the `l.x = ...;` assignments of the CUDA layout function
    ``fn`` (integer arithmetic on positive values) in ``env``."""
    body = re.search(fn + r"\(.*?\) \{(.*?)\n\}", src, re.S).group(1)
    out = {}
    for name, expr in re.findall(r"l\.(\w+) = ([^;]+);", body):
        expr = re.sub(r"l\.(\w+)", lambda m: str(out[m.group(1)]), expr).replace("/", "//")
        out[name] = eval(expr, {}, env)
    return out


@pytest.mark.parametrize("d,k_size", [(64, 9), (256, 31), (512, 31)])
def test_blob_layout_matches_the_kernel(d, k_size):
    src = (CSRC / "conv_block_cached.cu").read_text()
    ngp = K4.tap_groups(k_size)[1]
    got = _c_layout(src, "blob_layout", {"d": d, "ngp": ngp, "kCh": K4.CTA_COLS,
                                        "kSigTab": K4.SIG_TAB})
    assert got == K4.blob_layout(d, k_size)


@pytest.mark.parametrize("left,d_k,warps", [(8, 16, 4), (70, 64, 4), (70, 64, 16), (70, 20, 1)])
def test_attention_smem_matches_the_kernel(left, d_k, warps):
    src = (CSRC / "int_attention.cu").read_text()

    def helper(name):
        m = re.search(r"inline int " + name + r"\(int (\w+)\) \{ return ([^;]+); \}", src)
        return lambda v: eval(m.group(2).replace("/", "//"), {},
                              {m.group(1): v, "kTQC": K3.TQ_CACHE})
    env = {"DK": d_k, "L": left, "warps": warps, "kTQC": K3.TQ_CACHE, "kExpTab": K3.EXP_TAB,
           "cached_row_bytes": helper("cached_row_bytes"),
           "cached_vt_words": helper("cached_vt_words"),
           "cached_p8_bytes": helper("cached_p8_bytes")}
    body = re.search(r"cached_att_layout\(int DK, int L, int warps\) \{(.*?)\n\}", src, re.S)
    env["rp"] = env["cached_row_bytes"](d_k)
    assert "const int rp = cached_row_bytes(DK);" in body.group(1)
    got = _c_layout(src, "cached_att_layout", env)
    assert got["bytes"] == K3.cached_smem_bytes(left, d_k, warps)
