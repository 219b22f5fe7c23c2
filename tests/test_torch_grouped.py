"""Grouped convs with GroupShuffle, ``heads`` and the non-ReLU activations
in the port against the JAX package.

A 3-block plan: a separable block with grouped (2) pointwise convs and a
residual, a non-separable block with grouped (4) K=5 convs and a residual,
and a separable ``heads`` = 1 block whose pointwise conv is grouped (4),
under relu, hardtanh, selu and swish, at W6A6 and W8A8:

(a) the float forward (FloatExec) within 1e-5 relative;
(b) the calibrated ranges (hardtanh W6A6, swish W8A8), the port on the
    CPU against the JAX package run op by op: equal for hardtanh, within
    1e-6 relative for swish (its float function may sit an ulp from
    XLA's);
(c) the frozen tables' digests equal the JAX package's (on the JAX
    package's ranges), and (each activation at both bit widths, each in
    both dyadic modes across them) FrozenExec, FrozenExecFused (static
    exponents) and FrozenExecKernels (the kernels' plain versions on
    the CPU) give the JAX FrozenExec's decoder int8 input, int32 logits,
    ids and lengths, bit for bit for relu and hardtanh; for selu and swish
    (float glue: torch's expm1 / sigmoid and XLA's compiled division by the
    scale may sit an ulp apart) at most one decoder-input code in 2,000
    off, by at most 1, and equal ids, each executor calling the kernel
    wrappers as ``kernel_launches`` says;
(d) hardtanh's integer clip before a dyadic requant equals the requant
    with a per-channel code ceiling (the identity a kernel may use), swept
    around each ceiling and the requant's rounding edges, and the port's
    ceiling is the JAX FrozenExec's;
(e) Kernels 2 and 8 grouped: their plain versions against XLA's grouped
    integer conv and GroupShuffle, their plans and launch checks at
    QuartzNet15x5-g4's and the Jasper-width block's sites, and the group
    widths they refuse (NotImplementedError), and the storage of W8A8's
    signed 9-bit codes after selu or swish: two uint8 byte planes, the
    split identity swept over every code.
Tests that need the card live in chip_smoke.py (phases 11 and 12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import jasper as JJ
from qasr_tpu.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.ops.quant_prims import dyadic_requant_static, requant_clamp
from qasr_tpu.quantize.freeze import FrozenExec as JaxFrozenExec
from qasr_tpu_torch import golden
from qasr_tpu_torch.compat.from_jax import state_from_jax, tables_from_jax
from qasr_tpu_torch.kernels import dense_conv as dc
from qasr_tpu_torch.kernels import pw_gemm as pg
from qasr_tpu_torch.kernels.checks import act_dtype
from qasr_tpu_torch.models import jasper as PJ
from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
from qasr_tpu_torch.ops.quant_prims import clip_ceiling, hardtanh_ceiling, requant_epilogue
from qasr_tpu_torch.quantize import freeze as port_freeze
from qasr_tpu_torch.quantize.freeze import (
    FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest,
)
from qasr_tpu_torch.quantize.ranges import params_to_device

FEAT = 16
ACTS = ("relu", "hardtanh", "selu", "swish")
EXACT = ("relu", "hardtanh")
# hardtanh's features are scaled up so that its clip at 20 bites
GAIN = {"hardtanh": 40.0}


def grouped_cfg(activation: str) -> ModelConfig:
    blocks = (
        BlockConfig(filters=32, repeat=2, kernel=(7,), residual=True, separable=True,
                    groups=2),
        BlockConfig(filters=32, repeat=2, kernel=(5,), residual=True, separable=False,
                    groups=4),
        BlockConfig(filters=48, repeat=1, kernel=(9,), residual=False, separable=True,
                    groups=4, heads=1),
    )
    return ModelConfig(encoder=EncoderConfig(feat_in=FEAT, blocks=blocks,
                                             activation=activation),
                       decoder=DecoderConfig(feat_in=48, num_classes=28),
                       preprocessor={"features": FEAT, "n_fft": 512, "dither": 1e-5})


def features(seed=7, b=2, t=96, gain=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, FEAT)) * gain).astype(np.float32)


_PAIRS = {}


def pair(act, bits):
    """(JAX model, port model) of one seed, BN-folded, the JAX one
    calibrated (compiled) on one feature batch, the port given its ranges."""
    if (act, bits) not in _PAIRS:
        jm = JaxASRModel.from_config(grouped_cfg(act), seed=0)
        pm = ASRModel.from_config(grouped_cfg(act), seed=0)
        for m in (jm, pm):
            m.set_quant_bit(bits, "all")
            m.bn_folding()
        jm.calibrate([features(gain=GAIN.get(act, 1.0))])
        pm.qstate = state_from_jax(jm.qstate)
        _PAIRS[act, bits] = (jm, pm)
    return _PAIRS[act, bits]


def test_plan_has_groups_shuffles_and_heads():
    plan = PJ.build_encoder_plan(grouped_cfg("relu").encoder)
    convs = [s for bp in plan.blocks for s in bp.convs]
    assert [s.groups for s in convs] == [16, 2, 32, 2, 4, 4, 32, 4]
    assert sum(s.heads == 1 for s in convs) == 1
    assert sum(map(PJ.is_depthwise, convs)) == 3
    assert sum(PJ.is_pointwise(s) and s.groups > 1 for s in convs) == 3
    assert sum(PJ.is_dense(s) and s.groups > 1 for s in convs) == 2


# ---------------------------------------------------------------------------
# (a) float, (b) calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
def test_float_forward_matches_jax(act):
    jm = JaxASRModel.from_config(grouped_cfg(act), seed=0)
    pm = ASRModel.from_config(grouped_cfg(act), seed=0)
    x = features(3, gain=GAIN.get(act, 1.0))
    lens = np.asarray([96, 70], np.int32)
    ex = JJ.FloatExec(jm.params["encoder"], activation=act)
    want, want_lens = JJ.encoder_forward(ex, jm.plan, jnp.asarray(x), jnp.asarray(lens))
    px = PJ.FloatExec(params_to_device(pm.params["encoder"], "cpu"), activation=act)
    got, got_lens = PJ.encoder_forward(px, pm.plan, torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


@pytest.mark.parametrize("act,bits", [("hardtanh", 6), ("swish", 8)])
def test_calibration_matches_jax(act, bits):
    jm = JaxASRModel.from_config(grouped_cfg(act), seed=0)
    pm = ASRModel.from_config(grouped_cfg(act), seed=0)
    for m in (jm, pm):
        m.set_quant_bit(bits, "all")
        m.bn_folding()
    feats = features(t=48, gain=GAIN.get(act, 1.0))
    with jax.disable_jit():
        jm.calibrate([feats])
    pm.calibrate([feats], device="cpu")
    want = np.asarray([np.float32(v) for v in jax.tree_util.tree_leaves(jm.qstate)])
    got = np.asarray([np.float32(v) for v in jax.tree_util.tree_leaves(pm.qstate)])
    assert len(got) == len(want) == 28 and (want != 0).sum() >= 14
    if act in EXACT:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# (c) the frozen paths
# ---------------------------------------------------------------------------


def jax_frozen_parts(jm, tables, feats, lens):
    """The JAX FrozenExec forward (compiled): decoder int8 input, int32
    logits, ids and lengths."""
    def run(x, lengths):
        fx = JaxFrozenExec(tables, jm.qcfg, activation=jm.plan.activation)
        enc, enc_lens = JJ.encoder_forward(fx, jm.plan, JJ.pad_frames_aligned(x), lengths)
        t = tables["decoder"]
        q = requant_clamp(fx._requant(enc.values, t["act_m"], t["act_e"]),
                          jm.qcfg.act_bit).astype(jnp.int8)
        logits = JJ.conv_nwc(q, t["w"], JJ.decoder_spec(q.shape[-1], t["w"].shape[-1]),
                             preferred=jnp.int32) + t["b"]
        lp = jax.nn.log_softmax(logits.astype(jnp.float32) * t["out_scale"], axis=-1)
        return q, logits, jnp.argmax(lp, axis=-1), enc_lens
    return [np.asarray(o) for o in jax.jit(run)(jnp.asarray(feats), jnp.asarray(lens))]


class _ClipCounting(FrozenExec):
    """FrozenExec counting the values hardtanh's ceiling clips."""
    clipped = 0

    def activation(self, x, dropout):
        out = super().activation(x, dropout)
        _ClipCounting.clipped += int((x.values.clamp_min(0) > out.values).sum())
        return out


def _clipped(pm, tables, feats, lens) -> int:
    _ClipCounting.clipped = 0
    golden.frozen_from_features(pm, tables, feats, lens, executor=_ClipCounting)
    return _ClipCounting.clipped


def _counting(monkeypatch):
    calls = {"dw_conv": 0, "pw_gemm": 0, "requant": 0, "dense_conv": 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name in calls:
        monkeypatch.setattr(port_freeze, name, counting(name, getattr(port_freeze, name)))
    return calls


# every activation at both bit widths, each in both dyadic modes across them
FROZEN_CASES = [("relu", 6, "static_e"), ("relu", 8, "per_channel"),
                ("hardtanh", 6, "static_e"), ("hardtanh", 8, "per_channel"),
                ("selu", 6, "per_channel"), ("selu", 8, "static_e"),
                ("swish", 6, "static_e"), ("swish", 8, "per_channel")]


@pytest.mark.parametrize("act,bits,mode", FROZEN_CASES)
def test_frozen_paths_match_jax(act, bits, mode, monkeypatch):
    jm, pm = pair(act, bits)
    jt = jm.freeze(dyadic_mode=mode)
    assert tables_digest(pm.freeze_host(mode)) == tables_digest(state_from_jax(jt))
    tables = tables_from_jax(jt, "cpu")
    rng = np.random.default_rng(31)
    feats = (rng.normal(size=(2, 128, FEAT)) * GAIN.get(act, 1.0)).astype(np.float32)
    lens = np.asarray([128, 93], np.int32)
    want = jax_frozen_parts(jm, jt, feats, lens)
    if act == "hardtanh":
        assert _clipped(pm, tables, feats, lens) > 100
    assert len(np.unique(want[2])) > 1, "degenerate ids"
    execs = (FrozenExec, FrozenExecKernels) + ((FrozenExecFused,) if mode != "per_channel"
                                               else ())
    names = ("decoder int8 input", "int32 logits", "ids", "enc_lens")
    for ex in execs:
        got = [g.numpy() for g in golden.frozen_from_features(pm, tables, feats, lens,
                                                              executor=ex)]
        if act in EXACT:
            for name, g, w in zip(names, got, want):
                np.testing.assert_array_equal(g, w, err_msg=f"{ex.__name__} {name}")
        else:
            d = np.abs(got[0].astype(np.int64) - want[0].astype(np.int64))
            assert d.max() <= 1 and (d > 0).sum() * 2000 <= d.size, (ex.__name__, d.sum())
            np.testing.assert_array_equal(got[2], want[2], err_msg=f"{ex.__name__} ids")
            np.testing.assert_array_equal(got[3], want[3])
    calls = _counting(monkeypatch)
    pcm = (rng.normal(size=(2, 8000)) * 0.1 * 32767).astype(np.int16)
    ids, _ = make_frozen_fn(pm, tables, argmax=True)(pcm, np.asarray([8000, 5600]))
    assert calls == {"requant": 0, "dense_conv": 0,
                     **port_freeze.kernel_launches(pm.plan, tables)}
    ids_p, _ = make_frozen_fn(pm, tables, argmax=True, fused=False)(
        pcm, np.asarray([8000, 5600]))
    assert torch.equal(ids, ids_p)


# ---------------------------------------------------------------------------
# (d) hardtanh's ceiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [6, 8])
def test_hardtanh_ceiling_identity(bits):
    """clamp(requant(clip(z, 0, H[c])), lo, hi) == clamp(requant(max(z, 0)),
    0, min(hi, requant(H[c]))) for a monotone dyadic requant with
    requant(0) = 0, swept over accumulators around each H[c] and around
    the requant's rounding edges; and the port's epilogue with the
    ceiling equals the JAX FrozenExec order (jnp.clip, then requant)."""
    rng = np.random.default_rng(bits)
    c = 24
    scale = rng.uniform(1e-4, 2e-2, c).astype(np.float32)
    h = hardtanh_ceiling(scale)
    np.testing.assert_array_equal(h, np.asarray(jnp.round(20.0 / scale).astype(jnp.int32)))
    m = rng.integers(2 ** 29, 2 ** 31 - 1, c).astype(np.int64)
    e = 30 + int(np.log2(np.median(h) / 2 ** (bits - 1)))
    edges = [(2 * k + 1) * 2 ** (e - 1) // m for k in range(-3, 40)]   # z m near a .5 edge
    z = np.concatenate([h[None, :] + np.arange(-3, 4)[:, None],
                        np.stack(edges) + rng.integers(-1, 2, (len(edges), c)),
                        rng.integers(-2 * h.max(), 2 * h.max(), (200, c))]).astype(np.int32)
    n = 2 ** (bits - 1) - 1
    zj, mj = jnp.asarray(z), jnp.asarray(m.astype(np.int32))
    lhs = requant_clamp(dyadic_requant_static(jnp.clip(zj, 0, jnp.asarray(h)), mj, e), bits)
    cap = dyadic_requant_static(jnp.asarray(h)[None, :], mj, e)
    rhs = jnp.clip(dyadic_requant_static(jnp.maximum(zj, 0), mj, e), 0, jnp.minimum(n, cap))
    np.testing.assert_array_equal(np.asarray(lhs), np.asarray(rhs))
    assert (np.asarray(lhs) == np.asarray(cap)).sum() > 50      # the ceiling bites
    got = requant_epilogue(torch.from_numpy(z)[None], relu=True, hcap=torch.from_numpy(h),
                           m=torch.from_numpy(m.astype(np.int32)), e=e, bits=bits)
    np.testing.assert_array_equal(got[0].numpy().astype(np.int64), np.asarray(lhs))
    # the join's scalar ceiling on int8 codes, capped at 127 as the JAX
    # FrozenExec does
    assert hardtanh_ceiling(np.float32(0.05), narrow=True) == 127
    assert hardtanh_ceiling(np.float32(0.5), narrow=True) == 40
    codes = torch.arange(-128, 128, dtype=torch.int32)
    np.testing.assert_array_equal(clip_ceiling(codes.clamp_min(0), 40).numpy(),
                                  np.clip(np.arange(-128, 128), 0, 40))


# ---------------------------------------------------------------------------
# (e) Kernels 2 and 8 grouped
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,groups,shuffle", [(1, 2, True), (1, 4, False), (5, 4, True),
                                              (3, 8, True)])
def test_grouped_plain_matches_xla_and_group_shuffle(k, groups, shuffle):
    rng = np.random.default_rng(10 * k + groups)
    b, t, cin, cout = 2, 23, 32, 64
    x = rng.integers(-128, 128, (b, t, cin)).astype(np.int8)
    w = rng.integers(-127, 127, (k, cin // groups, cout)).astype(np.int8)
    spec = JJ.ConvSpec(in_ch=cin, out_ch=cout, kernel=k, groups=groups, padding=k // 2)
    want = JJ.conv_nwc(jnp.asarray(x), jnp.asarray(w), spec, preferred=jnp.int32)
    want = np.asarray(JJ.group_shuffle(jnp.maximum(want, 0), groups) if shuffle
                      else jnp.maximum(want, 0))
    wk = PJ.kernel_weight(torch.from_numpy(w))
    kw = dict(groups=groups, shuffle=shuffle, relu=True)
    got = (pg.pw_gemm(torch.from_numpy(x), wk, **kw) if k == 1 else
           dc.dense_conv(torch.from_numpy(x), wk, padding=k // 2, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    sv = np.arange(cout, dtype=np.float32)
    np.testing.assert_array_equal(PJ.shuffle_channel_vector(sv, groups),
                                  np.asarray(JJ.shuffle_channel_vector(jnp.asarray(sv), groups)))


def test_grouped_plans_at_the_serving_sites():
    """Kernel 2 grouped at QuartzNet15x5-g4's grouped pointwise sites (B=64
    x 15 s: 49,152 rows) and Kernel 8 grouped at the Jasper-width grouped
    block's (C 768, K 25, 4 groups) and at Cout/g = 64: column tiles of the
    4 groups x 32 (Kernel 2) or 48 (Kernel 8) columns in GroupShuffle's
    order, a group's K in steps that its width fills (no zero-padded
    channels), every column tile of a slice, shared memory within a
    block's."""
    for cin, cout in ((256, 256), (256, 512), (512, 512)):
        p = pg.check_launch(49152, cin, cout, True, torch.int32, groups=4)
        assert p == pg.grouped_plan(49152, cin, cout, 4, True)
        assert (p["kgc"], p["nj"], p["cgp"], p["n_tiles"]) == (4, 32, cin // 4, cout // 128)
        assert p["grid"] == (132, 1) and not p["a_tma"] and p["groups"] == 4
        assert p["smem"] <= pg.SMEM_LIMIT
    p = dc.check_launch(64, 768, 768, 768, 25, 1, 12, 1, True, torch.int32, groups=4)
    assert (p["kgc"], p["nks"], p["nj"], p["groups"]) == (4, 3, 48, 4)
    assert p["nks"] * dc.GROUPED_KS == 768 // 4
    gx, gy, gz = p["grid"]
    assert (gx, gy, gz) == (6, 64, 1) and p["t_per"] == p["n_tiles"] == 4
    assert p["smem"] <= dc.SMEM_LIMIT and p["stages"] >= 2
    p = dc.check_launch(8, 300, 256, 256, 5, 1, 2, 1, False, torch.int8, groups=4)
    assert (p["nj"], p["nks"], p["n_tiles"], p["grid"][2]) == (48, 1, 2, 2)
    assert dc.tile_n(64) == 128


@pytest.mark.parametrize("launch", ["pw", "dense"])
def test_grouped_kernels_refuse_narrow_groups(launch):
    """A group of 8 input channels (not a multiple of 16 bytes: the TMA
    pitch a group's box starts at) is refused with NotImplementedError;
    groups that do not divide the channels with ValueError."""
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        if launch == "pw":
            pg.check_launch(100, 64, 64, False, torch.int8, groups=8)
        else:
            dc.check_launch(2, 100, 64, 64, 5, 1, 2, 1, False, torch.int8, groups=8)
    with pytest.raises(ValueError, match="must divide"):
        if launch == "pw":
            pg.check_launch(100, 64, 48, False, torch.int8, groups=5)
        else:
            dc.check_launch(2, 100, 96, 64, 5, 1, 2, 1, False, torch.int8, groups=5)


def test_w8a8_signed_codes_raise_on_cuda():
    """W8A8 selu / swish: the asymmetric sites' 9-bit codes may be
    negative.  They no longer raise on CUDA (the test keeps the name of
    the rule it replaced): their storage is two uint8 byte planes v = u -
    256 s on every device (``act_dtype`` uint8, ``signed_planes``), which
    Kernel 7 writes and the uint8 forms of Kernels 1, 2 and 8 multiply.
    Swept over every code in [-256, 255]: the split identity, Kernel 7's
    planes (its plain version) against the split of its int32 requant,
    and the plane identity conv(W, v) + b == join_planes(conv(W, u) + b,
    conv(W, s)) for a depthwise, a pointwise and a dense conv at weights
    of +-127; an epilogue (one byte plane) still refuses the code, and
    10 bits raise on CUDA."""
    from qasr_tpu_torch.kernels.checks import (
        act_clamp, join_planes, signed_planes, split_planes,
    )
    from qasr_tpu_torch.kernels.dw_conv import dw_conv
    from qasr_tpu_torch.kernels.requant import requant

    for dev in ("cpu", torch.device("cuda")):
        assert act_dtype("conv input", 9, False, dev) == torch.uint8
        assert act_dtype("conv input", 9, True, dev) == torch.uint8
    assert signed_planes(9, False) and not signed_planes(9, True) \
        and not signed_planes(8, False)
    assert act_dtype("conv input", 10, False, "cpu") == torch.int32
    with pytest.raises(NotImplementedError, match="10-bit"):
        act_dtype("conv input", 10, False, torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="byte planes"):
        act_clamp("dw_conv", 9, False)
    v = torch.arange(-256, 256, dtype=torch.int32)
    u, s = split_planes(v)
    assert u.dtype == s.dtype == torch.uint8 and set(s.tolist()) == {0, 1}
    assert torch.equal(u.to(torch.int32) - 256 * s.to(torch.int32), v)
    rng = np.random.default_rng(9)
    z = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, size=(2, 64, 16)).astype(np.int32))
    lens = torch.tensor([64, 40], dtype=torch.int32)
    q = requant(z, 3 << 20, 32, 9, lens=lens)
    assert q.dtype == torch.int32 and int(q.min()) == -256 and int(q.max()) == 255
    pu, ps = requant(z, 3 << 20, 32, 9, lens=lens, planes=True)
    assert all(torch.equal(a, b) for a, b in zip((pu, ps), split_planes(q)))
    # every code in [-256, 255] through each conv family, weights at +-127
    x = v[torch.from_numpy(rng.permutation(512))].reshape(1, 512, 1).repeat(1, 1, 16)
    xu, xs = split_planes(x)
    c = 16
    b = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, size=c).astype(np.int32))
    w_dw = torch.from_numpy(rng.choice([-127, 127], size=(5, c)).astype(np.int8))
    w_pw = torch.from_numpy(rng.choice([-127, 127], size=(c, c)).astype(np.int8))
    w_dc = torch.from_numpy(rng.choice([-127, 127], size=(c, 3, c)).astype(np.int8))
    convs = {"dw": lambda a, bias: dw_conv(a, w_dw, padding=2, bias=bias),
             "pw": lambda a, bias: pg.pw_gemm(a, w_pw, bias=bias),
             "dense": lambda a, bias: dc.dense_conv(a, w_dc, padding=1, bias=bias)}
    for name, conv in convs.items():
        want = conv(x, b)
        got = join_planes(conv(xu, b), conv(xs, None))
        assert torch.equal(got, want), name
    assert port_freeze.planes_bound(np.full((29, 1, 4), 127, np.int8), None) < 2 ** 31
