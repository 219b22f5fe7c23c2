"""W8A8 and Jasper's dense convs in the port against the JAX package.

(a) The premise of the uint8 storage: at W8A8 every asymmetric (+1 bit)
    site's codes are >= 0, in the JAX package's calibrating QuantExec and
    its FrozenExec, on a tiny QuartzNet and a tiny Jasper.
(b) Kernel 8's plain version (``dense_conv_plain``) against XLA's integer
    conv (``conv_nwc(..., preferred=int32)``) over K {1, 5, 11}, stride
    {1, 2}, dilation {1, 2}, int8 and uint8 inputs; and in its prologue
    and epilogue modes against the JAX package's requant chain, with
    ragged lengths.
(c) A tiny Jasper (a stride-2 first conv, dense residual blocks of one and
    two panes, a dilation-2 block, K 5-11, a pointwise block) at W6A6 and
    W8A8: the calibrated ranges equal the JAX package's run op by op, the
    frozen tables are digest-equal, and in both dyadic modes FrozenExec,
    FrozenExecFused and FrozenExecKernels (the kernels' plain versions)
    give the JAX FrozenExec's decoder input, int32 logits, ids and
    lengths, each calling the kernel wrappers as ``kernel_launches`` says.
(d) A tiny QuartzNet at W8A8: the same frozen paths in both dyadic modes.
Tolerance: exact.  Tests that need the card live in chip_smoke.py.
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
from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
from qasr_tpu_torch.quantize import freeze as port_freeze
from qasr_tpu_torch.quantize.freeze import (
    FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest,
)
from test_torch_slice_requant import jax_frozen_parts

FEAT = 16


def tiny_jasper_cfg():
    blocks = (
        BlockConfig(filters=32, repeat=1, kernel=(11,), stride=(2,), residual=False,
                    separable=False),
        BlockConfig(filters=32, repeat=2, kernel=(5,), residual=True, separable=False,
                    residual_dense=True),
        BlockConfig(filters=48, repeat=2, kernel=(7,), residual=True, separable=False,
                    residual_dense=True),
        BlockConfig(filters=48, repeat=1, kernel=(9,), dilation=(2,), residual=False,
                    separable=False),
        BlockConfig(filters=64, repeat=1, kernel=(1,), residual=False, separable=False),
    )
    return ModelConfig(encoder=EncoderConfig(feat_in=FEAT, blocks=blocks, activation="relu"),
                       decoder=DecoderConfig(feat_in=64, num_classes=28),
                       preprocessor={"features": FEAT, "n_fft": 512, "dither": 1e-5})


def tiny_quartznet_cfg():
    blocks = (
        BlockConfig(filters=16, repeat=1, kernel=(11,), stride=(2,), residual=False,
                    separable=True),
        BlockConfig(filters=16, repeat=2, kernel=(7,), residual=True, separable=True),
        BlockConfig(filters=24, repeat=1, kernel=(5,), residual=True, separable=True,
                    residual_dense=True),
        BlockConfig(filters=32, repeat=1, kernel=(1,), residual=False, separable=False),
    )
    return ModelConfig(encoder=EncoderConfig(feat_in=FEAT, blocks=blocks, activation="relu"),
                       decoder=DecoderConfig(feat_in=32, num_classes=28),
                       preprocessor={"features": FEAT, "n_fft": 512, "dither": 1e-5})


CFGS = {"jasper": tiny_jasper_cfg, "quartznet": tiny_quartznet_cfg}


def calib_features(n=2, b=2, t=96):
    rng = np.random.default_rng(7)
    return [rng.normal(size=(b, t, FEAT)).astype(np.float32) for _ in range(n)]


def pair(kind, bits, port_calibrates=True):
    """(JAX model, port model) of the same seed, BN-folded, and calibrated
    on the same features: JAX op by op, the port on the CPU; or (not
    ``port_calibrates``) JAX compiled and the port given its ranges."""
    jm = JaxASRModel.from_config(CFGS[kind](), seed=0)
    pm = ASRModel.from_config(CFGS[kind](), seed=0)
    for m in (jm, pm):
        m.set_quant_bit(bits, "all")
        m.bn_folding()
    feats = calib_features(1)
    if not port_calibrates:
        jm.calibrate(feats)
        pm.qstate = state_from_jax(jm.qstate)
        return jm, pm
    with jax.disable_jit():
        jm.calibrate(feats)
    pm.calibrate(feats, device="cpu")
    return jm, pm


@pytest.fixture(scope="module")
def jasper_pairs():
    return {bits: pair("jasper", bits) for bits in (6, 8)}


def leaves(qstate):
    return [np.float32(v) for v in jax.tree_util.tree_leaves(qstate)]


# ---------------------------------------------------------------------------
# (a) the premise of the uint8 storage
# ---------------------------------------------------------------------------


class _RecordingQuant(JJ.QuantExec):
    def __init__(self, *a, seen, **kw):
        super().__init__(*a, **kw)
        self.seen = seen

    def act_quantize(self, path, x, bits, identity=None):
        q = super().act_quantize(path, x, bits, identity)
        if bits == self.qcfg.act_bit + 1:
            self.seen.append(jnp.stack([jnp.min(q.values), jnp.max(q.values)]))
        return q


class _RecordingFrozen(JaxFrozenExec):
    def __init__(self, *a, seen, **kw):
        super().__init__(*a, **kw)
        self.seen = seen

    def _requant_in(self, entry, x, bits):
        q = super()._requant_in(entry, x, bits)
        if bits == self.qcfg.act_bit + 1:
            self.seen.append(jnp.stack([jnp.min(q.values), jnp.max(q.values)]).astype(jnp.int32))
        return q


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_w8a8_asymmetric_codes_are_nonnegative(kind):
    """Every 9-bit (asymmetric) site of W8A8 reads a post-ReLU value: its
    codes are >= 0 in the calibrating QuantExec and in FrozenExec, so a
    uint8 holds them (the codes' (min, max) per site)."""
    jm = JaxASRModel.from_config(CFGS[kind](), seed=0)
    jm.set_quant_bit(8, "all")
    jm.bn_folding()
    x = jnp.asarray(calib_features(1)[0])
    lens = jnp.asarray([96, 71], jnp.int32)
    n_asym = sum(s.asymmetric for bp in jm.plan.blocks for s in bp.convs + bp.res)

    @jax.jit
    def calibrating(x, lens):
        seen = []
        ex = _RecordingQuant(jm.params["encoder"], jm.qstate, jm.qcfg, activation="relu",
                             update_ranges=True, seen=seen)
        JJ.encoder_forward(ex, jm.plan, x, lens)
        return jnp.stack(seen), ex.new_qstate

    seen, jm.qstate = calibrating(x, lens)
    jm.qstate["decoder_act"] = {"x_min": np.float32(-1.0), "x_max": np.float32(1.0)}
    tables = jm.freeze()

    @jax.jit
    def frozen(x, lens):
        seen = []
        fx = _RecordingFrozen(tables, jm.qcfg, activation="relu", seen=seen)
        JJ.encoder_forward(fx, jm.plan, JJ.pad_frames_aligned(x), lens)
        return jnp.stack(seen)

    for ranges in (np.asarray(seen), np.asarray(frozen(x, lens))):
        assert ranges.shape == (n_asym, 2) and n_asym > 3
        assert ranges[:, 0].min() >= 0 and (ranges[:, 1] > 0).all(), ranges


# ---------------------------------------------------------------------------
# (b) Kernel 8's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("k,stride,dilation", [
    (k, s, d) for k in (1, 5, 11) for s in (1, 2) for d in (1, 2)])
def test_dense_conv_plain_matches_xla_int_conv(k, stride, dilation, u8):
    rng = np.random.default_rng(100 * k + 10 * stride + dilation)
    b, t, cin, cout = 2, 29, 24, 40
    x = (rng.integers(0, 256, (b, t, cin)) if u8 else
         rng.integers(-128, 128, (b, t, cin))).astype(np.uint8 if u8 else np.int8)
    w = rng.integers(-127, 127, (k, cin, cout)).astype(np.int8)
    pad = (dilation * (k - 1)) // 2 + stride - 1
    spec = JJ.ConvSpec(in_ch=cin, out_ch=cout, kernel=k, stride=stride, dilation=dilation,
                       padding=pad)
    jx = jnp.asarray(x.astype(np.int32)) if u8 else jnp.asarray(x)
    jw = jnp.asarray(w.astype(np.int32)) if u8 else jnp.asarray(w)
    want = np.asarray(JJ.conv_nwc(jx, jw, spec, preferred=jnp.int32))
    wk = torch.from_numpy(w.transpose(2, 0, 1).copy())
    got = dense_conv(torch.from_numpy(x), wk, stride=stride, padding=pad, dilation=dilation)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch", [1, 4, 64])
def test_dense_conv_plan_covers_every_jasper_site(batch):
    """Kernel 8's plan at every Jasper10x5Dr site (15 s: 1,536 frames in):
    its Cout tile is a width of wgmma's int8 m64nNk32 that splits Jasper's
    Couts without padding, its resident rows, weight ring (two stages or
    more) and alignment slack fit a block's shared memory, its weight box
    is (128 bytes, 1 tap, BN), and the grid covers every frame tile, batch
    element and Cout tile once."""
    from qasr_tpu_torch.kernels import dense_conv as dc
    from qasr_tpu_torch.models.config import jasper10x5dr
    from qasr_tpu_torch.models.jasper import build_encoder_plan, is_dense, out_frames

    legal = {8, 16, 24} | set(range(32, 257, 16))   # m64nNk32's N for .s8 / .u8
    plan = build_encoder_plan(jasper10x5dr().encoder)
    specs = [s for bp in plan.blocks for s in bp.convs if is_dense(s)]
    assert len(specs) == 52
    for s in specs:
        t_in = 1536 if s.stride == 2 else 768
        t_out = out_frames(t_in, s.kernel, s.stride, s.padding, s.dilation)
        p = dc.check_launch(batch, t_in, s.in_ch, s.out_ch, s.kernel, s.stride, s.padding,
                            s.dilation, False, torch.uint8)
        assert p == dc.plan(batch, t_out, s.in_ch, s.out_ch, s.kernel, s.stride, s.dilation)
        bn = p["bn"]
        assert bn in legal and bn in dc.WIDTHS and s.out_ch % bn == 0
        assert p["box"] == (dc.KC, 1, bn)
        assert p["rows"] == (dc.BM - 1) * s.stride + (s.kernel - 1) * s.dilation + 1
        assert p["pitch"] == p["nc"] * dc.KC + 16 and p["nc"] * dc.KC >= s.in_ch
        assert 2 <= p["stages"] <= dc.MAX_STAGES
        assert p["smem"] == (p["stages"] * (bn * dc.KC + 16) + p["rows"] * p["pitch"]
                             + dc.ALIGN) <= dc.SMEM_LIMIT
        gx, gy, gz = p["grid"]
        n_ct = s.out_ch // bn
        assert (gx - 1) * dc.BM < t_out <= gx * dc.BM and gy == batch
        assert (gz - 1) * p["ct_per"] < n_ct <= gz * p["ct_per"]
        owned = [(x, z * p["ct_per"] + i) for x in range(gx) for z in range(gz)
                 for i in range(p["ct_per"]) if z * p["ct_per"] + i < n_ct]
        assert sorted(owned) == [(x, c) for x in range(gx) for c in range(n_ct)]
        assert gx * gy * gz >= min(dc.SMS, gx * gy * n_ct)
    assert {s.out_ch: dc.tile_n(s.out_ch) for s in specs} == {
        256: 128, 384: 192, 512: 128, 640: 160, 768: 192, 896: 128}


@pytest.mark.parametrize("args,match", [
    ((2, 100, 24, 32, 5, 1, 2, 1, False, torch.int8), "multiple of 16"),
    ((2, 100, 32, 32, 5, 1, 2, 1, False, torch.int32), "int8 or uint8"),
    ((2, 4, 16, 16, 11, 1, 0, 1, False, torch.int8), "empty output"),
    ((65536, 8, 16, 16, 1, 1, 0, 1, False, torch.int8), "B below 65536"),
    ((2, 400, 768, 896, 101, 1, 100, 2, True, torch.int32), "two 128-channel weight stages"),
    ((2, 400, 768, 768, 54, 1, 53, 2, False, torch.uint8), "two 192-channel weight stages"),
])
def test_dense_conv_check_launch_refuses(args, match):
    """check_launch refuses what Kernel 8 does not take, the ring's limit
    included: at K=54 d=2 Cin=768 the 234 resident rows leave room for two
    stages of Cout 896's 128-channel tile but not of Cout 768's 192."""
    from qasr_tpu_torch.kernels import dense_conv as dc

    with pytest.raises(ValueError, match=match):
        dc.check_launch(*args)
    if "192-channel" in match:
        p = dc.check_launch(2, 400, 768, 896, 54, 1, 53, 2, False, torch.uint8)
        assert (p["bn"], p["stages"], p["rows"]) == (128, 2, 234)


def _jax_chain_prologue(x, in_bias, lens, m1, e1, bits1):
    v = jnp.maximum(jnp.asarray(x, jnp.int32) + in_bias, 0)
    v = JJ.mask_values(v, jnp.asarray(lens))
    return requant_clamp(dyadic_requant_static(v, jnp.asarray(m1), e1), bits1)


@pytest.mark.parametrize("mode", ["none", "requant6", "requant9_u8", "join"])
@pytest.mark.parametrize("x32", [False, True])
def test_dense_conv_modes_match_jax_chain(mode, x32):
    """The prologue (bias, ReLU, ragged length mask, requant; from int8 or
    int32) and each epilogue against the JAX package's ops in the
    FrozenExec order."""
    rng = np.random.default_rng(5 + x32)
    b, t, cin, cout, k, dil = 3, 37, 32, 48, 7, 2
    pad = (dil * k) // 2 - 1
    x = (rng.integers(-2 ** 20, 2 ** 20, (b, t, cin)).astype(np.int32) if x32 else
         rng.integers(-128, 128, (b, t, cin)).astype(np.int8))
    w = rng.integers(-31, 31, (k, cin, cout)).astype(np.int8)
    in_bias = rng.integers(-500, 500, cin).astype(np.int32)
    in_len = np.asarray([37, 20, 5], np.int32)
    m1, e1, bits1 = rng.integers(2 ** 29, 2 ** 31, cin).astype(np.int32), (42 if x32 else 32), 9
    bias = rng.integers(-2000, 2000, cout).astype(np.int32)
    m, e = rng.integers(2 ** 29, 2 ** 31, cout).astype(np.int32), 40
    out_len = np.asarray([30, 12, 1], np.int32)
    res = rng.integers(-2 ** 22, 2 ** 22, (b, t, cout)).astype(np.int32)
    m_r, e_r = rng.integers(2 ** 29, 2 ** 31, cout).astype(np.int32), 46

    a = _jax_chain_prologue(x, in_bias, in_len, m1, e1, bits1)
    assert int(jnp.min(a)) >= 0 and int(jnp.max(a)) > 127   # uint8 codes past int8
    spec = JJ.ConvSpec(in_ch=cin, out_ch=cout, kernel=k, dilation=dil, padding=pad)
    y = JJ.conv_nwc(a, jnp.asarray(w.astype(np.int32)), spec, preferred=jnp.int32) + bias
    kw = dict(dilation=dil, padding=pad, bias=torch.from_numpy(bias),
              in_bias=torch.from_numpy(in_bias), in_relu=True, in_len=torch.from_numpy(in_len),
              m1=torch.from_numpy(m1), e1=e1, bits1=bits1)
    if mode == "none":
        want, kw["relu"] = jnp.maximum(y, 0), True
    elif mode.startswith("requant"):
        bits = 6 if mode == "requant6" else 9
        v = JJ.mask_values(jnp.maximum(y, 0), jnp.asarray(out_len))
        want = requant_clamp(dyadic_requant_static(v, jnp.asarray(m), e), bits)
        kw.update(relu=True, lens=torch.from_numpy(out_len), m=torch.from_numpy(m), e=e,
                  bits=bits)
    else:
        want = requant_clamp(dyadic_requant_static(y, jnp.asarray(m), e)
                             + dyadic_requant_static(jnp.asarray(res), jnp.asarray(m_r), e_r), 7)
        kw.update(m=torch.from_numpy(m), e=e, bits=7, res=torch.from_numpy(res),
                  m_r=torch.from_numpy(m_r), e_r=e_r)
    got = dense_conv(torch.from_numpy(x), torch.from_numpy(w.transpose(2, 0, 1).copy()), **kw)
    want_dtype = {"none": torch.int32, "requant6": torch.int8, "requant9_u8": torch.uint8,
                  "join": torch.int8}[mode]
    assert got.dtype == want_dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want, np.int64))
    assert len(np.unique(got.numpy())) > 8
    assert torch.equal(got, dense_conv_plain(torch.from_numpy(x),
                                             torch.from_numpy(w.transpose(2, 0, 1).copy()),
                                             **kw))


# ---------------------------------------------------------------------------
# (c), (d) the frozen and calibrating paths
# ---------------------------------------------------------------------------


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


def _frozen_paths_match(jm, pm, mode, monkeypatch):
    jt = jm.freeze(dyadic_mode=mode)
    tables = tables_from_jax(jt, "cpu")
    assert tables_digest(pm.freeze_host(mode)) == tables_digest(state_from_jax(jt))
    rng = np.random.default_rng(31)
    feats = rng.normal(size=(2, 128, FEAT)).astype(np.float32)
    lens = np.asarray([128, 93], np.int32)
    want = jax_frozen_parts(jm, jt, feats, lens)
    assert len(np.unique(want[2])) > 1, "degenerate ids"
    static = mode != "per_channel"
    names = ("decoder int8 input", "int32 logits", "ids", "enc_lens")
    execs = (FrozenExec, FrozenExecFused, FrozenExecKernels) if static else \
        (FrozenExec, FrozenExecKernels)
    for ex in execs:
        got = golden.frozen_from_features(pm, tables, feats, lens, executor=ex)
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{ex.__name__} {name}")
    calls = _counting(monkeypatch)
    pcm = (rng.normal(size=(2, 8000)) * 0.1 * 32767).astype(np.int16)
    ids, _ = make_frozen_fn(pm, tables, argmax=True)(pcm, np.asarray([8000, 5600]))
    assert calls == {"requant": 0, "dense_conv": 0,
                     **port_freeze.kernel_launches(pm.plan, tables)}
    ids_p, _ = make_frozen_fn(pm, tables, argmax=True, fused=False)(
        pcm, np.asarray([8000, 5600]))
    assert torch.equal(ids, ids_p)
    return calls


@pytest.mark.parametrize("bits", [6, 8])
def test_jasper_calibration_and_tables_match_jax(jasper_pairs, bits):
    jm, pm = jasper_pairs[bits]
    want, got = leaves(jm.qstate), leaves(pm.qstate)
    # the post-ReLU sites' minima are 0; every maximum is not
    assert len(got) == len(want) == 32 and sum(v != 0 for v in want) >= 16
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


@pytest.mark.parametrize("mode", ["static_e", "per_channel"])
@pytest.mark.parametrize("bits", [6, 8])
def test_jasper_frozen_paths_match_jax(jasper_pairs, bits, mode, monkeypatch):
    jm, pm = jasper_pairs[bits]
    calls = _frozen_paths_match(jm, pm, mode, monkeypatch)
    # 1 + 2 (block 1) + 2 (block 2) + 1 dense convs; 1 + 2 residual 1x1s,
    # the pointwise block and the decoder
    assert calls["dense_conv"] == 6 and calls["pw_gemm"] == 5 and calls["dw_conv"] == 0
    # static: block 2's second pane joins in the requant kernel; per_channel
    # also requantizes every dense conv's and residual 1x1's input there
    assert calls["requant"] == (1 if mode == "static_e"
                                else port_freeze._requant_sites(pm.plan, pm.freeze_host(mode)))


@pytest.mark.parametrize("mode", ["static_e", "per_channel"])
def test_quartznet_w8a8_frozen_paths_match_jax(mode, monkeypatch):
    """(W8A8 QuartzNet's calibration is test_torch_calibrate's.)"""
    jm, pm = pair("quartznet", 8, port_calibrates=False)
    _frozen_paths_match(jm, pm, mode, monkeypatch)


@pytest.fixture
def one_torch_thread():
    """Full width on one intra-op thread: with several test workers on the
    same cores, torch's default pool is far slower; integer results do not
    depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mode", ["static_e", "per_channel"])
def test_quartznet15x5_w8a8_golden_on_cpu(mode):
    """Full-width QuartzNet15x5 at W8A8 (the committed ranges) reproduces
    the JAX package's golden record on FrozenExecKernels, its uint8 codes
    in the kernels' plain versions (the card holds the other executors:
    chip_smoke.py phase 10b)."""
    model = golden.flagship("quartznet15x5", 8)
    feats, lens = golden.golden_features()
    got = golden.port_record(model, model.freeze(mode, device="cpu"), feats, lens,
                             executor=FrozenExecKernels)
    assert golden.compare_golden(got, golden.load_golden(mode, "quartznet15x5", 8)) == []
