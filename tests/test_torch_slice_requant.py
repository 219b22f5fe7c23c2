"""The port's frozen QuartzNet kernel executors against the JAX package, in
every dyadic mode, end to end:

(a) From the same float features and tables, FrozenExecFused (static
    exponents, every requant in a kernel's prologue or epilogue) and
    FrozenExecKernels (any tables; the requants next to a depthwise conv
    in Kernel 1's prologue and epilogue with per-channel exponents, the
    rest in the requant kernel) on the kernels' plain versions give the int8 decoder input, int32 logits,
    ids and enc_lens of the JAX FrozenExec, and for per_channel tables of
    the JAX FrozenExec(use_pallas=True) (requant_pallas in interpret mode),
    on a small plan with every site kind and dense residual blocks.
(b) make_frozen_fn picks the executor from the tables and calls each
    kernel wrapper as kernel_launches predicts.
(c) ASRModel.transcribe(dyadic_mode="per_channel") on the CPU gives the
    JAX package's transcripts.
(d) Full-width QuartzNet15x5 reproduces the per_channel and the static_e
    golden records on FrozenExecKernels, with 77 dw_conv + 94 pw_gemm +
    32 requant calls per per_channel forward (153 of the 185 requant sites
    fold into Kernel 1) (the plain executor's
    per_channel record is held on the card by chip_smoke.py).
Tolerance: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.data.audio import write_wav
from qasr_tpu.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.models.jasper import conv_nwc, decoder_spec, encoder_forward
from qasr_tpu.models.jasper import pad_frames_aligned as jax_pad_frames
from qasr_tpu.ops.quant_prims import requant_clamp
from qasr_tpu.quantize.freeze import FrozenExec as JaxFrozenExec
from qasr_tpu_torch import golden
from qasr_tpu_torch.compat.from_jax import state_from_jax, tables_from_jax
from qasr_tpu_torch.models.ctc_model import ASRModel, frozen_executor, make_frozen_fn
from qasr_tpu_torch.quantize import freeze as port_freeze
from qasr_tpu_torch.quantize.freeze import FrozenExecFused, FrozenExecKernels

MODES = ("static_e", "static_e16", "per_channel")


def small_cfg():
    """Every QuartzNet site kind at widths 16-32 (a stride-2 separable
    block, a residual separable block with repeat 2, two dense residual
    blocks, the second with two panes, a dilation-2 block, a
    non-separable k=1 block)."""
    blocks = (
        BlockConfig(filters=16, repeat=1, kernel=(11,), stride=(2,),
                    residual=False, separable=True),
        BlockConfig(filters=16, repeat=2, kernel=(7,), residual=True, separable=True),
        BlockConfig(filters=16, repeat=1, kernel=(5,), residual=True, separable=True,
                    residual_dense=True),
        BlockConfig(filters=16, repeat=1, kernel=(5,), residual=True, separable=True,
                    residual_dense=True),
        BlockConfig(filters=24, repeat=1, kernel=(9,), dilation=(2,),
                    residual=False, separable=True),
        BlockConfig(filters=32, repeat=1, kernel=(1,), residual=False, separable=False),
    )
    return ModelConfig(encoder=EncoderConfig(feat_in=16, blocks=blocks, activation="relu"),
                       decoder=DecoderConfig(feat_in=32, num_classes=28),
                       preprocessor={"features": 16, "n_fft": 512, "dither": 1e-5})


@pytest.fixture(scope="module")
def models():
    jm = JaxASRModel.from_config(small_cfg(), seed=0)
    jm.set_quant_bit(6, "all")
    jm.bn_folding()
    jm.calibrate_on_noise(batches=1, batch_size=2, seconds=0.5)
    pm = ASRModel.from_config(small_cfg(), seed=0)
    pm.set_quant_bit(6, "all")
    pm.bn_folding()
    pm.qstate = state_from_jax(jm.qstate)
    return jm, pm


def jax_frozen_parts(model, tables, feats, lens, use_pallas=False):
    """JAX FrozenExec forward with the decoder's int8 input and int32
    logits kept (FrozenExec.decoder spelled out, requant_pallas at the
    decoder's input under use_pallas as FrozenExec.decoder does)."""
    @jax.jit
    def run(x, lengths):
        fx = JaxFrozenExec(tables, model.qcfg, activation=model.plan.activation,
                           use_pallas=use_pallas)
        enc, enc_lens = encoder_forward(fx, model.plan, jax_pad_frames(x), lengths)
        t = tables["decoder"]
        if use_pallas:
            from qasr_tpu.kernels.requant import requant_pallas
            from qasr_tpu.ops.quant_prims import Dyadic
            q = requant_pallas(enc.values, Dyadic(t["act_m"], t["act_e"]),
                               model.qcfg.act_bit).astype(jnp.int8)
        else:
            q = requant_clamp(fx._requant(enc.values, t["act_m"], t["act_e"]),
                              model.qcfg.act_bit).astype(jnp.int8)
        logits = conv_nwc(q, t["w"], decoder_spec(q.shape[-1], t["w"].shape[-1]),
                          preferred=jnp.int32) + t["b"]
        lp = jax.nn.log_softmax(logits.astype(jnp.float32) * t["out_scale"], axis=-1)
        return q, logits, jnp.argmax(lp, axis=-1), enc_lens
    return [np.asarray(o) for o in run(jnp.asarray(feats), jnp.asarray(lens))]


def _counting(monkeypatch):
    calls = {"dw_conv": 0, "pw_gemm": 0, "requant": 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name in calls:
        monkeypatch.setattr(port_freeze, name, counting(name, getattr(port_freeze, name)))
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_kernel_executors_match_jax(models, mode, monkeypatch):
    jm, pm = models
    jt = jm.freeze(dyadic_mode=mode)
    tables = tables_from_jax(jt, "cpu")
    rng = np.random.default_rng(31)
    feats = rng.normal(size=(2, 128, 16)).astype(np.float32)
    lens = np.asarray([128, 93], np.int32)
    wants = [jax_frozen_parts(jm, jt, feats, lens)]
    if mode == "per_channel":
        wants.append(jax_frozen_parts(jm, jt, feats, lens, use_pallas=True))
    assert len(np.unique(wants[0][2])) > 1, "degenerate ids"
    static = mode != "per_channel"
    assert frozen_executor(tables) is (FrozenExecFused if static else FrozenExecKernels)
    names = ("decoder int8 input", "int32 logits", "ids", "enc_lens")
    for ex in (FrozenExecFused, FrozenExecKernels) if static else (FrozenExecKernels,):
        got = golden.frozen_from_features(pm, tables, feats, lens, executor=ex)
        for want in wants:
            for name, g, w in zip(names, got, want):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{ex.__name__} {name}")
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32

    # the serving function picks the executor and launches as planned
    calls = _counting(monkeypatch)
    pcm = (rng.normal(size=(2, 8000)) * 0.1 * 32767).astype(np.int16)
    ids, _ = make_frozen_fn(pm, tables, argmax=True)(pcm, np.asarray([8000, 5600]))
    want_calls = {"requant": 0, **port_freeze.kernel_launches(pm.plan, tables)}
    assert calls == want_calls
    # the dense block's later pane joins in the requant kernel on the static
    # path; per_channel requantizes there at the conv inputs Kernel 1 does
    # not take, every join and the decoder
    assert want_calls["requant"] == (1 if static else port_freeze._requant_sites(pm.plan, tables))
    ids_p, _ = make_frozen_fn(pm, tables, argmax=True, fused=False)(
        pcm, np.asarray([8000, 5600]))
    assert torch.equal(ids, ids_p)


def test_transcribe_per_channel_matches_jax(models, tmp_path, monkeypatch):
    jm, pm = models
    rng = np.random.default_rng(41)
    paths = []
    for i, n in enumerate((8000, 5600)):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[-1], rng.uniform(-0.4, 0.4, n).astype(np.float32), sr=16000)
    monkeypatch.setenv("QASR_DYADIC_MODE", "per_channel")
    want = jm.transcribe(paths, batch_size=2)
    got = pm.transcribe(paths, batch_size=2, device="cpu", dyadic_mode="per_channel")
    assert got == want
    assert any(want), "empty transcripts"


@pytest.fixture
def one_torch_thread():
    """The full-width flagship on one intra-op thread: with several test
    workers on the same cores, torch's default thread pool makes it ~100x
    slower; its integer results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_flagship_goldens_on_kernel_executors(monkeypatch):
    model = golden.quartznet15x5_w6a6()
    feats, lens = golden.golden_features()
    for mode in ("per_channel", "static_e"):
        got = golden.port_record(model, model.freeze(mode, device="cpu"), feats, lens,
                                 executor=FrozenExecKernels)
        assert golden.compare_golden(got, golden.load_golden(mode)) == [], mode
    calls = _counting(monkeypatch)
    make_frozen_fn(model, tables := model.freeze("per_channel", device="cpu"))(
        np.zeros((1, 4000), np.int16), np.asarray([4000]))
    assert calls == port_freeze.kernel_launches(model.plan, tables) == {
        "dw_conv": 77, "pw_gemm": 94, "requant": 32}
    with pytest.raises(ValueError, match="static-exponent"):
        FrozenExecFused(tables, model.qcfg, activation="relu")
