"""The port's frozen QuartzNet slice against the JAX package, end to end.

(a) From the same float features and tables, the port's FrozenExec, its
    FrozenExecFused (on the kernels' plain versions) and the JAX FrozenExec
    give identical int8 decoder inputs, int32 logits, ids and enc_lens.
    Tolerance: exact.
(b) From the same int16 PCM, the port's MelFrontend is within
    max |d| <= 1e-3 and mean |d| <= 1e-4 of JAX's (float32 FFTs in two
    libraries), first-site int8 codes flip on <= 0.1% of elements and only
    by +-1, and make_frozen_fn gives equal enc_lens (ids equal whenever the
    codes are).
(c) Importing the port (every module, the calibration workflow's and the
    CLIs' included) and a CPU forward never import jax or qasr_tpu;
    the port's sources import nothing of qasr_tpu; device=None means the
    CUDA device.
Full-width QuartzNet15x5 is held to the committed golden record.
"""
import dataclasses
import glob
import importlib.util
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models.config import (
    BlockConfig, DecoderConfig, EncoderConfig, ModelConfig,
)
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.models.ctc_model import make_frozen_fn as jax_make_frozen_fn
from qasr_tpu.models.jasper import conv_nwc, decoder_spec, encoder_forward
from qasr_tpu.models.jasper import pad_frames_aligned as jax_pad_frames
from qasr_tpu.ops.quant_prims import requant_clamp
from qasr_tpu.quantize.freeze import FrozenExec as JaxFrozenExec
from qasr_tpu_torch import golden
from qasr_tpu_torch.compat.from_jax import state_from_jax, tables_from_jax
from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
from qasr_tpu_torch.quantize import freeze as port_freeze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_cfg():
    """Every site kind of QuartzNet at widths 32-64 (see test_torch_freeze)."""
    blocks = (
        BlockConfig(filters=32, repeat=1, kernel=(11,), stride=(2,),
                    residual=False, separable=True),
        BlockConfig(filters=32, repeat=2, kernel=(7,), residual=True, separable=True),
        BlockConfig(filters=48, repeat=1, kernel=(9,), dilation=(2,),
                    residual=False, separable=True),
        BlockConfig(filters=64, repeat=1, kernel=(1,), residual=False, separable=False),
    )
    return ModelConfig(encoder=EncoderConfig(feat_in=32, blocks=blocks, activation="relu"),
                       decoder=DecoderConfig(feat_in=64, num_classes=28),
                       preprocessor={"features": 32, "n_fft": 512, "dither": 1e-5})


@pytest.fixture(scope="module")
def models():
    jm = JaxASRModel.from_config(tiny_cfg(), seed=0)
    jm.set_quant_bit(6, "all")
    jm.bn_folding()
    jm.calibrate_on_noise(batches=1, batch_size=2, seconds=0.5)
    pm = ASRModel.from_config(tiny_cfg(), seed=0)
    pm.set_quant_bit(6, "all")
    pm.bn_folding()
    pm.qstate = state_from_jax(jm.qstate)
    return jm, pm


def jax_frozen_parts(model, tables, feats, lens):
    """JAX FrozenExec forward with the decoder's int8 input and int32
    logits kept (FrozenExec.decoder spelled out)."""
    @jax.jit
    def run(x, lengths):
        fx = JaxFrozenExec(tables, model.qcfg, activation=model.plan.activation)
        enc, enc_lens = encoder_forward(fx, model.plan, jax_pad_frames(x), lengths)
        t = tables["decoder"]
        q = requant_clamp(fx._requant(enc.values, t["act_m"], t["act_e"]),
                          model.qcfg.act_bit).astype(jnp.int8)
        logits = conv_nwc(q, t["w"], decoder_spec(q.shape[-1], t["w"].shape[-1]),
                          preferred=jnp.int32) + t["b"]
        lp = jax.nn.log_softmax(logits.astype(jnp.float32) * t["out_scale"], axis=-1)
        return q, logits, jnp.argmax(lp, axis=-1), enc_lens
    return [np.asarray(o) for o in run(jnp.asarray(feats), jnp.asarray(lens))]


@pytest.mark.parametrize("mode", ["static_e", "static_e16", "per_channel"])
def test_slice_from_features_bit_identical(models, mode):
    """per_channel (vector exponents) runs on the plain executor only; the
    kernel executor refuses it."""
    jm, pm = models
    jt = jm.freeze(dyadic_mode=mode)
    tables = tables_from_jax(jt, "cpu")
    rng = np.random.default_rng(17)
    feats = rng.normal(size=(2, 128, 32)).astype(np.float32)
    lens = np.asarray([128, 93], np.int32)
    want = jax_frozen_parts(jm, jt, feats, lens)
    assert len(np.unique(want[2])) > 1, "degenerate ids"
    names = ("decoder int8 input", "int32 logits", "ids", "enc_lens")
    static = mode != "per_channel"
    for fused in (False, True) if static else (False,):
        got = golden.frozen_from_features(pm, tables, feats, lens, fused=fused)
        for name, g, w in zip(names, got, want):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"fused={fused} {name}")
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32
    if not static:
        with pytest.raises(ValueError, match="static-exponent"):
            golden.frozen_from_features(pm, tables, feats, lens, fused=True)


def test_slice_from_pcm_within_frontend_tolerance(models, monkeypatch, capsys):
    for flag in ("QASR_DW_MXU", "QASR_CM", "QASR_CM_FUSED", "QASR_CM_JOIN"):
        monkeypatch.delenv(flag, raising=False)
    jm, pm = models
    rng = np.random.default_rng(23)
    pcm = (rng.normal(size=(2, 16000)) * 0.1 * 32767).astype(np.int16)
    pcm[1, 11200:] = 0
    lens = np.asarray([16000, 11200], np.int32)

    fj, lj = jm.frontend(jnp.asarray(pcm, jnp.float32) * 2.0 ** -15,
                         jnp.asarray(lens), dither=0.0)
    fp, lp = pm.frontend(torch.from_numpy(pcm).to(torch.float32) * 2.0 ** -15,
                         torch.from_numpy(lens), dither=0.0)
    fj, fp = np.asarray(fj), fp.numpy()
    np.testing.assert_array_equal(lp.numpy(), np.asarray(lj))
    diff = np.abs(fp - fj)
    assert diff.max() <= 1e-3 and diff.mean() <= 1e-4, (diff.max(), diff.mean())

    jt = jm.freeze()
    e0 = jt["blocks"][0]["convs"][0]
    inv, n = np.float32(1.0) / e0["act_scale"], 2 ** (e0["act_bits"] - 1) - 1
    codes = [np.clip(np.round(inv * f), -n, n - 1) for f in (fj, fp)]
    flips = codes[0] != codes[1]
    assert flips.mean() <= 1e-3 and np.abs(codes[0] - codes[1]).max() <= 1

    ids_j, el_j = jax_make_frozen_fn(jm, jt, argmax=True)(jnp.asarray(pcm), jnp.asarray(lens))
    ids_p, el_p = make_frozen_fn(pm, tables_from_jax(jt, "cpu"), argmax=True)(
        torch.from_numpy(pcm), torch.from_numpy(lens))
    ids_j, el_j = np.asarray(ids_j), np.asarray(el_j)
    np.testing.assert_array_equal(el_p.numpy(), el_j)
    assert ids_p.shape == ids_j.shape
    valid = np.arange(ids_j.shape[1])[None, :] < el_j[:, None]
    agree = (ids_p.numpy() == ids_j)[valid].mean()
    with capsys.disabled():
        print(f"\nfrontend max|d|={diff.max():.2e} mean|d|={diff.mean():.2e}; "
              f"first-site code flips {int(flips.sum())}/{flips.size}; "
              f"ids agree on {agree:.4f} of valid frames")
    if not flips.any():
        assert agree == 1.0


def test_port_imports_no_jax():
    """With ``qasr_tpu``, PyYAML and HF ``tokenizers`` made unimportable
    (the GPU machine has none of them), import every module of the port,
    build and serve a tiny QuartzNet and a tiny Conformer-CTC on the CPU,
    save and restore both (.nemo, .qasr), beam-decode and stream (the
    windowed streamer, the cache-aware stream): neither jax nor any part of
    qasr_tpu is imported."""
    code = """
import importlib, pkgutil, sys, tempfile, os
sys.modules["qasr_tpu"] = None   # any import of the JAX package now fails
sys.modules["yaml"] = None
sys.modules["tokenizers"] = None
import numpy as np, torch
import qasr_tpu_torch
for mod in pkgutil.walk_packages(qasr_tpu_torch.__path__, "qasr_tpu_torch."):
    importlib.import_module(mod.name)
for name in ("cli.inference", "cli.synthesize", "quantize.synth", "compat.pickle_io",
             "data.dataset", "data.parsers", "ops.stats", "quantize.conformer_ptq",
             "quantize.conformer_synth", "quantize.ranges", "models.conformer",
             "models.conformer_ctc", "utils.yaml_io", "utils.checkpoint", "utils.cloud",
             "compat.nemo_loader", "data.tokenizers", "data.vocabs", "models.ctc_bpe_model",
             "models.lstm_decoder", "decode.beam_search", "cli.conformer_infer",
             "decode.streaming"):
    assert "qasr_tpu_torch." + name in sys.modules, name
from qasr_tpu_torch.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig, init_conformer_qstate
blocks = (BlockConfig(filters=16, repeat=1, kernel=(5,), stride=(2,), residual=False,
                      separable=True),
          BlockConfig(filters=16, repeat=2, kernel=(3,), residual=True, separable=True))
cfg = ModelConfig(encoder=EncoderConfig(feat_in=16, blocks=blocks),
                  decoder=DecoderConfig(feat_in=16, num_classes=28),
                  preprocessor={"features": 16})
m = ASRModel.from_config(cfg)
m.set_quant_bit(6)
m.bn_folding()
m.qstate_from_json(m.qstate_to_json().replace('"x_max": 0.0', '"x_max": 2.0'))
ids, el = make_frozen_fn(m, m.freeze(device="cpu"), argmax=True)(
    torch.zeros(2, 4000, dtype=torch.int16), torch.tensor([4000, 3000]))
assert ids.shape[0] == 2
ccfg = ConformerConfig(feat_in=16, n_layers=1, d_model=64, n_heads=4,
                       subsampling_conv_channels=8, conv_kernel_size=5, dropout=0.0)
mcfg = ModelConfig(encoder=EncoderConfig(feat_in=16, blocks=()),
                   decoder=DecoderConfig(feat_in=64, num_classes=28),
                   preprocessor={"features": 16, "dither": 0.0})
c = ConformerCTC.from_config(mcfg, ccfg)
c.enc_qcfg = ConformerQuantConfig(quantize_attention=True, integer_softmax=True,
                                  integer_layernorm=True, integer_activations=True,
                                  static_attention=True)
qs = init_conformer_qstate(ccfg, c.enc_qcfg)
qs["dec_in"] = {"x_min": np.float32(0), "x_max": np.float32(0)}
for site in [qs["pre_out"], qs["dec_in"]] + [s for layer in qs["layers"] for s in layer.values()]:
    site["x_min"], site["x_max"] = np.float32(-1.5), np.float32(2.0)
c.enc_qstate = qs
c.freeze(device="cpu")
rng = np.random.default_rng(0)
pcm = (rng.normal(size=(2, 8000)) * 3000).astype(np.int16)
texts = c.transcribe_greedy(pcm, np.asarray([8000, 6000]), device="cpu")
assert len(texts) == 2
# the Conformer's zero-shot workflow: synthesis, calibration, the PTQ forward
c2 = ConformerCTC.from_config(mcfg, ccfg)
c2.quantize_encoder_synthetic(num_batch=1, batch_size=2, seqlen=24, train_iter=2,
                              device="cpu", **{k: True for k in (
                                  "quantize_attention", "integer_softmax", "integer_layernorm",
                                  "integer_activations", "static_attention")})
assert c2.mode() == "ptq" and len(c2.transcribe_greedy(pcm, np.asarray([8000, 6000]),
                                                       device="cpu")) == 2
# checkpoints without PyYAML, and the native beam search
td = tempfile.mkdtemp()
m.save_to(os.path.join(td, "q.qasr"))
assert ASRModel.restore_from(os.path.join(td, "q.qasr")).folded
m2 = ASRModel.from_config(cfg)
m2.save_to(os.path.join(td, "q.nemo"))
assert ASRModel.from_pretrained(os.path.join(td, "q.nemo")).cfg == cfg
c2.save_to(os.path.join(td, "c.qasr"))
c3 = ConformerCTC.restore_from(os.path.join(td, "c.qasr"))
assert c3.mode() == "ptq" and len(c3.transcribe_beam(pcm, np.asarray([8000, 6000]),
                                                     beam_width=4, device="cpu")) == 2
# streaming: the windowed streamer over the QuartzNet, the cache-aware
# stream over a causal copy of the Conformer
from qasr_tpu_torch import CacheAwareConformerStream, StreamingTranscriber
import dataclasses
assert len(StreamingTranscriber(m, chunk_frames=32, device="cpu").predictions(
    (rng.normal(size=12000) * 3000).astype(np.int16))) > 0
cc = ConformerCTC.from_config(dataclasses.replace(mcfg, preprocessor={
    "features": 16, "dither": 0.0, "normalize": False}), dataclasses.replace(
    ccfg, att_context_size=(4, 0), causal_conv=True))
cc.enc_qcfg, cc.enc_qstate = c.enc_qcfg, qs
cc.freeze(device="cpu")
cs = CacheAwareConformerStream(cc, device="cpu")
cs.feed(pcm[0])
cs.flush()
assert isinstance(cs.text(), str)
assert "jax" not in sys.modules, sorted(k for k in sys.modules if k.startswith("jax"))
bad = sorted(k for k, v in sys.modules.items()
             if (k == "qasr_tpu" or k.startswith("qasr_tpu.")) and v is not None)
assert not bad, bad
print("no-jax ok")
"""
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "no-jax ok" in proc.stdout, proc.stderr[-3000:]


def test_port_sources_import_nothing_of_qasr_tpu():
    """No module of the port, and not chip_smoke.py, imports qasr_tpu, jax,
    PyYAML or HF tokenizers (at top level or inside a function)."""
    pat = re.compile(r"^\s*(from|import)\s+(qasr_tpu|jax|yaml|tokenizers)(\.|\s|$)")
    files = glob.glob(os.path.join(ROOT, "qasr_tpu_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    assert len(files) > 20
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}"
                     for i, line in enumerate(f, 1) if pat.match(line)]
    assert hits == []


def test_entry_points_default_to_cuda():
    """device=None means the CUDA device: without a GPU every entry point
    raises instead of running on the CPU; with one it is cuda:0."""
    from qasr_tpu_torch.compat.from_jax import conformer_tables_from_jax
    from qasr_tpu_torch.decode.streaming import CacheAwareConformerStream, StreamingTranscriber
    from qasr_tpu_torch.device import as_device
    from qasr_tpu_torch.quantize.conformer_freeze import frozen_stream_init

    if torch.cuda.is_available():
        assert as_device(None) == torch.device("cuda", 0)
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        as_device(None)
    assert as_device("cpu") == torch.device("cpu")
    model = golden.quartznet15x5_w6a6()
    for call in (lambda: model.freeze(), lambda: model.transcribe([np.zeros(1600, np.int16)]),
                 lambda: tables_from_jax({"blocks": []}),
                 lambda: conformer_tables_from_jax({"layers": []}),
                 lambda: StreamingTranscriber(model)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    conf = golden.conformer16x256_w8a8()
    for call in (lambda: conf.freeze(), lambda: conf.forward(np.zeros((1, 1600), np.int16),
                                                             np.asarray([1600])),
                 lambda: conf.transcribe_greedy(np.zeros((1, 1600), np.int16),
                                                np.asarray([1600]))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the streaming entry points: a frozen causal Conformer's stream
    causal = dataclasses.replace(conf.ccfg, att_context_size=(70, 0), causal_conv=True)
    conf.ccfg = causal
    conf.frontend.cfg = dataclasses.replace(conf.frontend.cfg, normalize=False)
    tables = conf.freeze(device="cpu")["encoder"]
    for call in (lambda: CacheAwareConformerStream(conf),
                 lambda: frozen_stream_init(tables, causal, 1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_port_host_copies_match_jax(tmp_path):
    """The port's own copies of the JAX package's host modules: the
    QuartzNet range asset byte for byte, the model presets, greedy CTC
    collapse and the WAV reader."""
    from qasr_tpu.data.audio import read_audio_pcm16 as jax_read, write_wav
    from qasr_tpu.decode.ctc import ctc_collapse as jax_collapse
    from qasr_tpu.models.config import PRESETS as JAX_PRESETS
    from qasr_tpu_torch.data.audio import read_audio_pcm16
    from qasr_tpu_torch.decode.ctc import ctc_collapse
    from qasr_tpu_torch.models.config import PRESETS

    with open(os.path.join(ROOT, "qasr_tpu", "assets",
                           "quartznet15x5_noise_qstate_w6a6_s0.json"), "rb") as f:
        want = f.read()
    with open(golden.QSTATE_PATH, "rb") as f:
        assert f.read() == want
    # other test files register extra presets into the JAX dict at run time
    assert set(PRESETS) <= set(JAX_PRESETS) and "QuartzNet15x5Base-En" in PRESETS
    for name in PRESETS:
        assert dataclasses.asdict(PRESETS[name]()) == dataclasses.asdict(JAX_PRESETS[name]())
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 29, size=(3, 40))
    lens = np.asarray([40, 17, 0])
    labels = [chr(ord("a") + i) for i in range(28)]
    assert ctc_collapse(ids, 28, labels, lens) == jax_collapse(ids, 28, labels, lens)
    for sr in (16000, 8000):
        path = str(tmp_path / f"x{sr}.wav")
        write_wav(path, rng.uniform(-0.5, 0.5, 4000).astype(np.float32), sr=sr)
        np.testing.assert_array_equal(read_audio_pcm16(path), jax_read(path))


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
def test_flagship_port_cpu_matches_golden(monkeypatch):
    """Full-width QuartzNet15x5 W6A6 built without jax (init, fold, committed
    ranges, static_e freeze) equals the JAX golden record on the CPU, with
    both executors; the fused walk calls each kernel wrapper once per conv,
    as the plan predicts (77 dw_conv, 94 pw_gemm)."""
    model = golden.quartznet15x5_w6a6()
    tables = model.freeze(device="cpu")
    feats, lens = golden.golden_features()
    want = golden.load_golden()
    assert golden.port_record(model, tables, feats, lens, fused=False)["ids"] == want["ids"]

    calls = {"dw_conv": 0, "pw_gemm": 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name in calls:
        monkeypatch.setattr(port_freeze, name, counting(name, getattr(port_freeze, name)))
    got = golden.port_record(model, tables, feats, lens, fused=True)
    assert golden.compare_golden(got, want) == []
    assert calls == port_freeze.kernel_launches(model.plan) == {"dw_conv": 77, "pw_gemm": 94}


@pytest.mark.slow
def test_flagship_golden_recomputed_by_jax():
    """JAX on the CPU recomputes the committed golden record."""
    spec = importlib.util.spec_from_file_location(
        "torch_golden", os.path.join(ROOT, "experiments", "torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert golden.compare_golden(mod.jax_golden(), golden.load_golden()) == []
