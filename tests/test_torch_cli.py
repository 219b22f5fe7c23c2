"""The port's data layer, WER and CLIs against the JAX package.

(a) On a seeded manifest of 4 wavs: the parsers' token ids, the dataset's
    items and the shuffled loader's batches equal the JAX package's, and so
    do edit distances, word_error_rate and the accumulating WER.
(b) JAX's cli.synthesize writes a pickle; JAX's cli.inference and the
    port's (``--device cpu``) give equal hypotheses and WER on it at W6A6
    (calibrated on the pickle, frozen tables), ``--dynamic`` and
    ``--no_quant``, and ``--decoder beam`` on a ``.nemo`` the JAX package
    wrote.
(c) The port's CLIs run end to end with qasr_tpu made unimportable, and
    neither jax nor qasr_tpu is imported: cli.synthesize writes a pickle
    the JAX package loads, cli.inference reads it.
"""
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import qasr_tpu.decode.ctc as jax_ctc
from qasr_tpu.cli import inference as jax_inference
from qasr_tpu.cli import synthesize as jax_synthesize
from qasr_tpu.compat.pickle_io import load_synthetic as jax_load_synthetic
from qasr_tpu.data import dataset as jax_dataset
from qasr_tpu.data import parsers as jax_parsers
from qasr_tpu.data.audio import write_wav
from qasr_tpu.models import config as JC
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu_torch.cli import inference as port_inference
from qasr_tpu_torch.data import dataset as port_dataset
from qasr_tpu_torch.data import parsers as port_parsers
from qasr_tpu_torch.decode import ctc as port_ctc
from qasr_tpu_torch.models import config as PC
from test_torch_calibrate import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET = "TorchPortTinyCLI"
TEXTS = ("Hello world.", "the cat sat on 2 mats", "Dr. Smith's 3rd call", "quiet night")


def tiny_cfg(C):
    blocks = (C.BlockConfig(filters=24, repeat=1, kernel=(7,), stride=(2,), residual=False,
                            separable=True),
              C.BlockConfig(filters=24, repeat=2, kernel=(5,), residual=True, separable=True),
              C.BlockConfig(filters=40, repeat=1, kernel=(1,), residual=False, separable=False))
    return C.ModelConfig(encoder=C.EncoderConfig(feat_in=16, blocks=blocks, activation="relu"),
                         decoder=C.DecoderConfig(feat_in=40, num_classes=28),
                         preprocessor={"features": 16, "n_fft": 512, "dither": 1e-5})


TINY_CFG_SRC = inspect.getsource(tiny_cfg)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A manifest of 4 seeded wavs (tones in noise, 0.6-1.2 s)."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(21)
    path = str(root / "manifest.json")
    with open(path, "w") as f:
        for i, text in enumerate(TEXTS):
            n = int(16000 * (0.6 + 0.2 * i))
            t = np.arange(n) / 16000
            x = 0.3 * np.sin(2 * np.pi * (200 + 70 * i) * t) + 0.05 * rng.normal(size=n)
            wav = str(root / f"u{i}.wav")
            write_wav(wav, x.astype(np.float32))
            f.write(json.dumps({"audio_filepath": wav, "duration": n / 16000, "text": text})
                    + "\n")
    return root, path


@pytest.fixture
def presets(monkeypatch):
    monkeypatch.setitem(JC.PRESETS, PRESET, lambda: tiny_cfg(JC))
    monkeypatch.setitem(PC.PRESETS, PRESET, lambda: port_config(tiny_cfg(JC)))


def test_data_and_wer_match_jax(corpus):
    _, manifest = corpus
    labels = list(PC.DEFAULT_LABELS)
    for name in ("base", "en"):
        jp = jax_parsers.make_parser(labels, name)
        pp = port_parsers.make_parser(labels, name)
        assert [pp(t) for t in TEXTS] == [jp(t) for t in TEXTS]
    assert port_parsers.ENCharParser(labels)(TEXTS[2]) is not None
    assert port_parsers.CharParser(labels)(TEXTS[0]) is None   # '.' is out of vocabulary
    assert port_dataset.read_manifest(manifest) == [
        port_dataset.ManifestEntry(**vars(e)) for e in jax_dataset.read_manifest(manifest)]
    jd = jax_dataset.AudioToCharDataset(manifest, labels)
    pd = port_dataset.AudioToCharDataset(manifest, labels)
    assert len(pd) == len(jd) == 4
    for i in range(4):
        for got, want in zip(pd[i], jd[i]):
            np.testing.assert_array_equal(got, want)
    jb = list(jax_dataset.DataLoader(jd, batch_size=3, shuffle=True, seed=3))
    pb = list(port_dataset.DataLoader(pd, batch_size=3, shuffle=True, seed=3))
    assert len(pb) == len(jb) == 2
    for got, want in zip(pb, jb):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert pb[0][0].shape[1] % port_dataset.BUCKET_QUANTUM == 0
    hyps = ["the cat sat", "hello word", "", "a b c d"]
    refs = ["the cat sat on", "hello world", "quiet", "a c d e"]
    for cer in (False, True):
        assert port_ctc.word_error_rate(hyps, refs, use_cer=cer) == \
            jax_ctc.word_error_rate(hyps, refs, use_cer=cer)
    rng = np.random.default_rng(8)
    preds = rng.integers(0, 29, (3, 30))
    targets = rng.integers(0, 28, (3, 12))
    tl, pl = np.asarray([12, 7, 0]), np.asarray([30, 21, 9])
    jw, pw = jax_ctc.WER(labels), port_ctc.WER(labels)
    jw.update(preds, targets, tl, pl)
    pw.update(preds, targets, tl, pl)
    assert (pw.scores, pw.words, pw.compute()) == (jw.scores, jw.words, jw.compute())
    lp = rng.normal(size=(2, 5, 29))
    np.testing.assert_array_equal(port_ctc.greedy_predictions(lp),
                                  jax_ctc.greedy_predictions(lp))


@pytest.fixture(scope="module")
def jax_pickle(corpus):
    root, _ = corpus
    JC.PRESETS[PRESET] = lambda: tiny_cfg(JC)
    try:
        return jax_synthesize.main(["--asr_model", PRESET, "--num_batch", "2", "--batch_size",
                                    "2", "--seqlen", "64", "--train_iter", "3", "--dump_path",
                                    str(root), "--allow_random_weights", "--parallel", "2"])
    finally:
        del JC.PRESETS[PRESET]


@pytest.mark.parametrize("mode", [[], ["--dynamic"], ["--no_quant"]],
                         ids=["w6a6", "dynamic", "no_quant"])
def test_cli_inference_matches_jax(corpus, jax_pickle, presets, monkeypatch, mode):
    _, manifest = corpus
    argv = ["--asr_model", PRESET, "--dataset", manifest, "--weight_bit", "6", "--act_bit",
            "6", "--batch_size", "2", "--allow_random_weights"] + mode
    if not mode:
        argv += ["--load", jax_pickle]
    seen = {}
    wer_fn = jax_ctc.word_error_rate

    def spy(hypotheses, references, **kw):
        seen.update(hyps=list(hypotheses), refs=list(references))
        return wer_fn(hypotheses=hypotheses, references=references, **kw)
    monkeypatch.setattr(jax_ctc, "word_error_rate", spy)
    want = jax_inference.main(argv)
    wer, hyps, refs, model = port_inference.run(argv + ["--device", "cpu"])
    assert hyps == seen["hyps"] and refs == seen["refs"]
    assert wer == want and np.isfinite(wer)
    assert any(hyps)
    assert model.resolve_mode() == {"": "frozen", "--dynamic": "quant",
                                    "--no_quant": "fp32"}["".join(mode)]


def test_cli_beam_decoder_not_ported(corpus, presets, monkeypatch, tmp_path):
    """(The name predates the port's beam search.)  ``--decoder beam`` on a
    ``.nemo`` the JAX package wrote, given as ``--asr_model``: the JAX
    CLI's hypotheses and WER."""
    _, manifest = corpus
    nemo = str(tmp_path / "tiny.nemo")
    JaxASRModel.from_config(tiny_cfg(JC), seed=3).save_to(nemo)
    argv = ["--asr_model", nemo, "--dataset", manifest, "--decoder", "beam", "--beam_width",
            "8", "--batch_size", "2", "--dynamic", "--weight_bit", "6", "--act_bit", "6"]
    seen = {}
    wer_fn = jax_ctc.word_error_rate

    def spy(hypotheses, references, **kw):
        seen.update(hyps=list(hypotheses), refs=list(references))
        return wer_fn(hypotheses=hypotheses, references=references, **kw)
    monkeypatch.setattr(jax_ctc, "word_error_rate", spy)
    want = jax_inference.main(argv)
    wer, hyps, refs, model = port_inference.run(argv + ["--device", "cpu"])
    assert hyps == seen["hyps"] and refs == seen["refs"] and wer == want
    assert any(hyps) and model.resolve_mode() == "quant"


def test_port_clis_without_jax(corpus, tmp_path):
    """The port's CLIs, with qasr_tpu unimportable: synthesize on the CPU,
    then calibrate on the pickle and evaluate; neither jax nor qasr_tpu is
    imported, and the JAX package loads the pickle."""
    _, manifest = corpus
    code = f"""
import sys
sys.modules["qasr_tpu"] = None
import qasr_tpu_torch.cli.inference, qasr_tpu_torch.quantize.synth
from qasr_tpu_torch.cli import inference, synthesize
from qasr_tpu_torch.models import config as C
{TINY_CFG_SRC}
C.register_preset({PRESET!r}, lambda: tiny_cfg(C))
pkl = synthesize.main(["--asr_model", {PRESET!r}, "--num_batch", "1", "--batch_size", "2",
                       "--seqlen", "48", "--train_iter", "2", "--dump_path", {str(tmp_path)!r},
                       "--allow_random_weights", "--device", "cpu"])
wer = inference.main(["--asr_model", {PRESET!r}, "--dataset", {manifest!r}, "--load", pkl,
                      "--weight_bit", "6", "--act_bit", "6", "--percentile", "99.9",
                      "--allow_random_weights", "--device", "cpu"])
assert wer == wer
assert "jax" not in sys.modules, sorted(k for k in sys.modules if k.startswith("jax"))
bad = sorted(k for k, v in sys.modules.items()
             if (k == "qasr_tpu" or k.startswith("qasr_tpu.")) and v is not None)
assert not bad, bad
print("PICKLE", pkl)
"""
    env = dict(os.environ)
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    pkl = proc.stdout.split("PICKLE")[-1].strip()
    assert os.path.basename(pkl) == "syn_nb1_iter2_lr0.010.pkl"
    (batch,) = jax_load_synthetic(pkl)
    assert batch.shape == (2, 16, 48) and np.isfinite(batch).all()
