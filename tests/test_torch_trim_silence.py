"""``trim_silence`` in the port's datasets and its training CLI, on the CPU.

(a) Wavs of silence, two tones and silence again: the port's
    AudioToCharDataset(trim=True) and AudioToBPEDataset(trim=True) items
    equal the JAX package's datasets' items (trim=True) and are shorter
    than the untrimmed ones.
(b) cli/speech_to_text.py::make_dataset passes a data config's
    ``trim_silence`` on to either dataset, and the CLI trains a step with
    ``model.train_ds.trim_silence=true`` (--device cpu).
"""
import json

import numpy as np
import pytest

from qasr_tpu.data import tokenizers as jtok
from qasr_tpu.data.audio import write_wav
from qasr_tpu.data.dataset import AudioToCharDataset as JaxCharDataset
from qasr_tpu.models.ctc_bpe_model import AudioToBPEDataset as JaxBPEDataset
from qasr_tpu_torch.cli import speech_to_text
from qasr_tpu_torch.data import tokenizers as ptok
from qasr_tpu_torch.data.dataset import AudioToCharDataset
from qasr_tpu_torch.models.config import DEFAULT_LABELS
from qasr_tpu_torch.models.ctc_bpe_model import AudioToBPEDataset
from test_torch_train_cli import _yaml

SR = 16000
TEXTS = ["the cat", "hello world", "a dog ran"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(manifest path, tokenizer.json path): 3 wavs of 0.4-0.6 s of
    silence (faint noise), 0.5 s of two tones, 0.3-0.7 s of silence."""
    d = tmp_path_factory.mktemp("trim")
    rng = np.random.default_rng(0)
    path = d / "m.json"
    with open(path, "w") as f:
        for i, text in enumerate(TEXTS):
            t = np.arange(SR // 2) / SR
            tone = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * (900 + 50 * i) * t)
            sig = np.concatenate([rng.normal(size=int(SR * (0.4 + 0.1 * i))) * 1e-5, tone,
                                  rng.normal(size=int(SR * (0.7 - 0.2 * i))) * 1e-5])
            wav = str(d / f"u{i}.wav")
            write_wav(wav, sig.astype(np.float32))
            f.write(json.dumps({"audio_filepath": wav, "duration": len(sig) / SR,
                                "text": text}) + "\n")
    bpe = str(d / "tokenizer.json")
    jtok.BPETokenizer.train(TEXTS * 4, 30, bpe)
    return str(path), bpe


def _assert_items_equal(got_ds, want_ds):
    assert len(got_ds) == len(want_ds) == len(TEXTS)
    for i in range(len(TEXTS)):
        for got, want in zip(got_ds[i], want_ds[i]):
            np.testing.assert_array_equal(got, want)


def test_trimmed_items_match_jax(data):
    manifest, bpe = data
    labels = list(DEFAULT_LABELS)
    char = AudioToCharDataset(manifest, labels, trim=True)
    _assert_items_equal(char, JaxCharDataset(manifest, labels, trim=True))
    untrimmed = AudioToCharDataset(manifest, labels)
    for i in range(len(TEXTS)):
        assert len(char[i][0]) < len(untrimmed[i][0]) - SR // 4
    bpe_ds = AudioToBPEDataset(manifest, ptok.BPETokenizer(bpe), trim=True)
    _assert_items_equal(bpe_ds, JaxBPEDataset(manifest, jtok.BPETokenizer(bpe), trim=True))
    assert [len(x[0]) for x in bpe_ds] == [len(x[0]) for x in char]


@pytest.mark.parametrize("trim", [False, True])
def test_make_dataset_passes_trim_silence(data, trim):
    manifest, bpe = data
    dcfg = {"manifest_filepath": manifest, "trim_silence": trim}
    labels = list(DEFAULT_LABELS)
    for tokenizer in (None, ptok.BPETokenizer(bpe)):
        ds = speech_to_text.make_dataset(dcfg, labels, tokenizer)
        assert isinstance(ds, AudioToCharDataset if tokenizer is None else AudioToBPEDataset)
        assert ds.trim is trim
        want = JaxCharDataset(manifest, labels, trim=trim)
        assert [len(x[0]) for x in ds] == [len(x[0]) for x in want]


def test_cli_trains_with_trim_silence(tmp_path, data):
    manifest, _ = data
    cfg = _yaml(tmp_path, manifest, str(tmp_path / "exp"))
    tr = speech_to_text.main(["--config-path", cfg, "--device", "cpu", "trainer.max_steps=1",
                              "model.train_ds.trim_silence=true"])
    assert tr.step == 1
