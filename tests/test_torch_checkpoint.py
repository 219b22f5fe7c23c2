"""The port's QuartzNet checkpoints, model loading and vocabularies against
the JAX package (no PyYAML and no HF tokenizers in the port).

(a) ``.nemo`` both ways: a ``.nemo`` the JAX package writes restores in the
    port (``restore_from`` and ``from_pretrained``) to equal params and
    config, the port's restores in the JAX package equal, the two
    ``save_nemo`` state dicts have the same keys and tensors, and
    artifacts come back byte for byte; a folded model refuses ``.nemo``.
(b) ``.qasr`` both ways, unfolded and folded with calibrated ranges:
    params, range state and the quantization knobs equal; the restored
    folded model's frozen transcripts equal the JAX model's.
(c) ``from_pretrained`` by path, by ``$QASR_PRETRAINED_DIR``, by a model
    card fetched from a ``file://`` mirror into the md5-keyed cache (the
    JAX package's key) and re-used from it with no fetcher; it raises for
    a preset with no checkpoint (unless ``allow_random_weights``) and for
    an unknown name, with no network attempt.
(d) ``change_vocabulary``: the JAX package's decoder params and config,
    and frozen ids after it (a model that served before does not serve
    its old tables).
(e) The BPE tokenizer read without HF ``tokenizers`` against HF on a
    tokenizer the JAX package trained: vocab, ids (unknown characters one
    '<unk>' each, runs of them, the literal '<unk>', spaces) and decoded
    text; merges written as strings read the same.  The BPE model through
    both archives, its hypotheses and ``AudioToBPEDataset``; the char /
    word tokenizers and the vocabularies.
Tolerance: exact.
"""
import dataclasses
import hashlib
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from qasr_tpu.data import tokenizers as jtok
from qasr_tpu.data import vocabs as jvocabs
from qasr_tpu.data.audio import write_wav
from qasr_tpu.models.ctc_bpe_model import AudioToBPEDataset as JaxBPEDataset
from qasr_tpu.models.ctc_bpe_model import EncDecCTCModelBPE as JaxBPEModel
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.utils import cloud as jcloud
from qasr_tpu_torch.compat.from_jax import state_from_jax
from qasr_tpu_torch.compat.nemo_loader import state_dict_from_params
from qasr_tpu_torch.data import tokenizers as ptok
from qasr_tpu_torch.data import vocabs as pvocabs
from qasr_tpu_torch.models import config as PC
from qasr_tpu_torch.models.ctc_bpe_model import AudioToBPEDataset, EncDecCTCModelBPE
from qasr_tpu_torch.models.ctc_model import ASRModel
from qasr_tpu_torch.utils import cloud as pcloud
from test_torch_calibrate import port_config
from test_torch_conformer import assert_tree_equal
from test_torch_slice_requant import small_cfg

PRESET = "TorchPortTinyCkpt"
TEXTS = ["the cat sat on the mat", "hello world", "a quick brown fox", "the world is round",
         "it's a test"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: with several test workers on the same cores,
    torch's default thread pool makes the small ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pcm(seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * 3000).astype(np.int16) for n in (8000, 5600)]


def _wavs(tmp_path, pcm):
    paths = []
    for i, x in enumerate(pcm):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[-1], x.astype(np.float32) / 32768.0)
    return paths


@pytest.fixture(scope="module")
def jax_model():
    m = JaxASRModel.from_config(small_cfg(), seed=1)
    rng = np.random.default_rng(2)
    for b in m.params["encoder"]["blocks"]:      # BN statistics off their defaults
        for c in b["convs"] + b["res"]:
            if "bn" in c:
                c["bn"] = {k: np.asarray(v) * rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                           + (0.1 if k in ("beta", "mean") else 0.0)
                           for k, v in c["bn"].items()}
    return m


@pytest.fixture(scope="module")
def jax_folded(jax_model):
    m = JaxASRModel(cfg=jax_model.cfg, plan=jax_model.plan, frontend=jax_model.frontend,
                    params=jax_model.params, qstate=jax_model.qstate, qcfg=jax_model.qcfg)
    m.set_quant_bit(6)
    m.bn_folding()
    m.calibrate_on_noise(batches=1, batch_size=2, seconds=0.5)
    return m


def _artifact(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_bytes("a\nb\n▁c\n".encode("utf-8"))
    return str(path)


def _read_state_dict(path):
    with tarfile.open(path) as tar:
        return torch.load(tar.extractfile("model_weights.ckpt"), weights_only=True)


def test_nemo_interchanges_with_jax(jax_model, tmp_path):
    jax_model.artifacts = {"vocab.txt": _artifact(tmp_path)}
    jax_model.save_to(str(tmp_path / "jax.nemo"))
    pm = ASRModel.restore_from(str(tmp_path / "jax.nemo"))
    assert_tree_equal(state_from_jax(jax_model.params), pm.params, "params")
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jax_model.cfg)
    assert open(pm.artifacts["vocab.txt"], "rb").read() == "a\nb\n▁c\n".encode("utf-8")
    assert_tree_equal(pm.params, ASRModel.from_pretrained(str(tmp_path / "jax.nemo")).params)
    pm.save_to(str(tmp_path / "port.nemo"))
    jm = JaxASRModel.restore_from(str(tmp_path / "port.nemo"))
    assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(pm.cfg)
    assert open(jm.artifacts["vocab.txt"], "rb").read() == "a\nb\n▁c\n".encode("utf-8")
    want, got = _read_state_dict(tmp_path / "jax.nemo"), _read_state_dict(tmp_path / "port.nemo")
    assert list(got) == list(want) and len(got) > 40
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    sd = state_dict_from_params(pm.plan, pm.params)
    assert list(sd) == list(want) and all(torch.equal(sd[k], want[k]) for k in want)
    pm.bn_folding()
    with pytest.raises(ValueError, match="unfolded"):
        pm.save_to(str(tmp_path / "folded.nemo"))


@pytest.mark.parametrize("folded", [False, True])
def test_qasr_interchanges_with_jax(jax_model, jax_folded, tmp_path, folded):
    jm = jax_folded if folded else jax_model
    jm.artifacts = {"vocab.txt": _artifact(tmp_path)}
    jm.save_to(str(tmp_path / "jax.qasr"))
    pm = ASRModel.restore_from(str(tmp_path / "jax.qasr"))
    assert pm.folded == folded
    assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    assert_tree_equal(state_from_jax(jm.qstate), pm.qstate, "qstate")
    assert dataclasses.asdict(pm.qcfg) == dataclasses.asdict(jm.qcfg)
    assert open(pm.artifacts["vocab.txt"], "rb").read() == "a\nb\n▁c\n".encode("utf-8")
    pm.save_to(str(tmp_path / "port.qasr"))
    back = JaxASRModel.restore_from(str(tmp_path / "port.qasr"))
    assert back.folded == folded
    assert_tree_equal(state_from_jax(back.params), pm.params, "params")
    assert_tree_equal(state_from_jax(back.qstate), pm.qstate, "qstate")
    assert dataclasses.asdict(back.qcfg) == dataclasses.asdict(pm.qcfg)
    if folded:
        paths = _wavs(tmp_path, _pcm())
        want = jm.transcribe(paths, batch_size=2)
        assert pm.transcribe(paths, batch_size=2, device="cpu") == want
        assert any(want)


def test_from_pretrained_sources(jax_model, tmp_path, monkeypatch):
    monkeypatch.setitem(PC.PRESETS, PRESET, lambda: port_config(small_cfg()))
    monkeypatch.delenv("QASR_PRETRAINED_DIR", raising=False)
    monkeypatch.setenv("QASR_CACHE_DIR", str(tmp_path / "cache"))
    src = str(tmp_path / "mirror" / f"{PRESET}.nemo")
    os.makedirs(os.path.dirname(src))
    jax_model.save_to(src)
    want = state_from_jax(jax_model.params)
    assert_tree_equal(ASRModel.from_pretrained(src).params, want)
    # no checkpoint anywhere: a preset raises unless random weights are asked for
    with pytest.raises(FileNotFoundError, match="allow_random_weights"):
        ASRModel.from_pretrained(PRESET)
    random_model = ASRModel.from_pretrained(PRESET, allow_random_weights=True, seed=4)
    assert_tree_equal(random_model.params,
                      ASRModel.from_config(port_config(small_cfg()), seed=4).params)
    with pytest.raises(ValueError, match="unknown model"):
        ASRModel.from_pretrained("NoSuchModel")
    monkeypatch.setenv("QASR_PRETRAINED_DIR", os.path.dirname(src))
    assert_tree_equal(ASRModel.from_pretrained(PRESET).params, want)
    monkeypatch.delenv("QASR_PRETRAINED_DIR")
    # a model card on a file:// mirror: fetched once into the md5-keyed cache
    card = dict(pretrained_model_name=PRESET, location="file://" + src, description="tiny")
    monkeypatch.setattr(pcloud, "MODEL_CARDS", list(pcloud.MODEL_CARDS))
    pcloud.register_model_card(pcloud.PretrainedModelInfo(**card))
    fetched = []

    def fetch(url, dest):
        fetched.append(url)
        pcloud.file_fetcher(url, dest)
    with pytest.raises(FileNotFoundError):      # not cached and no fetcher: no download
        ASRModel.from_pretrained(PRESET)
    assert_tree_equal(ASRModel.from_pretrained(PRESET, fetcher=fetch).params, want)
    assert_tree_equal(ASRModel.from_pretrained(PRESET).params, want)   # the cache, no fetch
    assert fetched == ["file://" + src]
    key = hashlib.md5(("file://" + src + "tiny").encode()).hexdigest()
    cached = tmp_path / "cache" / key / f"{PRESET}.nemo"
    assert cached.exists()
    monkeypatch.setattr(jcloud, "MODEL_CARDS", list(jcloud.MODEL_CARDS))
    jcloud.register_model_card(jcloud.PretrainedModelInfo(**card))
    assert jcloud.resolve_pretrained(PRESET, fetcher=fetch) == str(cached)
    with pytest.raises(ValueError, match="file://"):
        pcloud.file_fetcher("https://example.invalid/x.nemo", str(tmp_path / "x"))


def test_change_vocabulary_matches_jax(jax_folded):
    jm = JaxASRModel(cfg=jax_folded.cfg, plan=jax_folded.plan, frontend=jax_folded.frontend,
                     params=dict(jax_folded.params), qstate=dict(jax_folded.qstate),
                     qcfg=jax_folded.qcfg, folded=True)
    pm = ASRModel.from_config(port_config(small_cfg()))
    pm.set_quant_bit(6)
    pm.params, pm.qstate, pm.folded = state_from_jax(jm.params), state_from_jax(jm.qstate), True
    pcm = np.stack([x[:5600] for x in _pcm()])
    lens = np.asarray([5600, 4000])
    _, _, ids = pm.forward(pcm, lens, device="cpu")           # builds the serving fn
    assert ids.shape[0] == 2
    new = ["x", "y", " ", "z"]
    old_range = dict(jm.qstate["decoder_act"])
    jm.change_vocabulary(new)
    pm.change_vocabulary(new)
    assert_tree_equal(state_from_jax(jm.params["decoder"]), pm.params["decoder"], "decoder")
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)
    assert_tree_equal(state_from_jax(jm.qstate), pm.qstate, "qstate")
    jm.qstate["decoder_act"] = old_range
    pm.qstate = state_from_jax(jm.qstate)
    lp_j, el_j, ids_j = jm.forward(pcm.astype(np.float32) / 32768.0, lens)
    lp_p, el_p, ids_p = pm.forward(pcm, lens, device="cpu")
    assert lp_p.shape[-1] == len(new) + 1
    np.testing.assert_array_equal(el_p.numpy(), el_j)
    np.testing.assert_array_equal(ids_p.numpy(), ids_j)


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "tokenizer.json")
    jtok.BPETokenizer.train(TEXTS, 40, path)
    return path


BPE_PROBES = ["the cat sat", "hello wörld zz", "  two  spaces ", "qqq xyz", "", " ", "a<unk>b",
              "<unk> <unk>", "it's the world", "▁the", "THE CAT"]


def test_bpe_tokenizer_matches_hf(bpe_path, tmp_path):
    from tokenizers import Tokenizer

    hf, jt, pt = Tokenizer.from_file(bpe_path), jtok.BPETokenizer(bpe_path), \
        ptok.BPETokenizer(bpe_path)
    assert pt.vocab == jt.vocab and pt.vocab_size == jt.vocab_size
    for text in BPE_PROBES:
        ids = pt.text_to_ids(text)
        assert ids == hf.encode(text).ids == jt.text_to_ids(text), text
        assert pt.ids_to_text(ids) == jt.ids_to_text(ids), text
    assert pt.text_to_ids("zz")[1:] == [pt.unk_id] * 2 and pt.text_to_ids("<unk>") == [0]
    spec = json.load(open(bpe_path, encoding="utf-8"))
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    old = tmp_path / "old.json"
    old.write_text(json.dumps(spec), encoding="utf-8")
    st = ptok.BPETokenizer(str(old))
    assert all(st.text_to_ids(t) == pt.text_to_ids(t) for t in BPE_PROBES)
    assert isinstance(ptok.tokenizer_from_config({"model_path": bpe_path}), ptok.BPETokenizer)
    for kind, cls in (("char", ptok.CharTokenizer), ("word", ptok.WordTokenizer)):
        vocab = list("abc ") if kind == "char" else ["the", "cat"]
        p = ptok.tokenizer_from_config({"type": kind, "vocab": vocab})
        j = jtok.tokenizer_from_config({"type": kind, "vocab": vocab})
        assert isinstance(p, cls) and p.vocab == j.vocab and p.vocab_size == j.vocab_size
        for text in ("the cat", "a bad cab", "dog"):
            assert p.text_to_ids(text) == j.text_to_ids(text)
            assert p.ids_to_text(p.text_to_ids(text)) == j.ids_to_text(j.text_to_ids(text))


def test_vocabs_match_jax():
    for kw in ({}, {"punct": False}, {"punct": False, "spaces": True}):
        p, j = pvocabs.Chars(**kw), jvocabs.Chars(**kw)
        assert p.labels == j.labels and len(p) == len(j)
        for text in ("Hello, World!", "it's\tok", "ümlaut"):
            assert p.encode(text) == j.encode(text)
            assert p.decode(p.encode(text)) == j.decode(j.encode(text))
    g2p = lambda text: ["HH", "AH0", " ", "XX"]  # noqa: E731
    assert pvocabs.Phonemes(g2p=g2p).encode("ha") == jvocabs.Phonemes(g2p=g2p).encode("ha")
    assert pvocabs.Phonemes().labels == jvocabs.Phonemes().labels
    with pytest.raises(ImportError):
        pvocabs.Phonemes().encode("hello")


def test_bpe_model_through_archives(bpe_path, tmp_path):
    """The JAX package's BPE model through .nemo and .qasr: the port
    restores its class, tokenizer and params, its hypotheses detokenize as
    the JAX package's, and AudioToBPEDataset equals the JAX one."""
    jm = JaxBPEModel.from_config_and_tokenizer(small_cfg(), jtok.BPETokenizer(bpe_path), seed=0)
    preds = np.random.default_rng(5).integers(0, jm.blank_id + 1, (3, 40))
    preds[0, 5:9] = jm.blank_id
    lens = np.asarray([40, 31, 0])
    for ext in ("nemo", "qasr"):
        jm.save_to(str(tmp_path / f"bpe.{ext}"))
        pm = ASRModel.restore_from(str(tmp_path / f"bpe.{ext}"))
        assert type(pm) is EncDecCTCModelBPE and pm.tokenizer.vocab == jm.tokenizer.vocab
        assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
        assert pm.decode_hypotheses(preds, lens) == jm.decode_hypotheses(preds, lens)
        assert pm.ids_to_text(torch.from_numpy(preds), torch.from_numpy(lens)) == \
            jm.decode_hypotheses(preds, lens)
        pm.save_to(str(tmp_path / f"port.{ext}"))
        back = JaxASRModel.restore_from(str(tmp_path / f"port.{ext}"))
        assert type(back) is JaxBPEModel and back.tokenizer.vocab == jm.tokenizer.vocab
    pcfg = port_config(small_cfg())
    pm = EncDecCTCModelBPE.from_config_and_tokenizer(pcfg, ptok.BPETokenizer(bpe_path), seed=0)
    assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)
    manifest = tmp_path / "m.json"
    wavs = _wavs(tmp_path, _pcm())
    with open(manifest, "w") as f:
        for w, text in zip(wavs + wavs, ["the cat", "zz", "", "hello world"]):
            f.write(json.dumps({"audio_filepath": w, "duration": 0.5, "text": text}) + "\n")
    pd = AudioToBPEDataset(str(manifest), pm.tokenizer)
    jd = JaxBPEDataset(str(manifest), jm.tokenizer)
    assert len(pd) == len(jd) == 3
    for i in range(3):
        for got, want in zip(pd[i], jd[i]):
            np.testing.assert_array_equal(got, want)
