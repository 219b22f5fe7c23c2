"""The port's CTC prefix beam search (its own copy of the native decoder,
built at first use) against the JAX package's, and the entry points that
decode with it.

(a) ``BeamSearchDecoderWithLM`` on seeded log-probs (ragged lengths, a
    near-tie only the LM breaks), without an LM, with a tiny ARPA LM
    written here and with its '.qlm' binary: the JAX package's n-best
    strings and scores exactly, at several beam widths and cutoffs, numpy
    or tensor input; without an LM the best string is
    ``beam_search_python``'s (the oracle; score within 1e-4).
(b) The streaming decoders (one stream fed in chunks, with the LM and
    after a reset; a batch of streams with ragged lengths): the JAX
    package's n-best exactly, and the offline decode's.
(c) A failed build raises; nothing falls back to the Python search.
(d) ``ConformerCTC.transcribe_beam`` equals the decoder over ``forward``'s
    log-probs and the JAX model's ``transcribe_beam`` over the same
    log-probs; ``cli.conformer_infer --decoder beam``: with ``--no_quant``
    the JAX CLI's hypotheses on the same archive, and with
    ``--calib_manifest --integer --freeze`` a frozen model whose
    hypotheses are its ``transcribe_beam``'s.  (The QuartzNet CLI's beam
    is test_torch_cli's.)
"""
import math

import numpy as np
import pytest
import torch

from qasr_tpu.cli import conformer_infer as jax_conformer_infer
from qasr_tpu.decode import beam_search as JB
from qasr_tpu.decode import ctc as jax_ctc
from qasr_tpu.models import conformer_ctc as JCC
from qasr_tpu_torch.cli import conformer_infer as port_conformer_infer
from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
from qasr_tpu_torch.decode import beam_search as PB
from qasr_tpu_torch.models import conformer_ctc as PCC
from test_torch_cli import corpus  # noqa: F401  (a fixture)
from test_torch_conformer import LABELS, SMALL, _noise_pcm

VOCAB = [" ", "a", "c", "s", "t"]
ARPA = """\\data\\
ngram 1=6
ngram 2=4

\\1-grams:
-1.0\t<s>\t-0.5
-1.0\t</s>
-0.8\tcat\t-0.3
-0.9\tsat\t-0.3
-1.7\tat\t-0.2
-2.5\t<unk>

\\2-grams:
-0.2\tcat sat
-0.5\t<s> cat
-0.7\tsat </s>
-0.4\tat cat

\\end\\
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: with several test workers on the same cores,
    torch's default thread pool makes the small ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logprobs(seed, b=4, t=30, v=len(VOCAB) + 1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, v)).astype(np.float32) * 2
    x = x - np.log(np.sum(np.exp(x), axis=-1, keepdims=True))
    # the first sample reads "cat sat " with a near-tie s / t only the LM breaks
    x[0] = -8.0
    for i, ch in enumerate("cat sat "):
        x[0, i, VOCAB.index(ch)] = -0.1
    x[0, 6, VOCAB.index("t")], x[0, 6, VOCAB.index("s")] = -0.65, -0.60
    x[0, 8:, -1] = -0.01
    x[0] = x[0] - np.log(np.sum(np.exp(x[0]), -1, keepdims=True))
    return x, np.asarray([t, t - 7, 1, t - 2, t - 5], np.int32)[:b]


@pytest.fixture(scope="module")
def lm_paths(tmp_path_factory):
    root = tmp_path_factory.mktemp("lm")
    arpa = root / "tiny.arpa"
    arpa.write_text(ARPA)
    return str(arpa), PB.convert_arpa_to_binary(str(arpa), str(root / "tiny.qlm"))


@pytest.mark.parametrize("lm", [None, "arpa", "qlm"])
def test_native_beam_matches_jax(lm_paths, lm):
    lp, lens = _logprobs(1)
    path = {None: None, "arpa": lm_paths[0], "qlm": lm_paths[1]}[lm]
    for kw in (dict(beam_width=16), dict(beam_width=4, cutoff_top_n=3),
               dict(beam_width=32, cutoff_prob=0.99, cutoff_top_n=40)):
        if lm is not None:
            kw.update(alpha=1.0, beta=0.5)
        want = JB.BeamSearchDecoderWithLM(VOCAB, lm_path=path, num_cpus=2, **kw)(lp, lens, 4)
        port = PB.BeamSearchDecoderWithLM(VOCAB, lm_path=path, num_cpus=2, **kw)
        assert port(lp, lens, 4) == want, kw
        assert port(torch.from_numpy(lp), torch.from_numpy(lens), 4) == want
        assert all(len(h) >= 1 for h in want)
    best = want[0][0][1]
    assert best.startswith("cat sat" if lm else "cat sas"), best
    if lm is None:
        got = PB.BeamSearchDecoderWithLM(VOCAB, beam_width=32)(lp, lens)
        for i in range(len(lens)):
            ref = PB.beam_search_python(lp[i, :lens[i]], VOCAB, beam_width=32, n_best=1)[0]
            assert got[i][0][1] == ref[1]
            assert abs(got[i][0][0] - ref[0]) < 1e-4
    with pytest.raises(ValueError, match="classes"):
        port(lp[:, :, :-1], lens)


def test_streaming_decoders_match_jax(lm_paths):
    lp, lens = _logprobs(2, b=5, t=24)
    jowner = JB.BeamSearchDecoderWithLM(VOCAB, beam_width=16, alpha=1.0, lm_path=lm_paths[0])
    powner = PB.BeamSearchDecoderWithLM(VOCAB, beam_width=16, alpha=1.0, lm_path=lm_paths[0])
    js = JB.StreamingBeamDecoder(VOCAB, beam_width=16, alpha=1.0, lm=jowner)
    ps = PB.StreamingBeamDecoder(VOCAB, beam_width=16, alpha=1.0, lm=powner)
    for start in range(0, 24, 5):
        js.feed(lp[0, start:start + 5])
        ps.feed(lp[0, start:start + 5])
        assert ps.best(3) == js.best(3)
    assert ps.best(4) == powner(lp[:1], np.asarray([24], np.int32), 4)[0]
    ps.reset()
    js.reset()
    ps.feed(torch.from_numpy(lp[1]))
    js.feed(lp[1])
    assert ps.best(2) == js.best(2)
    jb = JB.StreamingBeamBatch(5, VOCAB, beam_width=8, num_threads=3)
    pb = PB.StreamingBeamBatch(5, VOCAB, beam_width=8, num_threads=3)
    for start in range(0, 24, 7):
        step = np.minimum(np.maximum(lens - start, 0), 7).astype(np.int32)
        jb.feed(lp[:, start:start + 7], step)
        pb.feed(lp[:, start:start + 7], step)
    assert pb.best(2) == jb.best(2)
    assert pb.best(2) == PB.BeamSearchDecoderWithLM(VOCAB, beam_width=8)(lp, lens, 2)
    with pytest.raises(ValueError, match="exceeds"):
        pb.feed(lp[:, :3], np.full((5,), 4, np.int32))


def test_failed_build_raises(monkeypatch, tmp_path):
    (tmp_path / "ctc_beam_search.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(PB, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(PB, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PB, "_LIB", None)
    lp, lens = _logprobs(3)
    with pytest.raises(RuntimeError, match="building the CTC beam search failed"):
        PB.BeamSearchDecoderWithLM(VOCAB)(lp, lens)
    assert [p.name for p in (tmp_path / "build").iterdir()] == []    # no half-written library


@pytest.fixture(scope="module")
def conformer_pair():
    m = {"encoder": dict(SMALL, feat_in=32, subsampling=""), "labels": list(LABELS),
         "preprocessor": {"features": 32, "dither": 0.0}}
    return JCC.conformer_ctc_from_dict(m, seed=1), PCC.conformer_ctc_from_dict(m, seed=1)


def test_transcribe_beam_matches_jax(conformer_pair):
    jm, pm = conformer_pair
    pcm, lens = _noise_pcm(5, 0.6)
    lp, el = pm.forward(pcm, lens, device="cpu")
    got = pm.transcribe_beam(pcm, lens, beam_width=8, device="cpu")
    dec = PB.BeamSearchDecoderWithLM(pm.vocabulary, beam_width=8)
    assert got == [h[0][1] for h in dec(lp, el)]
    jm.forward = lambda audio, alens: (lp.numpy(), el.numpy())
    assert got == jm.transcribe_beam(None, None, beam_width=8)
    assert any(got)


def test_conformer_infer_beam(conformer_pair, corpus, tmp_path, monkeypatch):  # noqa: F811
    jm, pm = conformer_pair
    _, manifest = corpus
    archive = str(tmp_path / "conf.qasr")
    pm.save_to(archive)
    argv = ["--restore", archive, "--dataset", manifest, "--batch_size", "2", "--decoder",
            "beam", "--beam_width", "8"]
    seen = {}
    real = jax_ctc.word_error_rate

    def spy(hyps, refs, **kw):
        seen.update(hyps=list(hyps), refs=list(refs))
        return real(hyps, refs, **kw)
    monkeypatch.setattr(jax_ctc, "word_error_rate", spy)
    want = jax_conformer_infer.main(argv + ["--no_quant"])
    wer, hyps, refs, model = port_conformer_infer.run(argv + ["--no_quant", "--device", "cpu"])
    assert (hyps, refs) == (seen["hyps"], seen["refs"]) and wer == pytest.approx(want)
    assert model.mode() == "float"
    wer, hyps, refs, model = port_conformer_infer.run(
        argv + ["--calib_manifest", manifest, "--num_calib_batch", "2", "--integer", "--freeze",
                "--device", "cpu"])
    assert model.mode() == "frozen" and math.isfinite(wer) and len(hyps) == 4
    again = []
    for audio, alens, _, _ in DataLoader(AudioToCharDataset(manifest, list(model.vocabulary)),
                                         batch_size=2):
        again += model.transcribe_beam(audio, alens, beam_width=8, device="cpu")
    assert again == hyps
