"""The port's StreamingTransducer (qasr_tpu_torch/decode/streaming.py) on the
CPU: chunked greedy transducer decoding with the decoder's carry kept
across chunks equals offline ``transcribe_greedy``, and the JAX package's
transcripts.

(a) A Jasper-encoder transducer (float encoder and decoder): the streamed
    transcript and its partials (each a prefix) equal the port's offline
    transcript and the JAX package's streamed one (which its own tests hold
    to its offline one);
    ``transcribe_batch`` of three sessions of different lengths equals each
    session's offline transcript; ``latency_report``'s fields and text.
(b) The integer local-attention Conformer transducer (att_context 4,
    calibrated and frozen, encoder and decoder, by the JAX package):
    streamed over several windows == offline == the JAX package's streamed
    transcript, the port reading the JAX frontend and subsampler (two float
    implementations an ulp apart).
(c) The NotImplementedError rules (frame-wise ids, CTC beam options) and
    an unbounded Conformer's ValueError, as in the JAX package.
"""
import numpy as np
import pytest
import torch

from qasr_tpu.decode.streaming import StreamingTransducer as JaxStreamingTransducer
from qasr_tpu_torch.compat.from_jax import rnnt_model_from_jax
from qasr_tpu_torch.decode.streaming import StreamingTransducer
from test_torch_rnnt import _noise, jax_conformer_transducer, jax_jasper_transducer
from test_torch_rnnt_freeze import _jax_front_end

LENS = (16000, 9000, 12000)


@pytest.fixture(scope="module")
def jasper():
    jm = jax_jasper_transducer(normalize=False)
    audio, alens = _noise(9, LENS)
    return jm, rnnt_model_from_jax(jm), audio, alens


def _offline(model, audio, n, **kw):
    return model.transcribe_greedy(audio[None, :n].copy(), np.asarray([n], np.int32), **kw)[0]


def test_jasper_stream_matches_offline_and_jax(jasper):
    jm, pm, audio, alens = jasper
    n = LENS[0]
    offline = _offline(pm, audio[0], n, device="cpu")
    st = StreamingTransducer(pm, chunk_frames=32, device="cpu")
    partials = []
    streamed = st.transcribe(audio[0, :n], partials=partials)
    assert streamed == offline and offline and len(partials) >= 2
    assert partials[-1] == streamed and all(streamed.startswith(p) for p in partials)
    assert streamed == JaxStreamingTransducer(jm, chunk_frames=32).transcribe(audio[0, :n])
    batch = st.transcribe_batch(audio, alens)
    assert batch == [_offline(pm, audio[i], k, device="cpu") for i, k in enumerate(LENS)]
    rep = st.latency_report(audio[0, :n])
    assert rep["chunks"] >= 2 and rep["streaming_rtfx"] > 0 and rep["text"] == offline
    assert {"first_chunk_latency_ms", "p95_chunk_latency_ms",
            "steady_chunk_latency_ms"} <= rep.keys()


def test_integer_conformer_stream_matches_offline_and_jax(monkeypatch):
    from qasr_tpu.quantize.rnnt_freeze import freeze_rnnt_decoder

    jm = jax_conformer_transducer(att_context_size=4)
    jm.freeze_encoder()
    audio, _ = _noise(4, (12000,))
    audio = audio[0]
    # ranges set (calibrate_decoder_ranges is test_torch_rnnt_freeze's)
    jm.dec_frozen = freeze_rnnt_decoder(jm.params["rnnt"], jm.rnnt_cfg, enc_range=4.0,
                                        joint_range=3.0)
    pm = rnnt_model_from_jax(jm)
    _jax_front_end(monkeypatch, jm, pm)
    offline = _offline(pm, audio, len(audio), device="cpu")
    st = StreamingTransducer(pm, chunk_frames=64, device="cpu")
    assert sum(1 for _ in st._windows(len(audio))) >= 2
    assert st.transcribe(audio) == offline and offline
    assert offline == JaxStreamingTransducer(jm, chunk_frames=64).transcribe(audio)


def test_not_implemented_rules(jasper):
    _, pm, audio, _ = jasper
    st = StreamingTransducer(pm, chunk_frames=64, device="cpu")
    with pytest.raises(NotImplementedError):
        st.predictions(audio[0])
    with pytest.raises(NotImplementedError):
        st.transcribe_beam(audio[0])
    with pytest.raises(NotImplementedError):
        st.latency_report(audio[0], beam=True)
    with pytest.raises(NotImplementedError):
        st.latency_report(audio[0], beam_width=4)


def test_unbounded_conformer_cannot_stream():
    pm = rnnt_model_from_jax(jax_conformer_transducer(calibrate=False, att_context_size=-1))
    with pytest.raises(ValueError):
        StreamingTransducer(pm, device="cpu")


def test_device_none_means_cuda(jasper):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError):
        StreamingTransducer(jasper[1])
    with pytest.raises(RuntimeError):
        jasper[1].encode(np.zeros((1, 1600), np.float32), np.asarray([1600]))
