"""The port's streaming serving against the JAX package, on the CPU (the
kernels' plain versions), at small sizes: a 2-block QuartzNet (W6A6,
frozen) and the JAX tests' causal Conformer (2 layers, d 64, 4 heads, K 9,
att_context (8, 0), causal_conv, W8A8 frozen).

(a) The receptive fields equal the JAX package's.
(b) ``StreamingTranscriber``: stitched greedy ids equal the JAX
    streamer's and the port's own offline ids (QuartzNet and the causal
    Conformer), ``transcribe`` / ``transcribe_beam`` equal the offline
    transcripts, ``latency_report`` has its fields.
(c) ``frozen_stream_step`` over uneven chunks (5, 16, 3, 16, ...) from one
    state (``stream_state_from_jax``) equals the JAX ``frozen_stream_step``
    at every step: the caches k8, v8, glu8 and seen bit for bit, the float
    encodings within 1e-6 relative (the last i-LayerNorm's float affine
    y * gamma + beta: XLA may fuse it into one fma, torch rounds twice;
    the integer y is equal); the
    streamed rows equal the port's offline frozen causal forward bit for
    bit.
(d) ``CacheAwareConformerStream``: ``feed`` / ``flush`` ids and ``text``
    equal the JAX stream's and the offline transcript; ``latency_report``'s
    fields; ``reset``.
(e) The cache forms' plain versions (``int_attention_cached_plain``,
    ``conv_block_cached_plain``) equal the JAX composition over [cache ||
    new], for seen < L and >= L.

Where a float frontend or subsampler feeds both packages, the port reads
the JAX package's (``jax_frontend``, ``jax_subsampler``): the two float
implementations may sit an ulp apart (held to a tolerance in
test_torch_slice / test_torch_conformer), and these tests hold what comes
after them (windows, caches, the integer stack) bit for bit.  The card's
kernels are held to the plain versions in chip_smoke.py phase 12.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qasr_tpu.decode import streaming as JS
from qasr_tpu.models.config import BlockConfig as JBlock
from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import EncoderConfig as JEnc
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.models.conformer import subsample_convs as jax_subsample
from qasr_tpu.models.conformer_ctc import ConformerCTC as JaxConformerCTC
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.ops.integer_softmax import i_softmax_grid as jax_i_softmax_grid
from qasr_tpu.ops.quant_prims import dyadic_requant_static as jax_rq
from qasr_tpu.quantize import conformer_freeze as JCF
from qasr_tpu_torch.compat.from_jax import state_from_jax, stream_state_from_jax
from qasr_tpu_torch.decode import streaming as PS
from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM
from qasr_tpu_torch.kernels import conv_block as port_conv_block
from qasr_tpu_torch.kernels import int_attention as port_int_attention
from qasr_tpu_torch.models import conformer as port_conformer
from qasr_tpu_torch.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
from qasr_tpu_torch.models.ctc_model import ASRModel
from qasr_tpu_torch.quantize import conformer_freeze as port_cf
from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig
from qasr_tpu_torch.quantize.freeze import tables_digest

LABELS = (" ", "a", "b", "c")
FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
             integer_activations=True, static_attention=True)
ENC_RTOL = 1e-6


# ---------------------------------------------------------------------------
# models, and the JAX float front ends the port reads here
# ---------------------------------------------------------------------------


def _qn_blocks(block_cls):
    return (block_cls(filters=24, repeat=1, kernel=(7,), stride=(2,), residual=False,
                      separable=True),
            block_cls(filters=24, repeat=2, kernel=(5,), residual=True, separable=True))


PREP = {"features": 16, "dither": 0.0, "normalize": False}


@pytest.fixture(scope="module")
def quartznet():
    """A 2-block QuartzNet at W6A6, calibrated by the JAX package on noise;
    the port's copy takes its params and ranges."""
    jm = JaxASRModel.from_config(JModel(encoder=JEnc(feat_in=16, blocks=_qn_blocks(JBlock)),
                                        decoder=JDec(feat_in=24, num_classes=28),
                                        preprocessor=PREP), seed=0)
    jm.set_quant_bit(6, "all")
    jm.bn_folding()
    jm.calibrate_on_noise(batches=1, batch_size=2, seconds=0.5)
    pm = ASRModel.from_config(ModelConfig(encoder=EncoderConfig(feat_in=16,
                                                                blocks=_qn_blocks(BlockConfig)),
                                          decoder=DecoderConfig(feat_in=24, num_classes=28),
                                          preprocessor=PREP), seed=0)
    pm.set_quant_bit(6, "all")
    pm.bn_folding()
    pm.qstate = state_from_jax(jm.qstate)
    return jm, pm


CONF = dict(feat_in=32, n_layers=2, d_model=64, n_heads=4, subsampling="striding",
            subsampling_factor=4, subsampling_conv_channels=16, conv_kernel_size=9,
            att_context_size=(8, 0), causal_conv=True, dropout=0.0)


def _conformer_pair(n_layers=2, seed=0):
    """The JAX tests' causal frozen Conformer in both packages (the port's
    from the JAX ranges; its tables' digest equals the JAX ones')."""
    prep = {"features": 32, "dither": 0.0, "normalize": False}
    jcfg = JModel(encoder=JEnc(feat_in=32, blocks=[]),
                  decoder=JDec(feat_in=64, num_classes=len(LABELS)), labels=LABELS,
                  preprocessor=prep)
    jm = JaxConformerCTC.from_config(jcfg, JConf(**{**CONF, "n_layers": n_layers}), seed=seed)
    rng = np.random.default_rng(seed)
    calib = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    jm.quantize_encoder([(calib, np.asarray([16000, 12800], np.int32))], **FLAGS)
    jm.freeze()
    pcfg = ModelConfig(encoder=EncoderConfig(feat_in=32, blocks=()),
                       decoder=DecoderConfig(feat_in=64, num_classes=len(LABELS)),
                       labels=LABELS, preprocessor=prep)
    pm = ConformerCTC.from_config(pcfg, ConformerConfig(**{**CONF, "n_layers": n_layers}),
                                  seed=seed)
    pm.enc_qcfg = ConformerQuantConfig(**dataclasses.asdict(jm.enc_qcfg))
    pm.enc_qstate = state_from_jax(jm.enc_qstate)
    pm.freeze(device="cpu")
    assert tables_digest(pm.enc_frozen) == tables_digest(
        {k: v for k, v in jm.enc_frozen.items() if not k.startswith("_")})
    return jm, pm


@pytest.fixture(scope="module")
def conformer():
    return _conformer_pair()


class _JaxFrontend:
    """The port model's frontend call answered by the JAX model's."""

    def __init__(self, jm, pm):
        self.jm, self.cfg = jm, pm.frontend.cfg

    def __call__(self, audio, lens, dither=0.0):
        f, fl = self.jm.frontend(np.asarray(audio.cpu()), np.asarray(lens.cpu()), dither=dither)
        return torch.from_numpy(np.array(f)), torch.from_numpy(np.array(fl))


def jax_frontend(monkeypatch, jm, pm):
    monkeypatch.setattr(pm, "frontend", _JaxFrontend(jm, pm))


def jax_subsampler(monkeypatch, jm):
    """The port's subsampler calls answered by the JAX package's."""
    run = jax.jit(lambda x, lens: jax_subsample(jm.enc_frozen["subsampler"], jm.ccfg, x, lens))

    def sub(p, cfg, x, lens):
        y, yl = run(jnp.asarray(x.numpy()), jnp.asarray(lens.numpy()))
        return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(yl))
    monkeypatch.setattr(port_conformer, "subsample_convs", sub)
    monkeypatch.setattr(port_cf, "subsample_convs", sub)


def _noise(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.1).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) receptive fields
# ---------------------------------------------------------------------------


def test_receptive_fields_match_jax(quartznet):
    jm, pm = quartznet
    assert PS.receptive_field(pm.plan) == JS.receptive_field(jm.plan)
    for kw in (dict(CONF), {**CONF, "att_context_size": (70, 0), "n_layers": 16},
               {**CONF, "subsampling": "vggnet", "att_context_size": 4, "causal_conv": False},
               {**CONF, "subsampling_factor": 8, "att_context_size": (3, 5)}):
        pc, jc = ConformerConfig(**kw), JConf(**kw)
        assert PS.receptive_field_conformer(pc) == JS.receptive_field_conformer(jc)
        assert PS.receptive_field_conformer_lr(pc) == JS.receptive_field_conformer_lr(jc)
        assert PS._subsampler_span(pc) == JS._subsampler_span(jc)
    with pytest.raises(ValueError, match="finite receptive field"):
        PS.receptive_field_conformer(ConformerConfig(feat_in=32))


# ---------------------------------------------------------------------------
# (b) the windowed streamer
# ---------------------------------------------------------------------------


def test_windowed_quartznet_matches_jax_and_offline(quartznet, monkeypatch):
    jm, pm = quartznet
    jax_frontend(monkeypatch, jm, pm)
    audio = _noise(3, 40000)
    n = np.asarray([len(audio)], np.int32)
    lp_off, el, ids_off = pm.forward(audio[None], n, device="cpu")
    el = int(el[0])
    ids_off = ids_off[0, :el].numpy()
    assert len(np.unique(ids_off)) > 1, "degenerate ids"
    st = PS.StreamingTranscriber(pm, chunk_frames=96, context_frames=64, device="cpu")
    jst = JS.StreamingTranscriber(jm, chunk_frames=96, context_frames=64)
    assert (st.chunk_frames, st.context_left, st.context_right) == \
        (jst.chunk_frames, jst.context_left, jst.context_right)
    ids = st.predictions(audio)
    assert sum(1 for _ in st._windows(len(audio))) >= 3
    np.testing.assert_array_equal(ids[:el], ids_off)
    np.testing.assert_array_equal(ids, np.asarray(jst.predictions(audio)))
    assert st.transcribe(audio) == jst.transcribe(audio) == \
        pm.ids_to_text(torch.from_numpy(ids_off)[None], torch.tensor([el]))[0]
    partials = []
    text = st.transcribe_beam(audio, beam_width=4, partials=partials)
    offline = BeamSearchDecoderWithLM(pm.vocabulary, beam_width=4)(lp_off, torch.tensor([el]))
    assert text == offline[0][0][1] == jst.transcribe_beam(audio, beam_width=4)
    assert len(partials) >= 3
    rep = st.latency_report(audio, beam=True, beam_width=4)
    assert rep["chunks"] == len(partials) and rep["chunk_audio_s"] == 0.96
    for k in ("first_chunk_latency_ms", "mean_chunk_latency_ms", "p95_chunk_latency_ms",
              "steady_chunk_latency_ms", "streaming_rtfx"):
        assert rep[k] > 0, k


def test_windowed_causal_conformer_matches_offline(conformer):
    """The zero-lookahead defaults on the causal Conformer: the JAX
    streamer's window geometry, a right context of the subsampler / STFT
    edge only, and stitched ids equal to the offline frozen ids."""
    jm, pm = conformer
    audio = _noise(5, 36000)
    lp, el = pm.forward(audio[None], np.asarray([len(audio)], np.int32), device="cpu")
    el = int(el[0])
    st = PS.StreamingTranscriber(pm, chunk_frames=64, device="cpu")
    jst = JS.StreamingTranscriber(jm, chunk_frames=64)
    assert (st.rf, st.stride, st.chunk_frames, st.context_left, st.context_right) == \
        (jst.rf, jst.stride, jst.chunk_frames, jst.context_left, jst.context_right)
    assert st.lookahead_frames < st.context_left
    assert list(st._windows(len(audio))) == list(jst._windows(len(audio)))
    ids = st.predictions(audio)
    np.testing.assert_array_equal(ids[:el], lp[0, :el].argmax(-1).numpy())


# ---------------------------------------------------------------------------
# (c) frozen_stream_step
# ---------------------------------------------------------------------------


def _x_sub(jm, audio):
    feats, flens = jm.frontend(audio[None], np.asarray([len(audio)], np.int32), dither=0.0)
    x_sub, slens = jax_subsample(jm.enc_frozen["subsampler"], jm.ccfg, feats, flens)
    return np.asarray(x_sub)[0, :int(slens[0])]


def _assert_enc_close(got, want):
    """|got - want| <= ENC_RTOL * max(|want|, 1): the float affine's rounding
    (see the module docstring)."""
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() <= ENC_RTOL, err.max()


def test_frozen_stream_step_matches_jax(conformer):
    jm, pm = conformer
    tables = pm._tables(torch.device("cpu"))["encoder"]
    x_sub = _x_sub(jm, _noise(1, 46720))
    assert len(x_sub) == 72
    jstate = JCF.frozen_stream_init(jm.enc_frozen, jm.ccfg, 1)
    state = stream_state_from_jax(jstate, "cpu")
    outs, i = [], 0
    # uneven chunks past L and the conv tail (their shapes are the ones the
    # JAX stream meets again in test_cache_aware_stream_matches_jax)
    for n in (5, 16, 3, 16, 16, 16):
        chunk = x_sub[i:i + n]
        i += n
        jo, jstate = JCF.frozen_stream_step(jm.enc_frozen, jm.ccfg, jnp.asarray(chunk[None]),
                                            jstate)
        o, state = port_cf.frozen_stream_step(tables, pm.ccfg,
                                              torch.from_numpy(chunk[None].copy()), state)
        assert state["seen"] == int(jstate["seen"]) == i
        for pl, jl in zip(state["layers"], jstate["layers"]):
            for k in ("k8", "v8", "glu8"):
                np.testing.assert_array_equal(pl[k].numpy(), np.asarray(jl[k]), err_msg=k)
        _assert_enc_close(o.numpy(), np.asarray(jo))
        outs.append(o[0])
    assert i == len(x_sub) and any((np.asarray(jl["k8"]) != 0).all() for jl in jstate["layers"])
    # the streamed rows are the offline frozen causal forward's
    y = torch.from_numpy(x_sub[None].copy())
    x8 = port_cf.clip8(torch.round(port_cf.f32_div(y, tables["S_pre"])), tables["act_bit"])
    enc, _ = port_cf.conformer_encode(tables, pm.ccfg, x8, torch.tensor([len(x_sub)]))
    np.testing.assert_array_equal(torch.cat(outs).numpy(), enc[0].numpy())


def test_stream_launches_and_state(conformer, monkeypatch):
    """One step calls each kernel wrapper as ``stream_kernel_launches``
    says, and no other; the state's caches have the stream's shapes."""
    jm, pm = conformer
    tables = pm._tables(torch.device("cpu"))["encoder"]
    state = port_cf.frozen_stream_init(tables, pm.ccfg, 2, "cpu")
    assert state["seen"] == 0 and [tuple(v.shape) for v in state["layers"][0].values()] == \
        [(2, 8, 4, 16), (2, 8, 4, 16), (2, 8, 64)]
    calls = {}
    for name in ("lin_epilogue", "ffn_ln", "int_attention_cached", "conv_block_cached",
                 "int_attention", "conv_block"):
        fn = getattr(port_cf, name)

        def counting(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(port_cf, name, counting)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 112)).astype(np.float32))
    out, state = port_cf.frozen_stream_step(tables, pm.ccfg, x, state)
    assert calls == port_cf.stream_kernel_launches(pm.ccfg)
    assert out.shape == (2, 4, 64) and state["seen"] == 4


# ---------------------------------------------------------------------------
# (d) CacheAwareConformerStream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def offline_noise(conformer):
    """33,163 samples of noise, their offline frozen forward (log-probs,
    lengths) and their mel frames, through the JAX frontend and
    subsampler."""
    jm, pm = conformer
    audio = _noise(2, 33163)
    with pytest.MonkeyPatch.context() as mp:
        jax_frontend(mp, jm, pm)
        jax_subsampler(mp, jm)
        lp, el = pm.forward(audio[None], np.asarray([len(audio)], np.int32), device="cpu")
        feats, fl = pm.frontend(torch.from_numpy(audio[None]), torch.tensor([len(audio)]))
    return audio, lp, el, feats[0, :int(fl[0])]


def test_cache_aware_stream_matches_jax(conformer, offline_noise, monkeypatch):
    """Fed 11,000 samples, then 10,240 twice, then 1,683 (33,163: not
    hop-aligned, so flush() drains the last mel frame): 16, 16, 16 and 3
    new frames, step shapes the JAX stream has compiled already."""
    jm, pm = conformer
    jax_frontend(monkeypatch, jm, pm)
    jax_subsampler(monkeypatch, jm)
    audio, lp, el, _ = offline_noise
    ids_ref = lp[0, :int(el[0])].argmax(-1).numpy()
    st = PS.CacheAwareConformerStream(pm, device="cpu")
    jst = JS.CacheAwareConformerStream(jm)
    got, jgot = [], []
    bounds = (0, 11000, 21240, 31480, 33163)
    for a, b in zip(bounds[:-1], bounds[1:]):
        got.append(st.feed(audio[a:b]).tolist())
        jgot.append(np.asarray(jst.feed(audio[a:b])).tolist())
    got.append(st.flush().tolist())
    jgot.append(np.asarray(jst.flush()).tolist())
    assert got == jgot and [len(g) for g in got] == [16, 16, 16, 3, 0]
    assert st._frames_done == -(-len(audio) // 160)
    got = sum(got, [])
    np.testing.assert_array_equal(np.asarray(got), ids_ref)
    assert len(set(got)) > 1, "degenerate ids"
    offline = pm.ids_to_text(lp.argmax(-1), el)[0]
    assert st.text() == jst.text() == offline
    st.reset()
    assert st.text() == "" and st._state["seen"] == 0
    rep = st.latency_report(audio, chunk_samples=8000)
    assert rep["chunks"] == 5 and rep["chunk_audio_s"] == 0.5 and rep["state_frames"] == 8
    for k in ("first_chunk_latency_ms", "steady_chunk_latency_ms", "p95_chunk_latency_ms",
              "mean_chunk_latency_ms", "streaming_rtfx"):
        assert rep[k] > 0, k
    assert st.text() == offline


@pytest.mark.parametrize("frames", [4, 207])
def test_cache_aware_stream_slice_sizes(conformer, offline_noise, monkeypatch, frames):
    """The utterance's mel frames fed 4 at a time (40 ms: a step of one
    subsampled frame) and all at once (51 new frames: four subsampler
    windows of ``SUB_FRAMES``, the last zero-padded) give the offline
    ids."""
    jm, pm = conformer
    jax_subsampler(monkeypatch, jm)
    _, lp, el, feats = offline_noise
    assert len(feats) == 208
    st = PS.CacheAwareConformerStream(pm, device="cpu")
    got = [st.feed_feats(feats[a:a + frames]).tolist() for a in range(0, len(feats), frames)]
    assert max(map(len, got)) == (1 if frames == 4 else 51)
    np.testing.assert_array_equal(np.asarray(sum(got, [])),
                                  lp[0, :int(el[0])].argmax(-1).numpy())


def test_cache_aware_stream_checks(conformer):
    jm, pm = conformer
    other = ConformerCTC.from_config(pm.cfg, dataclasses.replace(pm.ccfg, causal_conv=False))
    with pytest.raises(ValueError, match="causal_conv"):
        PS.CacheAwareConformerStream(other, device="cpu")
    unfrozen = ConformerCTC.from_config(pm.cfg, pm.ccfg)
    with pytest.raises(ValueError, match="freeze"):
        PS.CacheAwareConformerStream(unfrozen, device="cpu")
    with pytest.raises(ValueError, match="causal config"):
        port_cf.frozen_stream_init(pm._tables(torch.device("cpu"))["encoder"],
                                   dataclasses.replace(pm.ccfg, att_context_size=(8, 2)),
                                   1, "cpu")


# ---------------------------------------------------------------------------
# (e) the cache forms' plain versions against the JAX composition
# ---------------------------------------------------------------------------


def _jax_attention(tbl, qu8, qv8, k_cat, v_cat, p8, seen, ab):
    """JAX's stream-step attention over [cache || new]
    (qasr_tpu/quantize/conformer_freeze.py:778-824)."""
    b, n, h, d_k = qu8.shape
    left = p8.shape[0] - 1
    n8 = 2 ** (ab - 1) - 1
    i_idx = jnp.arange(n)[:, None]
    j_idx = jnp.arange(left + n)[None, :]
    r = left + i_idx - j_idx
    mask = (r < 0) | (r > left) | (j_idx < left - seen)
    ac = jnp.einsum("bihd,bjhd->bhij", qu8, k_cat, preferred_element_type=jnp.int32)
    bd_full = jnp.einsum("bihd,phd->bhip", qv8, p8, preferred_element_type=jnp.int32)
    bd = jnp.take_along_axis(bd_full, jnp.broadcast_to(jnp.clip(r, 0, left)[None, None],
                                                       (b, h, n, left + n)), axis=-1)
    q = (jax_rq(ac, jnp.asarray(tbl["ac_grid"][0]), tbl["ac_grid"][1])
         + jax_rq(bd, jnp.asarray(tbl["bd_grid"][0]), tbl["bd_grid"][1]))
    a8 = jax_i_softmax_grid(q, mask=jnp.broadcast_to(mask[None], (b, n, left + n))[:, None],
                            out_bits=ab).astype(jnp.int8)
    ctx = jnp.einsum("bhij,bjhd->bihd", a8, v_cat,
                     preferred_element_type=jnp.int32).reshape(b, n, h * d_k)
    return jnp.clip(jax_rq(ctx, jnp.asarray(tbl["ctx_rq"][0]), tbl["ctx_rq"][1]),
                    -n8, n8 - 1).astype(jnp.int8)


def _jax_conv(tbl, c8, x8, glu_cache, d, kk, ab):
    """JAX's stream-step att_out join and conv module over [cache || new]
    (conformer_freeze.py:825-835)."""
    n8 = 2 ** (ab - 1) - 1
    x = JCF._join_lin(c8, tbl["att_out"], x8, tbl["j2_stream"], ab)
    yln = JCF._apply_affine_rq(JCF.i_layernorm_core(x), tbl["ln_conv"], ab)
    glu8 = jnp.clip(jax_rq(JCF._glu_int(tbl, yln, ab), jnp.asarray(tbl["glu_prod"][0]),
                           tbl["glu_prod"][1]), -n8, n8 - 1).astype(jnp.int8)
    glu_cat = jnp.concatenate([glu_cache, glu8], axis=1)
    mid8 = JCF._conv_tail_mid(tbl, glu_cat, (0, 0), d, ab)
    return JCF._join_lin(mid8, tbl["pw2"], x, tbl["j3_stream"], ab), glu_cat[:, -(kk - 1):]


def _i8(rng, *shape):
    return rng.integers(-127, 127, size=shape).astype(np.int8)


@pytest.mark.parametrize("seen", [0, 3, 20])
def test_cache_forms_plain_match_jax(conformer, seen):
    """n = 4 new frames over an L = 8 cache: a stream's first step (seen
    0), a later one with part of the cache still empty (seen 3 < L), and a
    full cache (seen 20)."""
    jm, pm = conformer
    jt = jm.enc_frozen
    JCF.frozen_stream_init(jt, jm.ccfg, 1)   # builds the JAX stream constants
    tables = pm._tables(torch.device("cpu"))["encoder"]
    p8s = port_cf._stream_p8(tables, pm.ccfg)
    ab = jt["act_bit"]
    rng = np.random.default_rng(seen)
    b, n, h, d_k, left, d, kk = 2, 4, 4, 16, 8, 64, 9
    for li, (jtbl, ptbl) in enumerate(zip(jt["layers"], tables["layers"])):
        np.testing.assert_array_equal(p8s[li].numpy(), np.asarray(jt["_stream_p8"][li]))
        qu8, qv8, k8, v8 = (_i8(rng, b, n, h, d_k) for _ in range(4))
        kc, vc = _i8(rng, b, left, h, d_k), _i8(rng, b, left, h, d_k)
        want = jax.jit(lambda *a, _t=jtbl: _jax_attention(_t, *a, seen, ab))(
            qu8, qv8, np.concatenate([kc, k8], 1), np.concatenate([vc, v8], 1),
            np.asarray(jt["_stream_p8"][li]))
        t = torch.from_numpy
        c8, k_new, v_new = port_int_attention.int_attention_cached_plain(
            t(qu8), t(qv8), t(k8), t(v8), t(kc), t(vc), p8s[li], seen, ac=ptbl["ac_grid"],
            bd=ptbl["bd_grid"], ctx_rq=ptbl["ctx_rq"], nbits=ab)
        np.testing.assert_array_equal(c8.numpy(), np.asarray(want))
        np.testing.assert_array_equal(k_new.numpy(), np.concatenate([kc, k8], 1)[:, n:])
        np.testing.assert_array_equal(v_new.numpy(), np.concatenate([vc, v8], 1)[:, n:])
        c8, x8, gc = _i8(rng, b, n, d), _i8(rng, b, n, d), _i8(rng, b, kk - 1, d)
        want_x, want_c = jax.jit(lambda *a, _t=jtbl: _jax_conv(_t, *a, d, kk, ab))(c8, x8, gc)
        got_x, got_c = port_conv_block.conv_block_cached_plain(t(c8), t(x8), t(gc), ptbl,
                                                               nbits=ab)
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
