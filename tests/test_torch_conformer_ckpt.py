"""The port's Conformer-CTC checkpoints, YAML factory, LSTM head and config
variants against the JAX package.

(a) ``.qasr`` both ways for the linear and the LSTM head, with and
    without calibrated ranges and a BPE tokenizer: params, range state,
    quantization config, head and tokenizer equal; restored with ranges
    and frozen, the port's log-probs from the same features equal the
    JAX model's (the linear head's within 1e-5, the LSTM head's within
    rtol 1e-5) with equal ids and transcripts.
(b) ``conformer_ctc_from_dict`` / ``_from_yaml`` for char, LSTM and BPE
    configs (``${...}`` references resolved): equal configs and params.
(c) The LSTM head (1 and 2 layers, uni- and bidirectional) against
    ``lstm_decoder_forward``: rtol 1e-5.
(d) The JAX package's ``test_frozen_config_variants`` configs (vggnet
    subsampling, untied position biases, 2 heads): float, PTQ and frozen
    against the JAX ConformerCTC in the same state, from the same
    features: float log-probs within 1e-5; vggnet's calibrated ranges
    within half a quantization step of the JAX package's (its compiled
    calibration is an ulp off its own op-by-op arithmetic); with one range
    state in both (vggnet's the JAX package's, the others' the port's),
    the PTQ and frozen log-probs within 1e-5 (measured 9.5e-7 on the PTQ ones),
    equal ids and transcripts, equal frozen tables, the x8 codes of the
    float32 subsampler (JAX op by op) equal, and the frozen integer
    encodings from the same x8 bit for bit (kernel wrappers included).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.data import tokenizers as jtok
from qasr_tpu.decode.ctc import ctc_collapse as jax_collapse
from qasr_tpu.models import conformer_ctc as JCC
from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import EncoderConfig as JEnc
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.models.conformer import subsample_convs as jax_subsample
from qasr_tpu.models.lstm_decoder import init_lstm_decoder as jax_init_lstm
from qasr_tpu.models.lstm_decoder import lstm_decoder_forward as jax_lstm
from qasr_tpu.quantize.conformer_freeze import frozen_conformer_apply
from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig as JQcfg
from qasr_tpu_torch.compat.from_jax import state_from_jax
from qasr_tpu_torch.data.tokenizers import BPETokenizer
from qasr_tpu_torch.models import conformer_ctc as PCC
from qasr_tpu_torch.models.config import DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.models.lstm_decoder import init_lstm_decoder, lstm_decoder_forward
from qasr_tpu_torch.quantize import conformer_freeze as port_cf
from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig
from qasr_tpu_torch.quantize.freeze import tables_digest
from qasr_tpu_torch.quantize.ranges import params_to_device
from test_torch_conformer import FLAGS, LABELS, SMALL, assert_tree_equal

LOGPROB_ATOL = 1e-5
STEP_TOL = 0.5
TEXTS = ["the cat sat on the mat", "hello world", "a quick brown fox", "the world is round"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: with several test workers on the same cores,
    torch's default thread pool makes the small ops here many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(labels=LABELS, **kw):
    prep = {"features": 32, "dither": 0.0}
    ccfg = dict(SMALL, subsampling="", **kw)
    return (JModel(encoder=JEnc(feat_in=32, blocks=()),
                   decoder=JDec(feat_in=64, num_classes=len(labels)), labels=labels,
                   preprocessor=prep), JConf(**ccfg),
            ModelConfig(encoder=EncoderConfig(feat_in=32, blocks=()),
                        decoder=DecoderConfig(feat_in=64, num_classes=len(labels)),
                        labels=labels, preprocessor=prep), ConformerConfig(**ccfg))


def _features(seed, t=48, batch=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, t, 32)).astype(np.float32), \
        np.asarray([t, t - 13], np.int32)[:batch]


@pytest.fixture(scope="module")
def bpe(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bpe") / "tokenizer.json")
    jtok.BPETokenizer.train(TEXTS, 36, path)
    return path


def _jax_state(jm, x, lens):
    """The JAX model's log-probs and lengths in its state (compiled)."""
    run = jax.jit(lambda p, a, b: jm._apply(p, a, b))
    return [np.asarray(o) for o in run(jm.params, jnp.asarray(x), jnp.asarray(lens))]


def _jax_frozen(jm, x, lens):
    """(encodings, log-probs, lengths) of the frozen JAX model."""
    enc, el = frozen_conformer_apply(jm.enc_frozen, jm.ccfg, x, lens)
    return enc, jm._head(jm.params, enc), el


def _jax_texts(jm, lp, el):
    """The JAX model's greedy transcripts of these log-probs."""
    jm.forward = lambda audio, alens: (lp, el)
    return jm.transcribe_greedy(None, None)


@pytest.mark.parametrize("kind,ranges,tokenizer", [
    ("linear", False, False), ("linear", True, True), ("lstm", True, False),
    ("lstm", False, True)])
def test_qasr_interchanges_with_jax(tmp_path, bpe, kind, ranges, tokenizer):
    m = {"encoder": dict(SMALL, feat_in=32, subsampling=""), "labels": list(LABELS),
         "preprocessor": {"features": 32, "dither": 0.0},
         "decoder": {"_target_": "nemo.collections.asr.modules.LSTMDecoder",
                     "lstm_hidden_size": 24} if kind == "lstm" else {}}
    jm = JCC.conformer_ctc_from_dict(m, tokenizer=jtok.BPETokenizer(bpe) if tokenizer else None)
    if ranges:      # the port's calibrated ranges, set on the JAX model
        cal = PCC.conformer_ctc_from_dict(m, tokenizer=BPETokenizer(bpe) if tokenizer else None)
        cal.quantize_encoder([_features(3), _features(4)], features=True, device="cpu", **FLAGS)
        jm.enc_qcfg = JQcfg(**dataclasses.asdict(cal.enc_qcfg))
        jm.enc_qstate = cal.enc_qstate
    jm.save_to(str(tmp_path / "jax.qasr"))
    pm = PCC.ConformerCTC.restore_from(str(tmp_path / "jax.qasr"))
    assert pm.decoder_kind == kind and pm.mode() == ("ptq" if ranges else "float")
    assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    assert dataclasses.asdict(pm.ccfg) == dataclasses.asdict(jm.ccfg)
    assert pm.vocabulary == jm.vocabulary
    if ranges:
        assert_tree_equal(state_from_jax(jm.enc_qstate), pm.enc_qstate, "qstate")
        assert dataclasses.asdict(pm.enc_qcfg) == dataclasses.asdict(jm.enc_qcfg)
    if tokenizer:
        assert pm.tokenizer.vocab == jm.tokenizer.vocab
    pm.save_to(str(tmp_path / "port.qasr"))
    back = JCC.ConformerCTC.restore_from(str(tmp_path / "port.qasr"))
    assert back.decoder_kind == kind
    assert_tree_equal(state_from_jax(back.params), pm.params, "params")
    assert (back.enc_qstate is None) == (not ranges)
    if ranges:
        assert_tree_equal(state_from_jax(back.enc_qstate), pm.enc_qstate, "qstate")
        assert dataclasses.asdict(back.enc_qcfg) == dataclasses.asdict(pm.enc_qcfg)
        jm.freeze()
        pm.freeze(device="cpu")
    if tokenizer:
        assert back.tokenizer.vocab == jm.tokenizer.vocab
    x, lens = _features(9)
    lp_j, el_j = _jax_state(jm, x, lens)
    lp_p, el_p = pm.encode_decode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(el_p.numpy(), el_j)
    if kind == "lstm":
        np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=0, atol=LOGPROB_ATOL)
    np.testing.assert_array_equal(lp_p.numpy().argmax(-1), lp_j.argmax(-1))
    assert pm.ids_to_text(lp_p.argmax(-1), el_p) == _jax_texts(jm, lp_j, el_j)


def test_from_dict_and_yaml_match_jax(tmp_path, bpe):
    yaml_text = """
name: conformer
model:
  sample_rate: 16000
  labels: [" ", "a", "b", "c", "'"]
  d_model: 64
  preprocessor:
    features: 32
    sample_rate: ${model.sample_rate}
    dither: 0.0
  encoder:
    _target_: nemo.collections.asr.modules.ConformerEncoder
    feat_in: ${model.preprocessor.features}
    n_layers: 1
    d_model: ${model.d_model}
    n_heads: 4
    subsampling: vggnet
    subsampling_factor: 4
    subsampling_conv_channels: -1
    conv_kernel_size: 9
    dropout: 0.1
  decoder:
    _target_: %s
    feat_in: ${model.encoder.d_model}
    lstm_hidden_size: 16
    num_layers: 2
    bidirectional: true
"""
    for target, tok in (("nemo.collections.asr.modules.ConvASRDecoder", None),
                        ("nemo.collections.asr.modules.LSTMDecoder", None),
                        ("nemo.collections.asr.modules.ConvASRDecoder", bpe)):
        path = tmp_path / "conf.yaml"
        path.write_text(yaml_text.replace("d_model: ${model.d_model}", "d_model: 64")
                        .replace("n_layers: 1\n    d_model: 64",
                                 "n_layers: 1\n    d_model: ${model.d_model}") % target)
        jm = JCC.conformer_ctc_from_yaml(str(path), seed=2,
                                         tokenizer=jtok.BPETokenizer(tok) if tok else None)
        pm = PCC.conformer_ctc_from_yaml(str(path), seed=2,
                                         tokenizer=BPETokenizer(tok) if tok else None)
        assert pm.decoder_kind == jm.decoder_kind
        assert dataclasses.asdict(pm.ccfg) == dataclasses.asdict(jm.ccfg)
        assert pm.ccfg.subsampling_conv_channels == 64 and pm.ccfg.subsampling == "vggnet"
        assert dataclasses.asdict(pm.cfg) == dataclasses.asdict(jm.cfg)
        assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    with pytest.raises(ValueError, match="unsupported"):
        PCC.conformer_config_from_dict({"feat_in": 32, "no_such_field": 1})
    with pytest.raises(ValueError, match="labels"):
        PCC.conformer_ctc_from_dict({"encoder": {"feat_in": 32}})


@pytest.mark.parametrize("layers,bidirectional", [(1, False), (2, True)])
def test_lstm_head_matches_jax(layers, bidirectional):
    jp = jax_init_lstm(np.random.default_rng(4), 24, 6, hidden=16, num_layers=layers,
                       bidirectional=bidirectional)
    pp = init_lstm_decoder(np.random.default_rng(4), 24, 6, hidden=16, num_layers=layers,
                           bidirectional=bidirectional)
    assert_tree_equal(state_from_jax(jp), pp, "lstm")
    enc = np.random.default_rng(5).normal(size=(2, 13, 24)).astype(np.float32)
    want = np.asarray(jax.jit(jax_lstm)(jp, jnp.asarray(enc)))
    got = lstm_decoder_forward(params_to_device(pp, "cpu"), torch.from_numpy(enc)).numpy()
    assert got.shape == (2, 13, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


VARIANTS = {"vggnet": dict(subsampling="vggnet", subsampling_factor=4,
                           subsampling_conv_channels=8),
            "untie_biases": dict(untie_biases=True),
            "two_heads": dict(n_heads=2, conv_kernel_size=5)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_config_variants_match_jax(variant):
    base = dict(feat_in=32, n_layers=1, d_model=32, n_heads=4, subsampling="striding",
                subsampling_factor=4, subsampling_conv_channels=16, conv_kernel_size=9,
                dropout=0.0)
    kw = dict(base, **VARIANTS[variant])
    labels = LABELS
    prep = {"features": 32, "dither": 0.0}
    jm = JCC.ConformerCTC.from_config(
        JModel(encoder=JEnc(feat_in=32, blocks=()), decoder=JDec(feat_in=32, num_classes=28),
               labels=labels, preprocessor=prep), JConf(**kw), seed=3)
    pm = PCC.ConformerCTC.from_config(
        ModelConfig(encoder=EncoderConfig(feat_in=32, blocks=()),
                    decoder=DecoderConfig(feat_in=32, num_classes=28), labels=labels,
                    preprocessor=prep), ConformerConfig(**kw), seed=3)
    assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    x, lens = _features(5, t=45)        # odd: vggnet's ceil-mode pool keeps a last row
    batches = [_features(6 + i, t=45) for i in range(2)]
    for state in ("float", "ptq", "frozen"):
        if state == "ptq":
            pm.quantize_encoder(batches, features=True, device="cpu", **FLAGS)
            if variant == "vggnet":     # the subsampler ahead of the first site is new
                jm.quantize_encoder(batches, features=True, **FLAGS)
                want = jax.tree_util.tree_leaves(state_from_jax(jm.enc_qstate))
                got = jax.tree_util.tree_leaves(pm.enc_qstate)
                n = 2 ** (pm.enc_qcfg.act_bit - 1) - 1
                mag = np.repeat([max(abs(float(a)), abs(float(b)))
                                 for a, b in zip(want[::2], want[1::2])], 2)
                steps = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)) \
                    / (mag / n)
                assert steps.max() <= STEP_TOL, steps.max()
            else:                       # the port's ranges on the JAX model
                jm.enc_qcfg = JQcfg(**dataclasses.asdict(pm.enc_qcfg))
                jm.enc_qstate = pm.enc_qstate
            # one range state in both from here on: the paths after calibration
            pm.enc_qcfg = ConformerQuantConfig(**dataclasses.asdict(jm.enc_qcfg))
            pm.enc_qstate = state_from_jax(jm.enc_qstate)
        elif state == "frozen":
            jm.freeze()
            pm.freeze(device="cpu")
            assert tables_digest(pm.enc_frozen) == tables_digest(state_from_jax(jm.enc_frozen))
        assert pm.mode() == state
        if state == "frozen":       # the encodings too, for the integer check below
            enc_j, lp_j, el_j = (np.asarray(o) for o in jax.jit(
                lambda a, b: _jax_frozen(jm, a, b))(jnp.asarray(x), jnp.asarray(lens)))
        else:
            lp_j, el_j = _jax_state(jm, x, lens)
        lp_p, el_p = pm.encode_decode(torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_array_equal(el_p.numpy(), el_j)
        np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=0, atol=LOGPROB_ATOL, err_msg=state)
        np.testing.assert_array_equal(lp_p.numpy().argmax(-1), lp_j.argmax(-1))
        assert pm.ids_to_text(lp_p.argmax(-1), el_p) == \
            [jax_collapse(lp_j.argmax(-1)[i:i + 1, :el_j[i]], jm.blank_id, jm.vocabulary)[0]
             for i in range(len(el_j))]
    # the frozen integer encoder from the JAX package's x8, kernel wrappers included
    jt = jm.enc_frozen
    nq = 2 ** (jt["act_bit"] - 1) - 1
    with jax.disable_jit():
        y, jl = jax_subsample(jt["subsampler"], jm.ccfg, jnp.asarray(x), jnp.asarray(lens))
        x8_j = np.asarray(jnp.clip(jnp.round(y / jt["S_pre"]), -nq, nq - 1).astype(jnp.int8))
    tables = pm.freeze(device="cpu")
    x8_p, sl = port_cf.conformer_x8(tables["encoder"], pm.ccfg, torch.from_numpy(x),
                                    torch.from_numpy(lens))
    np.testing.assert_array_equal(x8_p.numpy(), x8_j)
    for kernels in (False, True):
        enc, el = port_cf.conformer_encode(tables["encoder"], pm.ccfg,
                                           torch.from_numpy(x8_j.copy()), sl, kernels=kernels)
        np.testing.assert_array_equal(enc.numpy(), enc_j)
        np.testing.assert_array_equal(el.numpy(), el_j)
