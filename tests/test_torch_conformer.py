"""The port's frozen Conformer-CTC against the JAX package, end to end.

(a) Init, range state and frozen tables equal the JAX package's bit for
    bit (tree equality and the table digest).
(b) From the same float features, the port's encoder and quantized CTC
    head (plain executor, and the kernel executor on the kernels' plain
    versions) equal ``frozen_conformer_apply`` and the JAX head: bit for
    bit with ``subsampling=""``; with the striding subsampler the x8 codes
    may differ in at most 0.1% of elements by +-1, the integer stack from
    the same x8 is exact, and the greedy ids are equal.
(c) From int16 PCM, ``make_conformer_frozen_fn`` / ``transcribe_greedy``
    against ``ConformerCTC.forward`` / ``transcribe_greedy``: equal encoder
    lengths, ids equal wherever the frontend flips no first-site code.
(d) The full-width flagship (16 x 256) built without jax from the
    committed ranges matches the committed golden record on the CPU, on
    the plain executor and under every plan.
Log-probs are float: within 1e-5 (same arithmetic, two libraries).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import EncoderConfig as JEnc
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.models.conformer import subsample_convs as jax_subsample
from qasr_tpu.models.conformer_ctc import ConformerCTC as JaxConformerCTC
from qasr_tpu.quantize.conformer_freeze import frozen_conformer_apply
from qasr_tpu_torch import golden
from qasr_tpu_torch.compat.from_jax import conformer_tables_from_jax, state_from_jax
from qasr_tpu_torch.kernels import conv_block as port_conv_block
from qasr_tpu_torch.kernels import ffn_ln as port_ffn_ln
from qasr_tpu_torch.kernels import int_attention as port_int_attention
from qasr_tpu_torch.kernels import lin_epilogue as port_lin_epilogue
from qasr_tpu_torch.models.config import DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC, make_conformer_frozen_fn
from qasr_tpu_torch.quantize import conformer_freeze as port_cf
from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig
from qasr_tpu_torch.quantize.freeze import tables_digest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = tuple(" abcdefghijklmnopqrstuvwxyz'")
SMALL = dict(feat_in=32, n_layers=2, d_model=64, n_heads=4, subsampling_factor=4,
             subsampling_conv_channels=16, conv_kernel_size=9, dropout=0.0)
FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
             integer_activations=True, static_attention=True)


def _configs(subsampling):
    prep = {"features": 32, "dither": 0.0}
    jm = JModel(encoder=JEnc(feat_in=32, blocks=()), decoder=JDec(feat_in=64, num_classes=28),
                labels=LABELS, preprocessor=prep)
    pm = ModelConfig(encoder=EncoderConfig(feat_in=32, blocks=()),
                     decoder=DecoderConfig(feat_in=64, num_classes=28),
                     labels=LABELS, preprocessor=prep)
    return (jm, JConf(subsampling=subsampling, **SMALL),
            pm, ConformerConfig(subsampling=subsampling, **SMALL))


def _noise_pcm(seed, secs, batch=2):
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    pcm = (rng.normal(size=(batch, n)) * 0.1 * 32767).astype(np.int16)
    lens = np.full((batch,), n, np.int32)
    lens[-1] = int(n * 0.7)
    pcm[-1, lens[-1]:] = 0
    return pcm, lens


def _build(subsampling):
    jcfg, jccfg, pcfg, pccfg = _configs(subsampling)
    jm = JaxConformerCTC.from_config(jcfg, jccfg, seed=0)
    pcm, lens = _noise_pcm(1, 1.0)
    jm.quantize_encoder([(pcm.astype(np.float32) / 32768.0, lens)], **FLAGS)
    jm.freeze()
    pm = ConformerCTC.from_config(pcfg, pccfg, seed=0)
    pm.enc_qcfg = ConformerQuantConfig(**dataclasses.asdict(jm.enc_qcfg))
    pm.enc_qstate = state_from_jax(jm.enc_qstate)
    return jm, pm


@pytest.fixture(scope="module")
def striding():
    return _build("striding")


@pytest.fixture(scope="module")
def linear():
    return _build("")


def assert_tree_equal(a, b, path="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (path, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("subsampling", ["striding", ""])
def test_init_matches_jax(subsampling):
    jcfg, jccfg, pcfg, pccfg = _configs(subsampling)
    for seed in (0, 5):
        jm = JaxConformerCTC.from_config(jcfg, jccfg, seed=seed)
        pm = ConformerCTC.from_config(pcfg, pccfg, seed=seed)
        assert_tree_equal(state_from_jax(jm.params), pm.params, "params")
    assert dataclasses.asdict(pccfg) == dataclasses.asdict(jccfg)
    assert (pccfg.dw_padding, pccfg.att_context, pccfg.d_ff) == \
        (jccfg.dw_padding, jccfg.att_context, jccfg.d_ff)


@pytest.mark.parametrize("which", ["striding", "linear"])
def test_freeze_tables_match_jax(request, which):
    jm, pm = request.getfixturevalue(which)
    pt = pm.freeze_host()
    assert_tree_equal(state_from_jax(jm.enc_frozen), pt, "tables")
    assert tables_digest(jm.enc_frozen) == tables_digest(pt)
    # the JAX tables carried over through compat give the same device tables
    dev = conformer_tables_from_jax(jm.enc_frozen, "cpu")
    assert port_cf.conformer_tables_digest(dev) == tables_digest(pt)
    assert dev["layers"][0]["ff1_l1"]["wt"].dtype == torch.int8
    assert isinstance(dev["layers"][0]["j1_stream"][1], int)


def test_qstate_json_round_trip(striding):
    jm, pm = striding
    text = pm.qstate_to_json()
    other = ConformerCTC.from_config(*_configs("striding")[2:], seed=0)
    other.qstate_from_json(text)
    assert other.qstate_to_json() == text
    assert_tree_equal(state_from_jax(jm.enc_qstate),
                      jax.tree_util.tree_map(np.asarray, other.enc_qstate), "qstate")
    assert dataclasses.asdict(other.enc_qcfg) == dataclasses.asdict(jm.enc_qcfg)
    assert tables_digest(other.freeze_host()) == tables_digest(jm.enc_frozen)


def _jax_from_features(jm, feats, lens):
    @jax.jit
    def run(x, lengths):
        enc, enc_lens = frozen_conformer_apply(jm.enc_frozen, jm.ccfg, x, lengths)
        return enc, enc_lens, jm._head(jm.params, enc)
    return [np.asarray(o) for o in run(jnp.asarray(feats), jnp.asarray(lens))]


def _port_from_x8(pm, tables, x8, lens, kernels):
    enc, enc_lens = port_cf.conformer_encode(tables["encoder"], pm.ccfg, x8, lens,
                                             kernels=kernels)
    return enc.numpy(), enc_lens.numpy(), pm.head(tables, enc).numpy()


def test_linear_frozen_encoder_and_head_bit_identical(linear):
    """subsampling="": the one quantization of the features is the same
    float32 division in both packages, so everything after it is exact."""
    jm, pm = linear
    tables = pm.freeze(device="cpu")
    rng = np.random.default_rng(13)
    feats = rng.normal(size=(3, 41, 32)).astype(np.float32)
    lens = np.asarray([41, 30, 7], np.int32)
    enc_j, el_j, lp_j = _jax_from_features(jm, feats, lens)
    x8, sub_lens = port_cf.conformer_x8(tables["encoder"], pm.ccfg, torch.from_numpy(feats),
                                        torch.from_numpy(lens))
    for kernels in (False, True):
        enc, el, lp = _port_from_x8(pm, tables, x8, sub_lens, kernels)
        np.testing.assert_array_equal(enc, enc_j, err_msg=f"kernels={kernels}")
        np.testing.assert_array_equal(el, el_j)
        np.testing.assert_allclose(lp, lp_j, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lp.argmax(-1), lp_j.argmax(-1))
    assert len(np.unique(lp_j.argmax(-1))) > 1, "degenerate ids"


def test_striding_frozen_encoder_within_x8_tolerance(striding):
    """The float32 subsampler: x8 within 0.1% of codes at +-1 of XLA's,
    the integer stack from XLA's x8 exact, and equal greedy ids."""
    jm, pm = striding
    tables = pm.freeze(device="cpu")
    rng = np.random.default_rng(17)
    feats = rng.normal(size=(3, 96, 32)).astype(np.float32)
    lens = np.asarray([96, 70, 33], np.int32)
    jt = jm.enc_frozen
    n = 2 ** (jt["act_bit"] - 1) - 1
    y, jl = jax_subsample(jt["subsampler"], jm.ccfg, jnp.asarray(feats), jnp.asarray(lens))
    x8_j = np.asarray(jnp.clip(jnp.round(y / jt["S_pre"]), -n, n - 1).astype(jnp.int8))
    x8_p, pl = port_cf.conformer_x8(tables["encoder"], pm.ccfg, torch.from_numpy(feats),
                                    torch.from_numpy(lens))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    d = np.abs(x8_p.numpy().astype(np.int32) - x8_j.astype(np.int32))
    assert d.max() <= 1 and (d != 0).mean() <= 1e-3, (d.max(), (d != 0).mean())
    enc_j, el_j, lp_j = _jax_from_features(jm, feats, lens)
    for kernels in (False, True):
        enc, el, lp = _port_from_x8(pm, tables, torch.from_numpy(x8_j.copy()), pl, kernels)
        np.testing.assert_array_equal(enc, enc_j)
        np.testing.assert_array_equal(el, el_j)
        np.testing.assert_allclose(lp, lp_j, rtol=0, atol=1e-5)
    _, _, lp_p = _port_from_x8(pm, tables, x8_p, pl, True)
    np.testing.assert_array_equal(lp_p.argmax(-1), lp_j.argmax(-1))


@pytest.mark.parametrize("which", ["striding", "linear"])
def test_serving_from_pcm_matches_jax(request, which):
    """ConformerCTC.forward / transcribe_greedy, both packages, from int16
    PCM: lengths equal, log-probs close and ids equal when the frontend
    flips no first-site code."""
    jm, pm = request.getfixturevalue(which)
    pcm, lens = _noise_pcm(29, 1.3)
    pcm_f = pcm.astype(np.float32) / 32768.0   # the JAX frontend takes float PCM
    lp_j, el_j = (np.asarray(o) for o in jm.forward(pcm_f, lens))
    pm.freeze(device="cpu")    # both models serve frozen (jm froze in _build)
    assert pm.mode() == "frozen"
    lp_p, el_p = pm.forward(pcm, lens, device="cpu")
    np.testing.assert_array_equal(el_p.numpy(), el_j)
    assert lp_p.shape == lp_j.shape
    ids_p = make_conformer_frozen_fn(pm, pm.freeze(device="cpu"), argmax=True,
                                     kernels=False)(pcm, lens)[0].numpy()
    np.testing.assert_array_equal(ids_p, lp_p.numpy().argmax(-1))
    valid = np.arange(lp_j.shape[1])[None, :] < el_j[:, None]
    agree = (lp_p.numpy().argmax(-1) == lp_j.argmax(-1))[valid].mean()
    assert agree >= 0.9, agree
    if agree == 1.0:
        assert pm.transcribe_greedy(pcm, lens, device="cpu") == \
            jm.transcribe_greedy(pcm_f, lens)


def _count_kernel_calls(monkeypatch):
    """Count the encoder's calls of the four kernel wrappers (on CPU
    tensors each runs its plain version)."""
    calls = {"int_attention": 0, "conv_block": 0, "ffn_ln": 0, "lin_epilogue": 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    for name, mod in (("int_attention", port_int_attention), ("conv_block", port_conv_block),
                      ("ffn_ln", port_ffn_ln), ("lin_epilogue", port_lin_epilogue)):
        monkeypatch.setattr(port_cf, name, counting(name, getattr(mod, name)))
    return calls


@pytest.fixture(scope="module")
def flagship():
    model = golden.conformer16x256_w8a8()
    return model, model.freeze(device="cpu")


def test_flagship_golden_cpu(flagship, monkeypatch):
    """Full-width 16 x 256 Conformer-CTC built without jax (seed-0 init,
    the committed ranges, freeze) against the committed JAX record, on
    the plain executor and on the kernel executor under the default plan
    ("1", True), which calls each kernel wrapper as ``kernel_launches``
    says: 16 int_attention + 16 conv_block + 32 ffn_ln + 81 lin_epilogue."""
    model, tables = flagship
    res = golden.check_conformer_golden(model, tables, kernels=False)
    assert res["bad"] == [], res
    calls = _count_kernel_calls(monkeypatch)
    res = golden.check_conformer_golden(model, tables, kernels=True)
    assert res["bad"] == [], res
    assert calls == port_cf.kernel_launches(model.ccfg) == {
        "int_attention": 16, "conv_block": 16, "ffn_ln": 32, "lin_epilogue": 81}


@pytest.mark.parametrize("plan", [("conv", True), ("conv", False), ("1", False)])
def test_flagship_golden_cpu_other_plans(flagship, monkeypatch, plan):
    """The committed record holds under every plan (each is bit-identical
    to the XLA composition), with the launches its plan predicts."""
    model, tables = flagship
    calls = _count_kernel_calls(monkeypatch)
    res = golden.check_conformer_golden(model, tables, kernels=True,
                                        plan=port_cf.ConformerPlan(*plan))
    assert res["bad"] == [], res
    assert calls == port_cf.kernel_launches(model.ccfg, port_cf.ConformerPlan(*plan))


@pytest.mark.slow
def test_conformer_golden_recomputed_by_jax():
    """JAX on the CPU recalibrates the flagship and recomputes the
    committed range state and golden record."""
    spec = importlib.util.spec_from_file_location(
        "torch_conformer_golden", os.path.join(ROOT, "experiments",
                                               "torch_conformer_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    m = mod.jax_flagship()
    with open(golden.CONF_QSTATE_PATH) as f:
        assert f.read() == mod.qstate_json(m)
    rec, x8, lp = mod.jax_golden(m)
    want, wx8, wlp = golden.load_conformer_golden()
    assert rec == want
    np.testing.assert_array_equal(x8, wx8)
    np.testing.assert_array_equal(lp, wlp)
