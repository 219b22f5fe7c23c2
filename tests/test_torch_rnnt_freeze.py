"""The port's frozen integer transducer decoder (qasr_tpu_torch/quantize/
rnnt_freeze.py) and the full integer transducer against the JAX package,
on the CPU (Kernel 9's plain versions).

(a) ``freeze_rnnt_decoder``'s tables equal the JAX package's bit for bit
    (every leaf, dtype and Python type; 8- and 6-bit weights, two layers).
(b) ``pred_step_frozen`` (two layers, blank tokens, c at its clip; the
    JAX cell jitted, integer ops only) and ``joint_logits_frozen`` (the JAX
    joint under ``jax.disable_jit()``: its frame quantization divides in
    float32) equal the JAX package's; the frozen decoder's dtypes are int8
    h, int32 c, int32 logits.
(c) Frozen greedy ids equal the JAX package's (its jitted loop: integer
    ops, and the frame's quantization checked op by op in (b)), offline
    and over frame spans; the decode's stats (symbols, per-row joint
    steps) give the planned Kernel 9 launches.
(d) ``calibrate_decoder_ranges`` on a Jasper-encoder transducer is within
    1e-5 relative of the JAX package's.
(e) The full integer transducer (the JAX tests' one-layer d 64
    Conformer, calibrated and frozen by the JAX package, carried over by
    ``rnnt_model_from_jax``): with the JAX frontend and subsampler answering
    the port's calls (two float implementations sit an ulp apart), the
    encodings within 1e-6 and the ids equal the JAX package's, from its
    encodings and from the port's; the float-decoder path too.
(f) The BPE transducer decodes through the frozen decoder and its
    tokenizer, as the JAX package's.
(g) The flagship's golden record (full width, written by the JAX package):
    the port's tables' digests equal the record's, and the decoder from the
    record's frames and the encoder from its x8 give its frames, enc8 codes
    and ids (chip_smoke.py phase 13b also runs it from the record's audio).
(h) A calibrated Conformer transducer's ``.qasr`` archive interchanges:
    JAX-saved restores in the port with equal params and ranges and equal
    ids from the JAX package's encodings, and the port's restores in the
    JAX package.
(i) The flagship head with the blank's bias raised by 2 decodes the
    record's frames to the JAX package's ids, its frames ending with a
    blank and its rows taking their own numbers of steps.
(j) Kernel 9's table check is redone when a table tensor or scalar is
    replaced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import rnnt as JR
from qasr_tpu.models.conformer import subsample_convs as jax_subsample
from qasr_tpu.quantize import rnnt_freeze as JF
from qasr_tpu_torch import golden
from qasr_tpu_torch.compat.from_jax import rnnt_model_from_jax
from qasr_tpu_torch.kernels import rnnt_decoder as K9
from qasr_tpu_torch.models import rnnt as PR
from qasr_tpu_torch.quantize import conformer_freeze as port_cf
from qasr_tpu_torch.quantize import rnnt_freeze as PF
from qasr_tpu_torch.quantize.freeze import tables_digest
from test_torch_rnnt import _noise, _trees_equal, jax_conformer_transducer, jax_jasper_transducer

CFG = dict(num_classes=28, enc_hidden=40, pred_hidden=32, joint_hidden=24, pred_rnn_layers=2)
RANGE_RTOL = 1e-5


def _tables(wb=8, **kw):
    """Both packages' tables from seed 1, the blank's out bias at 1.0 (the
    decode then has steps that emit and steps that do not)."""
    jc, pc = JR.RNNTConfig(**{**CFG, **kw}), PR.RNNTConfig(**{**CFG, **kw})
    jp, pp = JR.init_rnnt_params(1, jc), PR.init_rnnt_params(1, pc)
    for p in (jp, pp):
        p["joint"]["out"]["b"][jc.blank_id] = 1.0
    jt = JF.freeze_rnnt_decoder(jp, jc, enc_range=3.0, joint_range=5.0, weight_bit=wb)
    pt = PF.freeze_rnnt_decoder(pp, pc, enc_range=3.0, joint_range=5.0, weight_bit=wb)
    return jc, pc, jt, pt


def _same_leaves(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_leaves(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same_leaves, a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("wb", [8, 6])
def test_freeze_tables_equal(wb):
    _, _, jt, pt = _tables(wb)
    assert _same_leaves(jt, pt)
    assert PF.decoder_tables_digest(jt) == PF.decoder_tables_digest(pt)


@pytest.fixture(scope="module")
def frozen():
    jc, pc, jt, pt = _tables()
    return jc, pc, jt, PF.rnnt_tables_to_device(pt, "cpu")


def test_cell_and_joint_bit_equal(frozen, rng):
    jc, _, jt, dt = frozen
    tok = np.full((5,), jc.blank_id, np.int32)
    tok[1:3] = (0, 17)
    h8 = rng.integers(-127, 128, (2, 5, 32)).astype(np.int8)
    c = rng.integers(-(1 << 23), (1 << 23) + 1, (2, 5, 32)).astype(np.int32)
    c[:, :, 0], c[:, :, 1] = 1 << 23, -(1 << 23)
    enc = (rng.normal(size=(5, 40)) * 3).astype(np.float32)
    step, _ = JF._jits(jt)   # integer ops only: compiled equals op by op
    jg, jh, jcq = (np.asarray(o) for o in step(jnp.asarray(tok), jnp.asarray(h8),
                                                jnp.asarray(c)))
    with jax.disable_jit():
        jl = np.asarray(JF.joint_logits_frozen(jt, jnp.asarray(enc), jnp.asarray(jg)))
    pg, ph, pcq = PF.pred_step_frozen(dt, torch.from_numpy(tok), torch.from_numpy(h8),
                                      torch.from_numpy(c))
    pl = PF.joint_logits_frozen(dt, torch.from_numpy(enc), pg)
    assert np.array_equal(pg.numpy(), jg) and np.array_equal(ph.numpy(), jh)
    assert np.array_equal(pcq.numpy(), jcq) and np.array_equal(pl.numpy(), jl)
    # the frozen decoder's dtypes, checked on its outputs
    assert (pg.dtype, ph.dtype, pcq.dtype, pl.dtype) == (torch.int8, torch.int8, torch.int32,
                                                        torch.int32)
    g8, (h8_0, c_0), hyps = PF.frozen_decoder_init(dt, PR.RNNTConfig(**CFG), 3)
    assert (g8.dtype, h8_0.dtype, c_0.dtype) == (torch.int8, torch.int8, torch.int32)
    assert h8_0.shape == c_0.shape == (2, 3, 32) and hyps == [[], [], []]


def test_frozen_greedy_ids_equal(frozen, rng):
    jc, pc, jt, dt = frozen
    enc = (rng.normal(size=(3, 10, 40)) * 2).astype(np.float32)
    lens = np.asarray([10, 6, 3])
    want = JF.greedy_decode_frozen(jt, jc, enc, lens)
    K9.rnnt_pred_step.launches = K9.rnnt_greedy.launches = 0
    stats = {}
    got = PF.greedy_decode_frozen(dt, pc, torch.from_numpy(enc), lens, stats=stats)
    assert got == want and any(want)
    assert stats["symbols"] == sum(map(len, want)) and stats["calls"] == 1
    # a row's joint steps: one an emission, one a frame it leaves with a blank
    assert all(s > len(h) for s, h in zip(stats["joint_steps"], want))
    assert stats["max_row_steps"] == max(stats["joint_steps"])
    assert PF.decoder_launches(dt, stats) == {"rnnt_greedy": 1, "rnnt_pred": 2}
    # on the CPU the wrappers run the plain versions and count nothing
    assert K9.rnnt_pred_step.launches == K9.rnnt_greedy.launches == 0
    carry = PF.frozen_decoder_init(dt, pc, 3)
    for t0, t1 in ((0, 4), (4, 10)):
        carry = PF.greedy_decode_frames_frozen(dt, pc, torch.from_numpy(enc[:, t0:t1]),
                                               np.clip(lens - t0, 0, t1 - t0), carry)
    assert carry[2] == want


def test_calibrate_decoder_ranges():
    jm = jax_jasper_transducer()
    pm = rnnt_model_from_jax(jm)
    audio, alens = _noise(3, (6000, 4800))
    want = JF.calibrate_decoder_ranges(jm, [(audio, alens)])
    got = PF.calibrate_decoder_ranges(pm, [(audio, alens)], device="cpu")
    for g, w in zip(got, want):
        assert abs(g - w) <= RANGE_RTOL * abs(w)


@pytest.fixture(scope="module")
def integer_transducer():
    """The JAX tests' full integer transducer (test_rnnt_freeze.py:122's
    config, out bias nudged), calibrated and frozen by the JAX package,
    and the port's copy."""
    jm = jax_conformer_transducer()
    jm.freeze_encoder()
    audio, alens = _noise(1, (8000, 6400))
    jm.freeze_decoder([(audio, alens)])
    return jm, rnnt_model_from_jax(jm), audio, alens


def _jax_front_end(monkeypatch, jm, pm):
    """The port's frontend and subsampler calls answered by the JAX
    package's."""
    class Front:
        cfg = pm.frontend.cfg

        def __call__(self, audio, lens, dither=0.0):
            f, fl = jm.frontend(np.asarray(audio), np.asarray(lens), dither=dither)
            return torch.from_numpy(np.array(f)), torch.from_numpy(np.array(fl))

    def sub(p, cfg, x, lens):
        y, yl = jax_subsample(jm.enc_frozen["subsampler"], jm.plan, jnp.asarray(x.numpy()),
                              jnp.asarray(lens.numpy()))
        return torch.from_numpy(np.array(y)), torch.from_numpy(np.array(yl))
    monkeypatch.setattr(pm, "frontend", Front())
    monkeypatch.setattr(port_cf, "subsample_convs", sub)


def test_full_integer_transducer_ids_equal(integer_transducer, monkeypatch):
    jm, pm, audio, alens = integer_transducer
    _jax_front_end(monkeypatch, jm, pm)
    jenc, jlens = (np.asarray(o) for o in jm.encode(audio, alens))
    want = JF.greedy_decode_frozen(jm.dec_frozen, jm.rnnt_cfg, jenc, jlens)
    enc, lens = pm.encode(audio, alens, device="cpu")
    assert np.array_equal(lens.numpy(), jlens)
    # the integer stack is equal; the last i-LayerNorm's float affine may
    # round once (XLA's fma) or twice (torch)
    np.testing.assert_allclose(enc.numpy(), jenc, rtol=1e-6, atol=1e-6)
    assert pm._greedy_hyps(torch.from_numpy(jenc), jlens) == want and any(want)
    assert pm._greedy_hyps(enc, lens) == want
    labels = list(pm.cfg.labels)
    assert pm.transcribe_greedy(audio, alens, device="cpu") == [
        "".join(labels[i] for i in h) for h in want]
    # the float decoder on the same frames
    monkeypatch.setattr(pm, "dec_frozen", None)
    assert pm._greedy_hyps(enc, lens) == JR.greedy_decode(jm.params["rnnt"], jm.rnnt_cfg, jenc,
                                                          jlens)


def test_model_from_jax_carries_state(integer_transducer):
    jm, pm, _, _ = integer_transducer
    assert _trees_equal(pm.params, jm.params) and _trees_equal(pm.enc_qstate, jm.enc_qstate)
    assert PF.decoder_tables_digest(pm.dec_frozen) == PF.decoder_tables_digest(jm.dec_frozen)
    assert port_cf.conformer_tables_digest(pm.encoder_tables(torch.device("cpu"))) == \
        tables_digest({k: v for k, v in jm.enc_frozen.items() if not k.startswith("_")})


def test_bpe_transducer_frozen(tmp_path):
    from qasr_tpu.data.tokenizers import BPETokenizer
    from qasr_tpu.models.config import DecoderConfig, ModelConfig
    from qasr_tpu.models.rnnt_model import EncDecRNNTBPEModel as JaxBPE
    from qasr_tpu_torch.models.rnnt_model import EncDecRNNTBPEModel
    from test_jasper_model import FEAT, tiny_encoder_cfg

    tok = BPETokenizer.train(["abba cab cabba bac"] * 10, vocab_size=24,
                             save_path=str(tmp_path / "tok.json"))
    cfg = ModelConfig(encoder=tiny_encoder_cfg(), decoder=DecoderConfig(feat_in=40, num_classes=1),
                      preprocessor={"features": FEAT, "dither": 0.0})
    jm = JaxBPE.from_config_and_tokenizer(
        cfg, tok, rnnt_cfg=JR.RNNTConfig(num_classes=tok.vocab_size, enc_hidden=40,
                                         pred_hidden=16, joint_hidden=16), seed=2)
    audio, alens = _noise(0, (4000,))
    jm.freeze_decoder([(audio, alens)])
    pm = rnnt_model_from_jax(jm)
    assert isinstance(pm, EncDecRNNTBPEModel) and pm.dec_frozen is not None
    enc, el = (np.asarray(o) for o in jm.encode(audio, alens))
    want = JF.greedy_decode_frozen(jm.dec_frozen, jm.rnnt_cfg, enc, el)
    assert pm._greedy_hyps(torch.from_numpy(enc), el) == want
    assert [pm._text(h) for h in want] == [tok.ids_to_text(h) for h in want]


def test_golden_record_on_cpu():
    model = golden.rnnt_conformer16x256_w8a8()
    res = golden.check_rnnt_golden(model, "cpu", audio=False)
    assert not res["bad"], res["bad"]
    assert all(res["symbols"])


def test_blank_biased_flagship_head_matches_jax():
    """The flagship head with the blank's bias raised by 2 (chip_smoke.py
    13b's second main-path head), frozen from the record's ranges in both
    packages, decodes the record's frames to the same ids: frames end with
    a blank and each row takes its own number of steps."""
    model = golden.rnnt_conformer16x256_w8a8(frozen=False, blank_bias=2.0)
    rec, enc, _, _ = golden.load_rnnt_golden()
    p, pc = model.params["rnnt"], model.rnnt_cfg
    jc = JR.RNNTConfig(**dataclasses.asdict(pc))
    kw = dict(enc_range=rec["ranges"][0], joint_range=rec["ranges"][1])
    jt = JF.freeze_rnnt_decoder(p, jc, **kw)
    dt = PF.rnnt_tables_to_device(PF.freeze_rnnt_decoder(p, pc, **kw), "cpu")
    stats = {}
    got = PF.greedy_decode_frozen(dt, pc, torch.from_numpy(enc), rec["enc_lens"], stats=stats)
    assert got == JF.greedy_decode_frozen(jt, jc, enc, np.asarray(rec["enc_lens"]))
    # frames end with a blank, and the rows take their own numbers of steps
    assert all(got) and all(s > len(h) for s, h in zip(stats["joint_steps"], got))
    assert len(set(stats["joint_steps"])) == len(got)


def test_kernel9_table_check_follows_replaced_tensors():
    """Kernel 9's table check is kept while the tables hold the same
    tensors and scalars; a replaced tensor or scalar is checked again (a bad
    one raises) and gets its own pointer."""
    dt = PF.rnnt_tables_to_device(_tables()[3], "cpu")
    cpu = torch.device("cpu")
    layers, joint = K9._check_tables(dt, cpu)
    assert K9._check_tables(dt, cpu)[1] is joint
    old = dt["joint"]["wt_out"]
    dt["joint"]["wt_out"] = old.to(torch.int32)
    with pytest.raises(ValueError, match="wt_out"):
        K9._check_tables(dt, cpu)
    dt["joint"]["wt_out"] = old.clone()
    _, joint2 = K9._check_tables(dt, cpu)
    assert joint2[2] == dt["joint"]["wt_out"].data_ptr() and joint2[:2] == joint[:2]
    dt["joint"]["e_o"] = 0
    with pytest.raises(ValueError, match="exponents"):
        K9._check_tables(dt, cpu)


def test_conformer_qasr_archives_both_ways(integer_transducer, tmp_path):
    from qasr_tpu.models.rnnt_model import RNNTModel as JaxRNNTModel
    from qasr_tpu_torch.models.rnnt_model import RNNTModel

    jm, _, audio, alens = integer_transducer
    jpath, ppath = str(tmp_path / "jax.qasr"), str(tmp_path / "port.qasr")
    jm.save_to(jpath)
    pm = RNNTModel.restore_from(jpath)
    assert pm.encoder_kind == "conformer" and pm.enc_qcfg.static_attention
    assert _trees_equal(pm.params, jm.params) and _trees_equal(pm.enc_qstate, jm.enc_qstate)
    assert port_cf.conformer_tables_digest(
        port_cf.conformer_tables_to_device(pm.freeze_encoder(), "cpu")) == \
        tables_digest({k: v for k, v in jm.enc_frozen.items() if not k.startswith("_")})
    jenc, jlens = (np.asarray(o) for o in jm.encode(audio, alens))
    assert pm._greedy_hyps(torch.from_numpy(jenc), jlens) == \
        JR.greedy_decode(jm.params["rnnt"], jm.rnnt_cfg, jenc, jlens)
    pm.save_to(ppath)
    jm2 = JaxRNNTModel.restore_from(ppath)
    assert _trees_equal(jm2.params, jm.params) and _trees_equal(jm2.enc_qstate, jm.enc_qstate)
