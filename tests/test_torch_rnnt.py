"""The port's transducer head (qasr_tpu_torch/models/rnnt.py), its Kernel 9
plain versions and its .qasr archives against the JAX package, on the CPU.

(a) ``init_rnnt_params`` equals the JAX package's from one seed.
(b) The float prediction network (``pred_step`` with two layers and blank
    tokens, ``pred_network``) and ``joint`` (relu, tanh, sigmoid) within
    1e-5 relative of the JAX package's (float32, TF32 off vs HIGHEST;
    XLA's and torch's sigmoid / tanh sit an ulp apart).
(c) Greedy decoding's ids equal the JAX package's.
(d) Beam search 'beam', 'tsd' and 'alsd' (the reference BeamRNNTInfer's,
    which test_rnnt_beam_parity.py holds to files this repository does not
    carry): the n-best sequences equal the JAX package's, their scores
    within 1e-4; an unknown type raises.
(e) Kernel 9's plain versions on the CPU: ``rnnt_pred_step`` (emit masks
    none / mixed / none emitting, two layers) equals the JAX package's
    ``pred_step_frozen`` followed by its greedy loop's ``where``;
    ``rnnt_joint``'s logits equal ``joint_logits_frozen`` and its ids the
    host argmax, a forced tie going to the lower column.
(f) ``.qasr`` archives interchange: a JAX-saved Jasper-encoder
    transducer restores in the port with equal params, its head decoding to
    the JAX package's ids, and the port's archive restores in the JAX
    package (test_torch_rnnt_freeze.py: a calibrated Conformer's, and
    ``rnnt_model_from_jax``, which carries params, ranges and frozen
    tables).
(g) Importing the transducer modules imports neither jax nor qasr_tpu.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import rnnt as JR
from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import EncoderConfig as JEnc
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.conformer import ConformerConfig as JConf
from qasr_tpu.models.rnnt_model import RNNTModel as JaxRNNTModel
from qasr_tpu.quantize import rnnt_freeze as JF
from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_joint, rnnt_pred_step
from qasr_tpu_torch.models import rnnt as PR
from qasr_tpu_torch.models.rnnt_model import RNNTModel
from qasr_tpu_torch.quantize import rnnt_freeze as PF
from qasr_tpu_torch.quantize.ranges import params_to_device
from test_jasper_model import FEAT, tiny_encoder_cfg

CFG = dict(num_classes=28, enc_hidden=40, pred_hidden=32, joint_hidden=24, pred_rnn_layers=2)
FLOAT_RTOL = 1e-5
SCORE_ATOL = 1e-4


def _pair(**kw):
    jc, pc = JR.RNNTConfig(**{**CFG, **kw}), PR.RNNTConfig(**{**CFG, **kw})
    return jc, pc, JR.init_rnnt_params(0, jc), params_to_device(PR.init_rnnt_params(0, pc),
                                                                "cpu")


def _close(got: torch.Tensor, want, rtol=FLOAT_RTOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= rtol * scale


def test_init_params_equal():
    jc, pc = JR.RNNTConfig(**CFG), PR.RNNTConfig(**CFG)
    jp, pp = JR.init_rnnt_params(3, jc), PR.init_rnnt_params(3, pc)
    flat_j = jax.tree_util.tree_leaves(jp)
    flat_p = jax.tree_util.tree_leaves(pp)
    assert len(flat_j) == len(flat_p)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(flat_j, flat_p))


def test_pred_step_and_network_float(rng):
    jc, pc, jp, pp = _pair()
    tok = np.asarray([jc.blank_id, 3, jc.blank_id, 27], np.int32)
    h = rng.normal(size=(2, 4, 32)).astype(np.float32) * 0.5
    c = rng.normal(size=(2, 4, 32)).astype(np.float32)
    jg, js = JR.pred_step(jp, jc, jnp.asarray(tok), JR.LSTMState(jnp.asarray(h), jnp.asarray(c)))
    pg, ps = PR.pred_step(pp, pc, torch.from_numpy(tok),
                          PR.LSTMState(torch.from_numpy(h), torch.from_numpy(c)))
    _close(pg, jg)
    _close(ps.h, js.h)
    _close(ps.c, js.c)
    targets = rng.integers(0, 28, (3, 5)).astype(np.int32)
    _close(PR.pred_network(pp, pc, torch.from_numpy(targets)),
           JR.pred_network(jp, jc, jnp.asarray(targets)))


@pytest.mark.parametrize("activation", ["relu", "tanh", "sigmoid"])
def test_joint_float(activation, rng):
    jc, pc, jp, pp = _pair(activation=activation)
    enc = rng.normal(size=(2, 5, 40)).astype(np.float32)
    pred = rng.normal(size=(2, 3, 32)).astype(np.float32)
    _close(PR.joint(pp, pc, torch.from_numpy(enc), torch.from_numpy(pred)),
           JR.joint(jp, jc, jnp.asarray(enc), jnp.asarray(pred)))


def test_greedy_float_ids_equal(rng):
    jc, pc, jp, pp = _pair()
    enc = rng.normal(size=(3, 12, 40)).astype(np.float32)
    lens = np.asarray([12, 8, 5])
    want = JR.greedy_decode(jp, jc, enc, lens)
    assert PR.greedy_decode(pp, pc, torch.from_numpy(enc), lens) == want
    assert sum(map(len, want)) > 0
    # the carry threads through frame spans: two spans decode as one
    carry = PR.greedy_init(pp, pc, 3)
    carry = PR.greedy_decode_frames(pp, pc, torch.from_numpy(enc[:, :6]), np.minimum(lens, 6),
                                    carry)
    carry = PR.greedy_decode_frames(pp, pc, torch.from_numpy(enc[:, 6:]),
                                    np.maximum(lens - 6, 0), carry)
    assert carry[2] == want


@pytest.mark.parametrize("search_type,kwargs", [
    ("beam", {}), ("tsd", {"tsd_max_sym_exp": 3}), ("alsd", {"alsd_max_target_len": 0.5}),
    ("default", {"score_norm": False})])
def test_beam_search_matches_jax(search_type, kwargs, rng):
    jc, pc, jp, pp = _pair(pred_rnn_layers=1)
    enc = rng.normal(size=(12, 40)).astype(np.float32)
    want = JR.beam_search(jp, jc, enc, beam_size=3, search_type=search_type, **kwargs)
    got = PR.beam_search(pp, pc, torch.from_numpy(enc), beam_size=3, search_type=search_type,
                         **kwargs)
    assert [h.y_sequence for h in got] == [h.y_sequence for h in want]
    assert max(abs(a.score - b.score) for a, b in zip(got, want)) <= SCORE_ATOL
    assert any(len(h.y_sequence) > 1 for h in want)
    assert PR.beam_decode_one(pp, pc, enc, 3, search_type, **kwargs) == \
        JR.beam_decode_one(jp, jc, enc, 3, search_type, **kwargs)


def test_beam_search_unknown_type_raises():
    _, pc, _, pp = _pair(pred_rnn_layers=1)
    with pytest.raises(NotImplementedError):
        PR.beam_search(pp, pc, np.zeros((2, 40), np.float32), search_type="maes")


@pytest.fixture(scope="module")
def frozen_pair():
    jc, pc = JR.RNNTConfig(**CFG), PR.RNNTConfig(**CFG)
    jt = JF.freeze_rnnt_decoder(JR.init_rnnt_params(0, jc), jc, enc_range=4.0,
                                joint_range=6.0)
    pt = PF.rnnt_tables_to_device(
        PF.freeze_rnnt_decoder(PR.init_rnnt_params(0, pc), pc, enc_range=4.0,
                               joint_range=6.0), "cpu")
    return jc, jt, pt


def test_kernel9_plain_pred_step(frozen_pair, rng):
    jc, jt, pt = frozen_pair
    tok = np.asarray([jc.blank_id, 5, 0, jc.blank_id, 28, 11], np.int32)
    h8 = rng.integers(-127, 128, (2, 6, 32)).astype(np.int8)
    c = rng.integers(-(1 << 23), (1 << 23) + 1, (2, 6, 32)).astype(np.int32)
    step, _ = JF._jits(jt)   # integer ops only: compiled equals op by op
    jg, jh, jcq = (np.asarray(o) for o in step(jnp.asarray(tok), jnp.asarray(h8),
                                                jnp.asarray(c)))
    for emit in (None, np.asarray([1, 0, 1, 1, 0, 1], bool), np.zeros(6, bool)):
        g8, h2, c2 = rnnt_pred_step(pt, torch.from_numpy(tok), torch.from_numpy(h8),
                                    torch.from_numpy(c),
                                    None if emit is None else torch.from_numpy(emit))
        keep = np.ones(6, bool) if emit is None else emit
        want_h = np.where(keep[None, :, None], jh, h8)
        want_c = np.where(keep[None, :, None], jcq, c)
        assert np.array_equal(h2.numpy(), want_h) and np.array_equal(c2.numpy(), want_c)
        assert np.array_equal(g8.numpy(), want_h[-1])
    assert rnnt_pred_step.launches == 0


def test_kernel9_plain_joint_and_tie(frozen_pair, rng):
    jc, jt, pt = frozen_pair
    enc = (rng.normal(size=(5, 3, 40)) * 2).astype(np.float32)
    h8 = rng.integers(-127, 128, (5, 32)).astype(np.int8)
    with jax.disable_jit():
        want = np.asarray(JF.joint_logits_frozen(jt, jnp.asarray(enc[:, 1]), jnp.asarray(h8)))
    logits, ids = rnnt_joint(pt, torch.from_numpy(enc)[:, 1], torch.from_numpy(h8))
    assert logits.dtype == torch.int32 and ids.dtype == torch.int32
    assert np.array_equal(logits.numpy(), want)
    assert np.array_equal(ids.numpy(), want.argmax(-1))
    # columns 4 and 9 made identical and far above the rest: the lower wins
    jt2 = dict(pt["joint"])
    for k in ("wt_out", "m_o", "b_out_logit"):
        jt2[k] = jt2[k].clone()
        jt2[k][9] = jt2[k][4]
    jt2["b_out_logit"][4] = jt2["b_out_logit"][9] = 1 << 24
    logits, ids = rnnt_joint({**pt, "joint": jt2}, torch.from_numpy(enc[:, 0]),
                             torch.from_numpy(h8))
    assert bool((logits[:, 4] == logits[:, 9]).all()) and ids.tolist() == [4] * 5
    assert rnnt_joint.launches == 0


# ---------------------------------------------------------------------------
# .qasr archives both ways
# ---------------------------------------------------------------------------


LABELS = (" ", "a", "b", "c")
FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
             integer_activations=True, static_attention=True)
CONF = dict(feat_in=32, n_layers=1, d_model=64, n_heads=4, subsampling="striding",
            subsampling_factor=4, subsampling_conv_channels=16, conv_kernel_size=9,
            dropout=0.0)


def _nudge(jm, seed=0):
    from qasr_tpu_torch.golden import nudged_out_bias

    out = jm.params["rnnt"]["joint"]["out"]
    out["b"] = nudged_out_bias(out["b"], jm.rnnt_cfg.blank_id, seed)


def jax_jasper_transducer(normalize=True):
    pre = {"features": FEAT, "dither": 0.0}
    if not normalize:
        pre["normalize"] = False
    jm = JaxRNNTModel.from_config(JModel(encoder=tiny_encoder_cfg(),
                                         decoder=JDec(feat_in=40, num_classes=28),
                                         preprocessor=pre))
    _nudge(jm)
    return jm


def jax_conformer_transducer(calibrate=True, seed=0, **conf):
    jm = JaxRNNTModel.conformer_transducer(
        JModel(encoder=JEnc(feat_in=32, blocks=[]),
               decoder=JDec(feat_in=64, num_classes=len(LABELS)), labels=LABELS,
               preprocessor={"features": 32, "dither": 0.0, "normalize": False}),
        JConf(**{**CONF, **conf}), seed=seed)
    _nudge(jm, seed + 1)
    if calibrate:
        rng = np.random.default_rng(seed)
        calib = (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32)
        jm.quantize_encoder([(calib, np.asarray([8000, 6400], np.int32))], **FLAGS)
    return jm


def _noise(seed, lens):
    rng = np.random.default_rng(seed)
    audio = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        audio[i, :n] = (rng.normal(size=n) * 0.1).astype(np.float32)
    return audio, np.asarray(lens, np.int32)


def _trees_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                      for x, y in zip(la, lb))


def test_qasr_archives_both_ways(tmp_path):
    kind = "jasper"
    jm = jax_jasper_transducer()
    jpath, ppath = str(tmp_path / "jax.qasr"), str(tmp_path / "port.qasr")
    jm.save_to(jpath)
    pm = RNNTModel.restore_from(jpath)
    assert pm.encoder_kind == kind and pm.rnnt_cfg.blank_id == jm.rnnt_cfg.blank_id
    assert _trees_equal(pm.params, jm.params)
    # the restored head decodes the JAX model's encodings to its ids
    rng = np.random.default_rng(5)
    enc = rng.normal(size=(2, 10, pm.rnnt_cfg.enc_hidden)).astype(np.float32)
    lens = np.asarray([10, 7])
    want = JR.greedy_decode(jm.params["rnnt"], jm.rnnt_cfg, enc, lens)
    assert pm._greedy_hyps(torch.from_numpy(enc), lens) == want and any(want)
    pm.save_to(ppath)
    jm2 = JaxRNNTModel.restore_from(ppath)
    assert jm2.encoder_kind == kind and _trees_equal(jm2.params, jm.params)


def test_restore_refuses_other_families(tmp_path):
    from qasr_tpu.models.conformer_ctc import ConformerCTC as JaxConformerCTC

    jm = JaxConformerCTC.from_config(
        JModel(encoder=JEnc(feat_in=32, blocks=[]),
               decoder=JDec(feat_in=64, num_classes=len(LABELS)), labels=LABELS,
               preprocessor={"features": 32}), JConf(**CONF))
    path = str(tmp_path / "ctc.qasr")
    jm.save_to(path)
    with pytest.raises(ValueError):
        RNNTModel.restore_from(path)


def test_transducer_modules_import_no_jax():
    code = ("import sys\n"
            "import qasr_tpu_torch.models.rnnt, qasr_tpu_torch.models.rnnt_model\n"
            "import qasr_tpu_torch.quantize.rnnt_freeze, qasr_tpu_torch.kernels.rnnt_decoder\n"
            "from qasr_tpu_torch import StreamingTransducer\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'qasr_tpu.'))"
            " or m == 'qasr_tpu']\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(
        __import__("pathlib").Path(__file__).resolve().parents[1]))
