"""The port's Conformer float encoder, calibration and PTQ forward against
the JAX package.

On the JAX tests' tiny Conformer (feat_in 32, 2 layers, d 64, 4 heads,
conv kernel 9; test_torch_conformer's configs), weights from the same
seed in both packages, seeded numpy inputs with unequal lengths:
(a) i_softmax (float scores, masks), i_layernorm, i_sigmoid_fp and
    i_swish_terms: bit for bit, over the whole int8 domain where there is
    one (the JAX package's default forms; test_torch_conformer_ops holds
    the integer cores under both of its QASR_FAST_IDIV forms);
(b) the float encoder and its pad-masked BN statistics: within rtol 1e-5
    (float32 GEMMs and convs in two libraries; measured 2.3e-7 on the
    encodings); its train mode equals it bit for bit without a generator
    or at dropout 0, and differs at dropout 0.1 (the draws' parity is
    test_torch_train.py's);
(c) calibration over 2 batches with every integer flag and static
    attention on the linear variant: min / max and percentile 99.9 give
    the JAX package's range state bit for bit ('dec_in' included), and
    min / max the frozen tables' digest; with float glue
    (quantize_attention off, float LayerNorm) and on the striding variant
    each site within STEP_TOL of one quantization step of its range
    (measured 0: both were exact here);
(d) the dynamic PTQ forward: log-probs within 1e-5 of the JAX package's
    and equal transcripts;
(f) ConformerCTC.forward / transcribe_greedy in the float, PTQ and frozen
    states against the JAX ConformerCTC in the same state; replacing the
    params' encoder or head drops the tables and the device state built
    from the old ones;
(g) the kernel wrappers' host side: Kernel 2's K-split covers Cin 4,864 in
    pieces check_launch takes, and the split product equals int_matmul;
    Kernel 1's causal pre-pad equals the JAX _qdepthwise at (30, 0); the
    calibrating forward calls the wrappers as ptq_kernel_launches says.
The JAX side runs op by op (jax.disable_jit) where bits are compared: its
compiled graph lets XLA contract multiply-adds and turn divisions into
reciprocal multiplications, an ulp off its source.  The striding
variant's inputs are 195 frames (48 after subsampling), the linear's 48,
so the JAX op-by-op calls share their compiled shapes.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qasr_tpu.decode.ctc import ctc_collapse as jax_collapse
from qasr_tpu.models.conformer import conformer_encoder_apply as jax_encoder
from qasr_tpu.models.conformer_ctc import ConformerCTC as JaxConformerCTC
from qasr_tpu.ops import integer_layernorm as jl
from qasr_tpu.ops import integer_sigmoid as jsig
from qasr_tpu.ops import integer_softmax as jsm
from qasr_tpu.ops.quant_prims import QTensor as JQTensor
from qasr_tpu.quantize import conformer_ptq as jptq
from qasr_tpu_torch.compat.from_jax import state_from_jax
from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.golden import conformer_flagship_configs
from qasr_tpu_torch.kernels import pw_gemm as k2
from qasr_tpu_torch.models.conformer import conformer_encoder_apply, encoder_params_to_device
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
from qasr_tpu_torch.ops import integer_layernorm as pl
from qasr_tpu_torch.ops import integer_sigmoid as psig
from qasr_tpu_torch.ops import integer_softmax as psm
from qasr_tpu_torch.ops.quant_prims import QTensor
from qasr_tpu_torch.quantize import conformer_ptq as pptq
from qasr_tpu_torch.quantize.freeze import tables_digest
from qasr_tpu_torch.quantize.ranges import qstate_to_device, qstate_to_host
from test_torch_conformer import FLAGS, _configs, _noise_pcm

FLOAT_RTOL = 1e-5
LOGPROB_ATOL = 1e-5
# calibrated ranges off the JAX package's, in quantization steps of the site
STEP_TOL = 0.5
T_IN = {"": 48, "striding": 195}


def _models(subsampling):
    jcfg, jccfg, pcfg, pccfg = _configs(subsampling)
    return (JaxConformerCTC.from_config(jcfg, jccfg, seed=0),
            ConformerCTC.from_config(pcfg, pccfg, seed=0))


def _batches(subsampling, n=2, seed=3):
    t = T_IN[subsampling]
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, t, 32)).astype(np.float32),
             np.asarray([t, t - 1 - 11 * i], np.int32)) for i in range(n)]


def _leaves(qstate):
    return [np.asarray(v, np.float32) for v in jax.tree_util.tree_leaves(qstate)]


def _calibrated(subsampling, n=2, **kw):
    jm, pm = _models(subsampling)
    batches = _batches(subsampling, n)
    with jax.disable_jit():
        jm.quantize_encoder(batches, features=True, **kw)
    pm.quantize_encoder(batches, features=True, device="cpu", **kw)
    return jm, pm


# ---------------------------------------------------------------------------
# (a) the integer ops
# ---------------------------------------------------------------------------


def _jax_eager(fn, *args):
    with jax.disable_jit():
        return np.asarray(fn(*(jnp.asarray(a) for a in args)))


def test_i_softmax_float_scores_with_masks():
    """Float scores (spread over the grid, rows past the -20 clip, ties
    on half grid steps), padded and local-context masks, fully masked
    rows; at the calibration's (B, H, T, T)."""
    rng = np.random.default_rng(7)
    t = T_IN[""]
    scores = (rng.normal(size=(2, 4, t, t)) * rng.uniform(0.1, 12, (2, 4, t, 1)))
    scores[0, 0, 0, :4] = np.arange(4) * psm.S_IN * 0.5        # halves of a grid step
    scores = scores.astype(np.float32)
    valid = np.arange(t)[None, :] < np.asarray([t, 37])[:, None]
    mask = ~(valid[:, :, None] & valid[:, None, :])
    mask[0, 3] = True                                            # a fully masked row
    mask = mask[:, None] | (np.abs(np.subtract.outer(np.arange(t), np.arange(t))) > 20)
    want = _jax_eager(lambda a, m: jsm.i_softmax(a, m, out_bits=8), scores, mask)
    got = psm.i_softmax(torch.from_numpy(scores), torch.from_numpy(mask), out_bits=8)
    assert got.dtype == torch.int32 and int(got.max()) == 127
    np.testing.assert_array_equal(got.numpy(), want)


def test_i_layernorm_int8_rows():
    """Rows over the whole int8 domain (wide, narrow, constant, extreme),
    with a float affine; at the calibration's (B, T, d)."""
    rng = np.random.default_rng(8)
    d = 64
    rows = [rng.integers(-128, 128, (78, d)), rng.integers(-3, 4, (8, d)),
            np.full((2, d), -128), np.full((2, d), 127), np.tile([-128, 127], (2, d // 2)),
            np.arange(-128, 128).reshape(-1, d)]
    q = np.concatenate(rows).astype(np.int8).reshape(2, -1, d)
    assert q.shape == (2, T_IN[""], d)
    gamma = rng.normal(size=d).astype(np.float32)
    beta = rng.normal(size=d).astype(np.float32)
    want = _jax_eager(jl.i_layernorm, q, gamma, beta)
    got = pl.i_layernorm(torch.from_numpy(q), torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_i_sigmoid_fp_and_swish_terms():
    """i_sigmoid_fp on a dense float grid over [-25, 25] (past the clip)
    and on exact half grid steps; i_swish_terms over every int8 value
    times a float spread; at the calibration's FFN shape (B, T, 4d)."""
    shape = (2, T_IN[""], 256)
    x = np.concatenate([np.linspace(-25, 25, 20001),
                        (np.arange(-2287, 2288) + 0.5) * psm.S_IN]).astype(np.float32)
    x = x.reshape(shape)
    np.testing.assert_array_equal(psig.i_sigmoid_fp(torch.from_numpy(x)).numpy(),
                                  _jax_eager(jsig.i_sigmoid_fp, x))
    q = np.repeat(np.arange(-128, 128, dtype=np.int8), 96)
    xf = (q.astype(np.float32) * np.float32(0.037)
          * np.tile(np.linspace(0.5, 1.5, 96, dtype=np.float32), 256))
    q, xf = q.reshape(shape), xf.reshape(shape)
    got = psig.i_swish_terms(torch.from_numpy(q), torch.from_numpy(xf))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_eager(jsig.i_swish_terms, q, xf))


# ---------------------------------------------------------------------------
# (b) the float encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subsampling,change", [
    ("", {}), ("striding", {}),
    ("", {"causal_conv": True}),                 # all K-1 pad frames on the left
    ("", {"self_attention_model": "abs_pos"}),   # absolute-position attention
])
def test_float_encoder_and_bn_stats_match_jax(subsampling, change):
    jm, pm = _models(subsampling)
    jm.ccfg = dataclasses.replace(jm.ccfg, **change)
    pm.ccfg = dataclasses.replace(pm.ccfg, **change)
    x, lens = _batches(subsampling, 1)[0]
    js, ps = [], []
    je, jlens = jax_encoder(jm.params["encoder"], jm.ccfg, jnp.asarray(x), jnp.asarray(lens),
                            bn_stats=js)
    pe, plens = conformer_encoder_apply(encoder_params_to_device(pm.params["encoder"], "cpu"),
                                        pm.ccfg, torch.from_numpy(x), torch.from_numpy(lens),
                                        bn_stats=ps)
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))
    je = np.asarray(je)
    np.testing.assert_allclose(pe.numpy(), je, rtol=FLOAT_RTOL, atol=FLOAT_RTOL * np.abs(je).max())
    assert len(ps) == len(js) == 2
    for (pm_, pv), (jm_, jv) in zip(ps, js):
        jm_, jv = np.asarray(jm_), np.asarray(jv)
        np.testing.assert_allclose(pm_.numpy(), jm_, rtol=FLOAT_RTOL,
                                   atol=FLOAT_RTOL * np.abs(jm_).max())
        np.testing.assert_allclose(pv.numpy(), jv, rtol=FLOAT_RTOL)
    # train mode (ported since): dropout only where a generator draws it
    dev_params = encoder_params_to_device(pm.params["encoder"], "cpu")

    def train(cfg, gen):
        return conformer_encoder_apply(dev_params, cfg, torch.from_numpy(x),
                                       torch.from_numpy(lens), train=True, generator=gen)[0]
    assert torch.equal(train(pm.ccfg, None), pe)
    assert torch.equal(train(pm.ccfg, torch.Generator().manual_seed(0)), pe)   # dropout 0
    dropped = dataclasses.replace(pm.ccfg, dropout=0.1)
    assert not torch.equal(train(dropped, torch.Generator().manual_seed(0)), pe)


# ---------------------------------------------------------------------------
# (c) calibration, (d) dynamic mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibration_every_flag_bit_exact(percentile):
    """The linear variant, every integer flag and static attention: the
    range state equal bit for bit, and the frozen tables' digest."""
    jm, pm = _calibrated("", percentile=percentile, **FLAGS)
    want, got = _leaves(state_from_jax(jm.enc_qstate)), _leaves(pm.enc_qstate)
    assert len(got) == len(want) == 2 * (2 * (9 + 5 + 4 + 5) + 2)
    assert sum(v != 0 for v in want) == len(want)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    assert "dec_in" in pm.enc_qstate
    if percentile is None:
        jm.freeze()
        assert tables_digest(pm.freeze_host()) == tables_digest(state_from_jax(jm.enc_frozen))


@pytest.mark.parametrize("subsampling,kw", [
    ("", dict(integer_activations=True)),                    # float glue: float softmax and LN
    ("striding", FLAGS),                                     # the float32 subsampler first
])
def test_calibration_within_a_step(subsampling, kw):
    jm, pm = _calibrated(subsampling, **kw)
    want, got = _leaves(state_from_jax(jm.enc_qstate)), _leaves(pm.enc_qstate)
    assert len(got) == len(want)
    n = 2 ** (pm.enc_qcfg.act_bit - 1) - 1
    mag = np.repeat([max(abs(float(a)), abs(float(b))) for a, b in zip(want[::2], want[1::2])], 2)
    steps = np.abs(np.asarray(got) - np.asarray(want)) / (mag / n)
    assert steps.max() <= STEP_TOL, steps.max()


def test_dynamic_forward_matches_jax():
    """Per-batch ranges at every site (and at 'dec_in'), every flag:
    log-probs within 1e-5 of the JAX package's op by op, equal
    transcripts."""
    jm, pm = _calibrated("", n=1, dynamic=True, **FLAGS)
    x, lens = _batches("", 1, seed=11)[0]
    with jax.disable_jit():
        lp_j, el_j = (np.asarray(o) for o in jm._apply(jm.params, jnp.asarray(x),
                                                       jnp.asarray(lens)))
    lp_p, el_p = pm.encode_decode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(el_p.numpy(), el_j)
    np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=0, atol=LOGPROB_ATOL)
    ids = lp_p.argmax(-1).numpy()
    assert len(np.unique(ids)) > 1, "degenerate ids"
    assert ctc_collapse(ids, pm.blank_id, pm.vocabulary, el_p.numpy()) == \
        [jax_collapse(lp_j.argmax(-1)[i:i + 1, :el_j[i]], jm.blank_id, jm.vocabulary)[0]
         for i in range(len(el_j))]


def test_forward_dispatch_matches_jax():
    """ConformerCTC dispatches as the JAX package's: the float encoder with
    no ranges, the PTQ forward after quantize_encoder, the frozen integer
    encoder after freeze.  In each state, from the same features (48 and
    34 frames): log-probs within 1e-5 of the JAX model's ``_apply`` (its
    dispatcher, op by op) and equal greedy transcripts; and from int16
    PCM, ``forward`` / ``transcribe_greedy`` give what ``encode_decode``
    gives on the port's own features.  New ranges drop the frozen tables
    (the JAX package: enc_frozen = None)."""
    jm, pm = _models("")
    x, lens = _batches("", 1, seed=13)[0]
    lens[1] = 34
    pcm, plens = _noise_pcm(31, 0.48)
    batches = _batches("")
    lps = []
    for state in ("float", "ptq", "frozen"):
        with jax.disable_jit():
            if state == "ptq":
                jm.quantize_encoder(batches, features=True, **FLAGS)
            elif state == "frozen":
                jm.freeze()
            lp_j, el_j = (np.asarray(o) for o in jm._apply(jm.params, jnp.asarray(x),
                                                           jnp.asarray(lens)))
        if state == "ptq":
            pm.quantize_encoder(batches, features=True, device="cpu", **FLAGS)
        elif state == "frozen":
            pm.freeze(device="cpu")
        assert pm.mode() == state
        lp_p, el_p = pm.encode_decode(torch.from_numpy(x), torch.from_numpy(lens))
        np.testing.assert_array_equal(el_p.numpy(), el_j)
        np.testing.assert_allclose(lp_p.numpy(), lp_j, rtol=0, atol=LOGPROB_ATOL)
        ids_j = lp_j.argmax(-1)
        assert pm.ids_to_text(lp_p.argmax(-1), el_p) == \
            [jax_collapse(ids_j[i:i + 1, :el_j[i]], jm.blank_id, jm.vocabulary)[0]
             for i in range(len(el_j))]
        # from PCM: the frontend, then the same dispatch
        feats, fl = pm.frontend(torch.from_numpy(pcm).to(torch.float32) * 2.0 ** -15,
                                torch.from_numpy(plens), dither=0.0)
        lp_f, el_f = pm.encode_decode(feats, fl)
        lp_a, el_a = pm.forward(pcm, plens, device="cpu")
        assert torch.equal(lp_a, lp_f) and torch.equal(el_a, el_f)
        assert pm.transcribe_greedy(pcm, plens, device="cpu") == pm.ids_to_text(
            lp_f.argmax(-1), el_f)
        lps.append(lp_p.numpy())
    assert np.abs(lps[0] - lps[1]).max() > 1e-3, "the PTQ forward gave the float log-probs"
    pm.quantize_encoder(batches[:1], features=True, device="cpu", **FLAGS)
    assert pm.enc_frozen is None and pm.mode() == "ptq"
    od = pm._devices["cpu"]
    assert od.tables is None and od.qstate is None and not od.fns


@pytest.mark.parametrize("entry", ["encoder", "decoder"])
def test_new_params_rebuild_the_device_state(entry):
    """Replacing an entry of the params (as the JAX package's users install
    estimate_bn_stats's result: params["encoder"] = ...) after calibrating,
    serving PTQ and freezing drops what was built from the old weights:
    the tables (the model serves PTQ again), and the device weights, so
    that the next calibration, PTQ forward and freeze equal a fresh
    model's with the new params.  Assigning enc_qstate drops the tables
    and the device's copy of the ranges too."""
    _, pm = _models("")
    batches = _batches("")
    x, lens = (torch.from_numpy(v) for v in batches[0])
    pm.quantize_encoder(batches, features=True, device="cpu", **FLAGS)
    lp_old, _ = pm.encode_decode(x, lens)
    old_q = pm.enc_qstate
    pm.freeze(device="cpu")
    pm.encode_decode(x, lens)
    assert pm.mode() == "frozen"
    pm.params[entry] = ConformerCTC.from_config(pm.cfg, pm.ccfg, seed=1).params[entry]
    assert pm.mode() == "ptq" and pm.enc_frozen is None
    fresh = ConformerCTC(cfg=pm.cfg, ccfg=pm.ccfg, frontend=pm.frontend, params=dict(pm.params))
    lps = []
    for m in (pm, fresh):
        m.quantize_encoder(batches, features=True, device="cpu", **FLAGS)
        lps.append(m.encode_decode(x, lens)[0])
        m.freeze(device="cpu")
        lps.append(m.encode_decode(x, lens)[0])
    assert _leaves(pm.enc_qstate) == _leaves(fresh.enc_qstate)
    assert tables_digest(pm.freeze_host()) == tables_digest(fresh.freeze_host())
    assert torch.equal(lps[0], lps[2]) and torch.equal(lps[1], lps[3])
    assert np.abs(lps[0].numpy() - lp_old.numpy()).max() > 1e-3, "the new params changed nothing"
    if entry == "encoder":
        assert _leaves(pm.enc_qstate) != _leaves(old_q), "the new encoder moved no range"
    # assigned ranges (one batch's) drop the tables and the device's copy
    # of the ranges
    fresh.quantize_encoder(batches[:1], features=True, device="cpu", **FLAGS)
    pm.enc_qstate = fresh.enc_qstate
    assert pm.mode() == "ptq" and pm.enc_frozen is None
    lp_p, lp_f = pm.encode_decode(x, lens)[0], fresh.encode_decode(x, lens)[0]
    assert torch.equal(lp_p, lp_f)
    assert np.abs(lp_p.numpy() - lps[0].numpy()).max() > 1e-3, "the new ranges changed nothing"


# ---------------------------------------------------------------------------
# (g) the kernel wrappers' host side
# ---------------------------------------------------------------------------


def test_k_split_covers_pre_out():
    """The Conformer's pre_out (Cin 256 x 19 = 4,864) is above what Kernel
    2 keeps resident; its pieces tile the contraction, each is a launch
    check_launch takes, and their products add up to int_matmul's."""
    pieces = k2.k_pieces(4864, 256)
    assert pieces == [(0, 2432), (2432, 4864)]
    for a, z in pieces:
        assert k2.check_launch(1500, z - a, 256, False, torch.int8)["smem"] <= k2.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared"):
        k2.check_launch(1500, 4864, 256, False, torch.int8)
    assert k2.k_pieces(2944, 256) == [(0, 2944)] and len(k2.k_pieces(2960, 1024)) == 2
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-128, 128, (37, 4864)).astype(np.int8))
    wt = torch.from_numpy(rng.integers(-127, 128, (256, 4864)).astype(np.int8))
    split = sum(k2.int_matmul(x[:, a:z].contiguous(), wt[:, a:z].contiguous())
                for a, z in pieces)
    assert torch.equal(split, k2.int_matmul(x, wt))


def test_causal_depthwise_prepad_matches_jax():
    """Kernel 1 pads both sides alike; a causal (30, 0) pad puts its 30
    frames on the left first.  On CPU tensors the wrapper runs the plain
    version: equal to the JAX _qdepthwise at (30, 0), and at (15, 15)."""
    rng = np.random.default_rng(6)
    w = rng.uniform(-0.2, 0.2, (31, 1, 48)).astype(np.float32)
    b = rng.uniform(-0.1, 0.1, 48).astype(np.float32)
    xq = rng.integers(-127, 127, (2, 45, 48)).astype(np.int8)
    scale = np.float32(0.023)
    w_int8, w_scale = pptq._weight_qparams(torch.from_numpy(w), 8, (0, 1))
    pw = {"wk": w_int8[:, 0, :].contiguous(), "w_scale": w_scale, "b": torch.from_numpy(b)}
    for padding in ((30, 0), (15, 15)):
        want = np.asarray(jptq._qdepthwise({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                           JQTensor(jnp.asarray(xq), jnp.float32(scale)), 8,
                                           padding=padding))
        for kernels in (True, False):
            got = pptq._qdepthwise(pw, QTensor(torch.from_numpy(xq), torch.tensor(scale)),
                                   padding, kernels)
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("subsampling", ["", "striding"])
def test_calibrating_forward_calls_the_kernels(monkeypatch, subsampling):
    """Kernels 1 and 2's wrappers take every depthwise conv and linear of a
    calibrating forward, as ptq_kernel_launches counts them (on CPU
    tensors they run their plain versions); kernels=False calls neither."""
    _, pm = _models(subsampling)
    calls = {"dw_conv": 0, "pw_gemm": 0}

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper
    monkeypatch.setattr(pptq, "dw_conv", counting("dw_conv", pptq.dw_conv))
    monkeypatch.setattr(pptq, "pw_gemm", counting("pw_gemm", pptq.pw_gemm))
    batches = _batches(subsampling)
    pm.quantize_encoder(batches, features=True, device="cpu", **FLAGS)
    assert calls == {k: 2 * v for k, v in pptq.ptq_kernel_launches(pm.ccfg).items()}
    assert calls == {"dw_conv": 4, "pw_gemm": 2 * 23}
    ranges = _leaves(pm.enc_qstate)
    pm.quantize_encoder(batches, features=True, device="cpu", kernels=False, **FLAGS)
    assert calls == {"dw_conv": 4, "pw_gemm": 46}
    assert [r.tobytes() for r in _leaves(pm.enc_qstate)] == [r.tobytes() for r in ranges]
    # the functional form: the encoder's sites alone ('dec_in' is the model's)
    qcfg = pm.enc_qcfg
    qs = pptq.calibrate_conformer(
        pptq.quantize_conformer_weights(pm.params["encoder"], pm.ccfg, 8, "cpu"), pm.ccfg, qcfg,
        [(torch.from_numpy(x), torch.from_numpy(n)) for x, n in batches],
        qstate_to_device(pptq.init_conformer_qstate(pm.ccfg, qcfg), "cpu"), kernels=False)
    want = dict(pm.enc_qstate)
    del want["dec_in"]
    assert [r.tobytes() for r in _leaves(qstate_to_host(qs))] == \
        [r.tobytes() for r in _leaves(want)]
    # the flagship: pre_out's 4,864-wide contraction in two launches
    assert pptq.ptq_kernel_launches(conformer_flagship_configs()[1], head=True) == {
        "dw_conv": 16, "pw_gemm": 16 * 11 + 2 + 1}
