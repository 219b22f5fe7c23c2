"""The port's float and calibrating executors against the JAX package.

On the tiny preset of test_jasper_model (4 blocks, widths 16-40, BN
statistics randomized), weights carried across with compat/from_jax.py
and seeded numpy inputs:
(a) dyadic_from_scale, requantize and requantize_approx: bit for bit over
    a grid of float32 scales;
(b) histogram_quantile: equal at sizes below and above 2**18;
(c) FloatExec, BN folded and not: log-probs and BN statistics within rtol
    1e-5 (float32 convs in two libraries);
(d) calibrate at W6A6 and W8A8, and at W6A6 with the exact calibration
    requants (calib_exact): with min / max ranges the range state and
    the frozen tables' digest equal the JAX package's; with percentile
    99.9 (torch.quantile against jnp.quantile, which interpolate in other
    float32 orders) the ranges are within rtol 1e-5;
(e) the dynamic forward against the JAX package's compiled one: log-probs
    within 1e-5 and ids equal;
(f) transcribe on the same wav paths, both models on the JAX package's
    features (the frontends' parity, within 1e-3, is test_torch_slice's):
    in each mode JAX's transcripts and per-sample log-probs within 1e-5,
    the dynamic mode against the JAX package run op by op (its compiled
    forward computes the per-batch scales with a float32 reciprocal, an
    ulp off).

The JAX package's calibration runs op by op (jax.disable_jit) where bits
are compared: its compiled graph lets XLA
contract float32 multiply-adds into FMAs and turn divisions by constants
into multiplications by reciprocals, which moves ranges by an ulp; the
compiled calibration is held within rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import config as JC
from qasr_tpu.models import jasper as JJ
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.ops import quant_prims as JQ
from qasr_tpu.ops.stats import histogram_quantile as jax_histogram_quantile
from qasr_tpu_torch.compat.from_jax import state_from_jax
from qasr_tpu_torch.models import config as PC
from qasr_tpu_torch.models import jasper as PJ
from qasr_tpu_torch.models.ctc_model import ASRModel
from qasr_tpu_torch.ops import quant_prims as PQ
from qasr_tpu_torch.ops.stats import histogram_quantile
from qasr_tpu_torch.quantize.freeze import tables_digest
from qasr_tpu_torch.quantize.ranges import batch_ranges
from test_jasper_model import make_model

FLOAT_RTOL = 1e-5
PERCENTILE_RTOL = 1e-5


def port_config(cfg):
    """A JAX ModelConfig as the port's (same fields)."""
    enc = dataclasses.asdict(cfg.encoder)
    enc["blocks"] = tuple(PC.BlockConfig(**b) for b in enc["blocks"])
    return PC.ModelConfig(encoder=PC.EncoderConfig(**enc),
                          decoder=PC.DecoderConfig(**dataclasses.asdict(cfg.decoder)),
                          preprocessor=dict(cfg.preprocessor))


def tiny_models(fold=True, wb=6, ab=6, percentile=None, calib_exact=False):
    """(JAX model, port model): the tiny preset with randomized BN, equal
    params."""
    enc_cfg, _, enc, dec, dec_cfg = make_model()
    cfg = JC.ModelConfig(encoder=enc_cfg, decoder=dec_cfg,
                         preprocessor={"features": 16, "n_fft": 512, "dither": 1e-5})
    jm = JaxASRModel.from_config(cfg)
    jm.params = {"encoder": enc, "decoder": dec}
    pm = ASRModel.from_config(port_config(cfg))
    pm.params = state_from_jax(jm.params)
    for m in (jm, pm):
        m.set_quant_bit(wb, "weight")
        m.set_quant_bit(ab, "act")
        m.set_percentile(percentile)
        m.qcfg = dataclasses.replace(m.qcfg, calib_exact=calib_exact)
        if fold:
            m.bn_folding()
    return jm, pm


def feature_batches(n=2, b=2, t=96):
    rng = np.random.default_rng(3)
    return [rng.normal(size=(b, t, 16)).astype(np.float32) for _ in range(n)]


def leaves(qstate):
    return [np.float32(v) for v in jax.tree_util.tree_leaves(qstate)]


def test_requant_prims_bit_exact():
    rng = np.random.default_rng(0)
    scales = np.concatenate([2.0 ** np.arange(-30, 10, dtype=np.float64),
                             rng.uniform(1e-6, 10.0, 500),
                             np.nextafter(np.float32(1.0), np.float32(2.0)) * np.ones(1)])
    scales = scales.astype(np.float32)
    jd = JQ.dyadic_from_scale(jnp.asarray(scales))
    pd = PQ.dyadic_from_scale(torch.from_numpy(scales))
    np.testing.assert_array_equal(pd.m.numpy(), np.asarray(jd.m))
    np.testing.assert_array_equal(pd.e.numpy(), np.asarray(jd.e))
    c = 64
    z = rng.integers(-2 ** 28, 2 ** 28, (3, 50, c)).astype(np.int32)
    ident = rng.integers(-2 ** 20, 2 ** 20, (3, 50, c)).astype(np.int32)
    for i in range(8):
        s_in = rng.uniform(1e-7, 1e-3, c).astype(np.float32)
        s_id = np.float32(rng.uniform(1e-6, 1e-3))
        s_out = np.float32(rng.uniform(1e-3, 10.0))
        bits = (6, 7, 8, 9)[i % 4]
        with jax.disable_jit():
            jx = JQ.QTensor(jnp.asarray(z), jnp.asarray(s_in))
            jid = JQ.QTensor(jnp.asarray(ident), jnp.asarray(s_id))
            j_exact = JQ.requantize(jx, jnp.asarray(s_out), bits, identity=jid)
            j_approx = JQ.requantize_approx(jx, jnp.asarray(s_out), bits, identity=jid)
        px = PQ.QTensor(torch.from_numpy(z), torch.from_numpy(s_in))
        pid = PQ.QTensor(torch.from_numpy(ident), torch.tensor(s_id))
        p_exact = PQ.requantize(px, torch.tensor(s_out), bits, identity=pid)
        p_approx = PQ.requantize_approx(px, torch.tensor(s_out), bits, identity=pid)
        np.testing.assert_array_equal(p_exact.values.numpy(), np.asarray(j_exact.values))
        np.testing.assert_array_equal(p_approx.values.numpy(), np.asarray(j_approx.values))
        assert len(np.unique(p_exact.values.numpy())) > 8


@pytest.mark.parametrize("n", [5000, (1 << 18) + 4099])
def test_histogram_quantile_matches_jax(n):
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.normal(size=n - 50), rng.standard_cauchy(50) * 30]).astype(np.float32)
    qs = [0.001, 0.5, 0.999]
    want = np.asarray(jax_histogram_quantile(jnp.asarray(x), qs))
    got = histogram_quantile(torch.from_numpy(x), qs).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.quantile(x.astype(np.float64), qs)
    assert np.all(np.abs(got - exact) <= (x.max() - x.min()) / 32 ** 5 * 2)
    # the calibration's batch ranges: histogram above 2**18, a sort below
    with jax.disable_jit():
        j_lo, j_hi = JJ._batch_ranges(jnp.asarray(x), 99.9)
    p_lo, p_hi = batch_ranges(torch.from_numpy(x), 99.9)
    np.testing.assert_allclose([float(p_lo), float(p_hi)], [float(j_lo), float(j_hi)],
                               rtol=PERCENTILE_RTOL)


@pytest.mark.parametrize("fold", [False, True])
def test_float_exec_matches_jax(fold):
    jm, pm = tiny_models(fold=fold)
    x = feature_batches(1, t=80)[0]
    lens = np.asarray([80, 57], np.int32)
    jex = JJ.FloatExec(jm.params["encoder"], activation="relu", collect_bn_stats=True)
    jenc, jel = JJ.encoder_forward(jex, jm.plan, jnp.asarray(x), jnp.asarray(lens))
    jlp = np.asarray(JJ.decoder_forward_float(jm.params["decoder"], jenc))
    params = pm.device_params("cpu")
    pex = PJ.FloatExec(params["encoder"], activation="relu", collect_bn_stats=True)
    penc, pel = PJ.encoder_forward(pex, pm.plan, torch.from_numpy(x), torch.from_numpy(lens))
    plp = PJ.decoder_forward_float(params["decoder"], penc).numpy()
    np.testing.assert_array_equal(pel.numpy(), np.asarray(jel))
    np.testing.assert_allclose(plp, jlp, rtol=FLOAT_RTOL, atol=FLOAT_RTOL)
    assert len(pex.bn_stats) == len(jex.bn_stats) == 8
    for (pm_, pv), (jm_, jv) in zip(pex.bn_stats, jex.bn_stats):
        np.testing.assert_allclose(pm_.numpy(), np.asarray(jm_), rtol=FLOAT_RTOL, atol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=FLOAT_RTOL, atol=1e-5)


@pytest.mark.parametrize("wb,ab,calib_exact", [(6, 6, False), (8, 8, False), (6, 6, True)])
@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_matches_jax(wb, ab, calib_exact, percentile):
    """(B, T, C) arrays, reference (B, C, T) tensors and (feats, lens)
    pairs all calibrate; the range state and, with min / max ranges, the
    frozen tables equal the JAX package's."""
    jm, pm = tiny_models(wb=wb, ab=ab, percentile=percentile, calib_exact=calib_exact)
    feats = feature_batches(3)
    lens = np.asarray([96, 70], np.int32)
    items = [feats[0], torch.from_numpy(feats[1].transpose(0, 2, 1).copy()),
             (feats[2], lens)]
    with jax.disable_jit():
        jm.calibrate([feats[0], feats[1].transpose(0, 2, 1), (feats[2], lens)])
    pm.calibrate(items, device="cpu")
    want, got = leaves(jm.qstate), leaves(pm.qstate)
    assert len(got) == len(want) == 36 and sum(v != 0 for v in want) > 20
    if percentile is None:
        assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
        assert tables_digest(pm.freeze_host()) == tables_digest(state_from_jax(jm.freeze()))
    else:
        np.testing.assert_allclose(got, want, rtol=PERCENTILE_RTOL, atol=0)
    if (wb, percentile, calib_exact) == (6, None, False):
        # the JAX package's compiled calibration: within rtol of the same
        jc, _ = tiny_models(wb=wb, ab=ab, percentile=percentile)
        jc.calibrate([feats[0], feats[1].transpose(0, 2, 1), (feats[2], lens)])
        np.testing.assert_allclose(got, leaves(jc.qstate), rtol=PERCENTILE_RTOL, atol=0)


def test_dynamic_forward_matches_jax():
    """Per-batch ranges at every site: the JAX package's compiled forward
    and the port's give the same ids and log-probs within 1e-5."""
    jm, pm = tiny_models(wb=6, ab=6)
    jm.set_dynamic(True)
    pm.set_dynamic(True)
    x = feature_batches(1, t=80)[0]
    lens = np.asarray([80, 61], np.int32)
    jlp, jel, _ = jax.jit(lambda f, n: jm._encode_decode_quant(
        jm.params["encoder"], jm.params["decoder"], jm.qstate, f, n,
        update_ranges=False))(jnp.asarray(x), jnp.asarray(lens))
    plp, pel, _ = pm.encode_decode_quant(torch.from_numpy(x), torch.from_numpy(lens))
    jlp = np.asarray(jlp)
    np.testing.assert_array_equal(pel.numpy(), np.asarray(jel))
    np.testing.assert_allclose(plp.numpy(), jlp, rtol=FLOAT_RTOL, atol=FLOAT_RTOL)
    np.testing.assert_array_equal(plp.argmax(-1).numpy(), jlp.argmax(-1))
    assert len(np.unique(jlp.argmax(-1))) > 1


def test_wide_operands_raise_on_cuda():
    """W8A8's 9-bit sites: the plain versions on the CPU, NotImplementedError
    for CUDA (checked before anything reaches the card)."""
    cuda = torch.device("cuda")
    assert PJ.check_operand_bits(torch.device("cpu"), 9, 8)
    assert not PJ.check_operand_bits(cuda, 7, 6)
    with pytest.raises(NotImplementedError, match="int16 operands"):
        PJ.check_operand_bits(cuda, 9, 8)
    _, pm = tiny_models(wb=8, ab=8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pm._frozen_fn("static_e", cuda, argmax=False)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    from qasr_tpu.data.audio import write_wav

    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(11)
    paths = []
    for i, secs in enumerate((0.7, 1.1, 0.9)):
        n = int(16000 * secs)
        t = np.arange(n) / 16000
        x = 0.3 * np.sin(2 * np.pi * (150 + 90 * i) * t) + 0.05 * rng.normal(size=n)
        paths.append(str(root / f"u{i}.wav"))
        write_wav(paths[-1], x.astype(np.float32))
    return paths


@pytest.fixture(scope="module")
def calibrated_qstate():
    jm, _ = tiny_models(wb=6, ab=6)
    jm.calibrate(feature_batches(2))
    return jm.qstate


@pytest.mark.parametrize("mode", ["fp32", "dynamic", "frozen"])
def test_transcribe_matches_jax(wavs, calibrated_qstate, mode):
    jm, pm = tiny_models(wb=6, ab=6)
    jm.qstate = calibrated_qstate
    pm.qstate = state_from_jax(calibrated_qstate)
    for m in (jm, pm):
        if mode == "fp32":
            m.set_quant_mode("none")
        m.set_dynamic(mode == "dynamic")
    # the JAX package's features in both: the frontends differ by up to 1e-3
    # (test_torch_slice), which moves dynamic ranges and near-tied argmaxes
    front = jax.jit(lambda a, n, frontend=jm.frontend: frontend(a, n, dither=0.0))
    feats_done = {}

    def features(a, n):   # each batch's features once, for both models
        key = (a.tobytes(), n.tobytes())
        if key not in feats_done:
            feats_done[key] = tuple(np.array(v) for v in front(jnp.asarray(a), jnp.asarray(n)))
        return feats_done[key]

    pm.frontend = lambda a, n, dither=0.0: tuple(
        torch.from_numpy(v) for v in features(a.numpy(), n.numpy()))
    if mode == "dynamic":
        # the per-batch scales: the JAX package op by op (its compiled graph
        # divides by n as a multiplication by float32 1/n), on the same
        # features
        jm.frontend = lambda a, n, dither=0.0: tuple(
            jnp.asarray(v) for v in features(np.asarray(a), np.asarray(n)))
    with jax.disable_jit(mode == "dynamic"):
        want = jm.transcribe(wavs, batch_size=3)
        jlp = jm.transcribe(wavs, batch_size=3, logprobs=True)
    got = pm.transcribe(wavs, batch_size=3, device="cpu")
    plp = pm.transcribe(wavs, batch_size=3, logprobs=True, device="cpu")
    assert any(want)
    assert [p_.shape for p_ in plp] == [j_.shape for j_ in jlp]
    assert got == want
    for p_, j_ in zip(plp, jlp):
        np.testing.assert_allclose(p_, j_, rtol=FLOAT_RTOL, atol=FLOAT_RTOL)
