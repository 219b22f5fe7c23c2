"""The port's Conformer data-free synthesis and BN-statistics estimate
against the JAX package.

On the tiny striding Conformer (test_torch_conformer's configs; every
layer's BN statistics randomized, equal in both packages):
(a) conformer_bn_targets equal (the standard deviations to an ulp: XLA's
    float32 square root); conformer_distill_loss and its input gradient
    within rtol 1e-4 (float32 GEMMs and convs in two libraries, through the
    KL's logs and ratios);
(b) from JAX's own jax.random.uniform start point, 5 Adam steps under the
    plateau schedule (torch.optim.Adam and ReduceLROnPlateau against the
    JAX package's in-graph rules): losses within rtol 1e-4, the batch
    within atol 1e-4;
(c) estimate_bn_stats: the new statistics and compensated affine within
    rtol 1e-5 of the JAX package's, and the float encoder's output
    unchanged by them to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.quantize import conformer_synth as JS
from qasr_tpu_torch.models.conformer import conformer_encoder_apply, encoder_params_to_device
from qasr_tpu_torch.quantize import conformer_synth as PS
from test_torch_conformer_calib import _models

RTOL = 1e-4
BN_RTOL = 1e-5
B, T = 2, 48


@pytest.fixture(scope="module")
def models():
    jm, pm = _models("striding")
    rng = np.random.default_rng(21)
    for jl, pl in zip(jm.params["encoder"]["layers"], pm.params["encoder"]["layers"]):
        d = pl["conv"]["bn"]["mean"].shape[0]
        for k, v in (("mean", rng.normal(0, 0.3, d)), ("var", rng.uniform(0.2, 2.0, d)),
                     ("gamma", rng.uniform(0.5, 1.5, d)), ("beta", rng.normal(0, 0.1, d))):
            jl["conv"]["bn"][k] = v.astype(np.float32)
            pl["conv"]["bn"][k] = v.astype(np.float32).copy()
    return jm, pm


def test_bn_targets_and_distill_loss_match_jax(models):
    jm, pm = models
    enc = encoder_params_to_device(pm.params["encoder"], "cpu")
    jt = JS.conformer_bn_targets(jm.params["encoder"])
    pt = PS.conformer_bn_targets(enc)
    assert len(pt[0]) == len(jt[0]) == 2
    for p_, j_ in zip(pt[0], jt[0]):
        np.testing.assert_array_equal(p_.numpy(), np.asarray(j_))
    for p_, j_ in zip(pt[1], jt[1]):
        np.testing.assert_allclose(p_.numpy(), np.asarray(j_), rtol=2 ** -23, atol=0)
    x = np.random.default_rng(4).uniform(-0.3, 0.3, (B, T, 32)).astype(np.float32)
    lens = np.asarray([T, T - 13], np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda v: JS.conformer_distill_loss(
        jm.params["encoder"], jm.ccfg, v, jnp.asarray(lens), jt)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pl = PS.conformer_distill_loss(enc, pm.ccfg, xt, torch.from_numpy(lens), pt)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=RTOL, atol=RTOL * np.abs(jg).max())


def test_adam_plateau_steps_match_jax(models):
    jm, pm = models
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    x0 = np.asarray(jax.random.uniform(key, (B, T, 32), jnp.float32, -0.3, 0.3))
    jx, jlosses = JS.synthesize_conformer_batch(
        jm.params["encoder"], jm.ccfg, key, batch_size=B, seqlen=T, train_iter=5, lr=0.02,
        targets=JS.conformer_bn_targets(jm.params["encoder"]))
    out, losses = PS.get_synthetic_conformer_data(pm.params["encoder"], pm.ccfg, batch_size=B,
                                                  seqlen=T, train_iter=5, lr=0.02, x0=[x0],
                                                  device="cpu")
    np.testing.assert_allclose(losses[0], np.asarray(jlosses), rtol=RTOL)
    assert losses[0][-1] < losses[0][0]
    x, lens = out[0]
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=RTOL)
    assert lens.tolist() == [T] * B
    # the seeded start points, as the QuartzNet synthesizer draws them
    (xs, _), = PS.get_synthetic_conformer_data(pm.params["encoder"], pm.ccfg, batch_size=B,
                                               seqlen=T, train_iter=0, device="cpu")[0]
    assert xs.shape == (B, T, 32) and float(xs.abs().max()) <= 0.3


def test_estimate_bn_stats_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(B, T, 32)).astype(np.float32),
                np.asarray([T, T - 7 * i - 5], np.int32)) for i in range(2)]
    jp = JS.estimate_bn_stats(jm.params["encoder"], jm.ccfg, batches)
    pp = PS.estimate_bn_stats(pm.params["encoder"], pm.ccfg, batches, device="cpu")
    for jl, pl in zip(jp["layers"], pp["layers"]):
        for k in ("mean", "var", "gamma", "beta"):
            want = np.asarray(jl["conv"]["bn"][k])
            np.testing.assert_allclose(pl["conv"]["bn"][k], want, rtol=BN_RTOL,
                                       atol=BN_RTOL * np.abs(want).max(), err_msg=k)
    assert not np.allclose(pp["layers"][0]["conv"]["bn"]["mean"],
                           pm.params["encoder"]["layers"][0]["conv"]["bn"]["mean"])
    x, lens = (torch.from_numpy(v) for v in batches[1])
    before = conformer_encoder_apply(encoder_params_to_device(pm.params["encoder"], "cpu"),
                                     pm.ccfg, x, lens)[0].numpy()
    after = conformer_encoder_apply(encoder_params_to_device(pp, "cpu"), pm.ccfg, x, lens)[0]
    np.testing.assert_allclose(after.numpy(), before, rtol=0, atol=1e-5)
