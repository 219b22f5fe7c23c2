"""The port's data-free synthesis and pickle I/O against the JAX package.

On the tiny preset of test_jasper_model (BN statistics randomized):
(a) bn_targets equal (the standard deviations to an ulp: XLA's float32
    square root); distill_loss and its gradient within rtol 1e-4
    (float32 convs in two libraries, through the KL's logs and ratios);
(b) from JAX's own jax.random.uniform start point, 5 Adam steps under the
    plateau schedule (torch.optim.Adam and ReduceLROnPlateau against the
    JAX package's in-graph rules): losses within rtol 1e-4, the batch
    within atol 1e-4;
(c) ReduceLROnPlateau reduces the rate at exactly _plateau_step's steps
    over a crafted loss sequence (plateaus longer than the patience,
    relative improvements either side of the 1e-4 threshold, the 1e-4
    floor), the rates equal to float32 rounding (JAX holds them in
    float32, torch in float64);
(d) synthetic-data pickles load across the packages both ways, with equal
    file names; the restricted unpickler refuses other payloads.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.compat import pickle_io as jax_pickle_io
from qasr_tpu.quantize import synth as JS
from qasr_tpu_torch.compat import pickle_io
from qasr_tpu_torch.quantize.ranges import params_to_device
from qasr_tpu_torch.quantize import synth as PS
from test_torch_calibrate import tiny_models

RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return tiny_models(fold=False)


def test_bn_targets_and_distill_loss_match_jax(models):
    jm, pm = models
    enc = params_to_device(pm.params["encoder"], "cpu")
    jt = JS.bn_targets(jm.plan, jm.params["encoder"])
    pt = PS.bn_targets(pm.plan, enc)
    assert len(pt[0]) == len(jt[0]) == 8
    for p_, j_ in zip(pt[0], jt[0]):
        np.testing.assert_array_equal(p_.numpy(), np.asarray(j_))
    for p_, j_ in zip(pt[1], jt[1]):  # XLA's float32 sqrt is not always correctly rounded
        np.testing.assert_allclose(p_.numpy(), np.asarray(j_), rtol=2 ** -23, atol=0)
    x = np.random.default_rng(4).uniform(-0.3, 0.3, (2, 48, 16)).astype(np.float32)
    lens = np.asarray([48, 48], np.int32)
    jl, jg = jax.jit(jax.value_and_grad(lambda v: JS.distill_loss(
        jm.plan, jm.params["encoder"], v, jnp.asarray(lens), jt)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pl = PS.distill_loss(pm.plan, enc, xt, torch.from_numpy(lens), pt)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=RTOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(xt.grad.numpy(), jg, rtol=RTOL, atol=RTOL * np.abs(jg).max())


def test_adam_plateau_steps_match_jax(models):
    jm, pm = models
    key = jax.random.split(jax.random.PRNGKey(0), 1)[0]
    b, t, c = 2, 48, 16
    x0 = np.asarray(jax.random.uniform(key, (b, t, c), jnp.float32, -0.3, 0.3))
    jx, jlosses = JS.synthesize_batch(jm.plan, jm.params["encoder"], key, batch_size=b, dim=c,
                                      seqlen=t, train_iter=5, lr=0.01,
                                      targets=JS.bn_targets(jm.plan, jm.params["encoder"]))
    out, losses = PS.get_synthetic_data(pm.plan, pm.params["encoder"], batch_size=b, dim=c,
                                        seqlen=t, train_iter=5, lr=0.01, x0=[x0],
                                        device="cpu", verbose=False, return_losses=True)
    np.testing.assert_allclose(losses[0], np.asarray(jlosses), rtol=RTOL)
    assert losses[0][-1] < losses[0][0]
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jx), rtol=0, atol=RTOL)
    # the seeded start points: U(-0.3, 0.3) from one CPU generator, in turn
    s = PS.start_points(2, b, t, c, seed=0)
    assert s[0].shape == (b, t, c) and not torch.equal(s[0], s[1])
    assert float(s[0].abs().max()) <= 0.3
    assert torch.equal(s[1], PS.start_points(2, b, t, c, seed=0)[1])


def test_plateau_schedule_matches_jax():
    losses = ([100.0 - i for i in range(10)] + [90.0] * 30            # plateau: reduce once
              + [89.999] * 3 + [89.98] + [89.98] * 26                  # below / above threshold
              + [50.0] + [50.0] * 60 + [40.0] * 40)                    # down to the 1e-4 floor
    sched = JS._SchedState(jnp.float32(0.01), jnp.float32(np.inf), jnp.int32(0))
    want = []
    for v in losses:
        sched = JS._plateau_step(sched, jnp.float32(v))
        want.append(float(sched.lr))
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)], lr=0.01)
    tsched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=0.1, patience=25, threshold=1e-4, min_lr=1e-4)
    got = []
    for v in losses:
        tsched.step(float(np.float32(v)))
        got.append(opt.param_groups[0]["lr"])
    # the same steps reduce the rate; the rates agree to float32 (JAX keeps
    # it in float32, torch in float64)
    def reductions(lrs):
        return [i for i in range(1, len(lrs)) if lrs[i] < lrs[i - 1] * (1 - 1e-6)]
    assert reductions(got) == reductions(want) and len(reductions(got)) == 2
    assert got[-1] == 1e-4
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)


def test_pickles_cross_load(tmp_path):
    rng = np.random.default_rng(6)
    batches = [rng.normal(size=(2, 40, 16)).astype(np.float32) for _ in range(3)]
    name = pickle_io.synthetic_filename("syn", 3, 200, 0.01, str(tmp_path / "a"))
    assert name == jax_pickle_io.synthetic_filename("syn", 3, 200, 0.01, str(tmp_path / "a"))
    assert name.endswith("syn_nb3_iter200_lr0.010.pkl")
    jax_path = str(tmp_path / "jax.pkl")
    port_path = str(tmp_path / "port.pkl")
    jax_pickle_io.save_synthetic(jax_path, batches)
    pickle_io.save_synthetic(port_path, [torch.from_numpy(b) for b in batches])
    for got in (pickle_io.load_synthetic(jax_path), jax_pickle_io.load_synthetic(port_path),
                pickle_io.load_synthetic(port_path)):
        assert len(got) == 3
        for g, b in zip(got, batches):
            np.testing.assert_array_equal(np.asarray(g), b.transpose(0, 2, 1))
    with open(port_path, "rb") as f:
        assert all(isinstance(t, torch.Tensor) for t in pickle.load(f))
    evil = str(tmp_path / "evil.pkl")
    with open(evil, "wb") as f:
        pickle.dump([np.zeros(2), print], f)
    with pytest.raises(pickle.UnpicklingError, match="blocked"):
        pickle_io.load_synthetic(evil)
