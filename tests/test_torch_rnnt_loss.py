"""The transducer loss (Kernel 10's plain version, models/rnnt.py::rnnt_loss)
and RNNTTrainer against the JAX package, on the CPU.

(a) ``rnnt_loss`` (the plain wavefront on CPU tensors) against
    rnnt_loss_wavefront and _rnnt_loss_rowscan: the NLL and its gradient
    with respect to the (B, T, U+1, V+1) log-probs within 1e-5 (relative
    for the NLL, absolute for the gradient), at ragged lengths, at U = 0
    and at T = 1, and the reductions of the JAX package's per-sample values;
    the port's row-scan the same against the JAX package's (which cannot
    take U = 0).
(b) A numpy walk of csrc/rnnt_loss.cu's two kernels (alpha, then beta and
    the occupancy gradients, by anti-diagonals, in float64) equals the
    plain version differentiated by autograd in float64 within 1e-10: the
    kernel's algorithm, its length clamps and its zero cells, held where
    no card is.
(c) On CPU tensors the wrapper runs the plain version (its launch count
    moves, the kernel's does not).
(d) RNNTTrainer against the JAX package's over 2 steps (a tiny Jasper
    encoder, dither 0, dropout 0): losses within 1e-5 relative, every
    param within 1e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qasr_tpu.models import rnnt as JR
from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.rnnt_model import RNNTModel as JaxRNNTModel
from qasr_tpu.train.trainer import RNNTTrainer as JaxRNNTTrainer
from qasr_tpu.train.trainer import TrainConfig as JaxTrainConfig
from qasr_tpu_torch.compat.from_jax import rnnt_model_from_jax
from qasr_tpu_torch.kernels import rnnt_loss as K10
from qasr_tpu_torch.models.rnnt import rnnt_loss
from qasr_tpu_torch.train.trainer import RNNTTrainer, TrainConfig, tree_leaves
from test_jasper_model import FEAT, tiny_encoder_cfg

TOL = 1e-5

CASES = {  # (T, U, input lengths, target lengths)
    "ragged": (7, 5, [7, 4, 1], [5, 2, 0]),
    "U=0": (6, 0, [6, 3], [0, 0]),
    "T=1": (1, 4, [1, 1], [4, 2]),
}


def _case(name, v=6, seed=0):
    t, u, il, tl = CASES[name]
    rng = np.random.default_rng(seed)
    b = len(il)
    logits = rng.normal(size=(b, t, u + 1, v + 1)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    targets = rng.integers(0, v, size=(b, u)).astype(np.int32)
    return lp, targets, np.asarray(il, np.int32), np.asarray(tl, np.int32), v


# the JAX package's row-scan indexes an empty label axis at U = 0
@pytest.mark.parametrize("name,impl", [(n, "wavefront") for n in sorted(CASES)]
                         + [(n, "rowscan") for n in sorted(CASES) if n != "U=0"])
def test_rnnt_loss_matches_jax(name, impl):
    lp, targets, il, tl, blank = _case(name)
    jfn = {"wavefront": JR.rnnt_loss_wavefront, "rowscan": JR._rnnt_loss_rowscan}[impl]

    def f(x):
        return jfn(x, jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl), blank, "none")
    want = np.asarray(jax.jit(f)(jnp.asarray(lp)))
    want_g = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(f(x))))(jnp.asarray(lp)))
    x = torch.tensor(lp, requires_grad=True)
    got = rnnt_loss(x, torch.tensor(targets), torch.tensor(il), torch.tensor(tl), blank,
                    "none", impl=impl)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=TOL)
    # the JAX package's reductions of its per-sample values
    for red, ref in (("mean_batch", want.mean()), ("sum", want.sum()),
                     ("mean", (want / np.maximum(tl, 1)).mean())):
        np.testing.assert_allclose(
            float(rnnt_loss(x.detach(), torch.tensor(targets), torch.tensor(il),
                            torch.tensor(tl), blank, red, impl=impl)), ref, rtol=TOL)


def _lae(a, b):
    m = max(a, b)
    return -np.inf if m == -np.inf else m + np.log1p(np.exp(-abs(a - b)))


def kernel_model(bl, em, il, tl):
    """csrc/rnnt_loss.cu's forward and backward kernels, walked in numpy:
    (nll (B,), d nll / d blank, d nll / d emit) at grad_nll = 1."""
    b_n, t_n, u1 = bl.shape
    u_n = u1 - 1
    nll = np.zeros(b_n)
    gb, ge = np.zeros(bl.shape), np.zeros(em.shape)
    for b in range(b_n):
        tb, ub = min(max(int(il[b]), 1), t_n), min(max(int(tl[b]), 0), u_n)
        al = np.full((t_n, u1), np.nan)
        prev = np.full(u1 + 1, -np.inf)
        prev[0] = al[0, 0] = 0.0
        for d in range(1, tb + ub):
            lo, hi = max(0, d - (tb - 1)), min(d, ub)
            cur = np.full(u1 + 1, -np.inf)
            for u in range(lo, hi + 1):
                t = d - u
                h = prev[u] + bl[b, t - 1, u] if t >= 1 else -np.inf
                e = prev[u - 1] + em[b, t, u - 1] if u >= 1 else -np.inf
                cur[u] = al[t, u] = _lae(h, e)
            prev = cur
        ll = prev[ub] + bl[b, tb - 1, ub]
        nll[b] = -ll
        nxt = np.full(u1 + 1, -np.inf)
        for d in range(tb - 1 + ub, -1, -1):
            lo, hi = max(0, d - (tb - 1)), min(d, ub)
            cur = np.full(u1 + 1, -np.inf)
            for u in range(lo, hi + 1):
                t = d - u
                a, bk = al[t, u], bl[b, t, u]
                if t == tb - 1 and u == ub:
                    cur[u] = bk
                    gb[b, t, u] = -np.exp(a + bk - ll)
                    continue
                h = bk + nxt[u] if t + 1 <= tb - 1 else -np.inf
                e = em[b, t, u] + nxt[u + 1] if u + 1 <= ub else -np.inf
                cur[u] = _lae(h, e)
                if h > -np.inf:
                    gb[b, t, u] = -np.exp(a + h - ll)
                if e > -np.inf:
                    ge[b, t, u] = -np.exp(a + e - ll)
            nxt = cur
    return nll, gb, ge


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel10_algorithm_matches_plain(name):
    lp, targets, il, tl, blank = _case(name, seed=1)
    lp64 = torch.tensor(lp, dtype=torch.float64)
    from qasr_tpu_torch.models.rnnt import lattice_log_probs

    bl, em = lattice_log_probs(lp64, torch.tensor(targets), blank)
    bl = bl.detach().clone().requires_grad_()
    em = em.detach().clone().requires_grad_()
    want = K10.rnnt_loss_plain(bl, em, torch.tensor(il), torch.tensor(tl))
    want.sum().backward()
    nll, gb, ge = kernel_model(bl.detach().numpy(), em.detach().numpy(), il, tl)
    np.testing.assert_allclose(nll, want.detach().numpy(), rtol=1e-10)
    np.testing.assert_allclose(gb, bl.grad.numpy(), atol=1e-10)
    np.testing.assert_allclose(ge, em.grad.numpy(), atol=1e-10)


def test_wrapper_runs_plain_on_cpu():
    lp, targets, il, tl, blank = _case("ragged")
    before = (K10.rnnt_loss.launches, K10.rnnt_loss_plain.launches)
    rnnt_loss(torch.tensor(lp), torch.tensor(targets), torch.tensor(il), torch.tensor(tl), blank)
    assert (K10.rnnt_loss.launches, K10.rnnt_loss_plain.launches) == (before[0], before[1] + 1)


def test_rnnt_trainer_matches_jax():
    jm = JaxRNNTModel.from_config(JModel(encoder=tiny_encoder_cfg(),
                                         decoder=JDec(feat_in=40, num_classes=28),
                                         preprocessor={"features": FEAT, "dither": 0.0}))
    pm = rnnt_model_from_jax(jm)
    cfg = dict(lr=0.01, warmup_steps=0, max_steps=100)
    jt, pt = JaxRNNTTrainer(jm, JaxTrainConfig(**cfg)), RNNTTrainer(pm, TrainConfig(**cfg),
                                                                    device="cpu")
    rng = np.random.default_rng(4)
    audio = (rng.normal(size=(2, 8000)) * 0.1).astype(np.float32)
    batch = (audio, np.asarray([8000, 6000], np.int32),
             rng.integers(0, 28, size=(2, 5)).astype(np.int32), np.asarray([5, 3], np.int32))
    for _ in range(2):
        np.testing.assert_allclose(pt.train_step(batch), jt.train_step(batch), rtol=TOL)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jm.params)]
    pl = tree_leaves(pm.params)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_allclose(b, a, atol=1e-4)
