"""The transducer loss (Kernel 10's plain versions, models/rnnt.py::rnnt_loss
and ::rnnt_loss_from_logits) and RNNTTrainer against the JAX package, on the
CPU.

(a) ``rnnt_loss`` (the plain wavefront on CPU tensors) against
    rnnt_loss_wavefront and _rnnt_loss_rowscan, and ``rnnt_loss_from_logits``
    (the plain version: log-softmax, gather, wavefront) against
    rnnt_loss_wavefront(log_softmax(logits)): the NLL and its gradient with
    respect to the (B, T, U+1, V+1) log-probs or logits within 1e-5
    (relative for the NLL, absolute for the gradient), at ragged lengths, at
    U = 0, at T = 1 and at B = 4 x T = 40 x U = 12 x V+1 = 30, and the
    reductions of the JAX package's per-sample values; the port's row-scan
    the same against the JAX package's (which cannot take U = 0).
(b) A numpy walk of csrc/rnnt_loss.cu's kernels in float64: the cell pass
    (log-sum-exp, log-probs into diagonal-major rows), the lattice kernel
    (alpha and beta each on its own, from a ring of staged rows whose copies
    land at once or only at the wait that guarantees them; unwritten memory
    is NaN, so a read of it shows) and the gradient pass (runs of 64 cells,
    the kernel's, and of 7, streamed element by element).  From the logits it
    equals jax.grad of the JAX package's rnnt_loss(log_softmax(logits)) in
    float64 within 1e-10; from the log-probs (the diagonal pass, the lattice,
    the occupancy pass) it equals the plain version differentiated by
    autograd in float64 within 1e-10: the kernels' algorithm, their length
    clamps and their zero cells, held where no card is.
    The kernel's branch-free log-add-exp, its formulas in float64, within
    5e-16 of log1p(exp(-x)) over [0, 40].
(c) On CPU tensors each wrapper runs its plain version (its launch count
    moves, the kernel's does not); the C entries' prototypes match
    kernels/_build.py's signatures and the wrapper's calls.
(d) RNNTTrainer against the JAX package's over 2 steps (a tiny Jasper
    encoder, dither 0, dropout 0): losses within 1e-5 relative, every
    param within 1e-4 absolute.
"""
import math
from pathlib import Path

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
from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels import rnnt_loss as K10
from qasr_tpu_torch.models.rnnt import lattice_log_probs, rnnt_loss, rnnt_loss_from_logits
from qasr_tpu_torch.train.trainer import RNNTTrainer, TrainConfig, tree_leaves
from test_jasper_model import FEAT, tiny_encoder_cfg
from test_torch_stream_cache_forms import _c_params, _call_args

TOL = 1e-5

CASES = {  # (T, U, input lengths, target lengths, V: labels without the blank)
    "ragged": (7, 5, [7, 4, 1], [5, 2, 0], 6),
    "U=0": (6, 0, [6, 3], [0, 0], 6),
    "T=1": (1, 4, [1, 1], [4, 2], 6),
    "B=4": (40, 12, [40, 23, 9, 1], [12, 7, 0, 3], 29),
}


def _case(name, seed=0):
    """(logits float32, their log-softmax by JAX, targets, lengths, blank)."""
    t, u, il, tl, v = CASES[name]
    rng = np.random.default_rng(seed)
    b = len(il)
    logits = rng.normal(size=(b, t, u + 1, v + 1)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    targets = rng.integers(0, v, size=(b, u)).astype(np.int32)
    return logits, lp, targets, np.asarray(il, np.int32), np.asarray(tl, np.int32), v


def _jax_nll(impl, targets, il, tl, blank):
    jfn = {"wavefront": JR.rnnt_loss_wavefront, "rowscan": JR._rnnt_loss_rowscan,
           "logits": lambda x, *a: JR.rnnt_loss_wavefront(jax.nn.log_softmax(x, -1), *a)}[impl]

    def f(x):
        return jfn(x, jnp.asarray(targets), jnp.asarray(il), jnp.asarray(tl), blank, "none")
    return f


def _port_loss(impl, x, targets, il, tl, blank, red):
    args = (torch.tensor(targets), torch.tensor(il), torch.tensor(tl), blank, red)
    if impl == "logits":
        return rnnt_loss_from_logits(x, *args)
    return rnnt_loss(x, *args, impl=impl)


# the JAX package's row-scan indexes an empty label axis at U = 0
@pytest.mark.parametrize("name,impl", [(n, "wavefront") for n in sorted(CASES)]
                         + [(n, "rowscan") for n in sorted(CASES) if n != "U=0"]
                         + [(n, "logits") for n in sorted(CASES)])
def test_rnnt_loss_matches_jax(name, impl):
    logits, lp, targets, il, tl, blank = _case(name)
    inp = logits if impl == "logits" else lp
    f = _jax_nll(impl, targets, il, tl, blank)
    want = np.asarray(jax.jit(f)(jnp.asarray(inp)))
    want_g = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(f(x))))(jnp.asarray(inp)))
    x = torch.tensor(inp, requires_grad=True)
    got = _port_loss(impl, x, targets, il, tl, blank, "none")
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, atol=TOL)
    # the JAX package's reductions of its per-sample values
    for red, ref in (("mean_batch", want.mean()), ("sum", want.sum()),
                     ("mean", (want / np.maximum(tl, 1)).mean())):
        np.testing.assert_allclose(
            float(_port_loss(impl, x.detach(), targets, il, tl, blank, red)), ref, rtol=TOL)


# ---------------------------------------------------------------------------
# csrc/rnnt_loss.cu's kernels walked in numpy (float64)
# ---------------------------------------------------------------------------


def _lae(a, b):
    m = max(a, b)
    return -np.inf if m == -np.inf else m + np.log1p(np.exp(-abs(a - b)))


def _lengths(il, tl, b, t_n, u_n):
    return min(max(int(il[b]), 1), t_n), min(max(int(tl[b]), 0), u_n)


def _cells(shape, il, tl):
    """Every (b, t, u) of a (B, T, U+1) lattice and whether it is inside
    its utterance's clamped lengths."""
    b_n, t_n, u1 = shape
    for b in range(b_n):
        tb, ub = _lengths(il, tl, b, t_n, u1 - 1)
        for t in range(t_n):
            for u in range(u1):
                yield b, t, u, t < tb and u <= ub


def cell_pass(z, targets, il, tl, blank):
    """rnnt_lse_kernel: (lse (B, T, U+1), blank_d, emit_d (B, T+U, U+1)
    diagonal-major), NaN where the kernel writes nothing."""
    b_n, t_n, u1, v1 = z.shape
    lse = np.full(z.shape[:3], np.nan)
    bd = np.full((b_n, t_n + u1 - 1, u1), np.nan)
    ed = bd.copy()
    for b, t, u, inside in _cells(z.shape[:3], il, tl):
        if not inside:
            continue
        m = z[b, t, u].max()
        lse[b, t, u] = m + np.log(np.exp(z[b, t, u] - m).sum())
        bd[b, t + u, u] = z[b, t, u, blank] - lse[b, t, u]
        if u < u1 - 1:
            y = min(max(int(targets[b, u]), 0), v1 - 1)
            ed[b, t + u, u] = z[b, t, u, y] - lse[b, t, u]
    return lse, bd, ed


def lae_kernel(a, b, seed_error=0.0):
    """csrc/rnnt_loss.cu's branch-free log-add-exp, its formulas in float64
    (polynomials in Horner's order, no fused multiply-adds; the
    reciprocal's seed from float32, off by ``seed_error`` relative)."""
    m = np.fmax(a, b)
    with np.errstate(invalid="ignore"):
        x = np.fmin(np.abs(a - b), 40.0)
    shift = 6755399441055744.0
    k = x * 1.4426950408889634 + shift
    nd = k - shift
    q = x - nd * 6.93147180369123816490e-01
    q = q - nd * 1.90821492927058770002e-10
    t, p = -q, 0.0
    for c in range(13, -1, -1):
        p = p * t + 1.0 / math.factorial(c)
    y = p * np.ldexp(1.0, -nd.astype(np.int64))
    d = 2.0 + y
    r = (1.0 / d.astype(np.float32)).astype(np.float64) * (1.0 + seed_error)
    r = r + r * (1.0 - d * r)
    r = r + r * (1.0 - d * r)
    s = y * r
    w, at = s * s, 0.0
    for c in range(16, -1, -1):
        at = at * w + 1.0 / (2 * c + 1)
    return np.where(m == -np.inf, -np.inf, m + 2.0 * s * at)


def test_kernel10_log_add_exp_series():
    """The kernel's log-add-exp (exp by Cody-Waite and Taylor, log1p by
    atanh's series) within 5e-16 of log1p(exp(-x)) over x in [0, 40] and
    at its ends, whichever way the reciprocal's seed errs by 2^-20."""
    x = np.concatenate([np.linspace(0.0, 40.0, 200001),
                        np.random.default_rng(0).uniform(0.0, 3.0, 100000), [np.inf]])
    want = np.log1p(np.exp(-x))
    for err in (-2.0 ** -20, 0.0, 2.0 ** -20):
        got = lae_kernel(np.zeros_like(x), -x, err)
        assert np.abs(got - want).max() <= 5e-16
    assert lae_kernel(np.array([-np.inf]), np.array([-np.inf]))[0] == -np.inf
    np.testing.assert_allclose(lae_kernel(np.array([-3.0, 1.0]), np.array([-np.inf, 2.0])),
                               np.logaddexp([-3.0, 1.0], [-np.inf, 2.0]), rtol=0, atol=5e-16)


def diag_pass(bl, em, il, tl):
    """rnnt_diag_kernel: the given log-probs into diagonal-major rows."""
    b_n, t_n, u1 = bl.shape
    bd = np.full((b_n, t_n + u1 - 1, u1), np.nan)
    ed = bd.copy()
    for b, t, u, inside in _cells(bl.shape, il, tl):
        if inside:
            bd[b, t + u, u] = bl[b, t, u]
            if u < u1 - 1:
                ed[b, t + u, u] = em[b, t, u]
    return bd, ed


class Ring:
    """The lattice kernel's ring of K10.STAGES staged rows (blank, emit),
    U_b + 1 columns a row, by cp.async groups: a copy lands when it is
    issued (land="issue") or at the wait that guarantees it ("wait")."""

    def __init__(self, bd, ed, ub, land):
        self.bd, self.ed, self.ub, self.land = bd, ed, ub, land
        self.buf = np.full((K10.STAGES, 2, bd.shape[1]), np.nan)
        self.groups, self.open = [], []

    def _copy(self, row, slot):
        n = self.ub + 1
        self.buf[slot, 0, :n], self.buf[slot, 1, :n] = self.bd[row, :n], self.ed[row, :n]

    def stage(self, row, slot):
        if self.land == "issue":
            self._copy(row, slot)
        self.open.append((row, slot))

    def commit(self):
        self.groups.append(self.open)
        self.open = []

    def wait(self, pending):
        while len(self.groups) > pending:
            for row, slot in self.groups.pop(0):
                if self.land == "wait":
                    self._copy(row, slot)


def lattice_pass(bd, ed, il, tl, t_n, land):
    """rnnt_lattice_kernel, two-sided: (ll (B,), alpha, hb, he (B, T, U+1)),
    alpha's and beta's walks each on its own; NaN where nothing is written."""
    b_n, _, u1 = bd.shape
    s_n = K10.STAGES
    alpha, hb, he = (np.full((b_n, t_n, u1), np.nan) for _ in range(3))
    ll = np.zeros(b_n)
    for b in range(b_n):
        tb, ub = _lengths(il, tl, b, t_n, u1 - 1)
        last = tb - 1 + ub
        # alpha: diagonal d from d - 1 and row d - 1
        ring = Ring(bd[b], ed[b], ub, land)
        for s in range(s_n - 1):
            if s < last:
                ring.stage(s, s)
            ring.commit()
        prev = np.full(u1, np.nan)
        prev[:ub + 1] = -np.inf
        prev[0] = alpha[b, 0, 0] = 0.0
        for d in range(1, last + 1):
            ring.wait(s_n - 2)
            row = d + s_n - 2
            if row < last:
                ring.stage(row, row % s_n)
            ring.commit()
            sb, se = ring.buf[(d - 1) % s_n]
            lo, hi = max(0, d - (tb - 1)), min(d, ub)
            cur = np.full(u1, np.nan)
            for u in range(ub + 1):
                v = -np.inf
                if lo <= u <= hi:
                    h = prev[u] + sb[u] if u < d else -np.inf
                    e = prev[u - 1] + se[u - 1] if u >= 1 else -np.inf
                    v = alpha[b, d - u, u] = _lae(h, e)
                cur[u] = v
            prev = cur
        ll[b] = prev[ub] + bd[b, last, ub]
        # beta: diagonal d from d + 1 and row d
        ring = Ring(bd[b], ed[b], ub, land)
        for s in range(s_n - 1):
            if s <= last:
                ring.stage(last - s, s)
            ring.commit()
        prev = np.full(u1, np.nan)
        prev[:ub + 1] = -np.inf
        for i in range(last + 1):
            d = last - i
            ring.wait(s_n - 2)
            s = i + s_n - 1
            if s <= last:
                ring.stage(last - s, s % s_n)
            ring.commit()
            sb, se = ring.buf[i % s_n]
            lo, hi = max(0, d - (tb - 1)), min(d, ub)
            cur = np.full(u1, np.nan)
            for u in range(ub + 1):
                v = -np.inf
                if lo <= u <= hi:
                    t = d - u
                    if t == tb - 1 and u == ub:
                        h, e = sb[u], -np.inf
                        v = h
                    else:
                        h = sb[u] + prev[u] if t < tb - 1 else -np.inf
                        e = se[u] + prev[u + 1] if u < ub else -np.inf
                        v = _lae(h, e)
                    hb[b, t, u], he[b, t, u] = h, e
                cur[u] = v
            prev = cur
    return ll, alpha, hb, he


def grad_pass(z, targets, il, tl, blank, lse, alpha, hb, he, ll, g, chunk=64):
    """rnnt_grad_kernel: d (g . nll) / d logits, a block a run of ``chunk``
    cells: their g occ_b, g occ_e, lse (+inf past the lengths) and label,
    then the run's elements in order, each one's cell and label index from
    the float32 reciprocal of V+1 and one correction."""
    v1 = z.shape[3]
    flat_z, grad = z.reshape(-1), np.full(z.size, np.nan)
    cells = list(_cells(z.shape[:3], il, tl))
    inv = np.float32(1.0) / np.float32(v1)
    for c0 in range(0, len(cells), chunk):
        n = min(chunk, len(cells) - c0)
        gb, ge, s, y = np.zeros(n), np.zeros(n), np.full(n, np.inf), np.full(n, -1)
        for j, (b, t, u, inside) in enumerate(cells[c0:c0 + n]):
            if inside:
                gb[j] = g[b] * np.exp(alpha[b, t, u] + hb[b, t, u] - ll[b])
                ge[j] = g[b] * np.exp(alpha[b, t, u] + he[b, t, u] - ll[b])
                s[j] = lse[b, t, u]
                if u < z.shape[2] - 1:
                    y[j] = min(max(int(targets[b, u]), 0), v1 - 1)
        e = np.arange(n * v1)
        i = ((e.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
        k = e - i * v1
        i, k = np.where(k < 0, i - 1, np.where(k >= v1, i + 1, i)), \
            np.where(k < 0, k + v1, np.where(k >= v1, k - v1, k))
        v = (gb[i] + ge[i]) * np.exp(flat_z[c0 * v1 + e] - s[i])
        v -= np.where(k == blank, gb[i], 0.0) + np.where(k == y[i], ge[i], 0.0)
        grad[c0 * v1 + e] = v
    return grad.reshape(z.shape)


def occ_pass(il, tl, alpha, hb, he, ll, g):
    """rnnt_occ_kernel: d (g . nll) / d blank_lp and / d emit_lp."""
    gb = np.full(alpha.shape, np.nan)
    ge = np.full(alpha.shape[:2] + (alpha.shape[2] - 1,), np.nan)
    for b, t, u, inside in _cells(alpha.shape, il, tl):
        ob = oe = 0.0
        if inside:
            ob = -g[b] * np.exp(alpha[b, t, u] + hb[b, t, u] - ll[b])
            oe = -g[b] * np.exp(alpha[b, t, u] + he[b, t, u] - ll[b])
        gb[b, t, u] = ob
        if u < alpha.shape[2] - 1:
            ge[b, t, u] = oe
    return gb, ge


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel10_algorithm_matches_plain(name):
    """The log-probs' path (diagonal pass, lattice, occupancies) against
    the plain version in float64, both ways the ring's copies can land."""
    _, lp, targets, il, tl, blank = _case(name, seed=1)
    g = np.random.default_rng(2).uniform(0.5, 1.5, size=len(il))
    bl, em = lattice_log_probs(torch.tensor(lp, dtype=torch.float64), torch.tensor(targets),
                               blank)
    bl = bl.detach().clone().requires_grad_()
    em = em.detach().clone().requires_grad_()
    want = K10.rnnt_loss_plain(bl, em, torch.tensor(il), torch.tensor(tl))
    (want * torch.tensor(g)).sum().backward()
    bd, ed = diag_pass(bl.detach().numpy(), em.detach().numpy(), il, tl)
    for land in ("issue", "wait"):
        ll, alpha, hb, he = lattice_pass(bd, ed, il, tl, lp.shape[1], land)
        gb, ge = occ_pass(il, tl, alpha, hb, he, ll, g)
        np.testing.assert_allclose(-ll, want.detach().numpy(), rtol=1e-10)
        np.testing.assert_allclose(gb, bl.grad.numpy(), atol=1e-10)
        np.testing.assert_allclose(ge, em.grad.numpy(), atol=1e-10)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel10_logits_algorithm_matches_jax(name):
    """The logits' path (cell pass, lattice, gradient pass) against jax.grad
    of the JAX package's rnnt_loss(log_softmax(logits)) in float64."""
    logits, _, targets, il, tl, blank = _case(name, seed=3)
    z = logits.astype(np.float64)
    g = np.random.default_rng(4).uniform(0.5, 1.5, size=len(il))
    with jax.enable_x64(True):
        f = _jax_nll("logits", targets, il, tl, blank)
        want = np.asarray(jax.jit(f)(jnp.asarray(z)))
        want_g = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jnp.asarray(g) * f(x))))(
            jnp.asarray(z)))
    assert want_g.dtype == np.float64
    lse, bd, ed = cell_pass(z, targets, il, tl, blank)
    for land in ("issue", "wait"):
        ll, alpha, hb, he = lattice_pass(bd, ed, il, tl, z.shape[1], land)
        np.testing.assert_allclose(-ll, want, rtol=1e-10)
        grad = grad_pass(z, targets, il, tl, blank, lse, alpha, hb, he, ll, g,
                         chunk=7 if land == "issue" else 64)
        np.testing.assert_allclose(grad, want_g, atol=1e-10)


def test_wrapper_runs_plain_on_cpu():
    _, lp, targets, il, tl, blank = _case("ragged")
    before = (K10.rnnt_loss.launches, K10.rnnt_loss_plain.launches)
    rnnt_loss(torch.tensor(lp), torch.tensor(targets), torch.tensor(il), torch.tensor(tl), blank)
    assert (K10.rnnt_loss.launches, K10.rnnt_loss_plain.launches) == (before[0], before[1] + 1)


def test_logits_wrapper_runs_plain_on_cpu():
    logits, _, targets, il, tl, blank = _case("ragged")
    counts = (K10.rnnt_loss_from_logits, K10.rnnt_loss_from_logits_plain, K10.rnnt_loss,
              K10.rnnt_loss_plain)
    before = [w.launches for w in counts]
    rnnt_loss_from_logits(torch.tensor(logits), torch.tensor(targets), torch.tensor(il),
                          torch.tensor(tl), blank)
    assert [w.launches for w in counts] == [before[0], before[1] + 1, before[2], before[3]]


@pytest.mark.parametrize("name", ["qasr_rnnt_lse", "qasr_rnnt_diag", "qasr_rnnt_lattice",
                                  "qasr_rnnt_grad", "qasr_rnnt_occ", "qasr_rnnt_round_floor"])
def test_signatures_match_the_c_entries(name):
    kernels = Path(K10.__file__).parent
    params = _c_params((kernels / "csrc" / "rnnt_loss.cu").read_text(), name)
    assert _build._SIGNATURES[name] == params
    assert _call_args(kernels / "rnnt_loss.py", name) == len(params)


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
