"""Optimizers and learning-rate schedules (port of qasr_tpu/train/optim.py).

The JAX package trains with optax: Novograd written as an optax transform,
and ``get_optimizer`` naming optax's optimizers with optax's defaults.
Here each is a ``torch.optim.Optimizer`` whose ``step`` applies optax's
update, not torch.optim's namesake (they differ: rmsprop's eps inside the
root and decay 0.9, adagrad's initial accumulator 0.1 and eps 1e-7,
adamw's weight decay 1e-4, ...).  ``max_norm`` clips the gradients by
their global norm first, as ``optax.chain(optax.clip_by_global_norm(n),
tx)`` does: unchanged when the norm is below n, else g / norm * n.

Schedule counts: Novograd reads its schedule at the step being taken (the
first update uses ``sched(1)``); optax's ``scale_by_learning_rate`` reads
it at the steps taken so far (the first update uses ``sched(0)``).

``state_leaves`` / ``load_state_leaves`` give the state in the leaf order
of the optax state the JAX package's optimizer keeps (``jax.tree_util.
tree_leaves``: the param tree's dicts in sorted key order, so the params
must be passed in that order), which is the ``opt/<i>`` layout of its
training checkpoints.

Schedules are plain ``step -> lr`` functions of a Python int.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Union

import torch

Schedule = Callable[[int], float]
LR = Union[float, Schedule]


class OptaxOptimizer(torch.optim.Optimizer):
    """An optimizer whose ``step`` applies an optax update to its params
    (one group, a fixed order).  Subclasses set ``slots`` (per-param state
    buffers: name, initial value, and whether the buffer is one scalar
    instead of the param's shape) and ``layout`` (the optax state's
    leaf order: "count" for a step counter, or a slot name for that slot's
    buffers of every param) and write ``_update``."""

    slots: Sequence = ()
    layout: Sequence[str] = ()

    def __init__(self, params, lr: LR, max_norm: Optional[float] = None, **hyper):
        super().__init__(list(params), dict(lr=lr, **hyper))
        self.max_norm = max_norm
        self.count = 0                      # updates taken
        for p in self.params:
            st = self.state[p]
            for name, init, scalar in self.slots:
                st[name] = (torch.full((), float(init), dtype=p.dtype, device=p.device)
                            if scalar else
                            torch.full_like(p, float(init), memory_format=torch.contiguous_format))

    @property
    def params(self) -> List[torch.Tensor]:
        return self.param_groups[0]["params"]

    @property
    def hyper(self) -> dict:
        return self.param_groups[0]

    def lr_at(self, count: int) -> float:
        lr = self.hyper["lr"]
        return float(lr(count)) if callable(lr) else float(lr)

    def _grads(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("closures are not taken")
        grads = self._grads()
        if self.max_norm:
            gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            # 1 (exactly) below the bound, else max_norm / norm
            scale = torch.where(gnorm < self.max_norm, torch.ones_like(gnorm),
                                self.max_norm / gnorm)
            grads = torch._foreach_mul(grads, scale)
        self._update(self.params, grads)
        self.count += 1

    def _update(self, ps: List[torch.Tensor], gs: List[torch.Tensor]) -> None:
        raise NotImplementedError

    # -- state in optax's leaf order ---------------------------------------

    def state_leaves(self) -> List[torch.Tensor]:
        out = []
        for item in self.layout:
            if item == "count":
                out.append(torch.tensor(self.count, dtype=torch.int32))
            else:
                out.extend(self.state[p][item] for p in self.params)
        return out

    def load_state_leaves(self, leaves: Sequence) -> None:
        """Set the state from ``state_leaves``'s list (numpy or tensors)."""
        leaves = list(leaves)
        want = sum(1 if item == "count" else len(self.params) for item in self.layout)
        if len(leaves) != want:
            raise ValueError(f"{type(self).__name__}: {len(leaves)} state leaves, "
                             f"expected {want}")
        it = iter(leaves)
        for item in self.layout:
            if item == "count":
                self.count = int(next(it))
                continue
            for p in self.params:
                buf = self.state[p][item]
                buf.copy_(torch.as_tensor(next(it)).reshape(buf.shape).to(buf))


class Novograd(OptaxOptimizer):
    """Novograd: a scalar second moment a param, v = ||g||^2 where v == 0
    (the first step, or a param whose gradients were all zero), else
    b2 v + (1 - b2) ||g||^2; g' = g / (sqrt(v) + eps) (+ weight_decay p,
    times (1 - b1) with grad_averaging); m = b1 m + g'; p -= lr(step) m
    with step the update being taken (1 for the first).  Leaves:
    NovogradState(step, m, v).

    The per-param scalars are one vector (each param's "v" a view of it)
    and every per-param update is a multi-tensor ``_foreach`` op: a step is
    some twenty launches whatever the number of params (a model has
    hundreds), at the cost of one device-to-host read of the divisors."""

    slots = (("m", 0.0, False),)
    layout = ("count", "m", "v")

    def __init__(self, params, lr: LR, betas=(0.95, 0.98), eps: float = 1e-8,
                 weight_decay: float = 0.0, grad_averaging: bool = False,
                 amsgrad: bool = False, max_norm: Optional[float] = None):
        if amsgrad:
            raise NotImplementedError("amsgrad Novograd variant not implemented")
        super().__init__(params, lr, max_norm, betas=tuple(betas), eps=eps,
                         weight_decay=weight_decay, grad_averaging=grad_averaging)
        ps = self.params
        self.v = torch.zeros((len(ps),), dtype=ps[0].dtype if ps else torch.float32,
                             device=ps[0].device if ps else None)
        for i, p in enumerate(ps):
            self.state[p]["v"] = self.v[i]

    def _update(self, ps, gs):
        h = self.hyper
        b1, b2 = h["betas"]
        norms = torch.stack(torch._foreach_norm(gs)) ** 2
        v_new = torch.where(self.v == 0, norms, b2 * self.v + (1 - b2) * norms)
        self.v.copy_(v_new)
        gs = torch._foreach_div(gs, (torch.sqrt(v_new) + h["eps"]).tolist())
        if h["weight_decay"]:
            torch._foreach_add_(gs, ps, alpha=h["weight_decay"])
        if h["grad_averaging"]:
            torch._foreach_mul_(gs, 1 - b1)
        ms = [self.state[p]["m"] for p in ps]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, gs)
        torch._foreach_add_(ps, ms, alpha=-self.lr_at(self.count + 1))


def _bias(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax's bias correction computes it."""
    return float(torch.tensor(1.0) - torch.tensor(decay) ** count)


class Adam(OptaxOptimizer):
    """optax.adam (b1 0.9, b2 0.999, eps 1e-8, eps_root 0), and optax.adamw
    with ``weight_decay`` (added to the scaled update, default 1e-4)."""

    slots = (("mu", 0.0, False), ("nu", 0.0, False))
    # (ScaleByAdamState(count, mu, nu), [adamw: EmptyState,] ScaleByScheduleState(count))
    layout = ("count", "mu", "nu", "count")

    def __init__(self, params, lr: LR, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0, weight_decay: Optional[float] = None,
                 max_norm: Optional[float] = None):
        super().__init__(params, lr, max_norm, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay)

    def _update(self, ps, gs):
        h = self.hyper
        mus = [self.state[p]["mu"] for p in ps]
        nus = [self.state[p]["nu"] for p in ps]
        for mu, nu, g in zip(mus, nus, gs):
            mu.copy_((1 - h["b1"]) * g + h["b1"] * mu)
            nu.copy_((1 - h["b2"]) * (g * g) + h["b2"] * nu)
        c1, c2 = _bias(h["b1"], self.count + 1), _bias(h["b2"], self.count + 1)
        us = [(mu / c1) / (torch.sqrt(nu / c2 + h["eps_root"]) + h["eps"])
              for mu, nu in zip(mus, nus)]
        if h["weight_decay"]:
            torch._foreach_add_(us, ps, alpha=h["weight_decay"])
        torch._foreach_add_(ps, us, alpha=-self.lr_at(self.count))


class SGD(OptaxOptimizer):
    """optax.sgd without momentum: p -= lr g."""

    layout = ("count",)

    def _update(self, ps, gs):
        torch._foreach_add_(ps, gs, alpha=-self.lr_at(self.count))


class Adadelta(OptaxOptimizer):
    """optax.adadelta (rho 0.9, eps 1e-6, no weight decay): e_g = rho e_g +
    (1 - rho) g^2, u = sqrt(e_x + eps) / sqrt(e_g + eps) g, e_x = rho e_x
    + (1 - rho) u^2, p -= lr u."""

    slots = (("e_g", 0.0, False), ("e_x", 0.0, False))
    layout = ("e_g", "e_x", "count")

    def __init__(self, params, lr: LR, rho: float = 0.9, eps: float = 1e-6,
                 max_norm: Optional[float] = None):
        super().__init__(params, lr, max_norm, rho=rho, eps=eps)

    def _update(self, ps, gs):
        rho, eps = self.hyper["rho"], self.hyper["eps"]
        us = []
        for p, g in zip(ps, gs):
            st = self.state[p]
            st["e_g"].copy_((1 - rho) * (g * g) + rho * st["e_g"])
            u = torch.sqrt(st["e_x"] + eps) / torch.sqrt(st["e_g"] + eps) * g
            st["e_x"].copy_((1 - rho) * (u * u) + rho * st["e_x"])
            us.append(u)
        torch._foreach_add_(ps, us, alpha=-self.lr_at(self.count))


class RMSprop(OptaxOptimizer):
    """optax.rmsprop (decay 0.9, eps 1e-8 inside the root, initial scale 0):
    nu = decay nu + (1 - decay) g^2, p -= lr g / sqrt(nu + eps)."""

    layout = ("nu", "count")

    def __init__(self, params, lr: LR, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, max_norm: Optional[float] = None):
        self.slots = (("nu", initial_scale, False),)
        super().__init__(params, lr, max_norm, decay=decay, eps=eps)

    def _update(self, ps, gs):
        decay, eps = self.hyper["decay"], self.hyper["eps"]
        us = []
        for p, g in zip(ps, gs):
            nu = self.state[p]["nu"]
            nu.copy_((1 - decay) * (g * g) + decay * nu)
            us.append(torch.rsqrt(nu + eps) * g)
        torch._foreach_add_(ps, us, alpha=-self.lr_at(self.count))


class Adagrad(OptaxOptimizer):
    """optax.adagrad (initial accumulator 0.1, eps 1e-7): s += g^2,
    p -= lr g / sqrt(s + eps) (0 where s is 0)."""

    layout = ("sum_of_squares", "count")

    def __init__(self, params, lr: LR, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, max_norm: Optional[float] = None):
        self.slots = (("sum_of_squares", initial_accumulator_value, False),)
        super().__init__(params, lr, max_norm, eps=eps)

    def _update(self, ps, gs):
        eps = self.hyper["eps"]
        us = []
        for p, g in zip(ps, gs):
            s = self.state[p]["sum_of_squares"]
            s.add_(g * g)
            us.append(torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g)
        torch._foreach_add_(ps, us, alpha=-self.lr_at(self.count))


def get_optimizer(name: str, params, learning_rate: LR, max_norm: Optional[float] = None,
                  **kwargs) -> OptaxOptimizer:
    """The optimizer registry: optax's names, update rules and defaults
    (kwargs by optax's argument names)."""
    name = name.lower()
    if name == "novograd":
        return Novograd(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "adam":
        return Adam(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "adamw":
        kwargs.setdefault("weight_decay", 1e-4)
        return Adam(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "sgd":
        return SGD(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "adadelta":
        return Adadelta(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "rmsprop":
        return RMSprop(params, learning_rate, max_norm=max_norm, **kwargs)
    if name == "adagrad":
        return Adagrad(params, learning_rate, max_norm=max_norm, **kwargs)
    raise ValueError(f"unknown optimizer {name}")


# ---------------------------------------------------------------------------
# schedules (step -> lr), as the JAX package defines them
# ---------------------------------------------------------------------------


def _with_warmup(base_lr: float, max_steps: int, min_lr: float, warmup_steps: int,
                 anneal: Callable[[float], float]) -> Schedule:
    def sched(step: int) -> float:
        step = float(step)
        if step > max_steps:
            return min_lr
        if step <= warmup_steps:
            return base_lr * (step + 1) / (warmup_steps + 1)
        return anneal(max(step - warmup_steps, 0.0))

    return sched


def _resolve_warmup(warmup_steps, warmup_ratio, max_steps) -> int:
    if warmup_steps is not None:
        return int(warmup_steps)
    if warmup_ratio is not None:
        return int(warmup_ratio * max_steps)
    return 0


def cosine_annealing(base_lr, max_steps, min_lr=0.0, warmup_steps=None,
                     warmup_ratio=None) -> Schedule:
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    span = max(max_steps - w, 1)

    def anneal(s):
        return (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * s / span)) + min_lr

    return _with_warmup(base_lr, max_steps, min_lr, w, anneal)


def square_annealing(base_lr, max_steps, min_lr=1e-5, warmup_steps=None,
                     warmup_ratio=None) -> Schedule:
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    span = max(max_steps - w, 1)

    def anneal(s):
        return max(base_lr * ((span - s) / span) ** 2, min_lr)

    return _with_warmup(base_lr, max_steps, min_lr, w, anneal)


def squareroot_annealing(base_lr, max_steps, min_lr=0.0, warmup_steps=None,
                         warmup_ratio=None) -> Schedule:
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def anneal(s):
        return max(base_lr * math.sqrt(max(max_steps - (s + w), 0) / max_steps), min_lr)

    return _with_warmup(base_lr, max_steps, min_lr, w, anneal)


def polynomial_decay_annealing(base_lr, max_steps, min_lr=0.0, power=1.0,
                               warmup_steps=None, warmup_ratio=None) -> Schedule:
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    span = max(max_steps - w, 1)

    def anneal(s):
        p = min(max(s, 0), span) / span
        return (base_lr - min_lr) * (1.0 - p) ** power + min_lr

    return _with_warmup(base_lr, max_steps, min_lr, w, anneal)


def inverse_sqrt_annealing(base_lr, max_steps, min_lr=0.0, warmup_steps=None,
                           warmup_ratio=None) -> Schedule:
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)

    def anneal(s):
        return base_lr / math.sqrt(s + w + 1) * math.sqrt(w + 1.0)

    return _with_warmup(base_lr, max_steps, min_lr, w, anneal)


def noam_annealing(base_lr, d_model, max_steps, min_lr=0.0, warmup_steps=1000) -> Schedule:
    def sched(step: int) -> float:
        s = max(float(step), 1.0)
        return max(base_lr * d_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5), min_lr)

    return sched


def warmup_hold_cosine(base_lr, max_steps, min_lr=0.0, warmup_steps=None, warmup_ratio=None,
                       hold_steps=0, hold_ratio=None) -> Schedule:
    """Warmup, a plateau at base_lr for hold_steps, then cosine."""
    w = _resolve_warmup(warmup_steps, warmup_ratio, max_steps)
    h = int(hold_ratio * max_steps) if hold_ratio is not None else int(hold_steps)
    span = max(max_steps - w - h, 1)

    def sched(step: int) -> float:
        step = float(step)
        if step > max_steps:
            return min_lr
        if step <= w:
            return base_lr * (step + 1) / (w + 1)
        if step < w + h:
            return base_lr
        s = max(step - w - h, 0.0)
        return (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * s / span)) + min_lr

    return sched


SCHEDULES = {
    "CosineAnnealing": cosine_annealing,
    "WarmupHoldCosineAnnealing": warmup_hold_cosine,
    "SquareAnnealing": square_annealing,
    "SquareRootAnnealing": squareroot_annealing,
    "PolynomialDecayAnnealing": polynomial_decay_annealing,
    "InverseSquareRootAnnealing": inverse_sqrt_annealing,
    "NoamAnnealing": noam_annealing,
}
