"""The activation-range state that both model families calibrate: a batch's
range (min / max or a percentile pair), the running-range update, and
moving range states and params trees between the host and a device.

A range state is a tree (dicts and lists) whose leaves are sites
{"x_min", "x_max"}: 0-d numpy float32 on the host, 0-d float32 tensors on
a device.  x_min == x_max marks a site that no batch has set yet.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from qasr_tpu_torch.ops.stats import quantile_range

# above this many elements a percentile range comes from histogram_quantile
# instead of a sort
_QUANTILE_SORT_MAX = 1 << 18


def ema_ranges(state, bmin, bmax, momentum: float):
    """The running-range update: the first batch initializes (a state with
    x_min == x_max), later ones move by an EMA, or by min / max at
    momentum -1."""
    init = state["x_min"] == state["x_max"]
    if momentum == -1:
        nmin = torch.minimum(state["x_min"], bmin)
        nmax = torch.maximum(state["x_max"], bmax)
    else:
        nmin = state["x_min"] * momentum + bmin * (1 - momentum)
        nmax = state["x_max"] * momentum + bmax * (1 - momentum)
    return {"x_min": torch.where(init, state["x_min"] + bmin, nmin),
            "x_max": torch.where(init, state["x_max"] + bmax, nmax)}


def sort_quantile(x_f: torch.Tensor, q: float) -> torch.Tensor:
    """The q-quantile of x_f from one sort, interpolated in the JAX
    package's (jnp.quantile's) float32 arithmetic: r = f32(q) * (n - 1),
    lo * (1 - (r - floor r)) + hi * (r - floor r)."""
    xs = torch.sort(x_f.reshape(-1)).values
    n = xs.numel()
    r = np.float32(q) * np.float32(n - 1)
    hw = np.float32(r - np.floor(r))
    lo, hi = (min(max(int(v), 0), n - 1) for v in (np.floor(r), np.ceil(r)))
    return xs[lo] * float(np.float32(1.0) - hw) + xs[hi] * float(hw)


def batch_ranges(x_f: torch.Tensor, percentile: Optional[float]):
    """(low, high) of one batch: min / max, or the percentile pair
    (``sort_quantile`` up to 2**18 elements, histogram_quantile above)."""
    if percentile is None:
        return torch.aminmax(x_f)
    if x_f.numel() > _QUANTILE_SORT_MAX:
        return quantile_range(x_f, percentile)
    return (sort_quantile(x_f, 1.0 - percentile / 100.0),
            sort_quantile(x_f, percentile / 100.0))


def copy_tree(t):
    """A copy of a tree's dicts and lists (the leaves are shared)."""
    if isinstance(t, dict):
        return {k: copy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [copy_tree(v) for v in t]
    return t


def params_to_device(tree, device) -> Any:
    """A params tree (numpy or torch leaves) as float32 torch tensors on
    ``device``."""
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_device(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def qstate_to_device(qstate, device) -> Dict[str, Any]:
    """The range state as 0-d float32 tensors on ``device``."""
    if isinstance(qstate, dict):
        return {k: qstate_to_device(v, device) for k, v in qstate.items()}
    if isinstance(qstate, (list, tuple)):
        return [qstate_to_device(v, device) for v in qstate]
    return torch.as_tensor(np.float32(qstate), device=device)


def qstate_to_host(qstate) -> Dict[str, Any]:
    """The range state as 0-d numpy float32 arrays (one read-back)."""
    if isinstance(qstate, dict):
        return {k: qstate_to_host(v) for k, v in qstate.items()}
    if isinstance(qstate, (list, tuple)):
        return [qstate_to_host(v) for v in qstate]
    return np.asarray(qstate.cpu().numpy(), np.float32)
