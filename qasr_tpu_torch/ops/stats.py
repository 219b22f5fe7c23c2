"""Bracketing quantiles for calibration (port of qasr_tpu/ops/stats.py).

The reference takes percentile ranges with torch.quantile over the whole
site tensor; torch.quantile refuses inputs above 2**24 elements.
``histogram_quantile`` brackets the order statistics instead: each round
splits every bracket into ``splits`` intervals, counts the elements at or
below each edge, and keeps the interval that holds the wanted rank;
``refine`` rounds leave an error of at most range / splits**refine.  The
bracket arithmetic is the JAX package's, so the result is too; the counts
come from a binary search of the edges in one sorted copy of x (on the GPU
a radix sort, a few passes over x's bytes), and nothing is read back to
the host.
"""
from __future__ import annotations

import numpy as np
import torch


def histogram_quantile(x: torch.Tensor, q, splits: int = 32, refine: int = 5) -> torch.Tensor:
    """The q-quantile (q in [0, 1], a scalar or a sequence) of x, as
    torch.quantile's 'linear' interpolation between the two order
    statistics that flank rank q (n - 1), each bracketed to within
    (max - min) / splits**refine.  Ranks are exact host integers (float32
    cannot count past 2**24)."""
    x = x.reshape(-1).to(torch.float32)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError("histogram_quantile: at most 2^31 - 1 elements")
    qs = np.atleast_1d(np.asarray(q, np.float64))
    frank = qs * (n - 1)
    k0 = np.floor(frank)
    dev = x.device
    frac = torch.as_tensor(frank - k0, dtype=torch.float32).to(dev)
    rank = torch.as_tensor(np.concatenate([k0, np.minimum(k0 + 1, n - 1)]),
                           dtype=torch.int64).to(dev)                      # (2Q,)
    xs = torch.sort(x).values
    lo = xs[0].expand(rank.shape).clone()
    hi = xs[-1].expand(rank.shape).clone()
    steps = torch.arange(1, splits, dtype=torch.float32, device=dev)
    for _ in range(refine):
        width = (hi - lo) / splits
        edges = lo[:, None] + width[:, None] * steps
        # #(x <= edge) for every edge of every bracket
        gt = torch.searchsorted(xs, edges.contiguous(), right=True) > rank[:, None]
        # the first interval whose count passes the rank (none: the last)
        j = torch.where(gt.any(1), gt.to(torch.int32).argmax(1),
                        torch.full_like(rank, splits - 1))
        lo = lo + j.to(torch.float32) * width
        hi = lo + width
    mids = (lo + hi) * 0.5
    nq = len(qs)
    out = mids[:nq] + frac * (mids[nq:] - mids[:nq])
    return out[0] if np.ndim(q) == 0 else out


def quantile_range(x: torch.Tensor, percentile: float, splits: int = 32, refine: int = 5):
    """(low, high) percentile clipping range: the (1 - p/100) and p/100
    quantiles."""
    out = histogram_quantile(x, [1.0 - percentile / 100.0, percentile / 100.0],
                             splits=splits, refine=refine)
    return out[0], out[1]
