"""Train-mode dropout, split into a draw and an apply: keep each element
with p = 1 - rate and scale the kept ones by 1 / (1 - rate), as the JAX
package's ``jax.random.bernoulli`` dropout does.  The keep mask comes from
a ``torch.Generator`` (a different stream from JAX's)."""
from __future__ import annotations

from typing import Optional

import torch


def draw_keep(shape, rate: float, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A bool keep mask: True with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - rate), 0.0)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """x unchanged at rate 0 or without a generator (eval), else dropped."""
    if rate <= 0 or generator is None:
        return x
    return apply_keep(x, draw_keep(x.shape, rate, generator, x.device), rate)
