"""Integer-only softmax, the I-BERT i-softmax (port of
qasr_tpu/ops/integer_softmax.py in its canonical integer form, the
``QASR_FAST_IDIV=0`` branch; the JAX package's f32 forms are TPU
workarounds that its tests hold equal to this one).

Scores on the fixed grid S_IN = 20/16383 (``i_softmax`` puts float scores
there with one rounding) are max-subtracted in integers,
exp(x) = 2^-z * exp(p), p in (-ln2, 0], is an integer quadratic, and the
normalization is a rounding integer division: no float anywhere.  The
same arithmetic is the CUDA kernels' device code
(``kernels/csrc/conformer_int.cuh``).
"""
from __future__ import annotations

import numpy as np
import torch

from qasr_tpu_torch.ops.quant_prims import f32_div

# i-exp polynomial (I-BERT section 3.2): exp(x) ~ a(x + b)^2 + c on (-ln2, 0]
_A, _B, _C = 0.3585, 1.353, 0.344
_LN2 = 0.6931471805599453

N_IN = 16383                 # 14-bit score granularity after max-subtract
S_IN = 20.0 / N_IN           # fixed input scale (window [-20, 0])
Q_LN2 = int(np.floor(-_LN2 / S_IN))            # -568
Q_B = int(np.floor(_B / S_IN))                 # 1108
Q_C = int(np.floor(_C / (_A * S_IN * S_IN)))   # 643_866
_PRESHIFT = 4                # headroom for the length-T int32 sum
MASKED = -(1 << 30)          # score of a masked pair before the row max


def floor_div(n: torch.Tensor, d) -> torch.Tensor:
    """floor(n / d) for integer tensors (``jnp.floor_divide``); a negative
    Python-int divisor flips both signs, as the JAX helper does."""
    if isinstance(d, int) and d < 0:
        n, d = -n, -d
    return torch.div(n, d, rounding_mode="floor")


def i_exp(q: torch.Tensor) -> torch.Tensor:
    """exp(q * S_IN) up to a common positive scale, as int32, for int32 q
    in [-N_IN, 0]: z = floor(q / Q_LN2) <= 28, p = q - z * Q_LN2 in
    (Q_LN2, 0], ((p + Q_B)^2 + Q_C) >> z."""
    q = q.to(torch.int32)
    z = floor_div(q, Q_LN2)
    p = q - z * Q_LN2
    q_l = (p + Q_B) * (p + Q_B) + Q_C
    return torch.bitwise_right_shift(q_l, z.clamp_max(30))


def i_softmax(scores: torch.Tensor, mask=None, *, out_bits: int = 8) -> torch.Tensor:
    """Integer softmax over the last axis of float32 scores (mask: bool,
    True = masked): the one quantization, round((scores - row max) / S_IN)
    clipped at -N_IN, then the integer core.  Returns int32 probabilities
    in [0, n] at scale 1/n, n = 2^(out_bits-1) - 1."""
    if mask is not None:
        scores = torch.where(mask, torch.finfo(scores.dtype).min, scores)
    m = scores.amax(dim=-1, keepdim=True)
    # clip before the int cast: masked lanes hold float32 -max
    x = f32_div(scores - m, S_IN).clamp_min(-float(N_IN))
    return _softmax_core(torch.round(x).to(torch.int32), mask, out_bits)


def i_softmax_grid(q_grid: torch.Tensor, mask=None, *, out_bits: int = 8) -> torch.Tensor:
    """Integer softmax over the last axis of int32 scores on the S_IN grid
    (mask: bool, True = masked, broadcast against q_grid).  Returns int32
    probabilities in [0, n] at scale 1/n, n = 2^(out_bits-1) - 1."""
    q_grid = q_grid.to(torch.int32)
    if mask is not None:
        q_grid = torch.where(mask, torch.full((), MASKED, dtype=torch.int32,
                                              device=q_grid.device), q_grid)
    m = q_grid.amax(dim=-1, keepdim=True)
    return _softmax_core((q_grid - m).clamp_min(-N_IN), mask, out_bits)


def _softmax_core(q: torch.Tensor, mask, out_bits: int) -> torch.Tensor:
    q_exp = i_exp(q)
    if mask is not None:
        q_exp = torch.where(mask, torch.zeros((), dtype=torch.int32,
                                              device=q_exp.device), q_exp)
    q_exp = torch.bitwise_right_shift(q_exp, _PRESHIFT)
    denom = q_exp.sum(dim=-1, keepdim=True, dtype=torch.int32).clamp_min(1)
    n = 2 ** (out_bits - 1) - 1
    # round-half-up division; every operand is >= 0
    return floor_div(q_exp * n + torch.bitwise_right_shift(denom, 1), denom)
