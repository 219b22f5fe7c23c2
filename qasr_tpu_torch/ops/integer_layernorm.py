"""Integer-only LayerNorm core, the I-BERT i-LayerNorm (port of
qasr_tpu/ops/integer_layernorm.py, canonical integer form).

Rounded integer mean, integer variance, an integer square root, and
(x - mu) / sigma as a floor division at 2^-_K fixed point; the input scale
cancels.  The JAX package seeds its Newton square root from a float32
log2; here the square root is computed digit by digit in integers, which
is floor(sqrt(n)) by construction (the tests hold the two equal over the
whole domain the core uses: var << 12 for var in [0, 2^16]).
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.ops.integer_softmax import floor_div

_K = 10  # fractional bits of the normalized output
_SB = 6  # fractional bits of the integer sigma


def i_sqrt(n: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(n)) for integer n in [0, 2^31) (0 for n <= 0), as int32:
    the binary digit-by-digit method, 16 steps of compare and subtract."""
    rem = n.to(torch.int64).clamp_min(0)
    res = torch.zeros_like(rem)
    bit = 1 << 30
    for _ in range(16):
        t = res + bit
        ge = rem >= t
        rem = torch.where(ge, rem - t, rem)
        res = torch.where(ge, (res >> 1) + bit, res >> 1)
        bit >>= 2
    return res.to(torch.int32)


def i_layernorm_core(q: torch.Tensor) -> torch.Tensor:
    """(x - mu) / sigma over the last axis of an 8-bit integer tensor, as
    int32 at scale 2^-_K.  int32 headroom: |q - mu| <= 255, the variance
    sum stays below 2^31 up to D = 8192, var << 12 < 2^28."""
    d_ax = q.shape[-1]
    q = q.to(torch.int32)
    s = q.sum(dim=-1, keepdim=True, dtype=torch.int32)
    # rounded mean, half away from zero on the magnitude
    mu = torch.where(s >= 0, floor_div(s + d_ax // 2, d_ax),
                     -floor_div(-s + d_ax // 2, d_ax))
    d = q - mu
    var = floor_div((d * d).sum(dim=-1, keepdim=True, dtype=torch.int32), d_ax)
    sigma_s = i_sqrt(torch.bitwise_left_shift(var, 2 * _SB)).clamp_min(1)
    return floor_div(torch.bitwise_left_shift(d, _K + _SB), sigma_s)


def i_layernorm(q: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis of an integer tensor of any scale (it
    cancels): the integer core at 2^-_K, then the float affine, in the JAX
    package's order (y * 2^-_K) * gamma + beta."""
    y = i_layernorm_core(q)
    return y.to(torch.float32) * (1.0 / (1 << _K)) * gamma + beta
