"""Integer sigmoid on the S_IN grid (port of qasr_tpu/ops/integer_sigmoid.py,
canonical integer form).

sigmoid(-|x|) = e / (e + E0) with e = i_exp(-|x|) and E0 = i_exp(0), and
sigmoid(|x|) = 1 - sigmoid(-|x|); the result is a fraction in
[0, 2^K_SIG].  Swish and GLU multiply it against an int8 activation, so
their product has scale act_scale / 2^K_SIG.
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.ops.integer_softmax import N_IN, Q_B, Q_C, S_IN, floor_div, i_exp
from qasr_tpu_torch.ops.quant_prims import f32_div

K_SIG = 7                    # fractional bits of the sigmoid fraction
_E0 = Q_B * Q_B + Q_C        # i_exp(0)


def i_sigmoid_grid(q: torch.Tensor) -> torch.Tensor:
    """Sigmoid fraction (int32 in [0, 2^K_SIG]) of int32 values on the
    S_IN grid; |q| is clipped at N_IN (sigmoid is saturated there)."""
    q = q.to(torch.int32).clamp(-N_IN, N_IN)
    e = i_exp(-q.abs())
    den = e + _E0
    s_neg = floor_div(torch.bitwise_left_shift(e, K_SIG)
                      + torch.bitwise_right_shift(den, 1), den)
    return torch.where(q >= 0, (1 << K_SIG) - s_neg, s_neg)


def i_sigmoid_fp(x: torch.Tensor) -> torch.Tensor:
    """Sigmoid fraction (int32 in [0, 2^K_SIG]) of float32 values: one
    rounding onto the S_IN grid, clipped at +-N_IN, then the integer
    sigmoid."""
    q = torch.round(f32_div(x, S_IN)).clamp(-float(N_IN), float(N_IN)).to(torch.int32)
    return i_sigmoid_grid(q)


def i_swish_terms(q_act: torch.Tensor, x_f: torch.Tensor) -> torch.Tensor:
    """swish as an integer product: the activation's own integers q_act
    (any scale S) times the sigmoid fraction of the same values in float
    x_f; int32 at scale S / 2^K_SIG."""
    return q_act.to(torch.int32) * i_sigmoid_fp(x_f)
