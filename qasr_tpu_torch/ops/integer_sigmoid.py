"""Integer sigmoid on the S_IN grid (port of qasr_tpu/ops/integer_sigmoid.py,
canonical integer form).

sigmoid(-|x|) = e / (e + E0) with e = i_exp(-|x|) and E0 = i_exp(0), and
sigmoid(|x|) = 1 - sigmoid(-|x|); the result is a fraction in
[0, 2^K_SIG].  Swish and GLU multiply it against an int8 activation, so
their product has scale act_scale / 2^K_SIG.
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.ops.integer_softmax import N_IN, Q_B, Q_C, floor_div, i_exp

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
