"""Integer sublayer blocks of the frozen Conformer, in plain torch: the
``_apply_rq`` / ``_join_lin`` / ``_ffn_mid`` / ``_glu_int`` /
``_conv_tail_mid`` compositions of qasr_tpu/quantize/conformer_freeze.py,
op for op.  The executors and the kernels' plain versions share them.

Tables are the device form of ``conformer_freeze.conformer_tables_to_device``:
a linear site is {"wt" (dout, din) int8, "b" int32, "m" int32, "e" int},
an affine site {"sgn", "b", "m" int32, "e" int}, a scalar requant a pair
(m int, e int).  Integer GEMMs go through ``int_matmul`` (int32 matmul on
the CPU, ``torch._int_mm`` or exact float64 on the card).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from qasr_tpu_torch.kernels.pw_gemm import int_matmul
from qasr_tpu_torch.ops.integer_sigmoid import i_sigmoid_grid
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static


def clip8(q: torch.Tensor, bits: int) -> torch.Tensor:
    """The Conformer's activation clamp [-n, n-1], n = 2^(bits-1) - 1, as int8."""
    n = 2 ** (bits - 1) - 1
    return q.clamp(-n, n - 1).to(torch.int8)


def _dot8(x8: torch.Tensor, lin) -> torch.Tensor:
    """x8 (..., din) int8 @ the site's weights -> (..., dout) int32."""
    wt = lin["wt"]
    acc = int_matmul(x8.reshape(-1, x8.shape[-1]).contiguous(), wt)
    return acc.reshape(*x8.shape[:-1], wt.shape[0])


def _apply_rq(z: torch.Tensor, t, bits: int) -> torch.Tensor:
    """acc-domain bias + exact dyadic requant + clamp -> int8."""
    return clip8(dyadic_requant_static(z + t["b"] if "b" in t else z, t["m"], t["e"]), bits)


def _apply_affine_rq(y: torch.Tensor, t, bits: int) -> torch.Tensor:
    return clip8(dyadic_requant_static(t["sgn"] * y + t["b"], t["m"], t["e"]), bits)


def _lin_rq(x8: torch.Tensor, t, bits: int) -> torch.Tensor:
    """linear -> acc bias -> dyadic requant -> clamp -> int8."""
    return _apply_rq(_dot8(x8, t), t, bits)


def _join_int(acc, tbl_branch, stream8, stream_rq: Tuple[int, int], bits: int):
    yb = dyadic_requant_static(acc + tbl_branch["b"], tbl_branch["m"], tbl_branch["e"])
    ys = dyadic_requant_static(stream8.to(torch.int32), stream_rq[0], stream_rq[1])
    return clip8(yb + ys, bits)


def _join_lin(x8, tbl, stream8, stream_rq, bits: int):
    """Residual join: the branch GEMM's requant plus the stream's requant."""
    return _join_int(_dot8(x8, tbl), tbl, stream8, stream_rq, bits)


def _swish8(a8: torch.Tensor, grid, prod, bits: int) -> torch.Tensor:
    """int8 activation -> S_IN grid -> integer swish product -> int8."""
    a32 = a8.to(torch.int32)
    g = dyadic_requant_static(a32, grid[0], grid[1])
    return clip8(dyadic_requant_static(a32 * i_sigmoid_grid(g), prod[0], prod[1]), bits)


def _ffn_mid(x8, tbl_l1, grid, prod, bits: int):
    """FFN first half: l1 linear -> requant -> integer swish -> int8."""
    return _swish8(_lin_rq(x8, tbl_l1, bits), grid, prod, bits)


def _glu_int(tbl, yln, bits: int) -> torch.Tensor:
    """GLU of the conv module as an int32 product (a8 * sigmoid fraction);
    the caller masks and requants it onto glu_prod."""
    a8c = _lin_rq(yln, tbl["pw1_a"], bits)
    g = tbl["pw1_g"]
    g_grid = dyadic_requant_static(_dot8(yln, g) + g["b"], g["m"], g["e"])
    return a8c.to(torch.int32) * i_sigmoid_grid(g_grid)


def depthwise_int(x8: torch.Tensor, w: torch.Tensor, padding) -> torch.Tensor:
    """Stride-1 depthwise conv of (B, T, C) int8 with (K, C) int8 taps and
    (left, right) zero padding, int32 accumulate (cross-correlation, as
    ``lax.conv_general_dilated``)."""
    k_size = w.shape[0]
    xp = F.pad(x8.to(torch.int32), (0, 0, int(padding[0]), int(padding[1])))
    t_out = xp.shape[1] - k_size + 1
    acc = torch.zeros((x8.shape[0], t_out, x8.shape[2]), dtype=torch.int32, device=x8.device)
    wi = w.to(torch.int32)
    for k in range(k_size):
        acc += xp[:, k:k + t_out] * wi[k]
    return acc


def _conv_tail_mid(tbl, glu8, padding, bits: int) -> torch.Tensor:
    """Depthwise conv over the GLU ints -> BN fold -> i-swish -> int8 pw2
    input."""
    bn8 = _apply_affine_rq(depthwise_int(glu8, tbl["dw_w"], padding), tbl["dw_bn"], bits)
    return _swish8(bn8, tbl["bn_grid"], tbl["bn_prod"], bits)
