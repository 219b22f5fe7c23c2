"""Kernel 1: integer depthwise conv with an input-requant prologue and the
consumer epilogue (kernels/csrc/dw_conv.cu).

Replaces qasr_tpu/kernels/cm_fused.py::fused_dw_win_cm, fused_dw_win_tm,
fused_dw_cm and fused_dw_win_i32, and qasr_tpu/kernels/depthwise.py::
depthwise_conv_int_pallas and depthwise_fused_requant.  ``dw_conv``
launches the CUDA kernel for CUDA tensors and runs ``dw_conv_plain`` for
CPU tensors; it never falls back from one to the other.
"""
from __future__ import annotations

from typing import Optional

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    check_act,
    check_vec,
    check_x,
    epilogue_bounds,
    requant_operand,
)
from qasr_tpu_torch.models.jasper import depthwise_conv_int, out_frames
from qasr_tpu_torch.ops.quant_prims import requant_epilogue


def prologue_plain(x: torch.Tensor, *, in_bias=None, in_relu: bool = False,
                   in_len: Optional[torch.Tensor] = None, m1, e1: int,
                   bits1: int) -> torch.Tensor:
    """The input-requant prologue of Kernels 1 and 2 on a whole (B, T, C)
    int8 or int32 tensor: bias -> ReLU -> zero frames t >= in_len[b] ->
    static dyadic requant -> clamp -> int8 (the producer's epilogue, run by
    its consumer)."""
    return requant_epilogue(x, bias=in_bias, relu=in_relu, lens=in_len, m=m1, e=e1,
                            bits=bits1)


def prologue_args(name: str, in_bias, in_relu, in_len, m1) -> None:
    """in_bias / in_relu / in_len belong to the prologue: without m1 they
    raise on every device."""
    if m1 is None and (in_bias is not None or in_relu or in_len is not None):
        raise ValueError(f"{name}: in_bias / in_relu / in_len need the prologue (m1)")


def check_prologue(name, x, in_bias, in_len, m1, e1, bits1, c, b):
    """The prologue's arguments on a CUDA x (B, T, C): (pro, m1 vector or
    None, m1 scalar, lo1, hi1, e1).  m1 is a (C,) int32 tensor or a scalar
    (a 0-d array: a site whose producer has one scale, such as a residual
    join), taken by value."""
    if m1 is None:
        check_x(name, x, 3)
        return 0, None, 0, 0, 0, 0
    check_act(name, x, 3)
    check_vec(name, "in_bias", in_bias, torch.int32, (c,), x.device)
    check_vec(name, "in_len", in_len, torch.int32, (b,), x.device)
    m1v, m1s = requant_operand(name, "m1", m1, c, x.device, exponent=False)
    lo1, hi1, e1 = epilogue_bounds(name, e1, bits1)
    return 1, m1v, m1s, lo1, hi1, e1


def dw_conv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  padding: int = 0, dilation: int = 1,
                  bias: Optional[torch.Tensor] = None, relu: bool = False,
                  out_len: Optional[torch.Tensor] = None, m=None,
                  e: Optional[int] = None, bits: Optional[int] = None,
                  in_bias: Optional[torch.Tensor] = None, in_relu: bool = False,
                  in_len: Optional[torch.Tensor] = None, m1=None,
                  e1: Optional[int] = None, bits1: Optional[int] = None
                  ) -> torch.Tensor:
    """Plain torch version: the prologue on the whole input, the sum of
    strided slices in int32, then the epilogue.  Same arguments and result
    as ``dw_conv``."""
    if m1 is not None:
        x = prologue_plain(x, in_bias=in_bias, in_relu=in_relu, in_len=in_len, m1=m1,
                           e1=e1, bits1=bits1)
    acc = depthwise_conv_int(x, w, stride, padding, dilation)
    if m is None:
        if bias is not None:
            acc = acc + bias
        return acc.clamp_min(0) if relu else acc
    return requant_epilogue(acc, bias=bias, relu=relu, lens=out_len, m=m,
                            e=e, bits=bits)


def dw_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
            padding: int = 0, dilation: int = 1,
            bias: Optional[torch.Tensor] = None, relu: bool = False,
            out_len: Optional[torch.Tensor] = None, m=None,
            e: Optional[int] = None, bits: Optional[int] = None,
            in_bias: Optional[torch.Tensor] = None, in_relu: bool = False,
            in_len: Optional[torch.Tensor] = None, m1=None,
            e1: Optional[int] = None, bits1: Optional[int] = None
            ) -> torch.Tensor:
    """Depthwise conv of x (B, T, C) with taps w (K, C) int8.

    Prologue off (``m1`` None): x is int8 and is convolved as it is.
    Prologue on: x is int8 or int32 and each input frame is first
    ``clamp(requant(mask(relu?(x + in_bias)), m1, e1), bits1)`` with the
    mask zeroing frames t >= in_len[b] (in_len None: no mask), m1 the (C,)
    int32 mantissa vector of this site's input requant or a scalar; the
    conv's zero padding stays 0.
    Epilogue off (``m`` None): returns (B, T_out, C) int32 ``relu?(conv +
    bias)``.  Epilogue on: returns int8 ``clamp(requant(mask(relu?(conv +
    bias)), m, e), bits)``, where the mask zeroes frames t >= out_len[b]
    and m is the (C,) int32 mantissa vector of the consumer site.
    """
    prologue_args("dw_conv", in_bias, in_relu, in_len, m1)
    kw = dict(stride=stride, padding=padding, dilation=dilation, bias=bias, relu=relu,
              out_len=out_len, m=m, e=e, bits=bits, in_bias=in_bias, in_relu=in_relu,
              in_len=in_len, m1=m1, e1=e1, bits1=bits1)
    if x.device.type == "cpu":
        return dw_conv_plain(x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"dw_conv: x must be (B, T, C), got {tuple(x.shape)}")
    b, t_in, c = x.shape
    pro, m1v, m1s, lo1, hi1, ee1 = check_prologue("dw_conv", x, in_bias, in_len, m1, e1,
                                                  bits1, c, b)
    k_size = w.shape[0]
    check_vec("dw_conv", "w", w, torch.int8, (k_size, c), x.device)
    check_vec("dw_conv", "bias", bias, torch.int32, (c,), x.device)
    if stride < 1 or dilation < 1 or padding < 0:
        raise ValueError("dw_conv: stride/dilation must be >= 1, padding >= 0")
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    if b == 0 or t_out <= 0:
        raise ValueError(f"dw_conv: empty output (B={b}, T_out={t_out})")
    epi = m is not None
    lo = hi = ee = 0
    if epi:
        check_vec("dw_conv", "m", m, torch.int32, (c,), x.device)
        check_vec("dw_conv", "out_len", out_len, torch.int32, (b,), x.device)
        lo, hi, ee = epilogue_bounds("dw_conv", e, bits)
    out = torch.empty((b, t_out, c), dtype=torch.int8 if epi else torch.int32,
                      device=x.device)
    lib = _build.library()
    rc = lib.qasr_dw_conv(
        _build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(m),
        _build.ptr(out_len), _build.ptr(out), b, t_in, c, t_out, k_size,
        stride, padding, dilation, int(relu), int(epi), ee, lo, hi, pro,
        int(x.dtype == torch.int32), _build.ptr(in_bias), int(in_relu),
        _build.ptr(in_len), _build.ptr(m1v), m1s, ee1, lo1, hi1, _build.stream_of(x))
    _build.check(rc, "dw_conv")
    dw_conv.launches += 1
    return out


dw_conv.launches = 0
