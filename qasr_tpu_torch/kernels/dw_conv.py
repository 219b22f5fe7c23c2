"""Kernel 1: integer depthwise conv with an input-requant prologue and the
consumer epilogue (kernels/csrc/dw_conv.cu).

Replaces qasr_tpu/kernels/cm_fused.py::fused_dw_win_cm, fused_dw_win_tm,
fused_dw_cm and fused_dw_win_i32, and qasr_tpu/kernels/depthwise.py::
depthwise_conv_int_pallas and depthwise_fused_requant.  ``dw_conv``
launches the CUDA kernel for CUDA tensors and runs ``dw_conv_plain`` for
CPU tensors; it never falls back from one to the other.  ``plan`` states
the kernel's tiles and shared memory, ``check_launch`` the shapes it takes.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    act_clamp,
    act_dtype,
    cap_operand,
    check_act,
    check_bytes,
    check_vec,
    epilogue_bounds,
    requant_operand,
)
from qasr_tpu_torch.models.jasper import depthwise_conv_int, out_frames
from qasr_tpu_torch.ops.quant_prims import clip_ceiling, requant_epilogue

CB = 32              # channels per block (threadIdx.x)
MAX_NT = 16          # thread rows per block
PER = 16             # output frames per thread (4 quads of 4)
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
GRID_YZ = 65535      # the grid's y (channel blocks) and z (batch) limits
# a requant exponent: a static int, or per-channel (C,) / 0-d int32 exponents
Exponent = Union[int, torch.Tensor, None]


def plan(b: int, t_out: int, c: int, k_size: int, stride: int, dilation: int) -> dict:
    """Kernel 1's tiles for one launch (csrc/dw_conv.cu takes nt, groups
    and tiles from here).

    The outputs of one phase q = t % dilation are a stride-``stride`` conv
    over every dilation-th input frame; a block owns 32 channels and ``tt``
    = 16 * ``nt`` consecutive outputs of one phase, ``tiles`` blocks per
    phase, ``nt`` chosen so those tiles are even and at most 256 outputs
    long.  Each of the ``stride`` sub-planes meets ceil(K / stride) taps,
    ``groups`` words of 4, staged as 4 byte-shifted copies of groups + 1
    words.  ``smem``: the shifted taps (16 bytes per group, sub-plane and
    channel), the packed taps they are shifted from (groups + 2 words) and
    the packed input words (``pitch`` per sub-plane and channel: 4 * nt +
    groups, rounded up past one spare word to an odd count)."""
    groups = -(-(-(-k_size // stride)) // 4)
    phases = min(dilation, t_out)
    u_plane = -(-t_out // dilation)           # outputs of phase 0, the longest
    tiles = -(-u_plane // (PER * MAX_NT))
    nt = -(-u_plane // (PER * tiles))
    pitch = (4 * nt + groups + 1) | 1
    smem = (16 * stride * (groups + 1) * CB + 4 * stride * (groups + 2) * CB
            + 4 * stride * CB * pitch)
    return {"nt": nt, "tt": PER * nt, "tiles": tiles, "groups": groups, "phases": phases,
            "pitch": pitch, "smem": smem, "grid": (phases * tiles, -(-c // CB), b),
            "block": (CB, nt)}


def check_launch(b: int, t_in: int, c: int, k_size: int, stride: int, padding: int,
                 dilation: int, pro: bool, x_dtype: torch.dtype) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not take:
    an empty output, an int32 input without the prologue, a grid beyond its
    y / z limits, frame indices beyond int32, or taps that outgrow a
    block's shared memory (ceil(K / stride) above ~1,160: the staged taps
    take 24 bytes per tap group and channel)."""
    if stride < 1 or dilation < 1 or padding < 0 or k_size < 1:
        raise ValueError("dw_conv: stride/dilation/K must be >= 1, padding >= 0")
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    if b < 1 or c < 1 or t_out <= 0:
        raise ValueError(f"dw_conv: empty output (B={b}, C={c}, T_out={t_out})")
    if not pro and x_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"dw_conv: without the prologue x must be int8 or uint8, "
                         f"got {x_dtype}")
    if t_in + t_out * stride + 2 * padding + dilation * k_size >= 2 ** 31:
        raise ValueError("dw_conv: frame indices must stay below 2^31")
    p = plan(b, t_out, c, k_size, stride, dilation)
    if p["grid"][1] > GRID_YZ or p["grid"][2] > GRID_YZ:
        raise ValueError(f"dw_conv: grid {p['grid']} beyond the y / z limit {GRID_YZ}")
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"dw_conv: K={k_size} stride={stride} needs {p['smem']} bytes of "
                         f"shared memory, above {SMEM_LIMIT}")
    return p


def prologue_plain(x: torch.Tensor, *, in_bias=None, in_relu: bool = False,
                   in_len: Optional[torch.Tensor] = None, m1, e1,
                   bits1: int, in_hcap=None) -> torch.Tensor:
    """The input-requant prologue of Kernels 1, 2 and 8 on a whole (B, T,
    C) int8 or int32 tensor: bias -> ReLU (and hardtanh's ceiling
    ``in_hcap``) -> zero frames t >= in_len[b] -> dyadic requant (a static
    exponent, or per-channel exponents) -> clamp -> int8, or uint8 for a
    9-bit code of a ReLU'd value (the producer's epilogue, run by its
    consumer)."""
    return requant_epilogue(x, bias=in_bias, relu=in_relu, lens=in_len, m=m1, e=e1,
                            bits=bits1, hcap=in_hcap)


def prologue_args(name: str, in_bias, in_relu, in_len, m1, in_hcap=None) -> None:
    """in_bias / in_relu / in_len / in_hcap belong to the prologue:
    without m1 they raise on every device, as does a ceiling without the
    ReLU flag."""
    if m1 is None and (in_bias is not None or in_relu or in_len is not None
                       or in_hcap is not None):
        raise ValueError(f"{name}: in_bias / in_relu / in_len / in_hcap need the "
                         f"prologue (m1)")
    if in_hcap is not None and not in_relu:
        raise ValueError(f"{name}: in_hcap (hardtanh's ceiling) needs in_relu")


def check_prologue(name, x, in_bias, in_len, m1, e1, bits1, c, b, vector_e=False,
                   in_relu=False):
    """The prologue's arguments on a CUDA x (B, T, C): (pro, m1 vector or
    None, m1 scalar, e1 vector or None, e1 scalar, lo1, hi1, u8).  m1 is a
    (C,) int32 tensor or a scalar (a 0-d array: a site whose producer has
    one scale, such as a residual join), taken by value; so is e1 where the
    kernel takes per-channel exponents (``vector_e``), else it is a static
    int.  ``u8``: the operand the kernel multiplies is unsigned, a uint8 x
    without the prologue or the uint8 codes of a 9-bit prologue on a
    ReLU'd input (``act_dtype``)."""
    if m1 is None:
        check_bytes(name, x, 3)
        return 0, None, 0, None, 0, 0, 0, x.dtype == torch.uint8
    check_act(name, x, 3)
    check_vec(name, "in_bias", in_bias, torch.int32, (c,), x.device)
    check_vec(name, "in_len", in_len, torch.int32, (b,), x.device)
    m1v, m1s = requant_operand(name, "m1", m1, c, x.device, exponent=False)
    if vector_e:
        e1v, e1s = requant_operand(name, "e1", e1, c, x.device, exponent=True)
        lo1, hi1 = act_clamp(name, bits1, in_relu)
    else:
        e1v, (lo1, hi1, e1s) = None, epilogue_bounds(name, e1, bits1, in_relu)
    return 1, m1v, m1s, e1v, e1s, lo1, hi1, hi1 == 255 and lo1 == 0


def dw_conv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  padding: int = 0, dilation: int = 1,
                  bias: Optional[torch.Tensor] = None, relu: bool = False,
                  out_len: Optional[torch.Tensor] = None, m=None,
                  e: Exponent = None, bits: Optional[int] = None,
                  in_bias: Optional[torch.Tensor] = None, in_relu: bool = False,
                  in_len: Optional[torch.Tensor] = None, m1=None,
                  e1: Exponent = None, bits1: Optional[int] = None,
                  hcap=None, in_hcap=None) -> torch.Tensor:
    """Plain torch version: the prologue on the whole input, the sum of
    strided slices in int32, then the epilogue.  Same arguments and result
    as ``dw_conv``."""
    if m1 is not None:
        x = prologue_plain(x, in_bias=in_bias, in_relu=in_relu, in_len=in_len, m1=m1,
                           e1=e1, bits1=bits1, in_hcap=in_hcap)
    acc = depthwise_conv_int(x, w, stride, padding, dilation)
    if m is None:
        if bias is not None:
            acc = acc + bias
        return clip_ceiling(acc.clamp_min(0), hcap) if relu else acc
    return requant_epilogue(acc, bias=bias, relu=relu, lens=out_len, m=m,
                            e=e, bits=bits, hcap=hcap)


def dw_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
            padding: int = 0, dilation: int = 1,
            bias: Optional[torch.Tensor] = None, relu: bool = False,
            out_len: Optional[torch.Tensor] = None, m=None,
            e: Exponent = None, bits: Optional[int] = None,
            in_bias: Optional[torch.Tensor] = None, in_relu: bool = False,
            in_len: Optional[torch.Tensor] = None, m1=None,
            e1: Exponent = None, bits1: Optional[int] = None,
            hcap=None, in_hcap=None) -> torch.Tensor:
    """Depthwise conv of x (B, T, C) with taps w (K, C) int8.

    Prologue off (``m1`` None): x is int8, or uint8 (a non-negative 9-bit
    code), and is convolved as it is.
    Prologue on: x is int8 or int32 and each input frame is first
    ``clamp(requant(mask(relu?(x + in_bias)), m1, e1), bits1)`` with the
    mask zeroing frames t >= in_len[b] (in_len None: no mask); the conv's
    zero padding stays 0.
    Epilogue off (``m`` None): returns (B, T_out, C) int32 ``relu?(conv +
    bias)``.  Epilogue on: returns int8 ``clamp(requant(mask(relu?(conv +
    bias)), m, e), bits)``, where the mask zeroes frames t >= out_len[b].
    A 9-bit code of a ReLU'd value (W8A8's post-ReLU sites) is stored
    uint8, in the prologue as in the epilogue (``act_dtype``); the products
    then read it unsigned.
    Each of m, e, m1, e1 is a (C,) int32 tensor (per channel: the
    per_channel tables' mantissas and exponents) or a scalar (a Python int
    or a 0-d array, taken by value); an exponent below 1 counts as 1 and
    one above 62 gives 0, as dyadic_requant has it.
    ``hcap`` / ``in_hcap``: hardtanh's ceiling after the epilogue's /
    prologue's ReLU (a clip to [0, H]): None, a Python int, or a (C,) int32
    tensor; each needs its ReLU flag.
    """
    prologue_args("dw_conv", in_bias, in_relu, in_len, m1, in_hcap)
    if hcap is not None and not relu:
        raise ValueError("dw_conv: hcap (hardtanh's ceiling) needs relu")
    kw = dict(stride=stride, padding=padding, dilation=dilation, bias=bias, relu=relu,
              out_len=out_len, m=m, e=e, bits=bits, in_bias=in_bias, in_relu=in_relu,
              in_len=in_len, m1=m1, e1=e1, bits1=bits1, hcap=hcap, in_hcap=in_hcap)
    if x.device.type == "cpu":
        return dw_conv_plain(x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"dw_conv: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"dw_conv: x must be (B, T, C), got {tuple(x.shape)}")
    b, t_in, c = x.shape
    pro, m1v, m1s, e1v, e1s, lo1, hi1, u8 = check_prologue(
        "dw_conv", x, in_bias, in_len, m1, e1, bits1, c, b, vector_e=True, in_relu=in_relu)
    k_size = w.shape[0]
    check_vec("dw_conv", "w", w, torch.int8, (k_size, c), x.device)
    check_vec("dw_conv", "bias", bias, torch.int32, (c,), x.device)
    p = check_launch(b, t_in, c, k_size, stride, padding, dilation, bool(pro), x.dtype)
    hv, hs = cap_operand("dw_conv", "hcap", hcap, c, x.device, relu)
    ihv, ihs = cap_operand("dw_conv", "in_hcap", in_hcap, c, x.device, in_relu)
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    epi = m is not None
    mv = ev = None
    ms = es = lo = hi = 0
    if epi:
        mv, ms = requant_operand("dw_conv", "m", m, c, x.device, exponent=False)
        ev, es = requant_operand("dw_conv", "e", e, c, x.device, exponent=True)
        check_vec("dw_conv", "out_len", out_len, torch.int32, (b,), x.device)
        lo, hi = act_clamp("dw_conv", bits, relu)
    out = torch.empty((b, t_out, c), device=x.device,
                      dtype=act_dtype("dw_conv", bits, relu, x.device) if epi else torch.int32)
    lib = _build.library()
    rc = lib.qasr_dw_conv(
        _build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(mv), ms, _build.ptr(ev), es,
        _build.ptr(out_len), _build.ptr(out), b, t_in, c, t_out, k_size, stride, padding,
        dilation, int(relu), int(epi), lo, hi, pro, int(x.dtype == torch.int32),
        _build.ptr(in_bias), int(in_relu), _build.ptr(in_len), _build.ptr(m1v), m1s,
        _build.ptr(e1v), e1s, lo1, hi1, p["nt"], p["groups"], p["tiles"], int(u8),
        _build.ptr(hv), hs, _build.ptr(ihv), ihs, _build.stream_of(x))
    _build.check(rc, "dw_conv")
    dw_conv.launches += 1
    return out


dw_conv.launches = 0
