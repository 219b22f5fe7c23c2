"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
pointers, so every device, dtype, shape and contiguity it relies on is
verified in Python first and anything else raises.  Also the host's proof
that a per-column requant site may run on the FP64 pipe (``f64_fits``),
which Kernel 4 applies per layer and Kernel 6 per site, and the grouped
forms of Kernels 2 and 8 per launch (``f64_site``), and the storage
rule of an activation code (``act_dtype``): int8, uint8 for the
non-negative 9-bit codes of W8A8's post-ReLU sites, and two uint8 planes
for its signed 9-bit codes after selu or swish."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from qasr_tpu_torch.ops.quant_prims import code_dtype

def check_x(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.dtype != torch.int8 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous {ndim}-D int8 tensor, "
                         f"got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def check_vec(name: str, arg: str, t: Optional[torch.Tensor], dtype,
              shape: Tuple[int, ...], device) -> None:
    """``t`` is None or a contiguous tensor of this dtype/shape/device."""
    if t is None:
        return
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: {arg} must be a torch tensor, got {type(t)}")
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name}: {arg} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def act_dtype(name: str, bits, nonneg: bool, device) -> torch.dtype:
    """The storage rule of an activation code of ``bits`` bits (a requant's
    output, a conv's operand): int8 for a signed code of 2-8 bits; uint8
    for a 9-bit code whose value is non-negative (the +1-bit asymmetric
    sites of W8A8 read a post-ReLU input, and the dyadic requant of a value
    >= 0 is >= 0, so the clamp [-256, 255] reads [0, 255]: one byte, which
    Hopper multiplies as u8 x s8); uint8 too for a signed 9-bit code v in
    [-256, 255] (the same sites after selu or swish), held as two byte
    planes v = u - 256 s with u = v & 255 and s = (v < 0) (``split_planes``,
    ``signed_planes``): Kernel 7 writes both, the uint8 forms of Kernels 1,
    2 and 8 multiply each with the epilogue off, and conv(W, v) = conv(W,
    u) - 256 conv(W, s).  10 bits and more are int32 on the CPU, where the
    plain versions run, and raise NotImplementedError on CUDA, whose
    kernels store bytes."""
    if not isinstance(bits, int) or bits < 2:
        raise ValueError(f"{name}: bits must be an int >= 2, got {bits!r}")
    if signed_planes(bits, nonneg):
        return torch.uint8
    dtype = code_dtype(bits, nonneg)
    if dtype == torch.int32 and torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"{name}: a {bits}-bit activation code has no kernel storage on CUDA (the kernels "
            f"store int8 codes of <= 8 bits and uint8 bytes or byte planes for 9-bit ones)")
    return dtype


def signed_planes(bits: int, nonneg: bool) -> bool:
    """Whether a code of ``bits`` bits is stored as two uint8 planes: a
    9-bit code of a value that may be negative (``act_dtype``)."""
    return bits == 9 and not nonneg


def split_planes(v: torch.Tensor):
    """(u, s) uint8 of signed 9-bit codes v in [-256, 255]: u = v & 255,
    s = (v < 0), so that v = u - 256 s (the plain form of Kernel 7's
    planes)."""
    v = v.to(torch.int32)
    return torch.bitwise_and(v, 255).to(torch.uint8), (v < 0).to(torch.uint8)


def join_planes(acc_u: torch.Tensor, acc_s: torch.Tensor) -> torch.Tensor:
    """conv(W, v) from the two planes' int32 accumulators: acc_u - 256 acc_s,
    exact in int32 wherever |conv(W, v)| < 2^31 (two's complement wraps
    back), which the freeze proves for every such site
    (``quantize/freeze.py::planes_bound``)."""
    return torch.sub(acc_u, acc_s, alpha=256)


def act_clamp(name: str, bits, nonneg: bool = False) -> Tuple[int, int]:
    """(lo, hi) of a kernel's requant output stored as ``act_dtype`` gives
    it on CUDA: [-2^(bits-1), 2^(bits-1)-1] for int8, [0, 255] for uint8
    (the 9-bit clamp [-256, 255] on a non-negative value).  An epilogue
    stores one byte plane, so a signed 9-bit code (Kernel 7's two planes)
    raises NotImplementedError."""
    if signed_planes(bits, nonneg):
        raise NotImplementedError(f"{name}: a signed 9-bit code is two byte planes, which "
                                  f"the requant kernel writes (requant(planes=True))")
    if act_dtype(name, bits, nonneg, "cuda") == torch.uint8:
        return 0, 255
    return int8_clamp(name, bits)


def int8_clamp(name: str, bits) -> Tuple[int, int]:
    """(lo, hi) of a requant that writes int8: [-2^(bits-1), 2^(bits-1)-1]."""
    if not isinstance(bits, int) or not 2 <= bits <= 8:
        raise ValueError(f"{name}: epilogue writes int8, bits must be in [2, 8], got {bits!r}")
    n = 2 ** (bits - 1) - 1
    return -n - 1, n


def epilogue_bounds(name: str, e, bits, nonneg: bool = False) -> Tuple[int, int, int]:
    """(lo, hi, e) of the requant epilogue: a static exponent and the
    output clamp, int8 [-2^(bits-1), 2^(bits-1)-1] or, for a non-negative
    value (``nonneg``), ``act_clamp``'s."""
    if not isinstance(e, int) or e < 1:
        raise ValueError(f"{name}: epilogue needs a static int exponent >= 1, got {e!r}")
    return (*(act_clamp(name, bits, True) if nonneg else int8_clamp(name, bits)), e)


def static_pair(name: str, arg: str, pair) -> Tuple[int, int]:
    """A scalar requant (m, e) a kernel takes by value: 0 < m < 2^31 and a
    static int exponent e >= 1."""
    m, e = int(pair[0]), pair[1]
    if not (isinstance(e, int) and e >= 1 and 0 < m < 2 ** 31):
        raise ValueError(f"{name}: {arg} must be a static (m, e) with 0 < m < 2^31, "
                         f"e >= 1; got {tuple(pair)!r}")
    return m, e


def check_act(name: str, x: torch.Tensor, ndim: int, u8: bool = False) -> None:
    """An activation a prologue or the requant kernel reads: contiguous,
    int8 or int32 (or uint8 where ``u8``)."""
    ok = (torch.int8, torch.int32) + ((torch.uint8,) if u8 else ())
    if x.dtype not in ok or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous {ndim}-D tensor of "
                         f"{' / '.join(str(d) for d in ok)}, got {x.dtype} {tuple(x.shape)} "
                         f"contiguous={x.is_contiguous()}")


def check_bytes(name: str, x: torch.Tensor, ndim: int) -> None:
    """An activation a kernel reads as it is: contiguous int8 or uint8 (a
    non-negative 9-bit code)."""
    if x.dtype not in (torch.int8, torch.uint8) or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous {ndim}-D int8 or uint8 tensor, "
                         f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def requant_operand(name: str, arg: str, v, c: int, device, exponent: bool):
    """A requant mantissa or exponent the kernels take per channel or by
    value: returns (a (C,) int32 device tensor, 0) or (None, the scalar).
    A scalar mantissa lies in [0, 2^31); a scalar exponent is >= 1 (above
    62 the requant gives 0).  Vector exponents are not read back here (that
    would wait for the stream): the kernels count one below 1 as 1, as the
    plain requant does."""
    if isinstance(v, torch.Tensor) and v.dim() > 0:
        check_vec(name, arg, v, torch.int32, (c,), device)
        return v, 0
    s = int(v)
    if exponent and not s >= 1:
        raise ValueError(f"{name}: scalar exponent {arg} must be >= 1, got {s}")
    if not exponent and not 0 <= s < 2 ** 31:
        raise ValueError(f"{name}: scalar mantissa {arg} must lie in [0, 2^31), got {s}")
    return None, s


INT_MAX = 2 ** 31 - 1   # the kernels' "no ceiling"


def cap_operand(name: str, arg: str, cap, c: int, device, relu: bool):
    """hardtanh's ceiling as a kernel takes it: (a (C,) int32 device
    tensor, 0) or (None, the scalar); None is no ceiling (INT_MAX).  A
    ceiling is the upper end of a clip to [0, H], so it needs the ReLU
    flag beside it and a scalar is >= 0."""
    if cap is None:
        return None, INT_MAX
    if not relu:
        raise ValueError(f"{name}: {arg} (hardtanh's ceiling) needs the ReLU flag")
    if isinstance(cap, torch.Tensor) and cap.dim() > 0:
        check_vec(name, arg, cap, torch.int32, (c,), device)
        return cap, 0
    v = int(cap)
    if v < 0:
        raise ValueError(f"{name}: scalar ceiling {arg} must be >= 0, got {v}")
    return None, min(v, INT_MAX)


def group_width(name: str, cin: int, cout: int, groups: int) -> int:
    """Cin / groups of a grouped conv on CUDA, which the grouped forms of
    Kernels 2 and 8 read in 16-byte granules and (their weights) through a
    TMA map with a Cin / groups byte pitch: it must be a positive multiple
    of 16.  A narrower group raises NotImplementedError (the plain version
    takes it on the CPU)."""
    if not isinstance(groups, int) or groups < 1 or cin % groups or cout % groups:
        raise ValueError(f"{name}: groups {groups!r} must divide Cin {cin} and Cout {cout}")
    cg = cin // groups
    if groups > 1 and cg % 16:
        raise NotImplementedError(
            f"{name}: a group of {cg} input channels (Cin {cin} / {groups} groups) is not a "
            f"multiple of 16 bytes, the granule the grouped kernels read a group's channels in")
    return cg


def weight_zmax(lin) -> torch.Tensor:
    """(dout,) int64 bound on |z| = |x . W[o] + b[o]| of a linear site over
    every int8 input x: 128 times the row's L1 norm plus |b|."""
    zmax = 128 * lin["wt"].to(torch.int64).abs().sum(1)
    return zmax + lin["b"].to(torch.int64).abs() if "b" in lin else zmax


def affine_zmax(site) -> torch.Tensor:
    """(d,) int64 bound on |z| = |sgn y + b| of an i-LN affine site: |y| <
    2^21 for the i-LN of an int8 row of d <= 512 values."""
    return (site["sgn"].to(torch.int64).abs() << 21) + site["b"].to(torch.int64).abs()


def f64_fits(zmax: torch.Tensor, m, e) -> bool:
    """Whether qasr_rq_f64 (csrc/requant.cuh) equals the exact requant
    (m, e) on every |z| <= zmax: |z| m < 2^(e + 26) for every column (so
    no result saturates and z m 2^-e stays far inside the fma's exact
    range), and 1 <= e <= 62 (qasr_rq counts e < 1 as 1, m 2^-e does not)."""
    prod = zmax.to(torch.int64) * torch.as_tensor(m).to(torch.int64).abs()
    lim = 1 << min(62, int(e) + 26)
    return 1 <= int(e) <= 62 and bool((prod < lim).all())


def f64_site(e, zmax: int = 2 ** 31) -> bool:
    """Whether qasr_rq_f64 equals the exact requant (m, e) for every
    mantissa 0 <= m < 2^31 and every |z| <= zmax (by default any int32 z):
    ``f64_fits`` at the largest m.  The grouped kernels' host proof of a
    requant site whose m is a device vector (never read back): any int32 z
    at e >= 36, a smaller |z| bound from the shapes at a smaller e."""
    # f64_fits at m = 2^31 - 1, in Python ints: the grouped wrappers call it
    # every launch, and a torch op here cost more host time than the kernel
    if not isinstance(e, int) or not 1 <= e <= 62:
        return False
    return min(int(zmax), 2 ** 31) * (2 ** 31 - 1) < 1 << min(62, e + 26)


def f64_scale(m, e) -> torch.Tensor:
    """m 2^-e as float64, per column (exact: m < 2^31)."""
    return torch.as_tensor(m).to(torch.float64) * 2.0 ** -int(e)
