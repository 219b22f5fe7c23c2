"""Argument checks shared by the kernel wrappers: a CUDA kernel takes
pointers, so every device, dtype, shape and contiguity it relies on is
verified in Python first and anything else raises.  Also the host's proof
that a per-column requant site may run on the FP64 pipe (``f64_fits``),
which Kernel 4 applies per layer and Kernel 6 per site."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def int8_clamp(name: str, bits) -> Tuple[int, int]:
    """(lo, hi) of a requant that writes int8: [-2^(bits-1), 2^(bits-1)-1]."""
    if not isinstance(bits, int) or not 2 <= bits <= 8:
        raise ValueError(f"{name}: epilogue writes int8, bits must be in [2, 8], got {bits!r}")
    n = 2 ** (bits - 1) - 1
    return -n - 1, n


def epilogue_bounds(name: str, e, bits) -> Tuple[int, int, int]:
    """(lo, hi, e) of the requant epilogue: a static exponent and an int8
    output clamp [-2^(bits-1), 2^(bits-1)-1]."""
    if not isinstance(e, int) or e < 1:
        raise ValueError(f"{name}: epilogue needs a static int exponent >= 1, got {e!r}")
    return (*int8_clamp(name, bits), e)


def static_pair(name: str, arg: str, pair) -> Tuple[int, int]:
    """A scalar requant (m, e) a kernel takes by value: 0 < m < 2^31 and a
    static int exponent e >= 1."""
    m, e = int(pair[0]), pair[1]
    if not (isinstance(e, int) and e >= 1 and 0 < m < 2 ** 31):
        raise ValueError(f"{name}: {arg} must be a static (m, e) with 0 < m < 2^31, "
                         f"e >= 1; got {tuple(pair)!r}")
    return m, e


def check_act(name: str, x: torch.Tensor, ndim: int) -> None:
    """An activation a prologue or the requant kernel reads: contiguous,
    int8 or int32."""
    if x.dtype not in (torch.int8, torch.int32) or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous {ndim}-D int8 or int32 tensor, "
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


def f64_scale(m, e) -> torch.Tensor:
    """m 2^-e as float64, per column (exact: m < 2^31)."""
    return torch.as_tensor(m).to(torch.float64) * 2.0 ** -int(e)
