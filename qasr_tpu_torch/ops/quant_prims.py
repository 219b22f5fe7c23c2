"""Integer quantization primitives in torch (port of qasr_tpu/ops/quant_prims.py).

The JAX package evaluates the dyadic requant ``round(z * m / 2**e)`` with
two 32-bit limbs because the TPU's vector unit has no 64-bit integers.
Torch has int64 on the CPU and on CUDA, so here the 61-bit product is one
int64 multiply and the rounding is one shift: ``dyadic_requant``,
``dyadic_requant_static`` and ``dyadic_requant_static16`` all reduce to

    sign(z) * min(round_half_even(|z| * m / 2**e), 2**26),   0 when e > 62

which is what the JAX functions compute on their contract domain
(|z| < 2**29, m < 2**31, e >= 1).  The same formula is the CUDA kernels'
device function (kernels/csrc/requant.cuh).

The host table builders are copied (their JAX module imports jax): numpy
float64 frexp plus Decimal ROUND_HALF_UP, as the reference's batch_frexp.
"""
from __future__ import annotations

import decimal
from decimal import Decimal
from typing import NamedTuple, Optional

import numpy as np
import torch

from qasr_tpu_torch.models.jasper import mask_values

# saturation sentinel of the JAX requant (quant_prims.py:210): far above any
# activation clamp bound, low enough that two results sum inside int32
SAT = 1 << 26


class QTensor(NamedTuple):
    """An integer tensor plus its float32 scale: value == values * scale.
    ``scale`` is a numpy float32 scalar or a per-channel (C,) array over
    the trailing (channel) axis."""

    values: torch.Tensor
    scale: object


class Dyadic(NamedTuple):
    """Dyadic multiplier m * 2**-e (m int32, e int32 or a Python int)."""

    m: object
    e: object


def symmetric_scale(x_min: torch.Tensor, x_max: torch.Tensor, bits: int) -> torch.Tensor:
    """clamp(max(|x_min|, |x_max|), 1e-8) / (2^(bits-1) - 1), elementwise,
    in the inputs' float dtype (per tensor or per channel)."""
    n = 2 ** (bits - 1) - 1
    return torch.maximum(x_min.abs(), x_max.abs()).clamp_min(1e-8) / n


def quantize(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    """round_half_even(f32(1/scale) * x) clipped to [-n, n-1], int32 (the
    reciprocal-then-multiply of the reference's linear_quantize)."""
    n = 2 ** (bits - 1) - 1
    return torch.round(torch.reciprocal(scale) * x).clamp(-n, n - 1).to(torch.int32)


def dyadic_from_scale_host(new_scale, max_bit: int = 31) -> Dyadic:
    """Per-channel exact decomposition of ``new_scale`` (copy of the JAX
    package's host builder): np.frexp in float64, Decimal ROUND_HALF_UP of
    m * 2**31, m == 2**31 renormalized to (m/2, e-1)."""
    ns = np.asarray(new_scale, dtype=np.float64).reshape(-1)
    if not np.all(ns > 0):
        raise ValueError("dyadic scales must be positive")
    m_f, exp = np.frexp(ns)
    m_out = np.empty(ns.shape, dtype=np.int64)
    for i, mf in enumerate(m_f):
        m_out[i] = int(Decimal(mf * (2 ** max_bit)).quantize(
            Decimal("1"), rounding=decimal.ROUND_HALF_UP))
    e_out = (max_bit - exp).astype(np.int64)
    over = m_out == (1 << max_bit)
    m_out[over] >>= 1
    e_out[over] -= 1
    if np.any(e_out < 1):
        raise ValueError("requant scale >= 2**30 is unsupported (e < 1)")
    shape = np.asarray(new_scale).shape
    return Dyadic(m_out.reshape(shape).astype(np.int32),
                  e_out.reshape(shape).astype(np.int32))


def dyadic_from_scale_host_static_e(new_scale, max_bit: int = 31):
    """One static exponent for a whole per-channel scale vector (copy of
    the JAX package's host builder): e from the largest scale, mantissas
    Decimal-rounded at that shift.  Returns (m int32 ndarray, e int)."""
    ns = np.asarray(new_scale, dtype=np.float64).reshape(-1)
    if not np.all(ns > 0):
        raise ValueError("dyadic scales must be positive")
    _, exp = np.frexp(ns.max())
    e = int(max_bit - exp)
    if e < 1:
        raise ValueError("requant scale >= 2**30 is unsupported")
    m = np.empty(ns.shape, dtype=np.int64)
    scale_2e = Decimal(2) ** e
    for i, v in enumerate(ns):
        m[i] = int((Decimal(v) * scale_2e).quantize(
            Decimal("1"), rounding=decimal.ROUND_HALF_UP))
    if np.any(m >= (1 << max_bit)):  # ties rounding the max channel up
        e -= 1
        m = np.asarray([int((Decimal(v) * (Decimal(2) ** e)).quantize(
            Decimal("1"), rounding=decimal.ROUND_HALF_UP)) for v in ns],
            np.int64)
    m = np.maximum(m, 1)
    shape = np.asarray(new_scale).shape
    return m.reshape(shape).astype(np.int32), e


def _as_i64(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def _requant_i64(z: torch.Tensor, m, e) -> torch.Tensor:
    """sign(z) * min(round_half_even(|z| * m / 2**e), 2**26) for e in
    [1, 62]; e a Python int or an int64 tensor broadcast against z."""
    z = z.to(torch.int64)
    # a Python-int mantissa stays a scalar: a host array would be copied to
    # the card, and that copy waits for the stream
    p = z.abs() * (m if isinstance(m, int) else _as_i64(m, z.device))
    fl = p >> e
    rem = p - (fl << e)
    if isinstance(e, int):
        half = 1 << (e - 1)
    else:
        half = torch.bitwise_left_shift(torch.ones_like(e), e - 1)
    up = (rem > half) | ((rem == half) & ((fl & 1) == 1))
    r = (fl + up.to(torch.int64)).clamp_max(SAT)
    return torch.sign(z) * r


def dyadic_requant(z: torch.Tensor, d: Dyadic) -> torch.Tensor:
    """Exact round_half_even(z * m / 2**e), per-channel m and e (tensors
    broadcast against z's trailing axis, or scalars).  Returns int32."""
    e = _as_i64(d.e, z.device)
    r = _requant_i64(z, d.m, e.clamp(1, 62))
    return torch.where(e > 62, torch.zeros_like(r), r).to(torch.int32)


def dyadic_requant_static(z: torch.Tensor, m, e: int) -> torch.Tensor:
    """dyadic_requant with one static Python-int exponent."""
    if not (isinstance(e, int) and e >= 1):
        raise ValueError(f"static exponent must be an int >= 1, got {e!r}")
    if e > 62:
        return torch.zeros(z.shape, dtype=torch.int32, device=z.device)
    return _requant_i64(z, m, e).to(torch.int32)


def dyadic_requant_static16(z: torch.Tensor, m, e: int) -> torch.Tensor:
    """The 16-bit-mantissa requant.  With int64 arithmetic it is the same
    exact formula; the JAX package's domain (1 <= e <= 31) is enforced."""
    if not (isinstance(e, int) and 1 <= e <= 31):
        raise ValueError(f"static_e16 exponent must be in [1, 31], got {e!r}")
    return _requant_i64(z, m, e).to(torch.int32)


def requant_clamp(q: torch.Tensor, bits: int) -> torch.Tensor:
    """fixedpoint_mul's output clamp [-n-1, n] (opposite asymmetry from the
    weight / first-site clamp [-n, n-1])."""
    n = 2 ** (bits - 1) - 1
    return q.clamp(-n - 1, n)


def requant_epilogue(acc: torch.Tensor, *, bias=None, relu: bool = False,
                     lens: Optional[torch.Tensor] = None, m, e: int,
                     bits: int) -> torch.Tensor:
    """The kernels' consumer epilogue on an int32 (B, T, C) accumulator:
    bias -> ReLU -> length mask -> static dyadic requant -> clamp -> int8.
    Same op order as the JAX FrozenExec walk (conv + bias, activation, then
    the consumer's mask and input requant)."""
    if bias is not None:
        acc = acc + bias
    if relu:
        acc = acc.clamp_min(0)
    if lens is not None:
        acc = mask_values(acc, lens)
    q = requant_clamp(dyadic_requant_static(acc, m, e), bits)
    return q.to(torch.int8)
