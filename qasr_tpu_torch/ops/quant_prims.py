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
Calibration and dynamic quantization derive their multipliers on the
device instead (``dyadic_from_scale``: float32 frexp from the bits, no
host sync) and requantize with them (``requantize``), or with the float32
multiplier itself (``requantize_approx``, calibration's default).
"""
from __future__ import annotations

import decimal
from decimal import Decimal
from typing import NamedTuple, Optional

import numpy as np
import torch

# saturation sentinel of the JAX requant (quant_prims.py:210): far above any
# activation clamp bound, low enough that two results sum inside int32
SAT = 1 << 26


class QTensor(NamedTuple):
    """An integer tensor plus its float32 scale: value == values * scale.
    ``scale`` is a numpy float32 scalar or a per-channel (C,) array over
    the trailing (channel) axis."""

    values: torch.Tensor
    scale: object

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


class Dyadic(NamedTuple):
    """Dyadic multiplier m * 2**-e (m int32, e int32 or a Python int)."""

    m: object
    e: object


def mask_values(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Zero the frames at and after each sample's length; x (B, T, C)."""
    keep = torch.arange(x.shape[1], device=lens.device)[None, :] < lens[:, None]
    return torch.where(keep[:, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def f32_div(y: torch.Tensor, s: float) -> torch.Tensor:
    """y / s as an IEEE division in y's dtype (a 0-d device tensor: CUDA
    divides by a host scalar through its reciprocal, an ulp off)."""
    return y / torch.full((), s, dtype=y.dtype, device=y.device)


def symmetric_scale(x_min: torch.Tensor, x_max: torch.Tensor, bits: int) -> torch.Tensor:
    """clamp(max(|x_min|, |x_max|), 1e-8) / (2^(bits-1) - 1), elementwise,
    in the inputs' float dtype (per tensor or per channel)."""
    n = 2 ** (bits - 1) - 1
    return f32_div(torch.maximum(x_min.abs(), x_max.abs()).clamp_min(1e-8), n)


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


def dyadic_from_scale(new_scale: torch.Tensor, max_bit: int = 31) -> Dyadic:
    """In-graph decomposition of a float32 ``new_scale`` (calibration and
    dynamic quantization): frexp from the float's bits, read on the device
    through an int32 view.  m keeps float32's 24 significand bits shifted
    up to bit 31; e = 31 - exponent.  Exact for normal floats."""
    bits = new_scale.to(torch.float32).contiguous().view(torch.int32)
    exp = ((bits >> 23) & 0xFF) - 126  # x = m * 2**exp, m in [0.5, 1)
    m24 = (bits & 0x7FFFFF) | 0x800000
    return Dyadic(m24 << (max_bit - 24), max_bit - exp)


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


def dyadic_requant_any(z: torch.Tensor, m, e) -> torch.Tensor:
    """requant(z, m, e): dyadic_requant_static for a static Python-int
    exponent, dyadic_requant for per-channel / 0-d exponents (clamped to
    [1, 62], 0 above 62)."""
    if isinstance(e, int):
        return dyadic_requant_static(z, m, e)
    return dyadic_requant(z, Dyadic(m, e))


def requant_epilogue(acc: torch.Tensor, *, bias=None, relu: bool = False,
                     lens: Optional[torch.Tensor] = None, m, e,
                     bits: int) -> torch.Tensor:
    """The kernels' consumer epilogue on an int32 (B, T, C) accumulator:
    bias -> ReLU -> length mask -> dyadic requant (``dyadic_requant_any``:
    a static or per-channel exponent) -> clamp -> int8.  Same op order as the JAX
    FrozenExec walk (conv + bias, activation, then the consumer's mask and
    input requant)."""
    if bias is not None:
        acc = acc + bias
    if relu:
        acc = acc.clamp_min(0)
    if lens is not None:
        acc = mask_values(acc, lens)
    return requant_clamp(dyadic_requant_any(acc, m, e), bits).to(torch.int8)


def requantize(x: QTensor, out_scale: torch.Tensor, bits: int, *,
               dyadic: Optional[Dyadic] = None,
               identity: Optional[QTensor] = None,
               identity_dyadic: Optional[Dyadic] = None) -> QTensor:
    """Requantize ``x`` (plus ``identity``, a residual join) onto
    ``out_scale``: clamp(requant(x.q, m, e) [+ requant(id.q, m1, e1)],
    -n-1, n), int32 values.  Without ``dyadic`` the multipliers come from
    the float32 scale ratios on the device (``dyadic_from_scale``)."""
    if dyadic is None:
        dyadic = dyadic_from_scale(x.scale / out_scale)
    q = dyadic_requant(x.values, dyadic)
    if identity is not None:
        if identity_dyadic is None:
            identity_dyadic = dyadic_from_scale(identity.scale / out_scale)
        q = q + dyadic_requant(identity.values, identity_dyadic)
    return QTensor(requant_clamp(q, bits), out_scale)


def requantize_approx(x: QTensor, out_scale: torch.Tensor, bits: int,
                      identity: Optional[QTensor] = None) -> QTensor:
    """The float-multiplier requant of calibration:
    clamp(round(x.q * f32(s_in / s_out)) [+ the same for identity], -n-1,
    n), int32 values.  The float32 multiplier differs from the dyadic one by
    at most 2**-24 relative; calibration keeps only the ranges."""
    q = torch.round(x.values.to(torch.float32) * (x.scale / out_scale))
    if identity is not None:
        q = q + torch.round(identity.values.to(torch.float32) * (identity.scale / out_scale))
    return QTensor(requant_clamp(q.to(torch.int32), bits), out_scale)
