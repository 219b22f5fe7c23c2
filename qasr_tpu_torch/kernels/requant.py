"""Elementwise and row-wise launches of the kernels' shared device functions
(kernels/csrc/requant.cuh via requant_check.cu, conformer_int.cuh via
conformer_int_check.cu), used to hold each against its plain torch
version on the card.  Not on the serving path."""
from __future__ import annotations

from typing import Optional

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec

INT_FNS = {"i_exp": 0, "i_sigmoid_grid": 1, "isqrt": 2, "floor_div": 3}


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs a CUDA device function; its plain "
                         f"version is the torch op in ops/")


def requant_device(z: torch.Tensor, m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """qasr_requant(z[i], m[i], e[i]) for 1-D int32 CUDA tensors."""
    _require_cuda("requant_device", z)
    n = z.shape[0]
    for name, t in (("z", z), ("m", m), ("e", e)):
        check_vec("requant_device", name, t, torch.int32, (n,), z.device)
    out = torch.empty_like(z)
    rc = _build.library().qasr_requant_check(
        _build.ptr(z), _build.ptr(m), _build.ptr(e), _build.ptr(out), n,
        _build.stream_of(z))
    _build.check(rc, "requant_device")
    return out


def int_fn_device(fn: str, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conformer_int.cuh function elementwise over 1-D int32 CUDA
    tensors: i_exp(a), i_sigmoid_grid(a), isqrt(a) or floor_div(a, b)."""
    _require_cuda("int_fn_device", a)
    n = a.shape[0]
    check_vec("int_fn_device", "a", a, torch.int32, (n,), a.device)
    if fn == "floor_div":
        if b is None:
            raise ValueError("int_fn_device: floor_div needs b")
        check_vec("int_fn_device", "b", b, torch.int32, (n,), a.device)
    out = torch.empty_like(a)
    rc = _build.library().qasr_int_fn_check(
        INT_FNS[fn], _build.ptr(a), _build.ptr(b), _build.ptr(out), n, _build.stream_of(a))
    _build.check(rc, f"int_fn_device({fn})")
    return out


def ln_core_device(x: torch.Tensor) -> torch.Tensor:
    """The device i-LN row core (qasr_ln_row) over the rows of a 2-D int8
    CUDA tensor (d a multiple of 32, at most 512) -> int32."""
    _require_cuda("ln_core_device", x)
    rows, d = x.shape
    check_vec("ln_core_device", "x", x, torch.int8, (rows, d), x.device)
    out = torch.empty((rows, d), dtype=torch.int32, device=x.device)
    rc = _build.library().qasr_ln_check(_build.ptr(x), _build.ptr(out), rows, d,
                                        _build.stream_of(x))
    _build.check(rc, "ln_core_device")
    return out
