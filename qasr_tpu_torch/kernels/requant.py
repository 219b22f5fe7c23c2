"""Kernel 7, the requant kernel (``requant``, kernels/csrc/requant.cu), and
elementwise and row-wise launches of the kernels' shared device functions
(kernels/csrc/requant.cuh via requant_check.cu, conformer_int.cuh via
conformer_int_check.cu), used to hold each against its plain torch
version on the card; those check launches are not on the serving path.

``requant`` launches its CUDA kernel for CUDA tensors and runs
``requant_plain`` for CPU tensors; it never falls back from one to the
other.  ``plan`` states its grid, ``check_launch`` the shapes it takes."""
from __future__ import annotations

from typing import Optional

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    cap_operand,
    check_act,
    check_vec,
    requant_operand,
    split_planes,
)
from qasr_tpu_torch.models.jasper import mask_values
from qasr_tpu_torch.ops.quant_prims import (
    clip_ceiling,
    code_dtype,
    dyadic_requant_any,
    requant_clamp,
)

INT_FNS = {"i_exp": 0, "i_sigmoid_grid": 1, "isqrt": 2, "floor_div": 3, "i_sigmoid_tab": 4,
           "div": 5, "isqrt_f": 6, "i_exp_tab": 7}


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs a CUDA device function; its plain "
                         f"version is the torch op in ops/")


def requant_device(z: torch.Tensor, m: torch.Tensor, e: torch.Tensor,
                   fast: bool = False, f64: bool = False) -> torch.Tensor:
    """qasr_requant(z[i], m[i], e[i]) for 1-D int32 CUDA tensors, or with
    ``fast`` qasr_rq(z[i], qasr_rq_make(m[i], e[i])), the form Kernels 1
    and 7 use, or with ``f64`` qasr_rq_f64 (Kernel 3's score requants; exact
    where |z| * m < 2^(e + 26), e <= 62)."""
    _require_cuda("requant_device", z)
    n = z.shape[0]
    for name, t in (("z", z), ("m", m), ("e", e)):
        check_vec("requant_device", name, t, torch.int32, (n,), z.device)
    out = torch.empty_like(z)
    rc = _build.library().qasr_requant_check(
        _build.ptr(z), _build.ptr(m), _build.ptr(e), _build.ptr(out), n, 2 if f64 else int(fast),
        _build.stream_of(z))
    _build.check(rc, "requant_device")
    return out


def int_fn_device(fn: str, a: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One conformer_int.cuh function elementwise over 1-D int32 CUDA
    tensors: i_exp(a), i_sigmoid_grid(a), isqrt(a), floor_div(a, b),
    i_sigmoid_tab(a) over the uint8 table b (qasr_i_sigmoid_tab, Kernel 4's
    GLU gate; b from kernels/conv_block.py::sigmoid_table), isqrt_f(a) (the
    float square root corrected, a < 2^30), i_exp_tab(a) (i_exp(a) >> 4 from
    the table of its quadratic, Kernel 3's softmax) or div(a, b)
    (qasr_div, Kernel 3's division by the row sum: a in [0, 2^31), b in
    [1, 2^31), the divisor's constants made per element)."""
    _require_cuda("int_fn_device", a)
    n = a.shape[0]
    check_vec("int_fn_device", "a", a, torch.int32, (n,), a.device)
    if fn in ("floor_div", "div"):
        if b is None:
            raise ValueError(f"int_fn_device: {fn} needs b")
        check_vec("int_fn_device", "b", b, torch.int32, (n,), a.device)
    elif fn == "i_sigmoid_tab":
        from qasr_tpu_torch.kernels.conv_block import SIG_TAB

        check_vec("int_fn_device", "b", b, torch.uint8, (SIG_TAB,), a.device)
    out = torch.empty_like(a)
    rc = _build.library().qasr_int_fn_check(
        INT_FNS[fn], _build.ptr(a), _build.ptr(b), _build.ptr(out), n, _build.stream_of(a))
    _build.check(rc, f"int_fn_device({fn})")
    return out


def ln_core_device(x: torch.Tensor, div: bool = False) -> torch.Tensor:
    """The device i-LN row core (qasr_ln_row, or with ``div`` Kernel 4's
    qasr_ln_row_div) over the rows of a 2-D int8 CUDA tensor (d a multiple
    of 32, at most 512) -> int32."""
    _require_cuda("ln_core_device", x)
    rows, d = x.shape
    check_vec("ln_core_device", "x", x, torch.int8, (rows, d), x.device)
    out = torch.empty((rows, d), dtype=torch.int32, device=x.device)
    rc = _build.library().qasr_ln_check(_build.ptr(x), _build.ptr(out), rows, d, int(div),
                                        _build.stream_of(x))
    _build.check(rc, "ln_core_device")
    return out


# ---------------------------------------------------------------------------
# Kernel 7: the requant kernel (kernels/csrc/requant.cu)
# ---------------------------------------------------------------------------


def requant_plain(z: torch.Tensor, m, e, bits: int, *, relu: bool = False,
                  lens: Optional[torch.Tensor] = None,
                  identity: Optional[torch.Tensor] = None, m_r=None,
                  e_r=None, hcap=None) -> torch.Tensor:
    """Plain torch version: the JAX FrozenExec's input requant (mask, then
    requant + clamp) and residual join.  Same arguments and result as
    ``requant``."""
    v = clip_ceiling(z.clamp_min(0), hcap) if relu else z
    if lens is not None:
        v = mask_values(v, lens)
    q = dyadic_requant_any(v, m, e)
    if identity is not None:
        i = identity if lens is None else mask_values(identity, lens)
        q = q + dyadic_requant_any(i, m_r, e_r)
    return requant_clamp(q, bits).to(out_dtype(z, bits, relu, identity))


def out_dtype(z: torch.Tensor, bits: int, relu: bool, identity) -> torch.dtype:
    """Kernel 7's output storage: int8 up to 8 bits; uint8 for a 9-bit
    requant of a non-negative value (``relu`` set, or a uint8 ``z``, and no
    identity, which may be negative); int32 for any other (``code_dtype``)."""
    return code_dtype(bits, (relu or z.dtype == torch.uint8) and identity is None)


# the C entry's input types: int8, int32, uint8 (a non-negative 9-bit code)
XTYPE = {torch.int8: 0, torch.int32: 1, torch.uint8: 2}
THREADS = 256     # threads per block
GRID_YZ = 65535   # the grid's y (channel-vector blocks) and z (batch) limits


def plan(b: int, t: int, c: int, aligned: bool = True) -> dict:
    """Kernel 7's grid for one launch, as csrc/requant.cu's launcher
    computes it.  A thread owns ``v`` consecutive channels (4; 1, the
    element path, where C is not a multiple of 4 or a tensor does not start
    on a 16-byte boundary) and takes 4 rows of its block's tile, ``rows`` =
    4 * ``block[1]`` rows of one batch element (grid z)."""
    v = 4 if c % 4 == 0 and aligned else 1
    vecs = -(-c // v)
    tx = min(vecs, 32)
    ty = THREADS // tx
    rows = 4 * ty
    return {"v": v, "block": (tx, ty), "rows": rows,
            "grid": (-(-t // rows), -(-vecs // tx), b)}


def check_launch(b: int, t: int, c: int, bits: int) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not
    take: B * T * C at or above 2^31, bits outside [2, 32], a grid beyond
    its y / z limits."""
    if b * t * c >= 2 ** 31:
        raise ValueError("requant: B * T * C must stay below 2^31")
    if not isinstance(bits, int) or not 2 <= bits <= 32:
        raise ValueError(f"requant: bits must be an int in [2, 32], got {bits!r}")
    p = plan(b, t, c)
    if p["grid"][1] > GRID_YZ or p["grid"][2] > GRID_YZ:
        raise ValueError(f"requant: grid {p['grid']} beyond the y / z limit {GRID_YZ}")
    return p


def requant(z: torch.Tensor, m, e, bits: int, *, relu: bool = False,
            lens: Optional[torch.Tensor] = None,
            identity: Optional[torch.Tensor] = None, m_r=None,
            e_r=None, hcap=None, planes: bool = False):
    """Dyadic requant of z (B, T, C) int8/int32 onto ``bits`` bits:

        clamp(requant(mask(relu?(z)), m, e) [+ requant(mask(identity), m_r, e_r)],
              -2^(bits-1), 2^(bits-1)-1)

    ``hcap``: hardtanh's ceiling after the ReLU (relu?(z) reads min(max(z,
    0), hcap)): None, a Python int or a (C,) int32 tensor; needs ``relu``.

    m, e, m_r, e_r are (C,) int32 tensors (per-channel mantissas and
    exponents) or scalars (a Python int or a 0-d array, taken by value);
    the mask zeroes frames t >= lens[b].  z is int8, int32 or uint8 (a
    non-negative 9-bit code).  Returns int8 when bits <= 8, uint8 for a
    9-bit requant of a non-negative value (``relu`` or a uint8 z, no
    identity: the clamp [-256, 255] reads [0, 255]), else int32
    (``out_dtype``).  ``planes``: a 9-bit requant of a value that may be
    negative, no identity, returned as its two uint8 planes (u, s), v = u -
    256 s (``checks.split_planes``), the storage of a signed 9-bit code.
    Replaces qasr_tpu/kernels/requant.py::requant_pallas."""
    if planes and (bits != 9 or relu or identity is not None or z.dtype == torch.uint8):
        raise ValueError("requant: planes are the storage of a signed 9-bit code: bits 9, "
                         "no relu, no identity, a signed z")
    if identity is not None and (m_r is None or e_r is None):
        raise ValueError("requant: identity needs m_r and e_r")
    if hcap is not None and not relu:
        raise ValueError("requant: hcap (hardtanh's ceiling) needs relu")
    if z.device.type == "cpu":
        out = requant_plain(z, m, e, bits, relu=relu, lens=lens, identity=identity,
                            m_r=m_r, e_r=e_r, hcap=hcap)
        return split_planes(out) if planes else out
    if z.device.type != "cuda":
        raise ValueError(f"requant: unsupported device {z.device}")
    check_act("requant", z, 3, u8=True)
    b, t, c = z.shape
    dev = z.device
    check_launch(b, t, c, bits)
    dtype = out_dtype(z, bits, relu, identity)
    n = 2 ** (bits - 1) - 1
    lo, hi = (0, 255) if dtype == torch.uint8 else (-n - 1, n)
    mv, ms = requant_operand("requant", "m", m, c, dev, exponent=False)
    ev, es = requant_operand("requant", "e", e, c, dev, exponent=True)
    mrv = erv = None
    ms_r = es_r = 0
    if identity is not None:
        check_act("requant identity", identity, 3)
        if tuple(identity.shape) != (b, t, c) or identity.device != dev:
            raise ValueError(f"requant: identity must be {(b, t, c)} on {dev}")
        mrv, ms_r = requant_operand("requant", "m_r", m_r, c, dev, exponent=False)
        erv, es_r = requant_operand("requant", "e_r", e_r, c, dev, exponent=True)
    check_vec("requant", "lens", lens, torch.int32, (b,), dev)
    hv, hs = cap_operand("requant", "hcap", hcap, c, dev, relu)
    if planes:
        dtype, lo, hi = torch.uint8, -256, 255
    out = torch.empty((b, t, c), dtype=dtype, device=dev)
    out_s = torch.empty_like(out) if planes else None
    rc = _build.library().qasr_requant_rows(
        _build.ptr(z), XTYPE[z.dtype], _build.ptr(mv), _build.ptr(ev), ms, es,
        _build.ptr(identity),
        int(identity is not None and identity.dtype == torch.int32),
        _build.ptr(mrv), _build.ptr(erv), ms_r, es_r, _build.ptr(lens), _build.ptr(out),
        _build.ptr(out_s), int(dtype == torch.int32), b * t, c, t, int(relu), _build.ptr(hv), hs, lo, hi,
        _build.stream_of(z))
    _build.check(rc, "requant")
    requant.launches += 1
    return (out, out_s) if planes else out


requant.launches = 0
