"""Kernel 6: one frozen Conformer FFN half-step with the next sublayer's
i-LayerNorm as an optional tail (kernels/csrc/ffn_ln.cu).

Replaces qasr_tpu/kernels/conf_module.py::fused_ffn_ln.  The TPU runs one
grid step per utterance; on the H100 that would fill 32 of 132 SMs, and
every row's LayerNorm needs only its own d values, so the kernel tiles the
flattened (B*T, d) stream in blocks of ``ROWS`` = 32 rows, one launch per
call: i-LayerNorm -> affine requant -> l1 GEMM -> requant -> i-swish (the
block's (32, f) int8 activation kept in shared memory) -> l2 GEMM ->
stream join -> [tail i-LayerNorm -> affine requant].  No length mask:
rows past a length are computed as any other row, as in the TPU kernel
and the XLA composition.

What the host prepares, once per site table and cached in it:
- the weights as the tile sequence the kernel consumes (``pack_tiles``);
- each site's per-column vectors stacked as int32 rows, and its requant
  scales m 2^-e in float64 where ``checks.f64_fits`` proves the FP64
  requant exact for every int8 input (``site_f64``; else the kernel runs
  that site's requants as qasr_rq);
- the i-swish (``swish_lut``) and the join's stream requant
  (``stream_table``) as 256-entry tables.

``ffn_ln`` launches the CUDA kernel for CUDA tensors and runs
``ffn_ln_plain`` (the XLA composition of qasr_tpu/quantize/
conformer_freeze.py, in torch) for CPU tensors; it never falls back from
one to the other.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    affine_zmax,
    check_vec,
    check_x,
    f64_fits,
    f64_scale,
    static_pair,
    weight_zmax,
)
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.quantize.conformer_int import _ffn_mid, _join_lin, _ln_rq, swish_lut

# csrc/ffn_ln.cu: rows per block, weight rows per tile (the output columns
# of a GEMM chunk), bytes of K per tile, stages of the weight ring
ROWS, COLS, KT, STAGES = 32, 128, 64, 3
MAX_D = 512
SMEM_LIMIT = 232448


def smem_bytes(d: int, f: int) -> int:
    """Dynamic shared memory of one block (csrc/ffn_ln.cu's layout): the
    weight stages, the x / out tile (rows of d bytes, swizzled), the LN
    output (rows of d + 16 bytes), the swish activation (rows of f + 16),
    the stream table, the swish table, the stages' mbarriers."""
    return (STAGES * COLS * KT + ROWS * (2 * d + 16) + ROWS * (f + 16) + 4 * 256 + 256
            + 2 * STAGES * 8)


def ffn_ln_plain(x8: torch.Tensor, ln, l1, grid, prod, l2, stream_rq, tail=None, *,
                 nbits: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version: i-LN -> ln affine requant -> ``_ffn_mid`` ->
    ``_join_lin`` [-> tail i-LN].  Same arguments and result as ``ffn_ln``."""
    x = _join_lin(_ffn_mid(_ln_rq(x8, ln, nbits), l1, grid, prod, nbits), l2, x8,
                  stream_rq, nbits)
    return x, (None if tail is None else _ln_rq(x, tail, nbits))


def pack_tiles(wt: torch.Tensor) -> torch.Tensor:
    """A (nout, K) int8 weight (nout, K multiples of 64) as the kernel's
    tile sequence, flat int8: chunks of COLS rows (the last may hold 64),
    each as K // KT tiles of rows x KT bytes (tile (c, k) at byte c COLS K
    + k rows KT), the 16-byte unit u of row r stored at unit u ^ ((r >> 1)
    & 3), so that the eight rows one ldmatrix reads at one unit fall on
    distinct bank groups."""
    nout, k = wt.shape
    parts = []
    for c0 in range(0, nout, COLS):
        rows = min(COLS, nout - c0)
        blk = wt[c0:c0 + rows].reshape(rows, k // KT, KT // 16, 16).permute(1, 0, 2, 3)
        r = torch.arange(rows, device=wt.device)[:, None]
        src = torch.arange(KT // 16, device=wt.device)[None, :] ^ ((r >> 1) & 3)
        parts.append(blk[:, r, src].reshape(-1))
    return torch.cat(parts).contiguous()


def site_f64(site, zmax: torch.Tensor) -> Optional[torch.Tensor]:
    """The site's m 2^-e per column (float64) when ``f64_fits`` proves
    qasr_rq_f64 exact over |z| <= zmax, else None (the kernel then runs the
    site's requants as qasr_rq)."""
    return f64_scale(site["m"], site["e"]).contiguous() if f64_fits(zmax, site["m"], site["e"]) \
        else None


def _packed(site) -> Dict[str, Any]:
    """The kernel's form of one site, built once and cached in its table:
    "rows" the int32 vectors (sgn, b, m of an i-LN affine site; b, m of a
    linear one, which has weights), "mf" its FP64 scales or None, and for
    a linear site its weight tiles and the tables keyed by their requants."""
    if "_ffn_ln" not in site:
        if "wt" not in site:
            rows = torch.stack([site["sgn"], site["b"], site["m"]])
            p = {"mf": site_f64(site, affine_zmax(site))}
        else:
            rows = torch.stack([site["b"], site["m"]])
            p = {"mf": site_f64(site, weight_zmax(site)), "tiles": pack_tiles(site["wt"]),
                 "tables": {}}
        p["rows"] = rows.to(torch.int32).contiguous()
        site["_ffn_ln"] = p
    return site["_ffn_ln"]


def stream_table(stream_rq, device) -> torch.Tensor:
    """The join's stream requant of every int8 x as int32, at x + 128."""
    x = torch.arange(-128, 128, dtype=torch.int32, device=device)
    return dyadic_requant_static(x, stream_rq[0], stream_rq[1]).to(torch.int32).contiguous()


def _table(p, key, make) -> torch.Tensor:
    if key not in p["tables"]:
        p["tables"][key] = make()
    return p["tables"][key]


def ffn_ln(x8: torch.Tensor, ln, l1, grid, prod, l2, stream_rq, tail=None, *,
           nbits: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One FFN half-step on the int8 stream x8 (B, T, d): ln the i-LN affine
    site, l1 / l2 the linear sites (d -> f -> d), grid / prod the i-swish
    requants, stream_rq the join's stream requant, tail the next
    sublayer's i-LN affine site or None.  Returns (the joined stream,
    its tail or None), both (B, T, d) int8."""
    if x8.device.type == "cpu":
        return ffn_ln_plain(x8, ln, l1, grid, prod, l2, stream_rq, tail, nbits=nbits)
    if x8.device.type != "cuda":
        raise ValueError(f"ffn_ln: unsupported device {x8.device}")
    check_x("ffn_ln x8", x8, 3)
    b, t, d = x8.shape
    f = l1["wt"].shape[0]
    dev = x8.device
    if b * t == 0 or d % 64 or d > MAX_D or f % 64 or smem_bytes(d, f) > SMEM_LIMIT \
            or not 2 <= nbits <= 8 or x8.data_ptr() % 16:
        raise ValueError(f"ffn_ln: needs B*T > 0, d a multiple of 64 up to {MAX_D}, "
                         f"f a multiple of 64 within {SMEM_LIMIT} bytes of shared "
                         f"memory, nbits in [2, 8] and an aligned x8 (got B={b} T={t} "
                         f"d={d} f={f} nbits={nbits})")
    check_vec("ffn_ln", "l1 wt", l1["wt"], torch.int8, (f, d), dev)
    check_vec("ffn_ln", "l2 wt", l2["wt"], torch.int8, (d, f), dev)
    scalars = [ln["e"], l1["e"], l2["e"]] + ([tail["e"]] if tail is not None else [])
    if not all(isinstance(e, int) and e >= 1 for e in scalars):
        raise ValueError(f"ffn_ln: site exponents must be static ints >= 1, got {scalars}")
    gm, ge = static_pair("ffn_ln", "grid", grid)
    pm, pe = static_pair("ffn_ln", "prod", prod)
    jm, je = static_pair("ffn_ln", "stream_rq", stream_rq)
    p_ln, p1, p2 = _packed(ln), _packed(l1), _packed(l2)
    p_t = None if tail is None else _packed(tail)
    for name, p, n in (("ln", p_ln, d), ("l1", p1, f), ("l2", p2, d), ("tail", p_t, d)):
        if p is None:
            continue
        check_vec("ffn_ln", f"{name} rows", p["rows"], torch.int32, (3 if name in ("ln", "tail")
                                                                      else 2, n), dev)
        check_vec("ffn_ln", f"{name} mf", p["mf"], torch.float64, (n,), dev)
    check_vec("ffn_ln", "l1 tiles", p1["tiles"], torch.int8, (f * d,), dev)
    check_vec("ffn_ln", "l2 tiles", p2["tiles"], torch.int8, (d * f,), dev)
    if p1["tiles"].data_ptr() % 16 or p2["tiles"].data_ptr() % 16:
        raise ValueError("ffn_ln: weight tiles must be 16-byte aligned")
    swish = _table(p1, ("swish", gm, ge, pm, pe, nbits),
                   lambda: swish_lut((gm, ge), (pm, pe), nbits, dev))
    stab = _table(p2, ("stream", jm, je), lambda: stream_table((jm, je), dev))
    out = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    tail8 = None if tail is None else torch.empty((b, t, d), dtype=torch.int8, device=dev)
    ptr = _build.ptr
    rc = _build.library().qasr_ffn_ln(
        ptr(x8), ptr(p1["tiles"]), ptr(p2["tiles"]), ptr(p_ln["rows"]), ptr(p_ln["mf"]),
        ptr(p1["rows"]), ptr(p1["mf"]), ptr(p2["rows"]), ptr(p2["mf"]),
        ptr(None if p_t is None else p_t["rows"]), ptr(None if p_t is None else p_t["mf"]),
        ptr(swish), ptr(stab), ptr(out), ptr(tail8), b * t, d, f, ln["e"], l1["e"], l2["e"],
        tail["e"] if tail is not None else 0, 2 ** (nbits - 1) - 1, _build.stream_of(x8))
    _build.check(rc, "ffn_ln")
    ffn_ln.launches += 1
    return out, tail8


ffn_ln.launches = 0
