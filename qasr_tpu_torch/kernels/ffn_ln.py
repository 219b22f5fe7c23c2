"""Kernel 6: one frozen Conformer FFN half-step with the next sublayer's
i-LayerNorm as an optional tail (kernels/csrc/ffn_ln.cu).

Replaces qasr_tpu/kernels/conf_module.py::fused_ffn_ln.  The TPU runs one
grid step per utterance; on the H100 that would fill 32 of 132 SMs, and
every row's LayerNorm needs only its own d values, so the kernel tiles the
flattened (B*T, d) stream in blocks of 32 rows, one launch per call:
i-LayerNorm -> affine requant -> l1 GEMM -> requant -> i-swish (the (64,
ff*d) int8 activation kept in shared memory) -> l2 GEMM -> stream join ->
[tail i-LayerNorm -> affine requant].  The weights stream through shared
memory in 64-row chunks.  No length mask: rows past a length are computed
as any other row, as in the TPU kernel and the XLA composition.

``ffn_ln`` launches the CUDA kernel for CUDA tensors and runs
``ffn_ln_plain`` (the XLA composition of qasr_tpu/quantize/
conformer_freeze.py, in torch) for CPU tensors; it never falls back from
one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, check_x, static_pair
from qasr_tpu_torch.quantize.conformer_int import _ffn_mid, _join_lin, _ln_rq

ROWS, COLS = 32, 64  # rows per block, columns per GEMM chunk (csrc/ffn_ln.cu)
MAX_D = 512
SMEM_LIMIT = 232448


def smem_bytes(d: int, f: int) -> int:
    """Dynamic shared memory of one block (csrc/ffn_ln.cu's layout): the
    weight stage, the LN output, the swish activation, the stream tile,
    the tabulated i-swish."""
    return 4 * (COLS * (256 // 4 + 4) + ROWS * ((d // 4 + 4) + (f // 4 + 4))) + ROWS * d + 256


def ffn_ln_plain(x8: torch.Tensor, ln, l1, grid, prod, l2, stream_rq, tail=None, *,
                 nbits: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain torch version: i-LN -> ln affine requant -> ``_ffn_mid`` ->
    ``_join_lin`` [-> tail i-LN].  Same arguments and result as ``ffn_ln``."""
    x = _join_lin(_ffn_mid(_ln_rq(x8, ln, nbits), l1, grid, prod, nbits), l2, x8,
                  stream_rq, nbits)
    return x, (None if tail is None else _ln_rq(x, tail, nbits))


def _rows(tbl, names, key: str) -> torch.Tensor:
    """The site's per-channel vectors stacked as the kernel reads them
    (int32 rows), built once and cached in the table under ``key``."""
    if key not in tbl:
        tbl[key] = torch.stack([tbl[n] for n in names]).to(torch.int32).contiguous()
    return tbl[key]


def ln_rows(tbl) -> torch.Tensor:
    """(3, d): sgn, b, m of an affine (i-LN gamma/beta) site."""
    return _rows(tbl, ("sgn", "b", "m"), "_ln3")


def bm_rows(tbl) -> torch.Tensor:
    """(2, dout): b, m of a linear site."""
    return _rows(tbl, ("b", "m"), "_bm")


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
    w1, w2 = l1["wt"], l2["wt"]
    check_vec("ffn_ln", "l1 wt", w1, torch.int8, (f, d), dev)
    check_vec("ffn_ln", "l2 wt", w2, torch.int8, (d, f), dev)
    if w1.data_ptr() % 16 or w2.data_ptr() % 16:
        raise ValueError("ffn_ln: weights must be 16-byte aligned")
    ln3, bm1, bm2 = ln_rows(ln), bm_rows(l1), bm_rows(l2)
    tail3 = None if tail is None else ln_rows(tail)
    for name, v, shape in (("ln", ln3, (3, d)), ("l1", bm1, (2, f)), ("l2", bm2, (2, d)),
                           ("tail", tail3, (3, d))):
        check_vec("ffn_ln", name, v, torch.int32, shape, dev)
    scalars = [ln["e"], l1["e"], l2["e"]] + ([tail["e"]] if tail is not None else [])
    if not all(isinstance(e, int) and e >= 1 for e in scalars):
        raise ValueError(f"ffn_ln: site exponents must be static ints >= 1, got {scalars}")
    gm, ge = static_pair("ffn_ln", "grid", grid)
    pm, pe = static_pair("ffn_ln", "prod", prod)
    jm, je = static_pair("ffn_ln", "stream_rq", stream_rq)
    out = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    tail8 = None if tail is None else torch.empty((b, t, d), dtype=torch.int8, device=dev)
    rc = _build.library().qasr_ffn_ln(
        _build.ptr(x8), _build.ptr(w1), _build.ptr(bm1), _build.ptr(w2), _build.ptr(bm2),
        _build.ptr(ln3), _build.ptr(tail3), _build.ptr(out), _build.ptr(tail8),
        b * t, d, f, ln["e"], l1["e"], gm, ge, pm, pe, l2["e"], jm, je,
        tail["e"] if tail is not None else 0, 2 ** (nbits - 1) - 1, _build.stream_of(x8))
    _build.check(rc, "ffn_ln")
    ffn_ln.launches += 1
    return out, tail8


ffn_ln.launches = 0
