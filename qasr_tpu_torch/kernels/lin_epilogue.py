"""Kernel 5: an int8 linear of the frozen Conformer with a requant, residual
join or i-swish epilogue (kernels/csrc/lin_epilogue.cu, on the int8
wgmma / TMA mainloop of kernels/csrc/gemm_s8.cuh).

Replaces qasr_tpu/kernels/gemm_fused.py::fused_lin_rq, fused_lin_join and
fused_lin_swish.  Under the fused plans (``quantize.conformer_freeze.
ConformerPlan(fused=True)``) every linear outside Kernels 4 and 6 runs
here: the pre projection, the q_u / q_v / k / v / pos projections, and,
when the FFN halves are not in Kernel 6, their l1 (swish) and l2 (join)
GEMMs.  The int32 accumulator stays in registers.

``lin_epilogue`` launches the CUDA kernel for CUDA tensors and runs
``lin_epilogue_plain`` (the ``_lin_rq`` / ``_join_lin`` / ``_ffn_mid``
compositions of quantize/conformer_int.py) for CPU tensors; it never falls
back from one to the other.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, check_x, static_pair
from qasr_tpu_torch.quantize.conformer_int import _ffn_mid, _join_lin, _lin_rq

MODE_RQ, MODE_JOIN, MODE_SWISH = 0, 1, 2

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
CHUNK = 128          # bytes of K per TMA box (the 128B swizzle's row)
BM, BN = 64, 128     # output tile: one consumer warpgroup x 128 columns
MAX_STAGES = 3
ALIGN = 1024         # slack to align the shared-memory base to the swizzle's repeat


def plan(n_rows: int, k: int, d: int) -> dict:
    """Kernel 5's tiles for one launch, as csrc/lin_epilogue.cu computes
    them: 64 x 128 output tiles (``grid`` blocks), x and the weights
    streaming through a ring of ``stages`` chunks of 128 bytes of K
    (``nk`` chunks), and the dynamic shared memory ``smem``: the ring or,
    after the products, the int32 staging tile in its place (rows of 4 *
    128 + 32 bytes), the swish table, the mbarriers and the alignment
    slack."""
    nk = -(-k // CHUNK)
    stages = min(nk, MAX_STAGES)
    ring = max(stages * (BM + BN) * CHUNK, BM * (4 * BN + 32))
    smem = ring + 256 + 8 * 2 * stages + ALIGN
    return {"bm": BM, "bn": BN, "stages": stages, "nk": nk, "smem": smem,
            "grid": (-(-n_rows // BM), -(-d // BN))}


def check_launch(n_rows: int, k: int, d: int) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not
    take: K a positive multiple of 16 (the TMA row pitch), at least one row
    and column, shared memory within a block's."""
    if n_rows < 1 or d < 1 or k < 16 or k % 16:
        raise ValueError(f"lin_epilogue: needs N >= 1, D >= 1 and K a positive multiple of 16 "
                         f"(TMA row pitch), got N={n_rows} K={k} D={d}")
    p = plan(n_rows, k, d)
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"lin_epilogue: {p['smem']} bytes of shared memory, above {SMEM_LIMIT}")
    return p

Pair = Tuple[int, int]


def lin_epilogue_plain(x8: torch.Tensor, lin, *, nbits: int,
                       stream8: Optional[torch.Tensor] = None,
                       stream_rq: Optional[Pair] = None,
                       swish: Optional[Tuple[Pair, Pair]] = None) -> torch.Tensor:
    """Plain torch version.  Same arguments and result as ``lin_epilogue``."""
    if swish is not None:
        return _ffn_mid(x8, lin, swish[0], swish[1], nbits)
    if stream8 is not None:
        return _join_lin(x8, lin, stream8, stream_rq, nbits)
    return _lin_rq(x8, lin, nbits)


def lin_epilogue(x8: torch.Tensor, lin, *, nbits: int,
                 stream8: Optional[torch.Tensor] = None,
                 stream_rq: Optional[Pair] = None,
                 swish: Optional[Tuple[Pair, Pair]] = None) -> torch.Tensor:
    """x8 (..., K) int8 through the linear site ``lin`` = {"wt" (D, K) int8,
    optional "b" (D,) int32, "m" (D,) int32, "e" int} -> (..., D)
    int8, clamp [-n, n-1] with n = 2^(nbits-1) - 1:

    rq    (default):      clamp(rq(x8 @ wt.T + b, m, e));
    join  (stream8 given): clamp(rq(x8 @ wt.T + b, m, e) + rq(stream8,
                          stream_rq)), stream8 (..., D) int8;
    swish (swish=(grid, prod)): a8 = clamp(rq(x8 @ wt.T + b, m, e)), then
                          clamp(rq(a8 * i_sigmoid(rq(a8, grid)), prod)).
    """
    if stream8 is not None and swish is not None:
        raise ValueError("lin_epilogue: join and swish are exclusive")
    if x8.device.type == "cpu":
        return lin_epilogue_plain(x8, lin, nbits=nbits, stream8=stream8,
                                  stream_rq=stream_rq, swish=swish)
    if x8.device.type != "cuda":
        raise ValueError(f"lin_epilogue: unsupported device {x8.device}")
    check_x("lin_epilogue x8", x8, x8.dim())
    wt = lin["wt"]
    d, k = wt.shape
    lead = tuple(x8.shape[:-1])
    n = math.prod(lead)
    dev = x8.device
    if x8.shape[-1] != k or x8.data_ptr() % 16 or wt.data_ptr() % 16 \
            or not 2 <= nbits <= 8:
        raise ValueError(f"lin_epilogue: needs x8 (..., K) with K = wt's {k}, 16-byte "
                         f"aligned x8 and wt, and nbits in [2, 8] (got x8 "
                         f"{tuple(x8.shape)}, nbits {nbits})")
    check_launch(n, k, d)
    check_vec("lin_epilogue", "wt", wt, torch.int8, (d, k), dev)
    bias = lin.get("b")
    check_vec("lin_epilogue", "b", bias, torch.int32, (d,), dev)
    m = lin["m"]
    check_vec("lin_epilogue", "m", m, torch.int32, (d,), dev)
    e = lin["e"]
    if not (isinstance(e, int) and e >= 1):
        raise ValueError(f"lin_epilogue: e must be a static int >= 1, got {e!r}")
    mode, m2, e2, m3, e3 = MODE_RQ, 0, 1, 0, 1
    if stream8 is not None:
        mode = MODE_JOIN
        check_vec("lin_epilogue", "stream8", stream8, torch.int8, lead + (d,), dev)
        m2, e2 = static_pair("lin_epilogue", "stream_rq", stream_rq)
    elif swish is not None:
        mode = MODE_SWISH
        m2, e2 = static_pair("lin_epilogue", "grid", swish[0])
        m3, e3 = static_pair("lin_epilogue", "prod", swish[1])
    out = torch.empty(lead + (d,), dtype=torch.int8, device=dev)
    rc = _build.library().qasr_lin_epilogue(
        _build.ptr(x8), _build.ptr(wt), _build.ptr(bias), _build.ptr(m),
        _build.ptr(stream8), _build.ptr(out), n, k, d, mode, e, m2, e2, m3, e3,
        2 ** (nbits - 1) - 1, _build.stream_of(x8))
    _build.check(rc, "lin_epilogue")
    lin_epilogue.launches += 1
    return out


lin_epilogue.launches = 0
