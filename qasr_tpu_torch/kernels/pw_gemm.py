"""Kernel 2: pointwise int8 GEMM with an input-requant prologue and a
requant, join or no epilogue (kernels/csrc/pw_gemm.cu, on the int8
wgmma / TMA mainloop of kernels/csrc/gemm_s8.cuh).

Replaces qasr_tpu/kernels/cm_fused.py::fused_pw_cm and fused_pw_join_cm,
and qasr_tpu/kernels/pw_matmul.py::requant_pointwise_matmul.
``pw_gemm`` launches the CUDA kernel for CUDA tensors and runs
``pw_gemm_plain`` for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, epilogue_bounds
from qasr_tpu_torch.kernels.dw_conv import check_prologue, prologue_args, prologue_plain
from qasr_tpu_torch.ops.quant_prims import (
    dyadic_requant_static,
    requant_clamp,
    requant_epilogue,
)

MODE_NONE, MODE_REQUANT, MODE_JOIN = 0, 1, 2

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
CHUNK = 128          # bytes of K per TMA box (the 128B swizzle's row)
STAGES = 2           # the weight ring's stages
ALIGN = 1024         # slack to align the shared-memory base to the swizzle's repeat


def plan(cin: int, cout: int) -> dict:
    """Kernel 2's tiles for one launch, as csrc/pw_gemm.cu computes them.

    A block (one consumer warpgroup and a producer warp) keeps its ``bm`` =
    64 rows of A (``nk`` chunks of 128 bytes of K) resident and walks every
    ``bn``-column tile of Cout, the weights streaming through a ring of
    ``stages``.  ``smem`` is its dynamic shared memory: the A tile, the
    ring, the int32 staging tile (rows of 4 * bn + 32 bytes), the
    mbarriers, the two row masks and the alignment slack."""
    bm, bn, nk = 64, (32 if cout <= 32 else 64), -(-cin // CHUNK)
    smem = (bm * CHUNK * nk + STAGES * bn * CHUNK + bm * (4 * bn + 32)
            + 8 * (2 * STAGES + 1) + 2 * bm + ALIGN)
    return {"bm": bm, "bn": bn, "stages": STAGES, "nk": nk, "smem": smem}


def check_launch(n_rows: int, cin: int, cout: int, pro: bool, x_dtype: torch.dtype) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not take:
    TMA needs a row pitch of Cin bytes that is a multiple of 16 (x int8
    without the prologue, wt always), and the plan's shared memory must fit
    a block."""
    if n_rows < 1 or cout < 1:
        raise ValueError(f"pw_gemm: empty input or output (N={n_rows}, Cout={cout})")
    if cin < 16 or cin % 16:
        raise ValueError(f"pw_gemm: Cin must be a positive multiple of 16 (TMA row pitch), "
                         f"got {cin}")
    if not pro and x_dtype != torch.int8:
        raise ValueError(f"pw_gemm: without the prologue x must be int8, got {x_dtype}")
    p = plan(cin, cout)
    if p["smem"] > SMEM_LIMIT:
        raise ValueError(f"pw_gemm: Cin={cin} Cout={cout} needs {p['smem']} bytes of shared "
                         f"memory, above {SMEM_LIMIT}")
    return p


def k_pieces(cin: int, cout: int) -> List[Tuple[int, int]]:
    """(start, stop) of the contraction pieces a no-epilogue launch takes
    Cin (a multiple of 16) in: Cin whole where ``plan`` fits a block's
    shared memory (Cin up to 23 chunks of 128 bytes, 2,944), else the
    fewest pieces of whole 128-byte chunks that fit, as even as the
    chunks allow (the Conformer's pre_out, 4,864 = 2 x 2,432).  Their int32
    products add up exactly: integer adds commute, and freeze bounds keep
    the accumulator below 2^31."""
    nk = -(-cin // CHUNK)
    n = 1
    while plan(-(-nk // n) * CHUNK, cout)["smem"] > SMEM_LIMIT:
        n += 1
    per = -(-nk // n) * CHUNK
    return [(a, min(a + per, cin)) for a in range(0, cin, per)]


def int_matmul(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Exact x2 (N, Cin) int8 @ wt (Cout, Cin)^T -> int32, never through a
    float32 GEMM (exact only below 2^24).  CPU: int32 matmul.  CUDA:
    torch._int_mm where its shape rules allow, else float64 (exact: freeze
    bounds every accumulator below 2^31 < 2^53)."""
    if x2.device.type == "cpu":
        return x2.to(torch.int32) @ wt.to(torch.int32).t()
    n, k = x2.shape
    cout = wt.shape[0]
    if n > 16 and k >= 16 and k % 8 == 0 and cout >= 16 and cout % 8 == 0:
        return torch._int_mm(x2, wt.t())
    return (x2.to(torch.float64) @ wt.to(torch.float64).t()).to(torch.int32)


def pad_k(x: torch.Tensor, wt: torch.Tensor, in_bias, m1):
    """Zero-pad the contraction (Cin) of x, wt and the prologue's
    per-channel in_bias / m1 up to a multiple of 16, the TMA row pitch
    Kernel 2 needs.  Exact: a padded channel holds 0 (its requant too), and
    its weights are 0."""
    pad = (-x.shape[2]) % 16
    if isinstance(in_bias, torch.Tensor):
        in_bias = F.pad(in_bias, (0, pad))
    if isinstance(m1, torch.Tensor) and m1.dim() > 0:
        m1 = F.pad(m1, (0, pad))
    return F.pad(x, (0, pad)), F.pad(wt, (0, pad)), in_bias, m1


def _mode(m, res) -> int:
    if res is not None:
        return MODE_JOIN
    return MODE_NONE if m is None else MODE_REQUANT


def pw_gemm_plain(x: torch.Tensor, wt: torch.Tensor, *,
                  bias: Optional[torch.Tensor] = None, relu: bool = False,
                  lens: Optional[torch.Tensor] = None, m=None,
                  e: Optional[int] = None, bits: Optional[int] = None,
                  res: Optional[torch.Tensor] = None, m_r=None,
                  e_r: Optional[int] = None, in_bias: Optional[torch.Tensor] = None,
                  in_relu: bool = False, in_len: Optional[torch.Tensor] = None,
                  m1=None, e1: Optional[int] = None,
                  bits1: Optional[int] = None) -> torch.Tensor:
    """Plain torch version: the prologue on the whole input, integer
    matmul, then the epilogue.  Same arguments and result as ``pw_gemm``."""
    if m1 is not None:
        x = prologue_plain(x, in_bias=in_bias, in_relu=in_relu, in_len=in_len, m1=m1,
                           e1=e1, bits1=bits1)
    b, t, cin = x.shape
    acc = int_matmul(x.reshape(b * t, cin), wt).reshape(b, t, wt.shape[0])
    mode = _mode(m, res)
    if mode == MODE_NONE:
        if bias is not None:
            acc = acc + bias
        return acc.clamp_min(0) if relu else acc
    if mode == MODE_REQUANT:
        return requant_epilogue(acc, bias=bias, relu=relu, lens=lens, m=m,
                                e=e, bits=bits)
    if bias is not None:
        acc = acc + bias
    q = dyadic_requant_static(acc, m, e) + dyadic_requant_static(res, m_r, e_r)
    return requant_clamp(q, bits).to(torch.int8)


def pw_gemm(x: torch.Tensor, wt: torch.Tensor, *,
            bias: Optional[torch.Tensor] = None, relu: bool = False,
            lens: Optional[torch.Tensor] = None, m=None,
            e: Optional[int] = None, bits: Optional[int] = None,
            res: Optional[torch.Tensor] = None, m_r=None,
            e_r: Optional[int] = None, in_bias: Optional[torch.Tensor] = None,
            in_relu: bool = False, in_len: Optional[torch.Tensor] = None,
            m1=None, e1: Optional[int] = None,
            bits1: Optional[int] = None) -> torch.Tensor:
    """Pointwise conv of x (B, T, Cin) with wt (Cout, Cin) int8.

    Cin need not be a multiple of 16: the wrapper zero-pads it (``pad_k``);
    without prologue and epilogue a Cin above what a block's shared memory
    holds runs as ``k_pieces`` launches whose int32 products are added.
    Prologue off (``m1`` None): x is int8.  Prologue on: x is int8 or int32
    and its rows are first ``clamp(requant(mask(relu?(x + in_bias)), m1,
    e1), bits1)``, m1 a (Cin,) int32 vector or a scalar, the mask zeroing frames
    t >= in_len[b] (in_len None: no mask), before they reach the GEMM.

    none    (m None, res None): (B, T, Cout) int32 ``relu?(x @ wt.T + bias)``;
    requant (m given):          int8 ``clamp(requant(mask(relu?(acc + bias)),
                                m, e), bits)``, mask: frame t >= lens[b];
    join    (res given):        int8 ``clamp(requant(acc + bias, m, e) +
                                requant(res, m_r, e_r), bits)``, res
                                (B, T, Cout) int32; no ReLU, no mask.
    """
    mode = _mode(m, res)
    if mode == MODE_JOIN and (relu or m is None):
        raise ValueError("pw_gemm: join takes m and no relu")
    prologue_args("pw_gemm", in_bias, in_relu, in_len, m1)
    if x.device.type == "cpu":
        return pw_gemm_plain(x, wt, bias=bias, relu=relu, lens=lens, m=m, e=e,
                             bits=bits, res=res, m_r=m_r, e_r=e_r, in_bias=in_bias,
                             in_relu=in_relu, in_len=in_len, m1=m1, e1=e1, bits1=bits1)
    if x.device.type != "cuda":
        raise ValueError(f"pw_gemm: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"pw_gemm: x must be (B, T, Cin), got {tuple(x.shape)}")
    if x.shape[2] % 16:
        x, wt, in_bias, m1 = pad_k(x, wt, in_bias, m1)
    b, t, cin = x.shape
    pro, m1v, m1s, _, ee1, lo1, hi1 = check_prologue("pw_gemm", x, in_bias, in_len, m1, e1,
                                                  bits1, cin, b)
    cout = wt.shape[0]
    pieces = k_pieces(cin, cout) if mode == MODE_NONE and not pro else [(0, cin)]
    if len(pieces) > 1:
        acc = sum(pw_gemm(x[..., a:z].contiguous(), wt[:, a:z].contiguous())
                  for a, z in pieces)
        if bias is not None:
            acc = acc + bias
        return acc.clamp_min(0) if relu else acc
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("pw_gemm: x and wt must be 16-byte aligned")
    check_launch(b * t, cin, cout, bool(pro), x.dtype)
    dev = x.device
    check_vec("pw_gemm", "wt", wt, torch.int8, (cout, cin), dev)
    check_vec("pw_gemm", "bias", bias, torch.int32, (cout,), dev)
    lo = hi = ee = ee_r = 0
    if mode != MODE_NONE:
        check_vec("pw_gemm", "m", m, torch.int32, (cout,), dev)
        lo, hi, ee = epilogue_bounds("pw_gemm", e, bits)
    if mode == MODE_REQUANT:
        check_vec("pw_gemm", "lens", lens, torch.int32, (b,), dev)
    else:
        lens = None  # only the requant epilogue masks rows
    if mode == MODE_JOIN:
        check_vec("pw_gemm", "res", res, torch.int32, (b, t, cout), dev)
        check_vec("pw_gemm", "m_r", m_r, torch.int32, (cout,), dev)
        _, _, ee_r = epilogue_bounds("pw_gemm", e_r, bits)
    out = torch.empty((b, t, cout),
                      dtype=torch.int32 if mode == MODE_NONE else torch.int8,
                      device=dev)
    lib = _build.library()
    rc = lib.qasr_pw_gemm(
        _build.ptr(x), _build.ptr(wt), _build.ptr(bias), _build.ptr(m),
        _build.ptr(lens), _build.ptr(res), _build.ptr(m_r), _build.ptr(out),
        b * t, cin, cout, t, mode, int(relu), ee, ee_r, lo, hi, pro,
        int(x.dtype == torch.int32), _build.ptr(in_bias), int(in_relu), _build.ptr(in_len),
        _build.ptr(m1v), m1s, ee1, lo1, hi1, _build.stream_of(x))
    _build.check(rc, "pw_gemm")
    pw_gemm.launches += 1
    return out


pw_gemm.launches = 0
