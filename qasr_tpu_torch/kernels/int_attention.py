"""Kernel 3: integer relative-position attention of the frozen Conformer
(kernels/csrc/int_attention.cu).

Replaces qasr_tpu/kernels/int_attention.py::fused_int_attention.  Per
(batch, head, query tile) the kernel builds the tile's full score rows in
shared memory (content scores q_u.k plus the Toeplitz diagonal of
q_v.pos), requants both onto the i-softmax grid, masks, runs the integer
softmax, multiplies by v and writes the requantized int8 context: the
(T, T) int32 world never reaches device memory.

``int_attention`` launches the CUDA kernel for CUDA tensors and runs
``int_attention_plain`` (the XLA composition of
qasr_tpu/quantize/conformer_freeze.py, in torch) for CPU tensors; it
never falls back from one to the other.
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, check_x
from qasr_tpu_torch.models.conformer import attention_mask
from qasr_tpu_torch.ops.integer_softmax import i_softmax_grid
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.quantize.conformer_int import clip8

# the kernel's tiling (csrc/int_attention.cu): query rows per block, keys
# per chunk, and the shared memory a block may use on Hopper
TQ, KC = 32, 64
SMEM_LIMIT = 232448


def smem_bytes(t: int, d_k: int) -> int:
    """Dynamic shared memory of one block (csrc/int_attention.cu's layout)."""
    tp = -(-t // KC) * KC
    dkw = -(-d_k // 32) * 8 + 4                     # padded row, in words
    return 4 * ((2 * TQ + KC + TQ + KC) * dkw       # Qu, Qv, K chunk, pos window
                + (-(-d_k // 32) * 32) * (KC // 4 + 4)  # V chunk, transposed
                + TQ * (TQ + KC + 1)                # bd of the chunk
                + TQ * (tp + 8)                     # score rows
                + TQ * (tp // 4 + 4))               # int8 probabilities


def bmm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched integer product as int32, exact: int32 matmul on the CPU,
    float64 on the card (every sum here is far below 2^53)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def int_attention_plain(qu8, qv8, k8, v8, p8, lens, *, ac, bd, ctx_rq,
                        left: int, right: int, nbits: int) -> torch.Tensor:
    """Plain torch version: the XLA composition of the frozen Conformer's
    attention core.  Same arguments and result as ``int_attention``."""
    b, t, h, d_k = qu8.shape
    valid = torch.arange(t, device=lens.device)[None, :] < lens[:, None]
    mask = attention_mask(valid, (left, right))
    ac_s = bmm_exact(qu8.permute(0, 2, 1, 3), k8.permute(0, 2, 3, 1))      # (B, h, T, T)
    bd_full = bmm_exact(qv8.permute(0, 2, 1, 3), p8.permute(1, 2, 0)[None])  # (B, h, T, 2T-1)
    ar = torch.arange(t, device=qu8.device)
    idx = (t - 1) + ar[:, None] - ar[None, :]
    bd_s = torch.gather(bd_full, -1, idx.expand(b, h, t, t))
    q_grid = (dyadic_requant_static(ac_s, ac[0], ac[1])
              + dyadic_requant_static(bd_s, bd[0], bd[1]))
    a8 = i_softmax_grid(q_grid, mask[:, None], out_bits=nbits)
    ctx = bmm_exact(a8, v8.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).reshape(b, t, h * d_k)
    return clip8(dyadic_requant_static(ctx, ctx_rq[0], ctx_rq[1]), nbits)


def int_attention(qu8, qv8, k8, v8, p8, lens, *, ac, bd, ctx_rq,
                  left: int, right: int, nbits: int) -> torch.Tensor:
    """qu8/qv8/k8/v8 (B, T, h, d_k) int8, p8 (2T-1, h, d_k) int8 (the
    projected relative-position table), lens (B,) int32; ac/bd/ctx_rq
    static (mantissa, exponent) requants; left/right the attention
    context (-1 = unlimited).  Returns the int8 context (B, T, h*d_k)."""
    if qu8.device.type == "cpu":
        return int_attention_plain(qu8, qv8, k8, v8, p8, lens, ac=ac, bd=bd,
                                   ctx_rq=ctx_rq, left=left, right=right, nbits=nbits)
    if qu8.device.type != "cuda":
        raise ValueError(f"int_attention: unsupported device {qu8.device}")
    b, t, h, d_k = qu8.shape
    dev = qu8.device
    for name, x in (("qu8", qu8), ("qv8", qv8), ("k8", k8), ("v8", v8)):
        check_x(f"int_attention {name}", x, 4)
        if tuple(x.shape) != (b, t, h, d_k) or x.device != dev or x.data_ptr() % 16:
            raise ValueError(f"int_attention: {name} must be (B, T, h, d_k) = "
                             f"{(b, t, h, d_k)} on {dev}, 16-byte aligned")
    check_vec("int_attention", "p8", p8, torch.int8, (2 * t - 1, h, d_k), dev)
    check_vec("int_attention", "lens", lens, torch.int32, (b,), dev)
    if b * t == 0 or d_k % 4 or not 0 < d_k <= 128 or p8.data_ptr() % 16:
        raise ValueError(f"int_attention: needs B*T > 0, d_k a multiple of 4 in "
                         f"[4, 128] and an aligned p8 (got B={b} T={t} d_k={d_k})")
    if smem_bytes(t, d_k) > SMEM_LIMIT:
        raise ValueError(f"int_attention: T={t} needs {smem_bytes(t, d_k)} bytes of "
                         f"shared memory per block (limit {SMEM_LIMIT})")
    for name, (m, e) in (("ac", ac), ("bd", bd), ("ctx_rq", ctx_rq)):
        if not (isinstance(e, int) and e >= 1 and 0 < int(m) < 2 ** 31):
            raise ValueError(f"int_attention: {name} must be a static (m, e) "
                             f"with 0 < m < 2^31, e >= 1; got {(m, e)!r}")
    out = torch.empty((b, t, h * d_k), dtype=torch.int8, device=dev)
    rc = _build.library().qasr_int_attention(
        _build.ptr(qu8), _build.ptr(qv8), _build.ptr(k8), _build.ptr(v8),
        _build.ptr(p8), _build.ptr(lens), _build.ptr(out), b, t, h, d_k,
        int(ac[0]), ac[1], int(bd[0]), bd[1], int(ctx_rq[0]), ctx_rq[1],
        int(left), int(right), 2 ** (nbits - 1) - 1, _build.stream_of(qu8))
    _build.check(rc, "int_attention")
    int_attention.launches += 1
    return out


int_attention.launches = 0
