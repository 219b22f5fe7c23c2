"""Kernel 3: integer relative-position attention of the frozen Conformer
(kernels/csrc/int_attention.cu).

Replaces qasr_tpu/kernels/int_attention.py::fused_int_attention, and
above its 2,048 frames the XLA composition the JAX package switches to.
Per (batch, head, query tile) the kernel forms the scores (content scores
q_u.k plus the Toeplitz diagonal of q_v.pos) 64 keys at a time, requants
both onto the i-softmax grid, masks, runs the integer softmax, multiplies
by v and writes the requantized int8 context: the (T, T) int32 world never
reaches device memory.  While the tile's full score rows fit in shared
memory (``smem_bytes``) they stay there (the resident form); above that
the kernel streams the keys three times, recomputing the scores (any T).

``int_attention`` launches the CUDA kernel for CUDA tensors and runs
``int_attention_plain`` (the XLA composition of
qasr_tpu/quantize/conformer_freeze.py, in torch) for CPU tensors; it
never falls back from one to the other.

The cache form (``int_attention_cached``, the stream step of a causal
Conformer, att_context (L, 0)): n new queries attend over [cache (L) ||
new (n)] keys, each to the L + 1 slots j in [i, L + i] whose relative
offset r = L + i - j indexes the (L + 1)-row pos table, masked where the
slot holds no frame yet (j < L - seen).  One block a (batch, head, 16
queries) with min(n, 16) warps: every staging copy (queries, the [cache
|| new] key and value rows, the pos rows, the i_exp table of
``exp_table``) issued at once as cp.async, the value rows in a second
group; a warp a query row: the L + 1 scores by dp4a from shared memory
and the integer softmax over them while the values land, then the
context by dp4a of its int8 probabilities against V transposed in shared
memory; the new caches (the last L rows of [cache || new]) written from
the staged rows.
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, check_x
from qasr_tpu_torch.models.conformer import attention_mask
from qasr_tpu_torch.ops.integer_softmax import Q_B, Q_C, Q_LN2, i_softmax_grid
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.quantize.conformer_int import clip8

# the kernel's tiling (csrc/int_attention.cu): query rows per block, keys
# per chunk, and the shared memory a block may use on Hopper
TQ, KC = 32, 64
SMEM_LIMIT = 232448


def smem_bytes(t: int, d_k: int) -> int:
    """Dynamic shared memory of one block of the resident form
    (csrc/int_attention.cu's layout); the streaming form takes any T."""
    tp = -(-t // KC) * KC
    dkw = -(-d_k // 32) * 8 + 4                     # padded row, in words
    pw = TQ + KC                                    # pos rows per window
    return 4 * ((2 * TQ + 2 * KC + 2 * pw) * dkw    # Qu, Qv, 2 K chunks, 2 pos windows
                + TQ * (pw + 1)                     # bd of the chunk
                + TQ * (tp + 8)                     # score rows
                + TQ * (tp // 4 + 4)                # int8 probabilities
                + TQ                                # row maxima
                + 568)                              # i_exp's quadratic table


def resident(t: int, d_k: int) -> bool:
    """True when the kernel keeps the score rows in shared memory."""
    return smem_bytes(t, d_k) <= SMEM_LIMIT


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


def cached_scores(qu8, qv8, k_cat, p8, seen: int, ac, bd):
    """(q_grid (B, h, n, L+n) int32, mask (n, L+n) bool) of the cache form:
    JAX's stream-step composition (conformer_freeze.py:778-817)."""
    b, n, h, d_k = qu8.shape
    left = p8.shape[0] - 1
    ac_s = bmm_exact(qu8.permute(0, 2, 1, 3), k_cat.permute(0, 2, 3, 1))         # (B, h, n, L+n)
    bd_full = bmm_exact(qv8.permute(0, 2, 1, 3), p8.permute(1, 2, 0)[None])     # (B, h, n, L+1)
    i = torch.arange(n, device=qu8.device)[:, None]
    j = torch.arange(left + n, device=qu8.device)[None, :]
    r = left + i - j
    mask = (r < 0) | (r > left) | (j < left - seen)
    bd_s = torch.gather(bd_full, -1, r.clamp(0, left).expand(b, h, n, left + n))
    return (dyadic_requant_static(ac_s, ac[0], ac[1])
            + dyadic_requant_static(bd_s, bd[0], bd[1])), mask


def int_attention_cached_plain(qu8, qv8, k8, v8, k_cache, v_cache, p8, seen: int, *,
                               ac, bd, ctx_rq, nbits: int):
    """Plain torch version of the cache form: the composition of JAX's
    ``_frozen_stream_step_body`` over [cache || new].  Same arguments and
    results as ``int_attention_cached``."""
    b, n, h, d_k = qu8.shape
    left = k_cache.shape[1]
    k_cat = torch.cat([k_cache, k8], 1)
    v_cat = torch.cat([v_cache, v8], 1)
    q_grid, mask = cached_scores(qu8, qv8, k_cat, p8, seen, ac, bd)
    a8 = i_softmax_grid(q_grid, mask[None, None], out_bits=nbits)
    ctx = bmm_exact(a8, v_cat.permute(0, 2, 1, 3)).permute(0, 2, 1, 3).reshape(b, n, h * d_k)
    c8 = clip8(dyadic_requant_static(ctx, ctx_rq[0], ctx_rq[1]), nbits)
    return c8, k_cat[:, n:].contiguous(), v_cat[:, n:].contiguous()


TQ_CACHE, CACHE_WARPS = 16, 16   # queries a block; warps a block at most (a query row each)
EXP_TAB = -Q_LN2                 # entries of the i_exp table (conformer_int.cuh kExpTab)


def exp_table(device) -> torch.Tensor:
    """i_exp's quadratic at r in [0, EXP_TAB): (Q_B - r)^2 + Q_C as int32,
    the table that the cache form reads (csrc/conformer_int.cuh
    ``qasr_exp_quad``; i_exp(-a) >> 4 is entry a mod 568 shifted right by
    a // 568 + 4).  Built once a device and cached."""
    dev = torch.device(device)
    tab = _EXP_TABLES.get(dev)
    if tab is None:
        r = torch.arange(EXP_TAB, dtype=torch.int32)
        tab = _EXP_TABLES[dev] = ((Q_B - r) * (Q_B - r) + Q_C).to(dev)
    return tab


_EXP_TABLES = {}


def cached_smem_bytes(left: int, d_k: int, warps: int = CACHE_WARPS) -> int:
    """Dynamic shared memory of one block of the cache form with ``warps``
    warps, by default its most (csrc/int_attention.cu's
    ``cached_att_layout``): Qu, Qv (TQ_CACHE rows), the K and V window
    (TQ_CACHE + L rows), the pos table (L + 1 rows), each row d_k rounded
    up to 16 bytes plus 16, the i_exp table, V transposed (a row of the
    window's slots, 4 a word, an odd word count, for each padded dim), each
    warp's L + 1 scores and exponents, and each query row's int8
    probabilities."""
    dkp = -(-d_k // 16) * 16
    vt_words = ((TQ_CACHE + left + 3) // 4 + 1) | 1
    return ((2 * TQ_CACHE + 2 * (TQ_CACHE + left) + left + 1) * (dkp + 16) + 4 * EXP_TAB
            + dkp * vt_words * 4 + warps * 2 * 4 * (left + 1)
            + TQ_CACHE * -(-(left + 1) // 4) * 4)


def int_attention_cached(qu8, qv8, k8, v8, k_cache, v_cache, p8, seen: int, *, ac, bd,
                         ctx_rq, nbits: int):
    """The cache form: qu8/qv8/k8/v8 (B, n, h, d_k) int8 of the n new
    frames, k_cache/v_cache (B, L, h, d_k) int8 (the last L frames' keys
    and values, zeros before the stream's start), p8 (L + 1, h, d_k) int8
    (the projected pos rows of relative offsets 0..L), ``seen`` the frames
    consumed before this step.  Returns (the int8 context (B, n, h*d_k),
    the new k and v caches: the last L rows of [cache || new])."""
    if qu8.device.type == "cpu":
        return int_attention_cached_plain(qu8, qv8, k8, v8, k_cache, v_cache, p8, seen,
                                          ac=ac, bd=bd, ctx_rq=ctx_rq, nbits=nbits)
    if qu8.device.type != "cuda":
        raise ValueError(f"int_attention_cached: unsupported device {qu8.device}")
    b, n, h, d_k = qu8.shape
    left = k_cache.shape[1]
    dev = qu8.device
    for name, x, rows in (("qu8", qu8, n), ("qv8", qv8, n), ("k8", k8, n), ("v8", v8, n),
                          ("k_cache", k_cache, left), ("v_cache", v_cache, left)):
        check_x(f"int_attention_cached {name}", x, 4)
        if tuple(x.shape) != (b, rows, h, d_k) or x.device != dev or x.data_ptr() % 16:
            raise ValueError(f"int_attention_cached: {name} must be {(b, rows, h, d_k)} on "
                             f"{dev}, 16-byte aligned")
    check_vec("int_attention_cached", "p8", p8, torch.int8, (left + 1, h, d_k), dev)
    if b * n == 0 or left < 1 or d_k % 4 or not 0 < d_k <= 128 or p8.data_ptr() % 16 \
            or not isinstance(seen, int) or seen < 0:
        raise ValueError(f"int_attention_cached: needs B*n > 0, L >= 1, d_k a multiple of 4 "
                         f"in [4, 128], an aligned p8 and an int seen >= 0 (got B={b} n={n} "
                         f"L={left} d_k={d_k} seen={seen!r})")
    if cached_smem_bytes(left, d_k) > SMEM_LIMIT:
        raise NotImplementedError(f"int_attention_cached: L={left} at d_k={d_k} needs "
                                  f"{cached_smem_bytes(left, d_k)} bytes of shared memory")
    for name, (m, e) in (("ac", ac), ("bd", bd), ("ctx_rq", ctx_rq)):
        if not (isinstance(e, int) and e >= 1 and 0 < int(m) < 2 ** 31):
            raise ValueError(f"int_attention_cached: {name} must be a static (m, e) "
                             f"with 0 < m < 2^31, e >= 1; got {(m, e)!r}")
    out = torch.empty((b, n, h * d_k), dtype=torch.int8, device=dev)
    k_new = torch.empty_like(k_cache)
    v_new = torch.empty_like(v_cache)
    rc = _build.library().qasr_int_attention_cached(
        _build.ptr(qu8), _build.ptr(qv8), _build.ptr(k8), _build.ptr(v8),
        _build.ptr(k_cache), _build.ptr(v_cache), _build.ptr(p8), _build.ptr(exp_table(dev)),
        _build.ptr(out),
        _build.ptr(k_new), _build.ptr(v_new), b, n, left, h, d_k, min(seen, left),
        int(ac[0]), ac[1], int(bd[0]), bd[1], int(ctx_rq[0]), ctx_rq[1],
        2 ** (nbits - 1) - 1, _build.stream_of(qu8))
    _build.check(rc, "int_attention_cached")
    int_attention_cached.launches += 1
    return out, k_new, v_new


int_attention_cached.launches = 0


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
    for name, (m, e) in (("ac", ac), ("bd", bd), ("ctx_rq", ctx_rq)):
        if not (isinstance(e, int) and e >= 1 and 0 < int(m) < 2 ** 31):
            raise ValueError(f"int_attention: {name} must be a static (m, e) "
                             f"with 0 < m < 2^31, e >= 1; got {(m, e)!r}")
    out = torch.empty((b, t, h * d_k), dtype=torch.int8, device=dev)
    rc = _build.library().qasr_int_attention(
        _build.ptr(qu8), _build.ptr(qv8), _build.ptr(k8), _build.ptr(v8),
        _build.ptr(p8), _build.ptr(lens), _build.ptr(out), b, t, h, d_k,
        int(ac[0]), ac[1], int(bd[0]), bd[1], int(ctx_rq[0]), ctx_rq[1],
        int(left), int(right), 2 ** (nbits - 1) - 1,
        int(not resident(t, d_k)), _build.stream_of(qu8))
    _build.check(rc, "int_attention")
    int_attention.launches += 1
    return out


int_attention.launches = 0
