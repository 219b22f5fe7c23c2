"""Kernel 2: pointwise int8 GEMM with an input-requant prologue and a
requant, join or no epilogue (kernels/csrc/pw_gemm.cu, on the int8
wgmma / TMA mainloop of kernels/csrc/gemm_s8.cuh).

Replaces qasr_tpu/kernels/cm_fused.py::fused_pw_cm and fused_pw_join_cm,
and qasr_tpu/kernels/pw_matmul.py::requant_pointwise_matmul.  Its grouped
form (``groups`` > 1: kernels/csrc/pw_gemm_grouped.cu, ``grouped_plan``)
computes the grouped pointwise convs of QuartzNet-style blocks: a
persistent grid whose blocks hold their weights resident (packed once per
weight tensor by ``pack_grouped``) and read each row tile's whole Cin once
for every group, its column tiles in GroupShuffle's order (``shuffle``).
``pw_gemm`` launches the CUDA kernel for CUDA tensors and runs
``pw_gemm_plain`` for CPU tensors; it never falls back from one to the
other.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    act_dtype,
    cap_operand,
    check_vec,
    epilogue_bounds,
    f64_site,
    group_width,
)
from qasr_tpu_torch.kernels.dw_conv import check_prologue, prologue_args, prologue_plain
from qasr_tpu_torch.ops.quant_prims import (
    clip_ceiling,
    dyadic_requant_static,
    requant_clamp,
    requant_epilogue,
)

MODE_NONE, MODE_REQUANT, MODE_JOIN = 0, 1, 2

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
CHUNK = 128          # bytes of K per TMA box (the 128B swizzle's row)
STAGES = 2           # the weight ring's stages
ALIGN = 1024         # slack to align the shared-memory base to the swizzle's repeat
SMS = 132            # the H100 SXM's streaming multiprocessors
# the grouped form (csrc/pw_gemm_grouped.cu)
GROUPED_BN = 128     # GroupShuffle-order positions a column tile covers
GROUPED_BM = 64      # rows a warpgroup pair's tile
GROUPED_STAGES = 4   # the A ring's deepest (even: stage s serves pair s % 2)
# two warpgroup pairs' staging tiles (64 rows x 128 int32) and row flags
GROUPED_STAGING = 2 * GROUPED_BM * (4 * GROUPED_BN + 16) + 2 * GROUPED_BM


def plan(cin: int, cout: int) -> dict:
    """Kernel 2's tiles for one ungrouped launch, as csrc/pw_gemm.cu
    computes them.

    A block (one consumer warpgroup and a producer warp) keeps its ``bm`` =
    64 rows of A (``nk`` chunks of 128 bytes of Cin) resident and walks
    every ``bn``-column tile of Cout, the weights streaming through a ring
    of ``stages``; the grid is the row tiles.  ``smem`` is its dynamic
    shared memory: the A tile, the ring, the int32 staging tile (rows of 4
    * bn + 32 bytes), the mbarriers, the two row masks and the alignment
    slack."""
    bm, bn, nk = 64, (32 if cout <= 32 else 64), -(-cin // CHUNK)
    smem = (bm * CHUNK * nk + STAGES * bn * CHUNK + bm * (4 * bn + 32)
            + 8 * (2 * STAGES + 1) + 2 * bm + ALIGN)
    return {"bm": bm, "bn": bn, "stages": STAGES, "nk": nk, "smem": smem, "groups": 1}


def group_chunk(groups: int) -> int:
    """The groups a grouped column tile takes: all of them at 2, 4 or 8
    groups (so GroupShuffle's positions of a column pair are consecutive),
    else the largest of 8, 4, 2 and 1 dividing ``groups``."""
    return next(k for k in (8, 4, 2, 1) if groups % k == 0)


@functools.lru_cache(maxsize=256)
def grouped_plan(n_rows: int, cin: int, cout: int, groups: int, pro: bool) -> dict:
    """Kernel 2 grouped's plan for one launch (csrc/pw_gemm_grouped.cu takes
    ``kgc``, ``t_per``, ``stages`` and ``grid``'s x from here and computes
    the same shared memory).

    A column tile holds GROUPED_BN positions of GroupShuffle's order:
    ``kgc`` groups (``group_chunk``) x ``nj`` columns, ``njt`` tiles a
    group chunk, ``n_tiles`` in all.  A group's channels take ``cgp`` bytes
    (Cin / groups rounded up to 32, the wgmma's K step) in the A tile and in
    the packed weights (``pack_grouped``: ``tile_bytes`` a column tile,
    ``nkb`` 128-byte chunks a group).  A block keeps the weights of
    ``t_per`` column tiles resident (the fewest grid-y slices that leave
    room for an A stage a warpgroup pair) and a ring of ``stages`` (even)
    A tiles of 64 rows x ``nka`` chunks, beside each pair's staging tile
    (64 rows x 128 int32) and row flags and the epilogue's per-position
    constants (16 bytes each); ``a_tma``: A arrives by TMA (the prologue
    off and Cin / groups a multiple of 32), else its pair fills it.
    ``grid``: about an SM's worth of blocks walking the ``row_tiles`` (two
    a block at a time), times the slices.
    ValueError where two A stages and one column tile do not fit a block."""
    cg, cog = cin // groups, cout // groups
    kgc = group_chunk(groups)
    nj = GROUPED_BN // kgc
    cgp = -(-cg // 32) * 32
    nkb, nka = -(-cgp // CHUNK), -(-(groups * cgp) // CHUNK)
    njt = -(-cog // nj)
    n_tiles = groups // kgc * njt
    tile = GROUPED_BN * nkb * CHUNK
    a_stage = GROUPED_BM * CHUNK * nka
    room = SMEM_LIMIT - ALIGN - GROUPED_STAGING - 16 * cout - 8 * (2 * GROUPED_STAGES + 1)
    t_per = next((-(-n_tiles // s) for s in range(1, n_tiles + 1)
                  if -(-n_tiles // s) * tile + 2 * a_stage <= room), None)
    if t_per is None:
        raise ValueError(f"pw_gemm: grouped Cin={cin} Cout={cout} groups={groups} needs "
                         f"{tile + 2 * a_stage} bytes of shared memory for one column tile and "
                         f"two A stages, above {room}")
    stages = min(GROUPED_STAGES, (room - t_per * tile) // a_stage) // 2 * 2
    slices = -(-n_tiles // t_per)
    row_tiles = -(-n_rows // GROUPED_BM)
    smem = (t_per * tile + stages * a_stage + GROUPED_STAGING + 16 * cout + 8 * (2 * stages + 1)
            + ALIGN)
    return {"groups": groups, "kgc": kgc, "nj": nj, "njt": njt, "n_tiles": n_tiles,
            "cgp": cgp, "nkb": nkb, "nka": nka, "tile_bytes": tile, "t_per": t_per,
            "stages": stages, "smem": smem, "a_tma": not pro and cg % 32 == 0,
            "row_tiles": row_tiles,
            "grid": (min(-(-row_tiles // 2), max(1, SMS // slices)), slices)}


def pack_grouped(wt: torch.Tensor, groups: int, kgc: int) -> torch.Tensor:
    """A grouped conv's weights wt (Cout, Cin / groups) int8 as the image
    Kernel 2 grouped keeps in shared memory (flat int8, ``grouped_plan``'s
    ``n_tiles`` x ``tile_bytes``): column tile (chunk gc, tile jt) after
    column tile; in each, group i of the chunk's ``nkb`` 128-byte K chunks,
    each ``nj`` rows (columns jt * nj.. of group gc * kgc + i; zero past Cout
    / groups) x 128 bytes (its channels, zero past Cin / groups) in the 128B
    swizzle: row r's 16-byte granule u at u ^ (r % 8)."""
    cout, cg = wt.shape
    cog = cout // groups
    nj = GROUPED_BN // kgc
    nkb = -(-(-(-cg // 32) * 32) // CHUNK)
    njt = -(-cog // nj)
    w = F.pad(wt.reshape(groups, cog, cg), (0, nkb * CHUNK - cg, 0, njt * nj - cog))
    w = w.reshape(groups // kgc, kgc, njt, nj, nkb, CHUNK // 16, 16).permute(0, 2, 1, 4, 3, 5, 6)
    r = torch.arange(nj, device=wt.device)[:, None]
    src = torch.arange(CHUNK // 16, device=wt.device)[None, :] ^ (r % 8)
    return w[:, :, :, :, r, src].reshape(-1).contiguous()


def packed(w: torch.Tensor, pack, groups: int, kgc: int) -> torch.Tensor:
    """``pack(w, groups, kgc)`` (a grouped kernel's weight image), built once
    per weight tensor and kept on it (rebuilt if the tensor is written in
    place)."""
    key = (pack.__module__, groups, kgc, w._version)
    hit = getattr(w, "_qasr_grouped_pack", None)
    if hit is None or hit[0] != key:
        hit = (key, pack(w, groups, kgc))
        w._qasr_grouped_pack = hit
    return hit[1]


def check_launch(n_rows: int, cin: int, cout: int, pro: bool, x_dtype: torch.dtype,
                 groups: int = 1) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not take:
    TMA needs a row pitch of Cin bytes that is a multiple of 16 (x int8 or
    uint8 without the prologue, wt always), and the plan's shared memory
    must fit a block.  A grouped launch (``grouped_plan``) needs Cin /
    groups a multiple of 16 (the 16-byte granules a group's channels are
    read in), else NotImplementedError (``checks.group_width``)."""
    if n_rows < 1 or cout < 1:
        raise ValueError(f"pw_gemm: empty input or output (N={n_rows}, Cout={cout})")
    cg = group_width("pw_gemm", cin, cout, groups)
    if cin < 16 or cin % 16 or cg < 16:
        raise ValueError(f"pw_gemm: Cin must be a positive multiple of 16 (TMA row pitch), "
                         f"got {cin}")
    if not pro and x_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"pw_gemm: without the prologue x must be int8 or uint8, "
                         f"got {x_dtype}")
    if groups > 1:
        return grouped_plan(n_rows, cin, cout, groups, pro)
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
    """Exact x2 (N, Cin) int8 or uint8 @ wt (Cout, Cin)^T -> int32, never
    through a float32 GEMM (exact only below 2^24).  CPU: int32 matmul.
    CUDA: torch._int_mm for int8 x2 where its shape rules allow, else
    float64 (exact: freeze bounds every accumulator below 2^31 < 2^53;
    _int_mm takes no uint8)."""
    if x2.device.type == "cpu":
        return x2.to(torch.int32) @ wt.to(torch.int32).t()
    n, k = x2.shape
    cout = wt.shape[0]
    if (x2.dtype == torch.int8 and n > 16 and k >= 16 and k % 8 == 0 and cout >= 16
            and cout % 8 == 0):
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


def grouped_matmul(x2: torch.Tensor, wt: torch.Tensor, groups: int) -> torch.Tensor:
    """Exact grouped x2 (N, Cin) @ wt (Cout, Cin/groups)^T -> int32: group
    g's Cout/g outputs read its Cin/g input columns (``int_matmul`` each)."""
    if groups == 1:
        return int_matmul(x2, wt)
    cg, cog = x2.shape[1] // groups, wt.shape[0] // groups
    return torch.cat([int_matmul(x2[:, g * cg:(g + 1) * cg].contiguous(),
                                 wt[g * cog:(g + 1) * cog]) for g in range(groups)], dim=1)


def shuffle_channels(x: torch.Tensor, groups: int) -> torch.Tensor:
    """GroupShuffle over the last axis: channel o of group o // (C/g) moves
    to (o % (C/g)) * g + o // (C/g)."""
    *lead, c = x.shape
    return x.reshape(*lead, groups, c // groups).transpose(-1, -2).reshape(*lead, c)


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
                  bits1: Optional[int] = None, groups: int = 1, shuffle: bool = False,
                  hcap=None, in_hcap=None) -> torch.Tensor:
    """Plain torch version: the prologue on the whole input, integer
    matmul, then the epilogue.  Same arguments and result as ``pw_gemm``."""
    if m1 is not None:
        x = prologue_plain(x, in_bias=in_bias, in_relu=in_relu, in_len=in_len, m1=m1,
                           e1=e1, bits1=bits1, in_hcap=in_hcap)
    b, t, cin = x.shape
    acc = grouped_matmul(x.reshape(b * t, cin), wt, groups).reshape(b, t, wt.shape[0])
    return epilogue_plain(acc, bias=bias, relu=relu, lens=lens, m=m, e=e, bits=bits,
                          res=res, m_r=m_r, e_r=e_r, hcap=hcap,
                          shuffle=groups if shuffle else 1)


def epilogue_plain(acc: torch.Tensor, *, bias=None, relu: bool = False, lens=None, m=None,
                   e=None, bits=None, res=None, m_r=None, e_r=None, hcap=None,
                   shuffle: int = 1) -> torch.Tensor:
    """The epilogue of Kernels 2 and 8 on an int32 (B, T, Cout)
    accumulator, in its mode: none, requant or join (``pw_gemm``).  With
    ``shuffle`` groups (> 1) the bias, ReLU and ceiling act in the conv's
    channel order, then GroupShuffle permutes the channels, and the mask,
    requant and join follow in the shuffled order."""
    mode = _mode(m, res)
    if shuffle > 1:
        if bias is not None:
            acc = acc + bias
        if relu:
            acc = clip_ceiling(acc.clamp_min(0), hcap)
        acc, bias, hcap = shuffle_channels(acc, shuffle), None, None
    if mode == MODE_NONE:
        if bias is not None:
            acc = acc + bias
        return clip_ceiling(acc.clamp_min(0), hcap) if relu else acc
    if mode == MODE_REQUANT:
        return requant_epilogue(acc, bias=bias, relu=relu, lens=lens, m=m,
                                e=e, bits=bits, hcap=hcap)
    if bias is not None:
        acc = acc + bias
    q = dyadic_requant_static(acc, m, e) + dyadic_requant_static(res, m_r, e_r)
    return requant_clamp(q, bits).to(torch.int8)


def check_epilogue(name: str, mode: int, shape, dev, bias, relu, lens, m, e, bits, res, m_r,
                   e_r):
    """The epilogue's arguments of Kernels 2 and 8 on CUDA, output (B, T,
    Cout) ``shape``: (lo, hi, e, e_r, lens, the empty output).  The
    requant epilogue writes int8, or uint8 for a 9-bit code of a ReLU'd
    value (``act_dtype``); the join writes int8; only the requant epilogue
    masks rows (``lens`` None otherwise)."""
    b, t, cout = shape
    check_vec(name, "bias", bias, torch.int32, (cout,), dev)
    lo = hi = ee = ee_r = 0
    nonneg = mode == MODE_REQUANT and bool(relu)
    if mode != MODE_NONE:
        check_vec(name, "m", m, torch.int32, (cout,), dev)
        lo, hi, ee = epilogue_bounds(name, e, bits, nonneg)
    if mode == MODE_REQUANT:
        check_vec(name, "lens", lens, torch.int32, (b,), dev)
    else:
        lens = None
    if mode == MODE_JOIN:
        check_vec(name, "res", res, torch.int32, (b, t, cout), dev)
        check_vec(name, "m_r", m_r, torch.int32, (cout,), dev)
        _, _, ee_r = epilogue_bounds(name, e_r, bits)
    out = torch.empty(shape, device=dev, dtype=torch.int32 if mode == MODE_NONE
                      else act_dtype(name, bits, nonneg, dev))
    return lo, hi, ee, ee_r, lens, out


def pw_gemm(x: torch.Tensor, wt: torch.Tensor, *,
            bias: Optional[torch.Tensor] = None, relu: bool = False,
            lens: Optional[torch.Tensor] = None, m=None,
            e: Optional[int] = None, bits: Optional[int] = None,
            res: Optional[torch.Tensor] = None, m_r=None,
            e_r: Optional[int] = None, in_bias: Optional[torch.Tensor] = None,
            in_relu: bool = False, in_len: Optional[torch.Tensor] = None,
            m1=None, e1: Optional[int] = None,
            bits1: Optional[int] = None, groups: int = 1, shuffle: bool = False,
            hcap=None, in_hcap=None) -> torch.Tensor:
    """Pointwise conv of x (B, T, Cin) with wt (Cout, Cin) int8.

    Cin need not be a multiple of 16: the wrapper zero-pads it (``pad_k``);
    without prologue and epilogue a Cin above what a block's shared memory
    holds runs as ``k_pieces`` launches whose int32 products are added.
    Prologue off (``m1`` None): x is int8, or uint8 (a non-negative 9-bit
    code).  Prologue on: x is int8 or int32 and its rows are first
    ``clamp(requant(mask(relu?(x + in_bias)), m1, e1), bits1)``, m1 a (Cin,)
    int32 vector or a scalar, the mask zeroing frames t >= in_len[b]
    (in_len None: no mask), before they reach the GEMM; a 9-bit code of a
    ReLU'd value is uint8 (``act_dtype``), and the GEMM then multiplies
    u8 by s8.

    none    (m None, res None): (B, T, Cout) int32 ``relu?(x @ wt.T + bias)``;
    requant (m given):          int8 ``clamp(requant(mask(relu?(acc + bias)),
                                m, e), bits)``, mask: frame t >= lens[b];
                                uint8 for 9 bits with relu;
    join    (res given):        int8 ``clamp(requant(acc + bias, m, e) +
                                requant(res, m_r, e_r), bits)``, res
                                (B, T, Cout) int32; no ReLU, no mask.

    ``hcap`` / ``in_hcap``: hardtanh's ceiling after the epilogue's /
    prologue's ReLU (a clip to [0, H], in the conv's channel order): None,
    a Python int, or a (Cout,) / (Cin,) int32 tensor; each needs its ReLU
    flag.  ``groups`` > 1: the grouped conv, wt (Cout, Cin / groups), group
    g's outputs reading its Cin / groups input channels (on CUDA Cin /
    groups must be a multiple of 16, else NotImplementedError);
    ``shuffle``: GroupShuffle over ``groups`` on the output, its m, m_r and
    res read in the shuffled order.
    """
    mode = _mode(m, res)
    if mode == MODE_JOIN and (relu or m is None):
        raise ValueError("pw_gemm: join takes m and no relu")
    prologue_args("pw_gemm", in_bias, in_relu, in_len, m1, in_hcap)
    if hcap is not None and not relu:
        raise ValueError("pw_gemm: hcap (hardtanh's ceiling) needs relu")
    if x.device.type == "cpu":
        return pw_gemm_plain(x, wt, bias=bias, relu=relu, lens=lens, m=m, e=e,
                             bits=bits, res=res, m_r=m_r, e_r=e_r, in_bias=in_bias,
                             in_relu=in_relu, in_len=in_len, m1=m1, e1=e1, bits1=bits1,
                             groups=groups, shuffle=shuffle, hcap=hcap, in_hcap=in_hcap)
    if x.device.type != "cuda":
        raise ValueError(f"pw_gemm: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"pw_gemm: x must be (B, T, Cin), got {tuple(x.shape)}")
    group_width("pw_gemm", x.shape[2], wt.shape[0], groups)
    if x.shape[2] % 16 and groups == 1:
        x, wt, in_bias, m1 = pad_k(x, wt, in_bias, m1)
        if isinstance(in_hcap, torch.Tensor):
            in_hcap = F.pad(in_hcap, (0, (-in_hcap.shape[0]) % 16))
    b, t, cin = x.shape
    pro, m1v, m1s, _, ee1, lo1, hi1, u8 = check_prologue("pw_gemm", x, in_bias, in_len, m1,
                                                         e1, bits1, cin, b, in_relu=in_relu)
    cout = wt.shape[0]
    pieces = (k_pieces(cin, cout) if mode == MODE_NONE and not pro and groups == 1
              else [(0, cin)])
    if len(pieces) > 1:
        acc = sum(pw_gemm(x[..., a:z].contiguous(), wt[:, a:z].contiguous())
                  for a, z in pieces)
        if bias is not None:
            acc = acc + bias
        return clip_ceiling(acc.clamp_min(0), hcap) if relu else acc
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("pw_gemm: x and wt must be 16-byte aligned")
    p = check_launch(b * t, cin, cout, bool(pro), x.dtype, groups)
    dev = x.device
    check_vec("pw_gemm", "wt", wt, torch.int8, (cout, cin // groups), dev)
    lo, hi, ee, ee_r, lens, out = check_epilogue("pw_gemm", mode, (b, t, cout), dev, bias,
                                                 relu, lens, m, e, bits, res, m_r, e_r)
    hv, hs = cap_operand("pw_gemm", "hcap", hcap, cout, dev, relu)
    ihv, ihs = cap_operand("pw_gemm", "in_hcap", in_hcap, cin, dev, in_relu)
    lib = _build.library()
    args = (_build.ptr(bias), _build.ptr(m), _build.ptr(lens), _build.ptr(res), _build.ptr(m_r),
            _build.ptr(out), b * t, cin, cout, t, mode, int(relu), ee, ee_r, lo, hi, pro,
            int(x.dtype == torch.int32), _build.ptr(in_bias), int(in_relu), _build.ptr(in_len),
            _build.ptr(m1v), m1s, ee1, lo1, hi1, int(u8), groups, int(bool(shuffle) and groups > 1),
            _build.ptr(hv), hs, _build.ptr(ihv), ihs)
    if groups == 1:
        rc = lib.qasr_pw_gemm(_build.ptr(x), _build.ptr(wt), *args, _build.stream_of(x))
    else:
        f64, f64_1 = grouped_f64(mode, ee, ee_r, 1, cin // groups, bool(u8), bias, pro, x.dtype,
                                 in_bias, ee1)
        rc = lib.qasr_pw_gemm_grouped(
            _build.ptr(x), _build.ptr(packed(wt, pack_grouped, groups, p["kgc"])), *args, p["kgc"],
            p["t_per"], p["stages"], p["grid"][0], int(f64), int(f64_1), _build.stream_of(x))
        pw_gemm.grouped_launches += 1
    _build.check(rc, "pw_gemm")
    pw_gemm.launches += 1
    return out


def grouped_f64(mode: int, e: int, e_r: int, k_size: int, cg: int, u8: bool, bias, pro,
                x_dtype, in_bias, e1: int) -> Tuple[bool, bool]:
    """Whether the grouped kernels' epilogue and prologue requants run on the
    FP64 pipe (``checks.f64_site`` over the |z| each can reach): the
    epilogue's z = acc + bias, |acc| <= K * Cin/g * 255 (uint8 operand; 128
    for int8) * 128, any int32 with a bias; the join also needs its int32
    residual's requant proven; the prologue's z = x + in_bias, |z| <= 128
    for an int8 x without in_bias, else any int32."""
    zmax = 2 ** 31 if bias is not None else k_size * cg * (255 if u8 else 128) * 128
    f64 = mode != MODE_NONE and f64_site(e, zmax) and (mode != MODE_JOIN or f64_site(e_r))
    f64_1 = bool(pro) and f64_site(e1, 128 if x_dtype == torch.int8 and in_bias is None
                                   else 2 ** 31)
    return f64, f64_1


pw_gemm.launches = 0
pw_gemm.grouped_launches = 0   # of them, the grouped form's (pw_gemm_grouped.cu)
