"""Kernel 8: dense integer 1-D conv with Kernel 2's input-requant prologue
and its none / requant / join epilogues (kernels/csrc/dense_conv.cu): an
implicit GEMM over (tap, Cin chunk) on wgmma, the input rows of an output
tile and their halo resident in shared memory (A from registers), the
weights by TMA through an mbarrier ring, no im2col in device memory.

Replaces no Pallas kernel: the JAX package computes these convs with
XLA's integer conv (qasr_tpu/models/jasper.py:332, ``conv_nwc`` with
``preferred_element_type=int32``).  Jasper10x5Dr's convs (K 11 to 29,
stride 2, dilation 2) run here.  ``dense_conv`` launches the CUDA kernel
for CUDA tensors and runs ``dense_conv_plain`` for CPU tensors; it never
falls back from one to the other.  ``plan`` states the kernel's tiles and
shared memory, ``check_launch`` the shapes it takes.  Its grouped form
(``groups`` > 1: kernels/csrc/dense_conv_grouped.cu, ``grouped_plan``)
computes the grouped non-separable convs of Jasper-style blocks (XLA's
grouped conv in the JAX package, qasr_tpu/ops/grouped_conv.py): the full
Cin's halo rows resident, column tiles in GroupShuffle's order
(``shuffle``), K steps sized to the group.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import cap_operand, check_vec, group_width
from qasr_tpu_torch.kernels.dw_conv import check_prologue, prologue_args, prologue_plain
from qasr_tpu_torch.kernels.pw_gemm import (
    MODE_JOIN,
    _mode,
    check_epilogue,
    epilogue_plain,
    group_chunk,
    grouped_f64,
    grouped_matmul,
    pad_k,
    packed,
)
from qasr_tpu_torch.models.jasper import out_frames

BM = 128             # output frames of a block's tile (two warpgroups of 64)
KC = 128             # bytes of Cin a K step takes (a TMA box's row, the 128B swizzle's)
WIDTHS = (128, 160, 192)  # the Cout tiles (wgmma N) the kernel is built for
MAX_STAGES = 8       # the weight ring's deepest
THREADS = 384        # two consumer warpgroups and a producer warpgroup
ALIGN = 1024         # slack to align the shared-memory base to the swizzle's repeat
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on an H100
SMS = 132            # the H100 SXM's streaming multiprocessors
GRID_YZ = 65535      # the grid's y (batch) and z limits


def tile_n(cout: int) -> int:
    """The Cout tile: of the WIDTHS, the one that covers Cout with the
    fewest padded columns, then the fewest tiles (768 -> 192, 896 -> 128,
    640 -> 160, 384 -> 192, 200 -> 128).  Wider tiles need more than the
    168 registers a thread of a 384-thread block has."""
    return min(WIDTHS, key=lambda bn: (-(-cout // bn) * bn, -(-cout // bn)))


def slice_tiles(blocks: int, n_tiles: int) -> int:
    """The column tiles a grid-z slice owns: all of them, unless ``blocks``
    (frame tiles x batch) alone would leave SMs idle; then the fewest
    slices that give every SM a block."""
    return next(c for c in range(n_tiles, 0, -1)
                if blocks * -(-n_tiles // c) >= min(SMS, blocks * n_tiles))


GROUPED_BN = 192     # GroupShuffle-order positions a grouped column tile covers
GROUPED_KS = 64      # bytes of a group's Cin a grouped K step takes (the 64B swizzle)
GROUPED_PAD16 = 3    # zero 16-byte chunks past Cin in the resident rows (a step's overrun)


@functools.lru_cache(maxsize=256)
def grouped_plan(b: int, t_out: int, cin: int, cout: int, k_size: int, stride: int,
                 dilation: int, groups: int) -> dict:
    """Kernel 8 grouped's plan for one launch (csrc/dense_conv_grouped.cu
    takes ``kgc``, ``stages`` and ``t_per`` from here and computes the same
    shared memory).

    A block owns BM output frames of one batch element with ``rows`` input
    rows of the full Cin resident as ``stride`` phases of ``nk16`` 16-byte
    chunks (Cin / 16 and GROUPED_PAD16 zero ones) of ``rpp`` rows (odd),
    ``a_bytes`` in all.  A column tile holds GROUPED_BN positions of
    GroupShuffle's order: ``kgc`` groups (``pw_gemm.group_chunk``) x ``nj``
    columns, ``njt`` tiles a group chunk, ``n_tiles`` in all; a K step is a
    tap and 64 bytes of each group's Cin / groups (``nks`` steps a tap), its
    weights one host-packed ``GROUPED_BN`` x 64-byte image (``pack_grouped``)
    through a ring of ``stages`` (as many as fit beside the rows, at most
    MAX_STAGES; fewer than 2 do not run).  Grid z slices the column tiles,
    ``t_per`` each (``slice_tiles``)."""
    cg, cog = cin // groups, cout // groups
    kgc = group_chunk(groups)
    nj = GROUPED_BN // kgc
    rows = (BM - 1) * stride + (k_size - 1) * dilation + 1
    nk16, rpp = cin // 16 + GROUPED_PAD16, -(-rows // stride) | 1
    a_bytes = stride * nk16 * rpp * 16
    stage = GROUPED_BN * GROUPED_KS
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - a_bytes) // (stage + 16))
    smem = stages * stage + a_bytes + 16 * stages + ALIGN
    njt = -(-cog // nj)
    n_tiles = groups // kgc * njt
    t_per = slice_tiles(-(-t_out // BM) * b, n_tiles)
    return {"groups": groups, "kgc": kgc, "nj": nj, "njt": njt, "n_tiles": n_tiles,
            "nks": -(-cg // GROUPED_KS), "rows": rows, "nk16": nk16, "rpp": rpp,
            "a_bytes": a_bytes, "stages": stages, "smem": smem, "t_per": t_per,
            "grid": (-(-t_out // BM), b, -(-n_tiles // t_per)),
            "block": THREADS}


def pack_grouped(w: torch.Tensor, groups: int, kgc: int) -> torch.Tensor:
    """A grouped conv's weights w (Cout, K, Cin / groups) int8 as the images
    Kernel 8 grouped bulk-copies a K step at a time (flat int8, GROUPED_BN
    x 64 bytes a step): column tile (chunk gc, tile jt), then tap, then K
    step kc; in each, group i of the chunk's ``nj`` rows (columns jt * nj..
    of group gc * kgc + i; zero past Cout / groups) x 64 bytes (its channels
    kc * 64.., zero past Cin / groups) in the 64B swizzle: row r's 16-byte
    granule u at u ^ ((r >> 1) % 4)."""
    cout, k_size, cg = w.shape
    cog, nj = cout // groups, GROUPED_BN // kgc
    njt, nks = -(-cog // nj), -(-cg // GROUPED_KS)
    x = F.pad(w.reshape(groups, cog, k_size, cg),
              (0, nks * GROUPED_KS - cg, 0, 0, 0, njt * nj - cog))
    x = x.reshape(groups // kgc, kgc, njt, nj, k_size, nks, GROUPED_KS // 16, 16)
    x = x.permute(0, 2, 4, 5, 1, 3, 6, 7)
    r = torch.arange(nj, device=w.device)[:, None]
    src = torch.arange(GROUPED_KS // 16, device=w.device)[None, :] ^ ((r >> 1) % 4)
    return x[:, :, :, :, :, r, src].reshape(-1).contiguous()


def plan(b: int, t_out: int, cin: int, cout: int, k_size: int, stride: int,
         dilation: int) -> dict:
    """Kernel 8's tiles for one ungrouped launch (csrc/dense_conv.cu takes
    ``bn``, ``stages`` and ``ct_per`` from here and computes the same
    shared memory).

    A block owns BM output frames of one batch element: ``rows`` = (BM - 1)
    * stride + (K - 1) * dilation + 1 input rows resident at ``pitch`` bytes
    (Cin padded to ``nc`` chunks of KC, plus 16 so that eight rows fall on
    distinct banks), and walks ``ct_per`` Cout tiles of ``bn`` (``tile_n``),
    the weights arriving as TMA boxes of ``box`` = (KC bytes of Cin, 1 tap,
    bn channels) through a ring of ``stages``, as many as fit beside the
    rows (``smem``: ring, rows, two mbarriers a stage and the alignment
    slack; fewer than 2 do not run).  Grid z splits Cout into the fewest
    slices of ``ct_per`` tiles that give every SM a block where the (frame
    tile, batch) blocks alone would leave some idle (one block an SM:
    its registers)."""
    nc = -(-cin // KC)
    rows = (BM - 1) * stride + (k_size - 1) * dilation + 1
    pitch = nc * KC + 16
    bn = tile_n(cout)
    stage = bn * KC
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - rows * pitch) // (stage + 16))
    smem = stages * stage + rows * pitch + 16 * stages + ALIGN
    n_ct = -(-cout // bn)
    ct_per = slice_tiles(-(-t_out // BM) * b, n_ct)
    return {"nc": nc, "rows": rows, "pitch": pitch, "bn": bn, "stages": stages,
            "smem": smem, "ct_per": ct_per, "box": (KC, 1, bn), "groups": 1,
            "grid": (-(-t_out // BM), b, -(-n_ct // ct_per)), "block": THREADS}


def check_launch(b: int, t_in: int, cin: int, cout: int, k_size: int, stride: int,
                 padding: int, dilation: int, pro: bool, x_dtype: torch.dtype,
                 groups: int = 1) -> dict:
    """The launch's plan, or ValueError for a shape the kernel does not take:
    an empty output, Cin not a positive multiple of 16 (the 16-byte
    granules the rows are copied in, the weight map's row pitch), an int32
    input without the prologue, frame indices beyond int32, a batch beyond
    the grid's y limit, or resident rows that leave no room for a ring of
    two weight stages in a block's shared memory (a grouped conv's rows
    hold the full Cin: ``grouped_plan``).  A grouped conv's Cin / groups
    that is not a multiple of 16 raises NotImplementedError
    (``checks.group_width``)."""
    if stride < 1 or dilation < 1 or padding < 0 or k_size < 1:
        raise ValueError("dense_conv: stride/dilation/K must be >= 1, padding >= 0")
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    if b < 1 or cout < 1 or t_out <= 0:
        raise ValueError(f"dense_conv: empty output (B={b}, Cout={cout}, T_out={t_out})")
    if group_width("dense_conv", cin, cout, groups) < 16 or cin % 16:
        raise ValueError(f"dense_conv: Cin must be a positive multiple of 16, got {cin}")
    if not pro and x_dtype not in (torch.int8, torch.uint8):
        raise ValueError(f"dense_conv: without the prologue x must be int8 or uint8, "
                         f"got {x_dtype}")
    if b * (t_in + t_out) * max(cin, cout) >= 2 ** 31 or b > GRID_YZ:
        raise ValueError("dense_conv: B * T * C must stay below 2^31 and B below 65536")
    p = (grouped_plan if groups > 1 else plan)(b, t_out, cin, cout, k_size, stride, dilation,
                                               *((groups,) if groups > 1 else ()))
    if p["grid"][2] > GRID_YZ:
        raise ValueError(f"dense_conv: grid {p['grid']} beyond the z limit {GRID_YZ}")
    if p["stages"] < 2:
        stage = f"{p['bn']}-channel" if groups == 1 else f"{GROUPED_KS}-byte x {GROUPED_BN}-column"
        raise ValueError(f"dense_conv: K={k_size} stride={stride} dilation={dilation} "
                         f"Cin={cin} keeps {p['rows'] * p['pitch']} bytes of rows resident, "
                         f"leaving no room for two {stage} weight stages in {SMEM_LIMIT} "
                         f"bytes of shared memory")
    return p


def dense_conv_plain(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     padding: int = 0, dilation: int = 1,
                     bias: Optional[torch.Tensor] = None, relu: bool = False,
                     lens: Optional[torch.Tensor] = None, m=None,
                     e: Optional[int] = None, bits: Optional[int] = None,
                     res: Optional[torch.Tensor] = None, m_r=None,
                     e_r: Optional[int] = None, in_bias: Optional[torch.Tensor] = None,
                     in_relu: bool = False, in_len: Optional[torch.Tensor] = None,
                     m1=None, e1: Optional[int] = None,
                     bits1: Optional[int] = None, groups: int = 1, shuffle: bool = False,
                     hcap=None, in_hcap=None) -> torch.Tensor:
    """Plain torch version: the prologue on the whole input, then a loop
    over taps of exact integer products (``int_matmul``: int32 on the
    CPU, torch._int_mm or float64 on the card; per group for a grouped
    conv) of the strided, shifted frames, then the epilogue.  Same
    arguments and result as ``dense_conv``."""
    if m1 is not None:
        x = prologue_plain(x, in_bias=in_bias, in_relu=in_relu, in_len=in_len, m1=m1,
                           e1=e1, bits1=bits1, in_hcap=in_hcap)
    b, t_in, cin = x.shape
    cout, k_size, _ = w.shape
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    xp = F.pad(x, (0, 0, padding, padding))
    acc = torch.zeros((b * t_out, cout), dtype=torch.int32, device=x.device)
    for k in range(k_size):
        start = k * dilation
        xs = xp[:, start:start + (t_out - 1) * stride + 1:stride].reshape(b * t_out, cin)
        acc += grouped_matmul(xs, w[:, k].contiguous(), groups)
    return epilogue_plain(acc.reshape(b, t_out, cout), bias=bias, relu=relu, lens=lens,
                          m=m, e=e, bits=bits, res=res, m_r=m_r, e_r=e_r, hcap=hcap,
                          shuffle=groups if shuffle else 1)


def dense_conv(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 0,
               dilation: int = 1, bias: Optional[torch.Tensor] = None, relu: bool = False,
               lens: Optional[torch.Tensor] = None, m=None,
               e: Optional[int] = None, bits: Optional[int] = None,
               res: Optional[torch.Tensor] = None, m_r=None,
               e_r: Optional[int] = None, in_bias: Optional[torch.Tensor] = None,
               in_relu: bool = False, in_len: Optional[torch.Tensor] = None,
               m1=None, e1: Optional[int] = None,
               bits1: Optional[int] = None, groups: int = 1, shuffle: bool = False,
               hcap=None, in_hcap=None) -> torch.Tensor:
    """Dense conv of x (B, T, Cin) with w (Cout, K, Cin) int8:
    y[b, t, o] = sum_k sum_c x[b, t*stride + k*dilation - padding, c] * w[o, k, c],
    frames outside [0, T) reading 0.

    Cin need not be a multiple of 16: the wrapper zero-pads it.  Prologue
    and epilogues are Kernel 2's (``pw_gemm``): prologue off, x is int8 or
    uint8 (a non-negative 9-bit code); on, x is int8 or int32 and each
    frame is first ``clamp(requant(mask(relu?(x + in_bias)), m1, e1),
    bits1)`` (frames t >= in_len[b] zeroed).  none: int32 ``relu?(y +
    bias)``; requant: int8 (uint8 for 9 bits with relu) ``clamp(requant(
    mask(relu?(y + bias)), m, e), bits)``, frames t >= lens[b] zeroed;
    join: int8 ``clamp(requant(y + bias, m, e) + requant(res, m_r, e_r),
    bits)``, res (B, T_out, Cout) int32.  ``groups``, ``shuffle``,
    ``hcap`` and ``in_hcap`` as in ``pw_gemm`` (w (Cout, K, Cin / groups)
    for a grouped conv)."""
    mode = _mode(m, res)
    if mode == MODE_JOIN and (relu or m is None):
        raise ValueError("dense_conv: join takes m and no relu")
    prologue_args("dense_conv", in_bias, in_relu, in_len, m1, in_hcap)
    if hcap is not None and not relu:
        raise ValueError("dense_conv: hcap (hardtanh's ceiling) needs relu")
    kw = dict(stride=stride, padding=padding, dilation=dilation, bias=bias, relu=relu,
              lens=lens, m=m, e=e, bits=bits, res=res, m_r=m_r, e_r=e_r, in_bias=in_bias,
              in_relu=in_relu, in_len=in_len, m1=m1, e1=e1, bits1=bits1, groups=groups,
              shuffle=shuffle, hcap=hcap, in_hcap=in_hcap)
    if x.device.type == "cpu":
        return dense_conv_plain(x, w, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"dense_conv: unsupported device {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"dense_conv: x must be (B, T, Cin) and w (Cout, K, Cin), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    group_width("dense_conv", x.shape[2], w.shape[0], groups)
    if x.shape[2] % 16 and groups == 1:
        x, w, in_bias, m1 = pad_k(x, w, in_bias, m1)
        if isinstance(in_hcap, torch.Tensor):
            in_hcap = F.pad(in_hcap, (0, (-in_hcap.shape[0]) % 16))
    b, t_in, cin = x.shape
    cout, k_size = w.shape[:2]
    pro, m1v, m1s, _, ee1, lo1, hi1, u8 = check_prologue("dense_conv", x, in_bias, in_len, m1,
                                                         e1, bits1, cin, b, in_relu=in_relu)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("dense_conv: x and w must be 16-byte aligned")
    p = check_launch(b, t_in, cin, cout, k_size, stride, padding, dilation, bool(pro), x.dtype,
                     groups)
    dev = x.device
    check_vec("dense_conv", "w", w, torch.int8, (cout, k_size, cin // groups), dev)
    t_out = out_frames(t_in, k_size, stride, padding, dilation)
    lo, hi, ee, ee_r, lens, out = check_epilogue("dense_conv", mode, (b, t_out, cout), dev,
                                                 bias, relu, lens, m, e, bits, res, m_r, e_r)
    hv, hs = cap_operand("dense_conv", "hcap", hcap, cout, dev, relu)
    ihv, ihs = cap_operand("dense_conv", "in_hcap", in_hcap, cin, dev, in_relu)
    args = (_build.ptr(x), _build.ptr(w), _build.ptr(bias), _build.ptr(m), _build.ptr(lens),
            _build.ptr(res), _build.ptr(m_r), _build.ptr(out), b, t_in, cin, t_out, cout, k_size,
            stride, padding, dilation, mode, int(relu), ee, ee_r, lo, hi, pro,
            int(x.dtype == torch.int32), _build.ptr(in_bias), int(in_relu), _build.ptr(in_len),
            _build.ptr(m1v), m1s, ee1, lo1, hi1, int(u8))
    lib = _build.library()
    if groups == 1:
        rc = lib.qasr_dense_conv(*args, p["bn"], p["stages"], p["ct_per"], 1, 0, _build.ptr(hv),
                                 hs, _build.ptr(ihv), ihs, _build.stream_of(x))
    else:
        f64, f64_1 = grouped_f64(mode, ee, ee_r, k_size, cin // groups, bool(u8), bias, pro,
                                 x.dtype, in_bias, ee1)
        args = (args[0], _build.ptr(packed(w, pack_grouped, groups, p["kgc"]))) + args[2:]
        rc = lib.qasr_dense_conv_grouped(
            *args, groups, int(bool(shuffle)), _build.ptr(hv), hs, _build.ptr(ihv), ihs,
            p["kgc"], p["stages"], p["t_per"], int(f64), int(f64_1), _build.stream_of(x))
        dense_conv.grouped_launches += 1
    _build.check(rc, "dense_conv")
    dense_conv.launches += 1
    return out


dense_conv.launches = 0
dense_conv.grouped_launches = 0   # of them, the grouped form's (dense_conv_grouped.cu)
