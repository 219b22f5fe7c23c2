"""Kernel 4: the frozen Conformer's attention-output join plus its whole
conv module (kernels/csrc/conv_block.cu; the cache form's cluster kernel
in kernels/csrc/conv_block_cached.cu).

Replaces qasr_tpu/kernels/conf_module.py::fused_conv_block.  The TPU runs
one grid step per utterance; on the H100 that would fill 32 of 132 SMs,
so the kernel splits in time instead, in two launches with ``glu8`` as
the only intermediate in device memory:

  stage A, per 32-row tile of the (B*T, d) stream: att_out GEMM + bias
  and stream requants -> x1 (kept in the output buffer); i-LayerNorm ->
  affine requant; one (d -> 2d) GLU GEMM with per-half requants and the
  i-sigmoid of the gate (``sigmoid_table``); rows at or past ``len``
  zeroed; glu_prod requant -> glu8.
  stage B, per 32-frame tile of one utterance with a K-1 frame halo:
  time-packed dp4a depthwise taps over glu8 (zero outside [0, T); taps
  from ``pack_taps``); BN affine requant; i-swish (``swish_table``); pw2
  GEMM with the j3 stream join against x1 -> out.

The tables and the packed weights are built and validated once per layer
(``_packed``); a call checks only its activations.
``conv_block`` launches both stages for CUDA tensors (one launch count
per call) and runs ``conv_block_plain`` (the XLA composition of
qasr_tpu/quantize/conformer_freeze.py, in torch) for CPU tensors; it
never falls back from one to the other.

The cache form (``conv_block_cached``, the stream step of a causal
Conformer) is one launch of ``conv_block_cached_kernel`` over the n new
frames: a cluster of d / 64 CTAs takes the rows of whole utterances, each
CTA 64 columns of att_out and pw2 and the same 64 GLU and depthwise
channels, its slice of the layer held in shared memory (``cached_blob``);
its x1 columns, its share of the i-LN's rows and its mid8 columns go to
every CTA through distributed shared memory, and glu8 stays in its CTA.
The depthwise runs over [cache (K-1 rows) || glu8 (n rows)] with padding
(0, 0), no length mask; the new cache is the last K-1 rows of [cache ||
glu8].  Past 32 new frames an utterance no
longer fits the kernel's tile, and the C entry runs the offline form's two
stages over the n frames instead; it picks the form and reports it, and
``conv_block_cached.forms`` counts the form that ran.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import (
    affine_zmax,
    check_vec,
    check_x,
    f64_fits,
    f64_scale,
    weight_zmax,
)
from qasr_tpu_torch.models.jasper import mask_values
from qasr_tpu_torch.ops.integer_sigmoid import i_sigmoid_grid
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.quantize.conformer_int import (
    _conv_tail_mid,
    _glu_int,
    _join_lin,
    _ln_rq,
    clip8,
    swish_lut,
)

ROWS = 32            # rows per block in both stages (csrc/conv_block.cu)
MAX_D = 512
CTA_COLS = 64        # columns a CTA of the cache form's cluster owns (kCh)
SIG_TAB = 4544       # entries of the GLU sigmoid table (csrc/conformer_int.cuh kSigTab)


def conv_block_plain(c8: torch.Tensor, x8: torch.Tensor, lens: torch.Tensor,
                     tbl, padding, *, nbits: int) -> torch.Tensor:
    """Plain torch version: att_out join -> ln_conv -> GLU -> pad mask ->
    depthwise -> BN -> i-swish -> pw2 join.  Same arguments and result as
    ``conv_block``."""
    x1 = _join_lin(c8, tbl["att_out"], x8, tbl["j2_stream"], nbits)
    yln = _ln_rq(x1, tbl["ln_conv"], nbits)
    y_int = mask_values(_glu_int(tbl, yln, nbits), lens)
    glu8 = clip8(dyadic_requant_static(y_int, *tbl["glu_prod"]), nbits)
    mid8 = _conv_tail_mid(tbl, glu8, padding, nbits)
    return _join_lin(mid8, tbl["pw2"], x1, tbl["j3_stream"], nbits)


def conv_block_cached_plain(c8: torch.Tensor, x8: torch.Tensor, glu_cache: torch.Tensor,
                            tbl, *, nbits: int):
    """Plain torch version of the cache form: JAX's stream-step composition
    (att_out join -> ln_conv -> GLU, no mask -> depthwise over [cache ||
    new] with padding (0, 0) -> BN -> i-swish -> pw2 join).  Same arguments
    and results as ``conv_block_cached``."""
    x1 = _join_lin(c8, tbl["att_out"], x8, tbl["j2_stream"], nbits)
    yln = _ln_rq(x1, tbl["ln_conv"], nbits)
    glu8 = clip8(dyadic_requant_static(_glu_int(tbl, yln, nbits), *tbl["glu_prod"]), nbits)
    glu_cat = torch.cat([glu_cache, glu8], 1)
    mid8 = _conv_tail_mid(tbl, glu_cat, (0, 0), nbits)
    out = _join_lin(mid8, tbl["pw2"], x1, tbl["j3_stream"], nbits)
    return out, glu_cat[:, glu_cat.shape[1] - glu_cache.shape[1]:].contiguous()


def tap_groups(k_size: int):
    """(ng, ngp): the depthwise tap groups of four that Kernel 4's time-packed
    dp4a walks (the last output of a quad reaches tap 4 (ng - 1) + 3 - 3)
    and the int32 words per channel of ``pack_taps`` (a leading zero word,
    padded to an odd count so that a warp's channels fall on 32 banks)."""
    ng = (k_size + 2) // 4 + 1
    return ng, (ng + 1) | 1


def pack_taps(dw_w: torch.Tensor) -> torch.Tensor:
    """(K, d) int8 depthwise taps -> (d, ngp) int32: word 0 is 0, word 1 + g
    holds taps 4g..4g+3 (byte i = tap 4g + i, 0 past K) of the channel."""
    k_size, d = dw_w.shape
    ng, ngp = tap_groups(k_size)
    taps = torch.zeros((d, 4 * ngp), dtype=torch.uint8, device=dw_w.device)
    taps[:, 4:4 + k_size] = dw_w.t().contiguous().view(torch.uint8)
    return taps.view(torch.int32).contiguous()


def sigmoid_table(device) -> torch.Tensor:
    """i_sigmoid_grid at q in [0, SIG_TAB) as uint8: the kernel's GLU gate
    reads it at min(|q|, SIG_TAB - 1) and mirrors it for q < 0 (the
    function is odd about 64 and saturates from q = 4541)."""
    q = torch.arange(SIG_TAB, dtype=torch.int32, device=device)
    return i_sigmoid_grid(q).to(torch.uint8)


def swish_table(tbl, nbits: int) -> torch.Tensor:
    """The conv module's i-swish after the BN as a function of bn8: mid8 at
    index bn8 + 128, as uint8 (the bytes of the int8 result)."""
    return swish_lut(tbl["bn_grid"], tbl["bn_prod"], nbits, tbl["dw_w"].device)


def blob_layout(d: int, k_size: int) -> Dict[str, int]:
    """Byte offsets of one CTA's slice in ``cached_blob``
    (csrc/conv_block_cached.cu ``blob_layout``), in three parts that the
    kernel waits for one by one: "ao" its w_ao rows (each d + 16 bytes),
    "vc" its columns of the 14 int32 vectors, "mfc" its columns of the five
    per-column FP64 scales (att_out, GLU a, GLU g, BN, pw2), "sc" the 16
    scalars; from "b": "lnv" the ln affine's sgn / b / m whole, "lnf" its
    FP64 scale whole, "ag" its w_ag rows, "sig" the sigmoid table; from "c":
    "w2" its w_2 rows, "pw" its packed taps; "bytes" the slice's size."""
    ngp = tap_groups(k_size)[1]
    row = d + 16
    sizes = [("ao", CTA_COLS * row), ("vc", 14 * CTA_COLS * 4), ("mfc", 5 * CTA_COLS * 8),
             ("sc", 16 * 4), ("lnv", 3 * d * 4), ("lnf", d * 8), ("ag", 2 * CTA_COLS * row),
             ("sig", SIG_TAB), ("w2", CTA_COLS * row), ("pw", CTA_COLS * ngp * 4)]
    out, o = {}, 0
    for name, size in sizes:
        out[name] = o
        o += size
    out["b"], out["c"], out["bytes"] = out["lnv"], out["w2"], o
    return out


def cached_blob(p: Dict[str, Any]) -> torch.Tensor:
    """The cache form's slice of a layer for each CTA of its cluster of d /
    64, from the packed tables ``p`` (``_packed``): (d / 64, bytes) uint8
    laid out by ``blob_layout``.  CTA q's weight rows are w_ao[64q:64q+64],
    the interleaved w_ag[128q:128q+128] (its 64 GLU channels' a and g rows)
    and w_2[64q:64q+64], each padded with 16 zero bytes (the kernel's
    ldmatrix pitch); its columns are [64q, 64q + 64) of every per-column
    vector and scale and its taps those channels'.  Bulk copies lay a slice
    out as the kernel reads it."""
    d = p["w_ao"].shape[1]
    c = d // CTA_COLS

    def u8(t):
        return t.contiguous().view(torch.uint8).reshape(c, -1)

    def cols(t):   # (rows, d) -> (c, rows, 64): each CTA's columns
        return t.reshape(t.shape[0], c, CTA_COLS).transpose(0, 1)

    def whole(t):
        return t.reshape(1, -1).expand(c, -1)

    def rows(w, k):   # CTA q's k-row slices, padded to d + 16 bytes
        return torch.nn.functional.pad(w.reshape(c, k, d), (0, 16))

    parts = [rows(p["w_ao"], CTA_COLS), cols(p["vec"]), cols(p["mf"][:5]), whole(p["sc"]),
             whole(p["vec"][2:5]), whole(p["mf"][5]), rows(p["w_ag"], 2 * CTA_COLS),
             whole(p["sig"]), rows(p["w_2"], CTA_COLS), p["dw_p"].reshape(c, -1)]
    return torch.cat([u8(t) for t in parts], dim=1).contiguous()


def _f64_scales(tbl):
    """(mf, ok): the per-column sites' m 2^-e as a (6, d) float64 tensor
    (att_out, GLU a, GLU g, BN, pw2, ln affine), and whether every column
    of them and the glu_prod requant stay in qasr_rq_f64's domain for
    every int8 input (``checks.f64_fits``): |z| is bounded by
    ``checks.weight_zmax`` at the linear sites, by 128 times the column's
    tap L1 norm times |sgn| plus |bias| at the BN, by
    ``checks.affine_zmax`` at the ln affine, and by 127 * 128 for
    glu_prod's a8 * sigmoid."""
    bn = tbl["dw_bn"]
    dw_zmax = (128 * tbl["dw_w"].to(torch.int64).abs().sum(0) * bn["sgn"].to(torch.int64).abs()
               + bn["b"].to(torch.int64).abs())
    ln = tbl["ln_conv"]

    def lin(name):
        return weight_zmax(tbl[name]), tbl[name]["m"], tbl[name]["e"]
    sites = [lin("att_out"), lin("pw1_a"), lin("pw1_g"), (dw_zmax, bn["m"], bn["e"]), lin("pw2"),
             (affine_zmax(ln), ln["m"], ln["e"])]
    ok = all(f64_fits(z, m, e) for z, m, e in sites)
    m_glu, e_glu = tbl["glu_prod"]
    ok = ok and f64_fits(torch.tensor([127 * 128]), torch.tensor([int(m_glu)]), e_glu)
    mf = torch.stack([f64_scale(m, e) for _, m, e in sites]).contiguous()
    return mf, ok


def _packed(tbl) -> Dict[str, Any]:
    """The kernel's table layout, built and validated once per layer table
    and cached in it: the GLU weights interleaved so that each 64-row chunk
    holds 16 a-rows then the matching 16 g-rows, twice; the depthwise taps
    packed four a word (``pack_taps``); the per-channel int32 vectors
    stacked (14, d); the static scalars as one int32 vector; the GLU
    sigmoid table; the i-swish table per activation width (``swish``); the
    per-column sites' requant scales in float64 and whether the kernel may
    requant them on the FP64 pipe (``_f64_scales``); the cache form's
    per-CTA weight slices (``cached_blob``)."""
    if "_conv_block" in tbl:
        return tbl["_conv_block"]
    a, g = tbl["pw1_a"], tbl["pw1_g"]
    d = a["wt"].shape[0]
    k_size = tbl["dw_w"].shape[0]
    w_ag = torch.stack([a["wt"].reshape(d // 16, 16, d),
                        g["wt"].reshape(d // 16, 16, d)], dim=1).reshape(2 * d, d)
    vec = torch.stack([
        tbl["att_out"]["b"], tbl["att_out"]["m"],
        tbl["ln_conv"]["sgn"], tbl["ln_conv"]["b"], tbl["ln_conv"]["m"],
        a["b"], a["m"], g["b"], g["m"],
        tbl["dw_bn"]["sgn"], tbl["dw_bn"]["b"], tbl["dw_bn"]["m"],
        tbl["pw2"]["b"], tbl["pw2"]["m"]]).to(torch.int32).contiguous()
    scalars = [tbl["att_out"]["e"], *tbl["j2_stream"], tbl["ln_conv"]["e"],
               a["e"], g["e"], *tbl["glu_prod"], tbl["dw_bn"]["e"],
               *tbl["bn_grid"], *tbl["bn_prod"], tbl["pw2"]["e"], *tbl["j3_stream"]]
    dev = a["wt"].device
    packed = {"w_ao": tbl["att_out"]["wt"].contiguous(), "w_ag": w_ag.contiguous(),
              "dw_p": pack_taps(tbl["dw_w"]), "w_2": tbl["pw2"]["wt"].contiguous(),
              "vec": vec,
              "sc": torch.tensor([int(s) for s in scalars], dtype=torch.int32, device=dev),
              "sig": sigmoid_table(dev), "swish": {}}
    packed["mf"], packed["f64"] = _f64_scales(tbl)
    packed["blob"] = cached_blob(packed)
    if dev.type == "cuda":
        shapes = {"w_ao": ((d, d), torch.int8), "w_ag": ((2 * d, d), torch.int8),
                  "dw_p": ((d, tap_groups(k_size)[1]), torch.int32),
                  "w_2": ((d, d), torch.int8), "vec": ((14, d), torch.int32),
                  "sc": ((16,), torch.int32), "sig": ((SIG_TAB,), torch.uint8),
                  "mf": ((6, d), torch.float64),
                  "blob": ((d // CTA_COLS, blob_layout(d, k_size)["bytes"]), torch.uint8)}
        for name, (shape, dtype) in shapes.items():
            check_vec("conv_block", name, packed[name], dtype, shape, dev)
            if packed[name].data_ptr() % 16:
                raise ValueError(f"conv_block: packed {name} is not 16-byte aligned")
    tbl["_conv_block"] = packed
    return packed


def _check_call(name: str, c8: torch.Tensor, x8: torch.Tensor, tbl, nbits: int):
    """The activations of a CUDA call and the layer's packed tables:
    (b, t, d, k_size, packed, swish table)."""
    check_x(f"{name} x8", x8, 3)
    check_x(f"{name} c8", c8, 3)
    b, t, d = x8.shape
    dev = x8.device
    check_vec(name, "c8", c8, torch.int8, (b, t, d), dev)
    k_size = tbl["dw_w"].shape[0]
    if b * t == 0 or d % 64 or d > MAX_D or not 2 <= nbits <= 8 or x8.data_ptr() % 16 \
            or c8.data_ptr() % 16:
        raise ValueError(f"{name}: needs B*T > 0, d a multiple of 64 up to {MAX_D}, nbits "
                         f"in [2, 8] and aligned inputs (got B={b} T={t} d={d} K={k_size})")
    p = _packed(tbl)
    if p["vec"].device != dev or p["vec"].shape[1] != d:
        raise ValueError(f"{name}: the layer's tables are for d={p['vec'].shape[1]} "
                         f"on {p['vec'].device}, the input is d={d} on {dev}")
    swish = p["swish"].get(nbits)
    if swish is None:
        swish = p["swish"][nbits] = swish_table(tbl, nbits)
    return b, t, d, k_size, p, swish


def _launch(c8, x8, lens, p, swish, glu8, out, k_size, pad_l, nbits):
    b, t, d = x8.shape
    rc = _build.library().qasr_conv_block(
        _build.ptr(c8), _build.ptr(x8), _build.ptr(lens), _build.ptr(p["w_ao"]),
        _build.ptr(p["w_ag"]), _build.ptr(p["dw_p"]), _build.ptr(p["w_2"]),
        _build.ptr(p["vec"]), _build.ptr(p["sc"]), _build.ptr(p["mf"] if p["f64"] else None),
        _build.ptr(p["sig"]), _build.ptr(swish), _build.ptr(glu8), _build.ptr(out),
        None, None, b, t, d, k_size, pad_l, 0, 2 ** (nbits - 1) - 1, _build.stream_of(x8))
    _build.check(rc, "conv_block")


def conv_block(c8: torch.Tensor, x8: torch.Tensor, lens: torch.Tensor, tbl,
               padding, *, nbits: int) -> torch.Tensor:
    """The frozen conv-module sublayer with the attention-output join in
    front: c8 the attention context (B, T, d) int8, x8 the int8 stream
    entering the attention sublayer, lens (B,) int32, tbl one layer of
    ``conformer_tables_to_device``, padding the depthwise (left, right).
    Returns the int8 stream after the conv module's join."""
    if x8.device.type == "cpu":
        return conv_block_plain(c8, x8, lens, tbl, padding, nbits=nbits)
    if x8.device.type != "cuda":
        raise ValueError(f"conv_block: unsupported device {x8.device}")
    b, t, d, k_size, p, swish = _check_call("conv_block", c8, x8, tbl, nbits)
    check_vec("conv_block", "lens", lens, torch.int32, (b,), x8.device)
    pad_l, pad_r = int(padding[0]), int(padding[1])
    if pad_l + pad_r != k_size - 1:
        raise ValueError(f"conv_block: padding {padding} must sum to K-1 = {k_size - 1}")
    glu8 = torch.empty((b, t, d), dtype=torch.int8, device=x8.device)
    out = torch.empty((b, t, d), dtype=torch.int8, device=x8.device)
    _launch(c8, x8, lens, p, swish, glu8, out, k_size, pad_l, nbits)
    conv_block.launches += 1
    return out


conv_block.launches = 0


def conv_block_cached(c8: torch.Tensor, x8: torch.Tensor, glu_cache: torch.Tensor, tbl, *,
                      nbits: int):
    """The cache form: c8 and x8 (B, n, d) int8 of the n new frames,
    glu_cache (B, K-1, d) int8 (the last K-1 GLU rows, zeros before the
    stream's start: the offline causal left padding).  Returns (the int8
    stream after the conv module's join, the new cache).  On the card one
    call runs in the form the C entry's plan picks ("cluster": one launch
    where an utterance's n rows fit the 32-row tile; "staged": the offline
    form's two stages past that): the counts go to ``launches`` and
    ``forms``, the plan (form, utterances a tile, clusters, shared memory
    bytes a CTA) to ``last_config``."""
    if x8.device.type == "cpu":
        return conv_block_cached_plain(c8, x8, glu_cache, tbl, nbits=nbits)
    if x8.device.type != "cuda":
        raise ValueError(f"conv_block_cached: unsupported device {x8.device}")
    b, n, d, k_size, p, swish = _check_call("conv_block_cached", c8, x8, tbl, nbits)
    if k_size < 2:
        raise ValueError("conv_block_cached: a kernel of K >= 2 taps keeps a cache")
    check_x("conv_block_cached glu_cache", glu_cache, 3)
    check_vec("conv_block_cached", "glu_cache", glu_cache, torch.int8, (b, k_size - 1, d),
              x8.device)
    if glu_cache.data_ptr() % 16:
        raise ValueError("conv_block_cached: glu_cache must be 16-byte aligned")
    glu8 = torch.empty((b, n, d), dtype=torch.int8, device=x8.device)
    out = torch.empty((b, n, d), dtype=torch.int8, device=x8.device)
    new_cache = torch.empty_like(glu_cache)
    cfg = (ctypes.c_int * 4)()
    rc = _build.library().qasr_conv_block_cached(
        _build.ptr(c8), _build.ptr(x8), _build.ptr(p["blob"]), _build.ptr(p["w_ao"]),
        _build.ptr(p["w_ag"]), _build.ptr(p["dw_p"]), _build.ptr(p["w_2"]),
        _build.ptr(p["vec"]), _build.ptr(p["sc"]), _build.ptr(p["mf"] if p["f64"] else None),
        _build.ptr(p["sig"]), _build.ptr(swish), _build.ptr(glu_cache), _build.ptr(new_cache),
        _build.ptr(glu8), _build.ptr(out), b, n, d, k_size, 2 ** (nbits - 1) - 1,
        ctypes.addressof(cfg), _build.stream_of(x8))
    _build.check(rc, "conv_block_cached")
    ran = "cluster" if cfg[0] else "staged"
    conv_block_cached.launches += 1
    conv_block_cached.forms[ran] += 1
    conv_block_cached.last_config = {"form": ran, "utterances": cfg[1], "clusters": cfg[2],
                                     "smem": cfg[3]}
    return out, new_cache


conv_block_cached.launches = 0
conv_block_cached.forms = {"cluster": 0, "staged": 0}
conv_block_cached.last_config = None
