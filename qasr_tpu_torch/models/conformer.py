"""Conformer encoder: configuration, host parameters, the float subsampler
and the float encoder (port of qasr_tpu/models/conformer.py).

Parameters are host numpy drawn from ``np.random.default_rng`` in the JAX
package's order, so the same seed gives the same arrays bit for bit;
``encoder_params_to_device`` makes the torch tree the float and
quantized forwards take.  Layout stays (B, T, D) channels-last.  Every
float region runs in float32 with TF32 off (the JAX package's
``QASR_SUB_PREC=hi`` lowering for the subsampler): a lower-precision
lowering flips first-site int8 codes.  The encoder's depthwise conv is a
plain ``F.conv1d(groups=C)``, standing in for the JAX package's
partitioner-safe ``ops/grouped_conv.py``.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.device import no_tf32
from qasr_tpu_torch.quantize.ranges import params_to_device


@dataclass(frozen=True)
class ConformerConfig:
    feat_in: int
    n_layers: int = 16
    d_model: int = 256
    feat_out: int = -1
    subsampling: str = "striding"       # 'vggnet' | 'striding' | '' (linear)
    subsampling_factor: int = 4
    subsampling_conv_channels: int = 64
    ff_expansion_factor: int = 4
    self_attention_model: str = "rel_pos"
    pos_emb_max_len: int = 5000
    n_heads: int = 4
    xscaling: bool = True
    untie_biases: bool = False
    conv_kernel_size: int = 31
    # int: both sides; (left, right): each side; -1 = unlimited
    att_context_size: Any = -1
    causal_conv: bool = False
    dropout: float = 0.1
    dropout_emb: float = 0.1
    dropout_att: float = 0.0

    @property
    def att_context(self) -> Tuple[int, int]:
        """(left, right) attention context; (-1, -1) = unlimited."""
        v = self.att_context_size
        if v is None:
            return (-1, -1)
        if isinstance(v, (tuple, list)):
            return (int(v[0]), int(v[1]))
        return (int(v), int(v))

    @property
    def dw_padding(self) -> Tuple[int, int]:
        k = self.conv_kernel_size
        return (k - 1, 0) if self.causal_conv else ((k - 1) // 2, (k - 1) // 2)

    @property
    def d_ff(self) -> int:
        return self.d_model * self.ff_expansion_factor


# ---------------------------------------------------------------------------
# init (torch Linear/Conv default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)))
# ---------------------------------------------------------------------------


def _linear(rng, din, dout, bias=True):
    bound = 1.0 / math.sqrt(din)
    p = {"w": rng.uniform(-bound, bound, (din, dout)).astype(np.float32)}
    if bias:
        p["b"] = rng.uniform(-bound, bound, (dout,)).astype(np.float32)
    return p


def _conv2d(rng, cin, cout, k):
    bound = 1.0 / math.sqrt(cin * k * k)
    return {"w": rng.uniform(-bound, bound, (k, k, cin, cout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def _conv1d(rng, cin_g, cout, k):
    bound = 1.0 / math.sqrt(cin_g * k)
    return {"w": rng.uniform(-bound, bound, (k, cin_g, cout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (cout,)).astype(np.float32)}


def _ln(d):
    return {"gamma": np.ones((d,), np.float32), "beta": np.zeros((d,), np.float32)}


def init_conformer_params(seed, cfg: ConformerConfig) -> Dict[str, Any]:
    """Host parameters, drawn in the JAX package's order (HWIO conv
    kernels, (din, dout) linear weights)."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.n_heads
    d_k = d // h
    params: Dict[str, Any] = {}
    if cfg.subsampling:
        n_sub = int(math.log2(cfg.subsampling_factor))
        convs = []
        cin = 1
        cc = cfg.subsampling_conv_channels
        for _ in range(n_sub):
            if cfg.subsampling == "vggnet":
                convs.append({"c1": _conv2d(rng, cin, cc, 3), "c2": _conv2d(rng, cc, cc, 3)})
            else:
                convs.append({"c1": _conv2d(rng, cin, cc, 3)})
            cin = cc
        f_out = cfg.feat_in
        for _ in range(n_sub):
            f_out = _sub_out_len(f_out, cfg.subsampling)
        params["pre_encode"] = {"convs": convs, "out": _linear(rng, cc * f_out, d)}
    else:
        params["pre_encode"] = {"linear": _linear(rng, cfg.feat_in, d)}
    if cfg.self_attention_model == "rel_pos" and not cfg.untie_biases:
        params["pos_bias_u"] = np.zeros((h, d_k), np.float32)
        params["pos_bias_v"] = np.zeros((h, d_k), np.float32)
    layers = []
    for _ in range(cfg.n_layers):
        lp = {
            "norm_ff1": _ln(d), "ff1": {"l1": _linear(rng, d, cfg.d_ff),
                                        "l2": _linear(rng, cfg.d_ff, d)},
            "norm_conv": _ln(d),
            "conv": {"pw1": _conv1d(rng, d, 2 * d, 1),
                     "dw": _conv1d(rng, 1, d, cfg.conv_kernel_size),
                     "bn": {"gamma": np.ones((d,), np.float32),
                            "beta": np.zeros((d,), np.float32),
                            "mean": np.zeros((d,), np.float32),
                            "var": np.ones((d,), np.float32)},
                     "pw2": _conv1d(rng, d, d, 1)},
            "norm_att": _ln(d),
            "att": {"q": _linear(rng, d, d), "k": _linear(rng, d, d),
                    "v": _linear(rng, d, d), "out": _linear(rng, d, d),
                    "pos": _linear(rng, d, d, bias=False)},
            "norm_ff2": _ln(d), "ff2": {"l1": _linear(rng, d, cfg.d_ff),
                                        "l2": _linear(rng, cfg.d_ff, d)},
            "norm_out": _ln(d),
        }
        if cfg.untie_biases and cfg.self_attention_model == "rel_pos":
            lp["pos_bias_u"] = np.zeros((h, d_k), np.float32)
            lp["pos_bias_v"] = np.zeros((h, d_k), np.float32)
        layers.append(lp)
    params["layers"] = layers
    if cfg.feat_out > 0 and cfg.feat_out != d:
        params["out_proj"] = _linear(rng, d, cfg.feat_out)
    return params


# ---------------------------------------------------------------------------
# masks, lengths, positions
# ---------------------------------------------------------------------------


def attention_mask(valid: torch.Tensor, att_context_size) -> torch.Tensor:
    """(B, T, T) bool, True = masked: padding pairs, and pairs outside the
    local context (query i may attend key j iff -right <= i - j <= left)."""
    t = valid.shape[1]
    mask = ~(valid[:, :, None] & valid[:, None, :])
    if isinstance(att_context_size, (tuple, list)):
        left, right = int(att_context_size[0]), int(att_context_size[1])
    elif att_context_size is None:
        left = right = -1
    else:
        left = right = int(att_context_size)
    if left >= 0 or right >= 0:
        idx = torch.arange(t, device=valid.device)
        diff = idx[:, None] - idx[None, :]
        far = torch.zeros((t, t), dtype=torch.bool, device=valid.device)
        if left >= 0:
            far |= diff > left
        if right >= 0:
            far |= -diff > right
        mask = mask | far[None]
    return mask


def _sub_out_len(length: int, kind: str) -> int:
    if kind == "vggnet":  # maxpool k2 s2 ceil
        return int(math.ceil((length - 2) / 2 + 1))
    return int(math.floor((length - 3) / 2 + 1))  # conv k3 s2 p0


def _sub_out_len_arr(lens: torch.Tensor, kind: str) -> torch.Tensor:
    """Subsampled lengths in float32 arithmetic, as the JAX package."""
    if kind == "vggnet":
        return torch.ceil((lens - 2) / 2 + 1).to(lens.dtype)
    return torch.floor((lens.to(torch.float32) - 3) / 2 + 1).to(lens.dtype)


def rel_positional_encoding(t: int, d_model: int):
    """(2T-1, d_model) float32 sinusoids over relative positions
    -(T-1)..(T-1)."""
    pos = np.arange(-(t - 1), t, 1.0)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(math.log(10000.0) / d_model))
    pe = np.zeros((2 * t - 1, d_model), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# the float subsampler
# ---------------------------------------------------------------------------


def subsampler_to_device(p, device) -> Dict[str, Any]:
    """Subsampler conv params (HWIO numpy) -> torch OIHW float32 tensors."""
    def conv(c):
        return {"w": torch.from_numpy(np.ascontiguousarray(
                    np.transpose(np.asarray(c["w"], np.float32), (3, 2, 0, 1)))).to(device),
                "b": torch.from_numpy(np.asarray(c["b"], np.float32)).to(device)}
    return {"convs": [{k: conv(v) for k, v in blk.items()} for blk in p["convs"]]}


def subsample_convs(p, cfg: ConformerConfig, x: torch.Tensor, lens: torch.Tensor):
    """The subsampler's conv stack + channel flatten, without the d_model
    projection: (B, T, F) float32 -> ((B, T', c*f), lens').  ``p`` from
    ``subsampler_to_device``.  float32 with TF32 off."""
    if cfg.subsampling != "striding":
        raise NotImplementedError(f"subsampling {cfg.subsampling!r} is not ported")
    with no_tf32():
        y = x.to(torch.float32)[:, None]                     # (B, 1, T, F)
        for blk in p["convs"]:
            # the bias is added after the convolution, as the JAX package does
            y = torch.relu(F.conv2d(y, blk["c1"]["w"], stride=2)
                           + blk["c1"]["b"][:, None, None])
            lens = _sub_out_len_arr(lens, cfg.subsampling)
    b, c, t, f = y.shape
    return y.permute(0, 2, 1, 3).reshape(b, t, c * f), lens


def conv_subsampling(p, cfg: ConformerConfig, x: torch.Tensor, lens: torch.Tensor):
    """(B, T, F) -> ((B, T', d_model), lens'): the conv stack, then the
    ``out`` projection."""
    y, lens = subsample_convs(p, cfg, x, lens)
    return _apply_linear(p["out"], y), lens


# ---------------------------------------------------------------------------
# the float encoder (torch params from ``encoder_params_to_device``)
# ---------------------------------------------------------------------------


def encoder_params_to_device(params, device) -> Dict[str, Any]:
    """Host encoder params -> float32 torch tensors on ``device``, the
    subsampler's conv kernels as OIHW (``subsampler_to_device``)."""
    tree = params_to_device(params, device)
    if "convs" in params["pre_encode"]:
        tree["pre_encode"].update(subsampler_to_device(params["pre_encode"], device))
    return tree


@functools.lru_cache(maxsize=16)
def position_tables(t: int, d_model: int, device: torch.device):
    """(the (2T-1, d) sinusoid table, the (T, T) rel-shift index
    T-1+i-j) on ``device``, built once per length (so a captured CUDA
    graph finds them there)."""
    pe = torch.from_numpy(rel_positional_encoding(t, d_model)).to(device)
    i = torch.arange(t, device=device)
    return pe, (t - 1) + i[:, None] - i[None, :]


def _apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    return y + p["b"] if "b" in p else y


def _layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["gamma"] + p["beta"]


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rel_shift(bd_full: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, H, T, 2T-1) position scores -> (B, H, T, T): column j of row i
    reads position T-1+i-j (the legacy rel-shift)."""
    b, h, t, _ = bd_full.shape
    return torch.gather(bd_full, -1, idx.expand(b, h, t, t))


def _masked_softmax(scores: torch.Tensor, mask_h: torch.Tensor) -> torch.Tensor:
    scores = torch.where(mask_h, torch.finfo(scores.dtype).min, scores)
    return torch.where(mask_h, 0.0, torch.softmax(scores, dim=-1))


def rel_attention(p, x: torch.Tensor, pos_emb: torch.Tensor, idx: torch.Tensor,
                  att_mask: torch.Tensor, pos_bias_u, pos_bias_v, n_heads: int) -> torch.Tensor:
    """Relative-position multi-head attention: scores[i, j] =
    ((q_i + u) . k_j + (q_i + v) . P[T-1+i-j]) / sqrt(d_k)."""
    b, t, d = x.shape
    d_k = d // n_heads
    q = _apply_linear(p["q"], x).reshape(b, t, n_heads, d_k)
    k = _apply_linear(p["k"], x).reshape(b, t, n_heads, d_k)
    v = _apply_linear(p["v"], x).reshape(b, t, n_heads, d_k)
    pos = _apply_linear(p["pos"], pos_emb).reshape(2 * t - 1, n_heads, d_k)
    ac = torch.einsum("bihd,bjhd->bhij", q + pos_bias_u, k)
    bd = rel_shift(torch.einsum("bihd,phd->bhip", q + pos_bias_v, pos), idx)
    attn = _masked_softmax((ac + bd) / math.sqrt(d_k), att_mask[:, None])
    ctx = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, t, d)
    return _apply_linear(p["out"], ctx)


def abs_attention(p, x: torch.Tensor, att_mask: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    d_k = d // n_heads
    q = _apply_linear(p["q"], x).reshape(b, t, n_heads, d_k)
    k = _apply_linear(p["k"], x).reshape(b, t, n_heads, d_k)
    v = _apply_linear(p["v"], x).reshape(b, t, n_heads, d_k)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(d_k)
    attn = _masked_softmax(scores, att_mask[:, None])
    ctx = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, t, d)
    return _apply_linear(p["out"], ctx)


def depthwise_conv_float(y: torch.Tensor, w: torch.Tensor, padding: Tuple[int, int]):
    """Depthwise conv of (B, T, C) float32 with (K, 1, C) taps, (left,
    right) zero padding, no bias: ``F.conv1d(groups=C)``."""
    c = y.shape[-1]
    yc = F.pad(y.transpose(1, 2), tuple(padding))
    return F.conv1d(yc, w.permute(2, 1, 0), groups=c).transpose(1, 2)


def conformer_conv_module(p, x: torch.Tensor, pad_mask: torch.Tensor,
                          stats_out: Optional[list] = None,
                          padding: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """pw1 -> GLU -> mask -> depthwise -> BN (running statistics) -> swish
    -> pw2.  ``stats_out`` collects the pre-BN depthwise output's
    pad-masked per-channel batch (mean, var), what data-free synthesis
    matches."""
    y = _apply_linear({"w": p["pw1"]["w"][0], "b": p["pw1"]["b"]}, x)
    a, g = torch.chunk(y, 2, dim=-1)
    y = torch.where(pad_mask[:, :, None], 0.0, a * torch.sigmoid(g))
    k = p["dw"]["w"].shape[0]
    if padding is None:
        padding = ((k - 1) // 2, (k - 1) // 2)
    y = depthwise_conv_float(y, p["dw"]["w"], padding) + p["dw"]["b"]
    if stats_out is not None:
        # padded frames hold bias values, not data
        vm = (~pad_mask)[:, :, None].to(y.dtype)
        cnt = vm.sum().clamp_min(1.0)
        mu = (y * vm).sum(dim=(0, 1)) / cnt
        var = (vm * (y - mu) ** 2).sum(dim=(0, 1)) / cnt
        stats_out.append((mu, var))
    bn = p["bn"]
    y = (y - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) * bn["gamma"] + bn["beta"]
    return _apply_linear({"w": p["pw2"]["w"][0], "b": p["pw2"]["b"]}, _swish(y))


def _feed_forward(p, x: torch.Tensor) -> torch.Tensor:
    return _apply_linear(p["l2"], _swish(_apply_linear(p["l1"], x)))


def encoder_masks(cfg: ConformerConfig, t: int, lens: torch.Tensor):
    """(valid (B, T) bool, attention mask (B, T, T), True = masked)."""
    valid = torch.arange(t, device=lens.device)[None, :] < lens[:, None]
    return valid, attention_mask(valid, cfg.att_context_size)


def conformer_encoder_apply(params, cfg: ConformerConfig, x: torch.Tensor, lens: torch.Tensor,
                            *, train: bool = False,
                            bn_stats: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, F) float32 features -> ((B, T', d) encodings, lens'), the
    eval graph (no dropout), float32 with TF32 off.  ``params`` from
    ``encoder_params_to_device``; ``bn_stats``, a list, collects each conv
    module's pre-BN (mean, var)."""
    if train:
        raise NotImplementedError("train-mode dropout is not ported (ROADMAP queue A "
                                  "item 12, training)")
    with no_tf32():
        if cfg.subsampling:
            x, lens = conv_subsampling(params["pre_encode"], cfg, x, lens)
        else:
            x = _apply_linear(params["pre_encode"]["linear"], x.to(torch.float32))
        t = x.shape[1]
        if cfg.xscaling:
            x = x * math.sqrt(cfg.d_model)
        pos_emb, idx = position_tables(t, cfg.d_model, x.device)
        valid, att_mask = encoder_masks(cfg, t, lens)
        pad_mask = ~valid
        u, v = params.get("pos_bias_u"), params.get("pos_bias_v")
        for lp in params["layers"]:
            x = 0.5 * _feed_forward(lp["ff1"], _layer_norm(lp["norm_ff1"], x)) + x
            y = _layer_norm(lp["norm_att"], x)
            if cfg.self_attention_model == "rel_pos":
                y = rel_attention(lp["att"], y, pos_emb, idx, att_mask,
                                  lp.get("pos_bias_u", u), lp.get("pos_bias_v", v), cfg.n_heads)
            else:
                y = abs_attention(lp["att"], y, att_mask, cfg.n_heads)
            x = y + x
            x = conformer_conv_module(lp["conv"], _layer_norm(lp["norm_conv"], x), pad_mask,
                                      stats_out=bn_stats, padding=cfg.dw_padding) + x
            x = 0.5 * _feed_forward(lp["ff2"], _layer_norm(lp["norm_ff2"], x)) + x
            x = _layer_norm(lp["norm_out"], x)
        if "out_proj" in params:
            x = _apply_linear(params["out_proj"], x)
    return x, lens
