"""Conformer encoder: configuration, host parameters and the float
subsampler (port of the serving subset of qasr_tpu/models/conformer.py).

Parameters are host numpy drawn from ``np.random.default_rng`` in the JAX
package's order, so the same seed gives the same arrays bit for bit.
Layout stays (B, T, D) channels-last.  The subsampler's convolutions are
the one float region in front of the integer encoder; they run in float32
with TF32 off (the JAX package's ``QASR_SUB_PREC=hi`` lowering): a
lower-precision lowering flips first-site int8 codes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.device import no_tf32


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
