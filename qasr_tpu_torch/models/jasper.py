"""Jasper/QuartzNet plan, host parameters and the shared block walk
(port of qasr_tpu/models/jasper.py).

Layout stays channels-last (B, T, C), as in the JAX package, so the port's
tensors compare one to one with the reference's.  Parameter init, BN
folding and the range state are host numpy and give the same arrays as the
JAX package from the same ``np.random.default_rng(seed)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.models.config import DecoderConfig, EncoderConfig

BN_EPS = 1e-3  # nn.BatchNorm1d(eps=1e-3) in the reference's JasperBlock


# ---------------------------------------------------------------------------
# Plan: static structure resolved from config
# ---------------------------------------------------------------------------


def compute_new_kernel_size(kernel_size: int, factor: float) -> int:
    new = max(int(kernel_size * factor), 1)
    return new + 1 if new % 2 == 0 else new


def get_same_padding(kernel: int, stride: int, dilation: int) -> int:
    if stride > 1 and dilation > 1:
        raise ValueError("Only stride OR dilation may be greater than 1")
    if dilation > 1:
        return (dilation * kernel) // 2 - 1
    return kernel // 2


@dataclass(frozen=True)
class ConvSpec:
    in_ch: int
    out_ch: int
    kernel: int
    stride: int = 1
    dilation: int = 1
    groups: int = 1
    heads: int = -1
    padding: int = 0
    bias: bool = False
    has_bn: bool = True
    asymmetric: bool = False     # +1 act bit (post-ReLU input)
    end_of_repeat: bool = False  # activation follows inside the block


@dataclass(frozen=True)
class BlockPlan:
    index: int
    convs: Tuple[ConvSpec, ...]
    res: Tuple[ConvSpec, ...]
    residual: bool
    dense_residual: bool
    residual_mode: str
    dropout: float
    groups: int
    se: bool
    se_reduction_ratio: int = 8
    se_context_window: int = -1


@dataclass(frozen=True)
class EncoderPlan:
    blocks: Tuple[BlockPlan, ...]
    activation: str
    feat_in: int
    feat_out: int


def build_encoder_plan(cfg: EncoderConfig) -> EncoderPlan:
    """Resolve BlockConfigs into explicit conv specs (same plan as the JAX
    package's build_encoder_plan)."""
    feat_in = cfg.feat_in * cfg.frame_splicing
    blocks: List[BlockPlan] = []
    residual_panes: List[int] = []
    for bi, b in enumerate(cfg.blocks):
        kernel = compute_new_kernel_size(b.kernel[0], b.kernel_size_factor)
        stride, dilation = b.stride[0], b.dilation[0]
        padding = get_same_padding(kernel, stride, dilation)
        convs: List[ConvSpec] = []
        inp = feat_in
        for r in range(b.repeat):
            is_last_rep = r == b.repeat - 1
            s = stride if (is_last_rep or not b.stride_last) else 1
            is_first_conv = bi == 0 and r == 0
            if b.separable:
                convs.append(ConvSpec(
                    in_ch=inp, out_ch=inp, kernel=kernel, stride=s,
                    dilation=dilation, groups=inp, heads=b.heads, padding=padding,
                    has_bn=False, asymmetric=not is_first_conv))
                convs.append(ConvSpec(
                    in_ch=inp, out_ch=b.filters, kernel=1, groups=b.groups,
                    has_bn=True, asymmetric=False,
                    end_of_repeat=not is_last_rep))
            else:
                convs.append(ConvSpec(
                    in_ch=inp, out_ch=b.filters, kernel=kernel, stride=s,
                    dilation=dilation, groups=b.groups, heads=b.heads,
                    padding=padding, has_bn=True,
                    asymmetric=not is_first_conv, end_of_repeat=not is_last_rep))
            inp = b.filters
        res: List[ConvSpec] = []
        dense_residual = False
        if b.residual:
            res_stride = stride if b.residual_mode == "stride_add" else 1
            if b.residual_dense:
                residual_panes.append(feat_in)
                panes = list(residual_panes)
                dense_residual = True
            else:
                panes = [feat_in]
            for ip in panes:
                res.append(ConvSpec(
                    in_ch=ip, out_ch=b.filters, kernel=1, stride=res_stride,
                    has_bn=True, asymmetric=bi != 0))
        blocks.append(BlockPlan(
            index=bi, convs=tuple(convs), res=tuple(res), residual=b.residual,
            dense_residual=dense_residual, residual_mode=b.residual_mode,
            dropout=b.dropout, groups=b.groups, se=b.se,
            se_reduction_ratio=b.se_reduction_ratio,
            se_context_window=b.se_context_size))
        feat_in = b.filters
    return EncoderPlan(blocks=tuple(blocks), activation=cfg.activation,
                       feat_in=cfg.feat_in * cfg.frame_splicing, feat_out=feat_in)


def is_depthwise(spec: ConvSpec) -> bool:
    return (spec.groups == spec.in_ch and spec.groups > 1 and spec.kernel > 1
            and spec.heads == -1)


def is_pointwise(spec: ConvSpec) -> bool:
    return (spec.kernel == 1 and spec.groups == 1 and spec.stride == 1
            and spec.dilation == 1 and spec.padding == 0 and spec.heads == -1)


# ---------------------------------------------------------------------------
# Parameter init (xavier_uniform) and BN folding — host numpy
# ---------------------------------------------------------------------------


def _init_conv(rng: np.random.Generator, spec: ConvSpec, dtype=np.float32) -> Dict[str, Any]:
    if spec.heads != -1:
        cin_g, out_ch = 1, spec.heads
    else:
        cin_g, out_ch = spec.in_ch // spec.groups, spec.out_ch
    fan_in = cin_g * spec.kernel
    fan_out = out_ch * spec.kernel
    a = math.sqrt(6.0 / (fan_in + fan_out))
    p: Dict[str, Any] = {
        "w": rng.uniform(-a, a, (spec.kernel, cin_g, out_ch)).astype(dtype)
    }
    if spec.bias:
        p["b"] = np.zeros((spec.out_ch,), dtype)
    if spec.has_bn:
        p["bn"] = {
            "gamma": np.ones((spec.out_ch,), dtype),
            "beta": np.zeros((spec.out_ch,), dtype),
            "mean": np.zeros((spec.out_ch,), dtype),
            "var": np.ones((spec.out_ch,), dtype),
        }
    return p


def _rng(seed) -> np.random.Generator:
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(
        int(np.asarray(seed).sum()) if hasattr(seed, "shape") else seed)


def init_encoder_params(seed, plan: EncoderPlan) -> Dict[str, Any]:
    rng = _rng(seed)
    blocks = []
    for bp in plan.blocks:
        b = {"convs": [_init_conv(rng, s) for s in bp.convs],
             "res": [_init_conv(rng, s) for s in bp.res]}
        if bp.se:
            c = bp.convs[-1].out_ch
            r = max(c // bp.se_reduction_ratio, 1)
            a1 = math.sqrt(6.0 / (c + r))
            a2 = math.sqrt(6.0 / (r + c))
            b["se"] = {"fc1": rng.uniform(-a1, a1, (c, r)).astype(np.float32),
                       "fc2": rng.uniform(-a2, a2, (r, c)).astype(np.float32)}
        blocks.append(b)
    return {"blocks": blocks}


def init_decoder_params(seed, cfg: DecoderConfig, dtype=np.float32) -> Dict[str, Any]:
    rng = _rng(seed)
    v = cfg.num_classes + 1
    a = math.sqrt(6.0 / (cfg.feat_in + v))
    return {
        "w": rng.uniform(-a, a, (1, cfg.feat_in, v)).astype(dtype),
        "b": np.zeros((v,), dtype),
    }


def fold_bn_conv(p: Dict[str, Any], eps: float = BN_EPS) -> Dict[str, Any]:
    """W' = W * gamma/sigma ; b' = (b - mu) * gamma/sigma + beta."""
    if "bn" not in p:
        return p
    bn = {k: np.asarray(v) for k, v in p["bn"].items()}
    sf = bn["gamma"] / np.sqrt(bn["var"] + np.float32(eps))
    b0 = np.asarray(p["b"]) if "b" in p else np.zeros_like(bn["mean"])
    return {"w": np.asarray(p["w"]) * sf,
            "b": (b0 - bn["mean"]) * sf + bn["beta"]}


def fold_bn_encoder(params: Dict[str, Any]) -> Dict[str, Any]:
    return {"blocks": [
        {"convs": [fold_bn_conv(c) for c in b["convs"]],
         "res": [fold_bn_conv(c) for c in b["res"]]}
        for b in params["blocks"]
    ]}


def init_qstate(plan: EncoderPlan) -> Dict[str, Any]:
    z = lambda: {"x_min": np.zeros((), np.float32), "x_max": np.zeros((), np.float32)}
    return {
        "blocks": [
            {"convs": [z() for _ in bp.convs],
             "res": [z() for _ in bp.res],
             "res_act": z()}
            for bp in plan.blocks
        ],
        "decoder_act": z(),
    }


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def out_frames(t_in, k_size: int, stride: int, padding: int, dilation: int):
    """Output frames of a 1-D conv (an int, or numpy / torch integer lengths)."""
    return (t_in + 2 * padding - dilation * (k_size - 1) - 1) // stride + 1


def conv_out_len(lens, spec: ConvSpec):
    """MaskedConv1d's output lengths (numpy or torch integer lengths).  A
    stride-1 conv with 'same' padding keeps every length: ``lens`` itself
    comes back, with no arithmetic launched on the device for it."""
    if spec.stride == 1 and 2 * spec.padding == spec.dilation * (spec.kernel - 1):
        return lens
    return out_frames(lens, spec.kernel, spec.stride, spec.padding, spec.dilation)


def pad_frames_aligned(feats: torch.Tensor, mult: int = 64) -> torch.Tensor:
    """Zero-pad the frame axis of (B, T, C) to a multiple of ``mult`` (the
    JAX package's (B, T, C) executor shape, so outputs compare 1:1)."""
    pad = (-feats.shape[1]) % mult
    return F.pad(feats, (0, 0, 0, pad)) if pad else feats


def mask_values(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Zero the frames at and after each sample's length; x (B, T, C)."""
    keep = torch.arange(x.shape[1], device=lens.device)[None, :] < lens[:, None]
    return torch.where(keep[:, :, None], x, torch.zeros((), dtype=x.dtype, device=x.device))


def depthwise_conv_int(x: torch.Tensor, w: torch.Tensor, stride: int,
                       padding: int, dilation: int) -> torch.Tensor:
    """Integer depthwise conv as a sum of strided slices, int32 accumulate.
    x: (B, T, C) int, w: (K, C) int.  Returns (B, T_out, C) int32."""
    k_size = w.shape[0]
    xp = F.pad(x.to(torch.int32), (0, 0, padding, padding))
    t_out = out_frames(x.shape[1], k_size, stride, padding, dilation)
    acc = torch.zeros((x.shape[0], t_out, x.shape[2]), dtype=torch.int32,
                      device=x.device)
    wi = w.to(torch.int32)
    for k in range(k_size):
        start = k * dilation
        acc += xp[:, start:start + (t_out - 1) * stride + 1:stride] * wi[k]
    return acc


# ---------------------------------------------------------------------------
# The shared walk (JasperBlock.forward)
# ---------------------------------------------------------------------------


def block_forward(exec_, bp: BlockPlan, xs: List[Any], lens):
    out = xs[-1]
    lens_orig = lens
    n = len(bp.convs)
    for ci, spec in enumerate(bp.convs):
        out, lens = exec_.masked_conv((bp.index, "convs", ci), spec, out, lens)
        if bp.groups > 1 and spec.has_bn:
            out = exec_.group_shuffle(out, bp.groups)
        if spec.end_of_repeat and ci != n - 1:
            out = exec_.activation(out, bp.dropout)
    if bp.se:
        out = exec_.squeeze_excite(bp.index, out, bp)
    if bp.residual:
        for pi, rspec in enumerate(bp.res):
            res_out, _ = exec_.masked_conv((bp.index, "res", pi), rspec, xs[pi], lens_orig)
            out = exec_.residual_add(bp.index, pi, out, res_out, bp.residual_mode)
    out = exec_.activation(out, bp.dropout)
    block_end = getattr(exec_, "block_end", None)
    if block_end is not None:
        # a block output may feed several consumers (next block + residual
        # branches), each with its own input requant: fusing executors
        # materialize it here
        out = block_end(out)
    if bp.residual and bp.dense_residual:
        return xs + [out], lens
    return [out], lens


def encoder_forward(exec_, plan: EncoderPlan, x, lens):
    xs: List[Any] = [x]
    for bp in plan.blocks:
        xs, lens = block_forward(exec_, bp, xs, lens)
    return xs[-1], lens


DECODER_SPEC_TEMPLATE = dict(kernel=1, stride=1, dilation=1, groups=1, heads=-1,
                             padding=0, bias=True, has_bn=False, asymmetric=False)


def decoder_spec(feat_in: int, num_classes_with_blank: int) -> ConvSpec:
    return ConvSpec(in_ch=feat_in, out_ch=num_classes_with_blank, **DECODER_SPEC_TEMPLATE)
