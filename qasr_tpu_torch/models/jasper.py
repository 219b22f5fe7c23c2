"""Jasper/QuartzNet plan, host parameters, the shared block walk and its
float and calibrating executors (port of qasr_tpu/models/jasper.py).

Layout stays channels-last (B, T, C), as in the JAX package, so the port's
tensors compare one to one with the reference's.  Parameter init, BN
folding and the range state are host numpy and give the same arrays as the
JAX package from the same ``np.random.default_rng(seed)``.

Executors of the walk besides the frozen ones (quantize/freeze.py):
  * ``FloatExec``  float32 convs (TF32 off), BN folded or not; collects the
                   pre-BN (mean, var) per BN site for data-free synthesis.
  * ``QuantExec``  integer convs with in-graph scales: calibration (the
                   running ranges of every activation site) and dynamic
                   quantization (per-batch ranges).  Depthwise convs (and
                   ``heads`` convs, their taps tiled over the channels) run
                   in Kernel 1, pointwise convs in Kernel 2 and dense convs
                   (Jasper's) in Kernel 8, grouped ones in the grouped
                   forms of Kernels 2 and 8, all without their requant
                   epilogue; on CPU tensors the wrappers run their plain
                   versions.

Both take grouped convs with GroupShuffle and the non-ReLU activations
(hardtanh, selu, swish); SqueezeExcite is float-only, as in the JAX package
and the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.device import no_tf32
from qasr_tpu_torch.kernels.checks import act_dtype, join_planes, signed_planes, split_planes
from qasr_tpu_torch.models.config import DecoderConfig, EncoderConfig, QuantConfig
from qasr_tpu_torch.ops.dropout import dropout as drop
from qasr_tpu_torch.ops.quant_prims import (
    QTensor,
    mask_values,
    quantize,
    requantize,
    requantize_approx,
    symmetric_scale,
)
from qasr_tpu_torch.quantize.ranges import batch_ranges, copy_tree, ema_ranges

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
    """A depthwise conv (one input channel a group, K 1 too, as the JAX
    package's conv_nwc takes it) or a ``heads`` conv: the same weights on
    every ``heads``-th channel, a depthwise conv over C whose taps tile
    (``heads_taps``).  Kernel 1."""
    return spec.heads != -1 or (spec.groups == spec.in_ch and spec.groups > 1)


def is_pointwise(spec: ConvSpec) -> bool:
    """A 1x1 conv, grouped or not (Kernel 2)."""
    return (spec.kernel == 1 and spec.stride == 1 and spec.dilation == 1
            and spec.padding == 0 and not is_depthwise(spec))


def is_dense(spec: ConvSpec) -> bool:
    """A conv with K > 1 (or a stride, dilation or padding) that is not
    depthwise, grouped or not: Jasper's K 11-29, stride 2 or dilation 2
    convs (Kernel 8)."""
    return not (is_depthwise(spec) or is_pointwise(spec))


def heads_taps(wk: torch.Tensor, spec: ConvSpec) -> torch.Tensor:
    """A depthwise conv's (K, C) taps: a ``heads`` conv's (K, heads) taps
    tiled over the C = in_ch channels (channel c takes head c % heads, the
    JAX package's fold of channels into the batch); others unchanged."""
    if spec.heads == -1:
        return wk
    return wk.repeat(1, spec.in_ch // spec.heads).contiguous()


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


# ---------------------------------------------------------------------------
# Float convs and the float executor
# ---------------------------------------------------------------------------


def conv_nwc(x: torch.Tensor, w: torch.Tensor, spec: ConvSpec,
             b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float 1-D conv of x (B, T, C) with w (K, C/groups, Cout), grouped or
    depthwise; ``heads`` fold channels into the batch.  float32 with TF32
    off, the counterpart of the JAX package's precision HIGHEST."""
    sh = x.shape
    if spec.heads != -1:
        x = x.reshape(sh[0], sh[1], sh[2] // spec.heads, spec.heads)
        x = x.permute(0, 2, 1, 3).reshape(-1, sh[1], spec.heads)
    groups = spec.groups if spec.heads == -1 else spec.heads
    with no_tf32():
        y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), None, spec.stride,
                     spec.padding, spec.dilation, groups).transpose(1, 2)
    if spec.heads != -1:
        t2 = y.shape[1]
        y = y.reshape(sh[0], sh[2] // spec.heads, t2, spec.heads)
        y = y.permute(0, 2, 1, 3).reshape(sh[0], t2, sh[2])
    return y if b is None else y + b


def group_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """GroupShuffle over the channels of (B, T, C)."""
    b, t, c = x.shape
    return x.reshape(b, t, groups, c // groups).transpose(2, 3).reshape(b, t, c)


SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
# the activations that leave every value >= 0: W8A8's asymmetric sites
# then hold uint8 codes, and after any other their signed 9-bit codes are
# two byte planes (kernels/checks.py::act_dtype)
NONNEG_ACTIVATIONS = ("relu", "hardtanh")


def _apply_activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The encoder's activation in float32; selu as the JAX package writes
    it (scale * where(x > 0, x, alpha * expm1(x)), the constants rounded to
    float32 once each), swish x * sigmoid(x)."""
    if kind == "relu":
        return torch.relu(x)
    if kind == "hardtanh":
        return x.clamp(0.0, 20.0)
    if kind == "selu":
        neg = SELU_ALPHA * torch.expm1(torch.where(x > 0, torch.zeros_like(x), x))
        return SELU_SCALE * torch.where(x > 0, x, neg)
    if kind == "swish":
        return x * torch.sigmoid(x)
    raise ValueError(f"unknown activation {kind}")


class FloatExec:
    """The float32 path.  BN is applied where the params still hold it,
    else the folded bias is inside the conv.  With ``collect_bn_stats``,
    ``bn_stats`` gathers the per-channel (mean, var with Bessel's
    correction) over (batch, time) of every pre-BN conv output, the
    statistics data-free synthesis matches to the BN running statistics.
    Params are torch tensors on the input's device.  With ``train`` and a
    ``generator``, each activation is followed by its block's dropout; BN
    still normalizes with the params' mean and var (which train as
    params), as the JAX package's FloatExec does."""

    def __init__(self, params, *, activation: str, collect_bn_stats: bool = False,
                 train: bool = False, generator: Optional[torch.Generator] = None):
        self.params = params
        self.activation_kind = activation
        self.collect = collect_bn_stats
        self.train = train
        self.generator = generator
        self.bn_stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        p = self.params["blocks"][bi][kind][i]
        y = conv_nwc(mask_values(x, lens), p["w"], spec, p.get("b"))
        if spec.has_bn and self.collect:
            self.bn_stats.append((y.mean(dim=(0, 1)), y.var(dim=(0, 1), correction=1)))
        if spec.has_bn and "bn" in p:
            bn = p["bn"]
            y = (y - bn["mean"]) / torch.sqrt(bn["var"] + BN_EPS) * bn["gamma"] + bn["beta"]
        return y, conv_out_len(lens, spec)

    def residual_add(self, block_idx: int, pane: int, out, res_out, mode: str):
        if mode in ("add", "stride_add"):
            return out + res_out
        return torch.maximum(out, res_out)

    def activation(self, x, dropout: float):
        y = _apply_activation(x, self.activation_kind)
        return drop(y, dropout, self.generator) if self.train else y

    def group_shuffle(self, x, groups):
        return group_shuffle(x, groups)

    def squeeze_excite(self, block_idx: int, x: torch.Tensor, bp: BlockPlan) -> torch.Tensor:
        """SqueezeExcite: the global (or windowed) time average -> fc1 ->
        ReLU -> fc2 -> sigmoid gate, float32 with TF32 off.  The windowed
        context is AvgPool1d(window, stride 1) upsampled back to T by
        repeating each value (nearest), as the JAX package computes it."""
        p = self.params["blocks"][block_idx]["se"]
        if bp.se_context_window <= 0:
            y = x.mean(dim=1, keepdim=True)
        else:
            w = bp.se_context_window
            c = torch.cumsum(F.pad(x, (0, 0, 1, 0)), dim=1)
            y = (c[:, w:] - c[:, :-w]) / w
            reps = -(-x.shape[1] // y.shape[1])
            y = torch.repeat_interleave(y, reps, dim=1)[:, :x.shape[1]]
        with no_tf32():
            y = torch.matmul(torch.relu(torch.matmul(y, p["fc1"])), p["fc2"])
        return x * torch.sigmoid(y)


# ---------------------------------------------------------------------------
# The calibrating / dynamic integer executor
# ---------------------------------------------------------------------------

def operand_dtype(device, act_bits: int, weight_bit: int, nonneg: bool) -> torch.dtype:
    """The storage of a conv's activation operand (kernels/checks.py::
    act_dtype): int8 for signed codes of <= 8 bits, uint8 for an asymmetric
    site's 9-bit codes of a post-ReLU value (``nonneg``), uint8 byte planes
    for its signed 9-bit codes after selu or swish (``checks.signed_planes``:
    the conv runs once a plane), int32 for anything wider on the CPU; on
    CUDA a code of 10 bits or more raises NotImplementedError, as do
    weights of more than 8 bits (the kernels multiply int8 weights)."""
    if weight_bit > 8 and torch.device(device).type == "cuda":
        raise NotImplementedError(f"weight_bit {weight_bit}: the kernels multiply int8 "
                                  f"weights (weight_bit <= 8) on CUDA")
    return act_dtype("conv operand", act_bits, nonneg, device)


def kernel_weight(w, depthwise: Optional[bool] = None):
    """A conv's weights (K, Cin/groups, Cout) in its kernel's layout:
    depthwise (K, C) (``heads``: (K, heads)), pointwise (Cout, Cin/groups),
    dense (Cout, K, Cin/groups).  ``depthwise`` None takes a conv with one
    input channel a group and K > 1 as depthwise (the tables carry no
    spec); a K = 1 depthwise conv needs it said."""
    k, cin_g, cout = w.shape
    if depthwise is None:
        depthwise = k > 1 and cin_g == 1
    if depthwise:
        return w[:, 0, :].contiguous()
    if k == 1:
        return w[0].t().contiguous()
    return w.permute(2, 0, 1).contiguous()


def quantize_weights(p, weight_bit: int, spec: ConvSpec) -> Dict[str, Any]:
    """A conv's per-output-channel symmetric weights: ``scale`` (Cout,) and
    ``wk`` the integers in the kernels' layout (``kernel_weight``; a
    ``heads`` conv's taps tiled over C, ``heads_taps``), int8 where they
    fit."""
    w = p["w"]
    scale = symmetric_scale(w.amin(dim=(0, 1)), w.amax(dim=(0, 1)), weight_bit)
    w_int = quantize(w, scale, weight_bit)
    narrow = w_int.to(torch.int8) if weight_bit <= 8 else w_int
    dw = is_depthwise(spec)
    wk = kernel_weight(narrow, dw)
    return {"scale": scale, "wk": heads_taps(wk, spec) if dw else wk, "b": p.get("b")}


class QuantExec:
    """Integer path with in-graph scales (port of the JAX QuantExec).

    ``update_ranges``: calibration; each activation site's batch range
    (min / max, or the ``qcfg.percentile`` pair) moves its running range
    in ``new_qstate`` (``ema_ranges``), and the requants use the float32
    multiplier unless ``qcfg.calib_exact``.  ``qcfg.dynamic``: each site
    quantizes with its batch range.  Otherwise the static running ranges
    of ``qstate``.  Params must be BN-folded torch tensors; ``qstate`` holds
    0-d tensors on their device (``qstate_to_device``).

    Convs: depthwise (and ``heads``) in Kernel 1 (``dw_conv``, epilogue
    off), pointwise (the decoder's too) in Kernel 2 (``pw_gemm``, no
    epilogue), dense in Kernel 8 (``dense_conv``, no epilogue), grouped
    ones in the grouped forms of Kernels 2 and 8, int32 out; GroupShuffle
    permutes the values and a per-channel scale (``group_shuffle_q``);
    activations other than ReLU run in float on the dequantized values and
    round back onto the same grid, as the JAX package; ``kernels=False``
    runs their plain versions, the oracle.  Activation operands are int8,
    or uint8 for W8A8's 9-bit codes of a post-ReLU value, or, for its
    signed 9-bit codes after selu or swish, two uint8 byte planes v = u -
    256 s, the conv run once a plane and joined as acc_u - 256 acc_s
    (``operand_dtype``; the plain path keeps them in int32); wider ones
    (10 bits, weight_bit > 8) run the plain versions on the CPU and raise
    NotImplementedError on CUDA.  ``weights`` caches each site's quantized
    weights across batches."""

    def __init__(self, params, qstate, qcfg: QuantConfig, *, activation: str,
                 update_ranges: bool, kernels: bool = True,
                 weights: Optional[Dict[Any, Any]] = None):
        for b in params["blocks"]:
            for c in b["convs"] + b["res"]:
                if "bn" in c:
                    raise ValueError("quant path requires BN-folded params; call "
                                     "fold_bn_encoder first")
        # imported here: the kernel wrappers import this module
        from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
        from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
        from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

        self.kernels = kernels
        self._dw, self._pw, self._dense = ((dw_conv, pw_gemm, dense_conv) if kernels else
                                           (dw_conv_plain, pw_gemm_plain, dense_conv_plain))
        self._nonneg_acts = activation in NONNEG_ACTIVATIONS
        self.params = params
        self.qcfg = qcfg
        self.activation_kind = activation
        self.update = update_ranges
        self.weights = {} if weights is None else weights
        self.new_qstate = copy_tree(qstate)

    # -- act quant ---------------------------------------------------------

    def act_quantize(self, path, x, bits: int, identity: Optional[QTensor] = None) -> QTensor:
        node = self.new_qstate
        for k in path[:-1]:
            node = node[k]
        state = node[path[-1]]
        x_f = x.dequantize() if isinstance(x, QTensor) else x
        if identity is not None:
            x_f = x_f + identity.dequantize()
        if self.update:
            bmin, bmax = batch_ranges(x_f, self.qcfg.percentile)
            state = ema_ranges(state, bmin, bmax, self.qcfg.act_momentum)
            node[path[-1]] = state
        if self.qcfg.dynamic:
            x_min, x_max = batch_ranges(x_f, self.qcfg.percentile)
        else:
            x_min, x_max = state["x_min"], state["x_max"]
        scale = symmetric_scale(x_min, x_max, bits)
        if isinstance(x, QTensor):
            if self.update and not self.qcfg.calib_exact:
                return requantize_approx(x, scale, bits, identity=identity)
            return requantize(x, scale, bits, identity=identity)
        return QTensor(quantize(x, scale, bits), scale)

    # -- conv ---------------------------------------------------------------

    def _qconv(self, key, p, spec: ConvSpec, x: QTensor, bits: int,
               nonneg: bool = False) -> QTensor:
        if key not in self.weights:
            self.weights[key] = quantize_weights(p, self.qcfg.weight_bit, spec)
        wq = self.weights[key]
        out_scale = wq["scale"] * x.scale
        b_int = None
        if wq["b"] is not None:
            b_int = torch.round(torch.reciprocal(out_scale) * wq["b"]).to(torch.int32)
        dtype = operand_dtype(x.values.device, bits, self.qcfg.weight_bit, nonneg)
        if not signed_planes(bits, nonneg):
            return QTensor(self._conv(spec, wq, x.values.to(dtype), b_int), out_scale)
        if not self.kernels:
            return QTensor(self._conv(spec, wq, x.values, b_int), out_scale)
        u, s = split_planes(x.values)
        y = join_planes(self._conv(spec, wq, u, b_int), self._conv(spec, wq, s, None))
        return QTensor(y, out_scale)

    def _conv(self, spec: ConvSpec, wq, xv: torch.Tensor, b_int) -> torch.Tensor:
        """The integer conv of one operand in its kernel (or plain version),
        epilogue off: int32 out."""
        if is_depthwise(spec):
            return self._dw(xv, wq["wk"], stride=spec.stride, padding=spec.padding,
                            dilation=spec.dilation, bias=b_int)
        if is_pointwise(spec):
            return self._pw(xv, wq["wk"], bias=b_int, groups=spec.groups)
        return self._dense(xv, wq["wk"], stride=spec.stride, padding=spec.padding,
                           dilation=spec.dilation, bias=b_int, groups=spec.groups)

    def _act_storage_bits(self, spec: ConvSpec) -> int:
        return self.qcfg.act_bit + (1 if spec.asymmetric else 0)

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        if isinstance(x, QTensor):
            x = QTensor(mask_values(x.values, lens), x.scale)
        else:
            x = mask_values(x, lens)
        bits = self._act_storage_bits(spec)
        # an asymmetric site reads a post-activation value (>= 0 after a
        # ReLU), except where the float features reach it directly
        nonneg = spec.asymmetric and isinstance(x, QTensor) and self._nonneg_acts
        xq = self.act_quantize(("blocks", bi, kind, i), x, bits)
        y = self._qconv(site, self.params["blocks"][bi][kind][i], spec, xq, bits, nonneg)
        return y, conv_out_len(lens, spec)

    def residual_add(self, block_idx: int, pane: int, out: QTensor, res_out: QTensor,
                     mode: str) -> QTensor:
        if mode not in ("add", "stride_add"):
            raise NotImplementedError(f"residual mode {mode!r}")
        return self.act_quantize(("blocks", block_idx, "res_act"), out,
                                 self.qcfg.act_bit, identity=res_out)

    def activation(self, x: QTensor, dropout: float) -> QTensor:
        if self.activation_kind == "relu":
            return QTensor(x.values.clamp_min(0), x.scale)
        y = _apply_activation(x.dequantize(), self.activation_kind)
        return QTensor(torch.round(y / x.scale).to(torch.int32), x.scale)

    def group_shuffle(self, x, groups):
        return group_shuffle_q(x, groups)

    def squeeze_excite(self, block_idx, x, bp):
        raise NotImplementedError("SqueezeExcite does not support quantization")


def shuffle_channel_vector(v, groups: int):
    """GroupShuffle's permutation of a per-channel vector (a scale, a
    mantissa): a numpy array or a torch tensor."""
    c = v.shape[0]
    return v.reshape(groups, c // groups).swapaxes(0, 1).reshape(c)


def group_shuffle_q(x: QTensor, groups: int) -> QTensor:
    """GroupShuffle on an integer activation: its values and, when it is
    per channel, its scale."""
    scale = x.scale
    if getattr(scale, "ndim", 0) == 1:
        scale = shuffle_channel_vector(scale, groups)
    return QTensor(group_shuffle(x.values, groups), scale)


def decoder_forward_float(params, x: torch.Tensor) -> torch.Tensor:
    """ConvASRDecoder in float32: 1x1 conv + bias, log-softmax."""
    spec = decoder_spec(x.shape[-1], params["w"].shape[-1])
    return torch.log_softmax(conv_nwc(x, params["w"], spec, params["b"]), dim=-1)


def decoder_forward_quant(exec_: QuantExec, dec_params, x: QTensor) -> torch.Tensor:
    """The decoder on QuantExec: its input site (act_bit, unmasked), the
    integer 1x1 conv (Kernel 2), then dequantize and log-softmax."""
    spec = decoder_spec(x.values.shape[-1], dec_params["w"].shape[-1])
    xq = exec_.act_quantize(("decoder_act",), x, exec_.qcfg.act_bit)
    y = exec_._qconv("decoder", dec_params, spec, xq, exec_.qcfg.act_bit)
    return torch.log_softmax(y.dequantize(), dim=-1)
