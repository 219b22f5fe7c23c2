"""Post-training quantization of the Conformer encoder: the quantization
config, the range state, calibration and the quantized (PTQ) forward
(port of qasr_tpu/quantize/conformer_ptq.py without its QAT forward).

Every projection's weights are quantized per output channel (once per
device, ``quantize_conformer_weights``), every matmul input goes through
an activation site whose range is the first batch's, then an EMA
(``_act_quant``, with the range state's ``batch_ranges`` /
``ema_ranges``, which the QuartzNet path shares), and the products are
exact integer GEMMs: the linears (``_qlinear``) on Kernel 2's
no-epilogue form, the depthwise conv (``_qdepthwise``) on Kernel 1 with
the epilogue off, the attention's data-dependent products as exact
library calls.  The integer flags move the softmax, LayerNorms, swish
and the GLU sigmoid into integer arithmetic; static attention gives q+u,
q+v, k, v and the projected position table calibrated sites.  Float ops
keep the JAX source's order (``acc * (S_x * S_w) + b``, ``(ac + bd) /
sqrt(d_k)``), so the CPU results equal the JAX package's run op by op.
Activation ranges come from pad-masked tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.device import no_tf32
from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
from qasr_tpu_torch.kernels.pw_gemm import int_matmul, k_pieces, pw_gemm
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    _layer_norm,
    _masked_softmax,
    _sub_out_len,
    _swish,
    encoder_masks,
    position_tables,
    rel_shift,
    subsample_convs,
    subsampler_to_device,
)
from qasr_tpu_torch.ops.integer_layernorm import i_layernorm
from qasr_tpu_torch.ops.integer_sigmoid import K_SIG, i_sigmoid_fp, i_swish_terms
from qasr_tpu_torch.ops.integer_softmax import i_softmax
from qasr_tpu_torch.ops.quant_prims import QTensor, f32_div, quantize, symmetric_scale
from qasr_tpu_torch.quantize.ranges import batch_ranges, copy_tree, ema_ranges

_LAYER_SITES = ("ff1_in", "ff1_mid", "att_in", "att_ctx", "conv_in",
                "conv_glu", "conv_mid", "ff2_in", "ff2_mid")
_LN_SITES = ("ln_ff1", "ln_att", "ln_conv", "ln_ff2", "ln_out")
_ACT_SITES = ("ff1_act", "ff2_act", "conv_a", "conv_bn")
_ATT_SITES = ("att_qu", "att_qv", "att_k", "att_v", "att_pos")


@dataclass(frozen=True)
class ConformerQuantConfig:
    """The JAX package's Conformer quantization knobs (same fields and
    defaults).  The frozen integer path needs every integer flag and
    static attention."""

    weight_bit: int = 8
    act_bit: int = 8
    act_momentum: float = 0.95
    percentile: Optional[float] = None
    dynamic: bool = False
    quantize_attention: bool = False
    integer_softmax: bool = False
    integer_layernorm: bool = False
    integer_activations: bool = False
    static_attention: bool = False

    def __post_init__(self):
        if self.integer_softmax and not self.quantize_attention:
            raise ValueError("integer_softmax requires quantize_attention")
        if self.integer_layernorm and self.act_bit > 8:
            raise ValueError("integer_layernorm supports act_bit <= 8")


def init_conformer_qstate(cfg: ConformerConfig,
                          qcfg: Optional[ConformerQuantConfig] = None) -> Dict[str, Any]:
    """Zeroed activation ranges for every site, in the JAX package's
    layout (x_min == x_max == 0 marks an uncalibrated site)."""
    def site():
        return {"x_min": np.zeros((), np.float32), "x_max": np.zeros((), np.float32)}

    sites = _LAYER_SITES
    if qcfg is not None and qcfg.integer_layernorm:
        sites = sites + _LN_SITES
    if qcfg is not None and qcfg.integer_activations:
        sites = sites + _ACT_SITES
    if qcfg is not None and qcfg.static_attention:
        sites = sites + _ATT_SITES
    st: Dict[str, Any] = {"pre_out": site(),
                          "layers": [{s: site() for s in sites}
                                     for _ in range(cfg.n_layers)]}
    if cfg.feat_out > 0 and cfg.feat_out != cfg.d_model:
        st["out_proj_in"] = site()
    return st


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _weight_qparams(w: torch.Tensor, wbit: int, reduce_axes: Tuple[int, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric weight quantization (out axis = last):
    (int8 weights, float32 scales)."""
    w = w.to(torch.float32)
    w_scale = symmetric_scale(torch.amin(w, dim=reduce_axes),
                              torch.amax(w, dim=reduce_axes), wbit)
    return quantize(w, w_scale, wbit).to(torch.int8), w_scale


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def quantize_linear(p, wbit: int, device) -> Dict[str, torch.Tensor]:
    """A host linear {"w" (din, dout), "b"?} quantized on the host and put
    on ``device``: {"wt" (dout, din) int8, "w_scale" (dout,), "b"?}."""
    w_int8, w_scale = _weight_qparams(torch.from_numpy(np.array(p["w"], np.float32)),
                                      wbit, (0,))
    out = {"wt": w_int8.t().contiguous().to(device), "w_scale": w_scale.to(device)}
    if "b" in p:
        out["b"] = _f32(p["b"], device)
    return out


def quantize_conformer_weights(params, cfg: ConformerConfig, wbit: int,
                               device) -> Dict[str, Any]:
    """The host encoder params as the PTQ forward takes them on
    ``device``: every linear (the pointwise convs as linears on w[0]) and
    the depthwise taps quantized per output channel on the host and
    uploaded once, {"wk" (K, C) int8, ...} for the depthwise; LN / BN
    params, biases and position biases as float32; the subsampler's
    convs as OIHW (``subsampler_to_device``)."""
    def dw(p):
        w_int8, w_scale = _weight_qparams(torch.from_numpy(np.array(p["w"], np.float32)),
                                          wbit, (0, 1))
        return {"wk": w_int8[:, 0, :].contiguous().to(device), "w_scale": w_scale.to(device),
                "b": _f32(p["b"], device)}

    def floats(tree):
        return {k: _f32(v, device) for k, v in tree.items()}

    pre = params["pre_encode"]
    new: Dict[str, Any] = {"pre_encode": (
        dict(subsampler_to_device(pre, device), out=quantize_linear(pre["out"], wbit, device))
        if cfg.subsampling else {"linear": quantize_linear(pre["linear"], wbit, device)})}
    for k in ("pos_bias_u", "pos_bias_v"):
        if k in params:
            new[k] = _f32(params[k], device)
    layers = []
    for lp in params["layers"]:
        cv = lp["conv"]
        nl = {k: floats(lp[k]) for k in ("norm_ff1", "norm_att", "norm_conv", "norm_ff2",
                                         "norm_out")}
        for ff in ("ff1", "ff2"):
            nl[ff] = {k: quantize_linear(lp[ff][k], wbit, device) for k in ("l1", "l2")}
        nl["att"] = {k: quantize_linear(lp["att"][k], wbit, device)
                     for k in ("q", "k", "v", "out", "pos")}
        nl["conv"] = {pw: quantize_linear({"w": cv[pw]["w"][0], "b": cv[pw]["b"]}, wbit, device)
                      for pw in ("pw1", "pw2")}
        nl["conv"].update(dw=dw(cv["dw"]), bn=floats(cv["bn"]))
        for k in ("pos_bias_u", "pos_bias_v"):
            if k in lp:
                nl[k] = _f32(lp[k], device)
        layers.append(nl)
    new["layers"] = layers
    if "out_proj" in params:
        new["out_proj"] = quantize_linear(params["out_proj"], wbit, device)
    return new


# ---------------------------------------------------------------------------
# int8 building blocks
# ---------------------------------------------------------------------------


def _act_quant(state, x_f: torch.Tensor, valid: Optional[torch.Tensor],
               qcfg: ConformerQuantConfig, update: bool = False) -> Tuple[QTensor, Any]:
    """Per-tensor symmetric activation quantization.  ``update``: the
    site's batch range (min / max, or the percentile pair) of x_f masked
    by ``valid`` (B, T), broadcast over trailing dims, moves its running
    range (first batch: set).  ``qcfg.dynamic``: quantize with the batch
    range; else with the (updated) running range.  ``state`` holds 0-d
    float32 tensors on x_f's device; returns (QTensor, new state)."""
    if valid is None:
        xm = x_f
    else:
        xm = x_f * valid.reshape(valid.shape + (1,) * (x_f.dim() - valid.dim()))
    if update or qcfg.dynamic:
        bmin, bmax = batch_ranges(xm, qcfg.percentile)
    new_state = ema_ranges(state, bmin, bmax, qcfg.act_momentum) if update else state
    if qcfg.dynamic:
        x_min, x_max = bmin, bmax
    else:
        x_min, x_max = new_state["x_min"], new_state["x_max"]
    scale = symmetric_scale(x_min, x_max, qcfg.act_bit)
    return QTensor(quantize(x_f, scale, qcfg.act_bit).to(torch.int8), scale), new_state


def _pw_kernel(x2: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    return pw_gemm(x2[None], wt)[0]


def _qlinear(p, xq: QTensor, kernels: bool = False) -> torch.Tensor:
    """int8 x int8 -> int32 product, float epilogue acc * (S_x * S_w) + b;
    ``p`` from ``quantize_linear``.  ``kernels``: the product on Kernel 2's
    no-epilogue form (any Cin: ``pw_gemm`` pads and splits it); else
    ``int_matmul``, as the frozen CTC head and the plain path take it."""
    x = xq.values
    x2 = x.reshape(-1, x.shape[-1])
    acc = (_pw_kernel if kernels else int_matmul)(x2, p["wt"]).reshape(*x.shape[:-1], -1)
    y = acc.to(torch.float32) * (xq.scale * p["w_scale"])
    return y + p["b"] if "b" in p else y


def _qdepthwise(p, xq: QTensor, padding: Tuple[int, int], kernels: bool = False) -> torch.Tensor:
    """int8 depthwise conv of (B, T, C) with (left, right) zero padding,
    int32 accumulate, float epilogue acc * (S_x * S_w) + b.  ``kernels``:
    Kernel 1 with the epilogue off (it pads both sides alike, so a causal
    (K-1, 0) pad puts its K-1 frames on the left first); else its plain
    version."""
    left, right = padding
    x, pad = xq.values, min(left, right)
    if left != right:
        x = F.pad(x, (0, 0, left - pad, right - pad))
    acc = (dw_conv if kernels else dw_conv_plain)(x, p["wk"], padding=pad)
    return acc.to(torch.float32) * (xq.scale * p["w_scale"]) + p["b"]


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An exact int8 x int8 -> int32 einsum (the attention's data-dependent
    products): int32 on the CPU; float64 on CUDA, exact while every sum
    stays below 2^53 (127^2 * T)."""
    if a.device.type == "cpu":
        return torch.einsum(eq, a.to(torch.int32), b.to(torch.int32))
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


# ---------------------------------------------------------------------------
# the quantized forward
# ---------------------------------------------------------------------------


def _q_rel_attention(p, st, xq: QTensor, pos_emb, idx, att_mask, valid, pos_bias_u,
                     pos_bias_v, n_heads: int, qcfg: ConformerQuantConfig, update: bool,
                     kernels: bool):
    """Relative-position attention on int8 projections; with
    ``quantize_attention`` the score and context products are int8 too
    (static sites or per-batch scales), with ``integer_softmax`` so is the
    softmax."""
    b, t = xq.values.shape[:2]
    d = p["q"]["wt"].shape[0]
    d_k = d // n_heads
    q = _qlinear(p["q"], xq, kernels).reshape(b, t, n_heads, d_k)
    k = _qlinear(p["k"], xq, kernels).reshape(b, t, n_heads, d_k)
    v = _qlinear(p["v"], xq, kernels).reshape(b, t, n_heads, d_k)
    # the sinusoids' own exact range, no calibration site
    pos_scale = symmetric_scale(pos_emb.min(), pos_emb.max(), qcfg.act_bit)
    posq = QTensor(quantize(pos_emb, pos_scale, qcfg.act_bit).to(torch.int8), pos_scale)
    pos = _qlinear(p["pos"], posq, kernels).reshape(2 * t - 1, n_heads, d_k)
    q_u = q + pos_bias_u
    q_v = q + pos_bias_v
    if qcfg.quantize_attention:
        vm = valid[..., None, None]

        def dyn8(x):
            s = symmetric_scale(x.min(), x.max(), qcfg.act_bit)
            return QTensor(quantize(x, s, qcfg.act_bit).to(torch.int8), s)

        if qcfg.static_attention:
            qu8, st["att_qu"] = _act_quant(st["att_qu"], q_u, valid, qcfg, update)
            qv8, st["att_qv"] = _act_quant(st["att_qv"], q_v, valid, qcfg, update)
            k8, st["att_k"] = _act_quant(st["att_k"], k, valid, qcfg, update)
            p8, st["att_pos"] = _act_quant(st["att_pos"], pos, None, qcfg, update)
        else:
            qu8, qv8, k8, p8 = dyn8(q_u * vm), dyn8(q_v * vm), dyn8(k * vm), dyn8(pos)
        ac = (_int_einsum("bihd,bjhd->bhij", qu8.values, k8.values).to(torch.float32)
              * (qu8.scale * k8.scale))
        bd_full = (_int_einsum("bihd,phd->bhip", qv8.values, p8.values).to(torch.float32)
                   * (qv8.scale * p8.scale))
    else:
        ac = torch.einsum("bihd,bjhd->bhij", q_u, k)
        bd_full = torch.einsum("bihd,phd->bhip", q_v, pos)
    scores = f32_div(ac + rel_shift(bd_full, idx), math.sqrt(d_k))
    mask_h = att_mask[:, None]
    n = 2 ** (qcfg.act_bit - 1) - 1
    if qcfg.quantize_attention and qcfg.integer_softmax:
        a8 = i_softmax(scores, mask=mask_h, out_bits=qcfg.act_bit).to(torch.int8)
    else:
        attn = _masked_softmax(scores, mask_h)
        if qcfg.quantize_attention:
            a8 = torch.round(attn * n).to(torch.int8)  # the exact [0, 1] range
    if qcfg.quantize_attention:
        if qcfg.static_attention:
            v8, st["att_v"] = _act_quant(st["att_v"], v, valid, qcfg, update)
        else:
            v8 = dyn8(v * valid[..., None, None])
        ctx = (_int_einsum("bhij,bjhd->bihd", a8, v8.values).to(torch.float32)
               * f32_div(v8.scale, n)).reshape(b, t, d)
    else:
        ctx = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, t, d)
    cq, st["att_ctx"] = _act_quant(st["att_ctx"], ctx, valid, qcfg, update)
    return _qlinear(p["out"], cq, kernels), st


def _i_swish(st, key, x, valid, qcfg, update):
    """Integer swish: x's own quantized integers times the integer sigmoid
    fraction of the same values."""
    xq, st[key] = _act_quant(st[key], x, valid, qcfg, update)
    y = i_swish_terms(xq.values, xq.dequantize())
    return y.to(torch.float32) * (xq.scale / (1 << K_SIG)), st


def _q_conv_module(p, st, x, pad_mask, valid, qcfg: ConformerQuantConfig, update: bool,
                   dw_padding, kernels: bool):
    """The conv module with int8 pw1 / depthwise / pw2; GLU and swish
    integer under ``integer_activations``, BN float."""
    xq, st["conv_in"] = _act_quant(st["conv_in"], x, valid, qcfg, update)
    a, g = torch.chunk(_qlinear(p["pw1"], xq, kernels), 2, dim=-1)
    if qcfg.integer_activations:
        aq, st["conv_a"] = _act_quant(st["conv_a"], a, valid, qcfg, update)
        y_int = aq.values.to(torch.int32) * i_sigmoid_fp(g)
        y = y_int.to(torch.float32) * (aq.scale / (1 << K_SIG))
    else:
        y = a * torch.sigmoid(g)
    y = torch.where(pad_mask[:, :, None], 0.0, y)
    yq, st["conv_glu"] = _act_quant(st["conv_glu"], y, valid, qcfg, update)
    y = _qdepthwise(p["dw"], yq, dw_padding, kernels)
    bn = p["bn"]
    y = (y - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) * bn["gamma"] + bn["beta"]
    if qcfg.integer_activations:
        y, st = _i_swish(st, "conv_bn", y, valid, qcfg, update)
    else:
        y = _swish(y)
    yq, st["conv_mid"] = _act_quant(st["conv_mid"], y, valid, qcfg, update)
    return _qlinear(p["pw2"], yq, kernels), st


def _q_layer_norm(p_ln, st, key, x, valid, qcfg, update):
    """LayerNorm, with integer statistics (i-LayerNorm on the input's own
    site) under ``integer_layernorm``."""
    if not qcfg.integer_layernorm:
        return _layer_norm(p_ln, x), st
    xq, st[key] = _act_quant(st[key], x, valid, qcfg, update)
    return i_layernorm(xq.values, p_ln["gamma"], p_ln["beta"]), st


def _q_feed_forward(p, st, x, valid, pre, qcfg, update, kernels):
    xq, st[f"{pre}_in"] = _act_quant(st[f"{pre}_in"], x, valid, qcfg, update)
    h = _qlinear(p["l1"], xq, kernels)
    if qcfg.integer_activations:
        y, st = _i_swish(st, f"{pre}_act", h, valid, qcfg, update)
    else:
        y = _swish(h)
    yq, st[f"{pre}_mid"] = _act_quant(st[f"{pre}_mid"], y, valid, qcfg, update)
    return _qlinear(p["l2"], yq, kernels), st


def conformer_encoder_apply_ptq(qparams, cfg: ConformerConfig, qcfg: ConformerQuantConfig,
                                qstate, x: torch.Tensor, lens: torch.Tensor, *,
                                update: bool = False, kernels: bool = True
                                ) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """The quantized encoder forward (eval graph, no dropout): (B, T, F)
    features -> (encodings, lens', new range state).  ``update``: a
    calibration pass (each site's running range moves); else static
    ranges, or per-batch ones under ``qcfg.dynamic``.  ``qparams`` from
    ``quantize_conformer_weights``, ``qstate`` 0-d tensors on their
    device.  ``kernels``: Kernels 1 and 2 for the depthwise convs and the
    linears (their plain versions on CPU tensors); False: the plain
    versions everywhere.  The subsampler's convs stay float32 (TF32 off);
    its flatten -> d_model projection is quantized at the pre_out site."""
    new_q = copy_tree(qstate)
    with no_tf32():
        if cfg.subsampling:
            p_pre = qparams["pre_encode"]
            y, lens = subsample_convs(p_pre, cfg, x, lens)
            valid0 = torch.arange(y.shape[1], device=lens.device)[None, :] < lens[:, None]
            yq, new_q["pre_out"] = _act_quant(new_q["pre_out"], y, valid0, qcfg, update)
            x = _qlinear(p_pre["out"], yq, kernels)
        else:
            x = x.to(torch.float32)
            valid0 = torch.arange(x.shape[1], device=lens.device)[None, :] < lens[:, None]
            yq, new_q["pre_out"] = _act_quant(new_q["pre_out"], x, valid0, qcfg, update)
            x = _qlinear(qparams["pre_encode"]["linear"], yq, kernels)
        t = x.shape[1]
        if cfg.xscaling:
            x = x * math.sqrt(cfg.d_model)
        pos_emb, idx = position_tables(t, cfg.d_model, x.device)
        valid, att_mask = encoder_masks(cfg, t, lens)
        pad_mask = ~valid
        vmask = valid.to(torch.float32)
        if cfg.self_attention_model != "rel_pos":
            raise NotImplementedError("abs-pos attention under PTQ (the JAX package raises "
                                      "too: rel_pos is the Conformer default)")
        u, v = qparams.get("pos_bias_u"), qparams.get("pos_bias_v")
        for li, lp in enumerate(qparams["layers"]):
            st = new_q["layers"][li]
            r = x
            y, st = _q_layer_norm(lp["norm_ff1"], st, "ln_ff1", x, vmask, qcfg, update)
            y, st = _q_feed_forward(lp["ff1"], st, y, vmask, "ff1", qcfg, update, kernels)
            x = 0.5 * y + r
            r = x
            y, st = _q_layer_norm(lp["norm_att"], st, "ln_att", x, vmask, qcfg, update)
            yq, st["att_in"] = _act_quant(st["att_in"], y, vmask, qcfg, update)
            y, st = _q_rel_attention(lp["att"], st, yq, pos_emb, idx, att_mask, vmask,
                                     lp.get("pos_bias_u", u), lp.get("pos_bias_v", v),
                                     cfg.n_heads, qcfg, update, kernels)
            x = y + r
            r = x
            y, st = _q_layer_norm(lp["norm_conv"], st, "ln_conv", x, vmask, qcfg, update)
            y, st = _q_conv_module(lp["conv"], st, y, pad_mask, vmask, qcfg, update,
                                   cfg.dw_padding, kernels)
            x = y + r
            r = x
            y, st = _q_layer_norm(lp["norm_ff2"], st, "ln_ff2", x, vmask, qcfg, update)
            y, st = _q_feed_forward(lp["ff2"], st, y, vmask, "ff2", qcfg, update, kernels)
            x = 0.5 * y + r
            x, st = _q_layer_norm(lp["norm_out"], st, "ln_out", x, vmask, qcfg, update)
            new_q["layers"][li] = st
        if "out_proj" in qparams:
            xq, new_q["out_proj_in"] = _act_quant(new_q["out_proj_in"], x, vmask, qcfg, update)
            x = _qlinear(qparams["out_proj"], xq, kernels)
    return x, lens, new_q


def calibrate_conformer(qparams, cfg: ConformerConfig, qcfg: ConformerQuantConfig, batches,
                        qstate, *, kernels: bool = True):
    """EMA calibration over (features (B, T, F), lens) batches, tensors on
    the device of ``qparams`` and ``qstate`` (0-d tensors there, e.g.
    ``qstate_to_device(init_conformer_qstate(cfg, qcfg), dev)``); returns
    the final range state.  A 'dec_in' site in ``qstate`` (the CTC head's
    input, which ``ConformerCTC.quantize_encoder`` adds) moves with each
    batch's pad-masked encodings."""
    with torch.no_grad():
        for feats, lens in batches:
            enc, enc_lens, new_q = conformer_encoder_apply_ptq(
                qparams, cfg, qcfg, qstate, feats, lens, update=True, kernels=kernels)
            if "dec_in" in qstate:
                vm = (torch.arange(enc.shape[1], device=enc.device)[None, :]
                      < enc_lens[:, None]).to(enc.dtype)[..., None]
                bmin, bmax = batch_ranges(enc * vm, qcfg.percentile)
                new_q["dec_in"] = ema_ranges(qstate["dec_in"], bmin, bmax, qcfg.act_momentum)
            qstate = new_q
    return qstate


def pre_out_width(cfg: ConformerConfig) -> int:
    """The input projection's contraction: the subsampler's flattened
    channels x frequencies (256 x 19 = 4,864 on the flagship), or feat_in
    without a subsampler."""
    cin = cfg.feat_in
    if cfg.subsampling:
        for _ in range(int(math.log2(cfg.subsampling_factor))):
            cin = _sub_out_len(cin, cfg.subsampling)
        cin *= cfg.subsampling_conv_channels
    return cin


def ptq_kernel_launches(cfg: ConformerConfig, head: bool = False) -> Dict[str, int]:
    """Kernel 1 and 2 launches of one ``conformer_encoder_apply_ptq(
    kernels=True)`` (and, with ``head``, the quantized CTC head after
    it): a depthwise conv a layer; eleven linears a layer (ff1 l1 / l2, q,
    k, v, pos, out, pw1, pw2, ff2 l1 / l2), the input projection in
    ``k_pieces`` launches, and out_proj / the head, one each."""
    cin = pre_out_width(cfg)
    pre = len(k_pieces(cin + (-cin) % 16, cfg.d_model))
    out = int(cfg.feat_out > 0 and cfg.feat_out != cfg.d_model)
    return {"dw_conv": cfg.n_layers, "pw_gemm": 11 * cfg.n_layers + pre + out + int(head)}
