"""Frozen integer-only Conformer encoder (port of the offline serving part
of qasr_tpu/quantize/conformer_freeze.py).

Host half (numpy): ``freeze_conformer`` turns the float params and the
calibrated range state into the JAX package's tables, bit for bit (int8
weights, acc-domain int32 biases, int32 mantissas, Python-int exponents,
float site scales).  ``conformer_tables_to_device`` puts them on a torch
device in the layouts the executors and kernels use.

Apply, split at the one float -> int boundary:
  * ``conformer_x8``: float features -> subsampler (float32, TF32 off)
    -> the single quantization onto the pre_out site -> (x8, lens);
  * ``conformer_encode``: x8 -> integer layer stack -> float encodings
    (the last i-LayerNorm's gamma/beta affine is the one float op).
``kernels=True`` runs the stack through the kernels that a
``ConformerPlan`` names (the JAX package's QASR_CONF_MOD / QASR_CONF_FUSED
flags, passed explicitly): every layer's attention core in Kernel 3
(``int_attention``) and its att_out join + conv module in Kernel 4
(``conv_block``); under ``mod="1"`` both FFN halves with their tail
i-LayerNorms in Kernel 6 (``ffn_ln``); under ``fused=True`` every other
linear in Kernel 5 (``lin_epilogue``).  The default plan ("1", True) leaves
no integer op outside a kernel but the last i-LayerNorm.  ``kernels=False``
runs the plain compositions throughout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain
from qasr_tpu_torch.kernels.ffn_ln import ffn_ln, ffn_ln_plain
from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain
from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    rel_positional_encoding,
    subsample_convs,
    subsampler_to_device,
)
from qasr_tpu_torch.ops.integer_layernorm import _K as _K_LN
from qasr_tpu_torch.ops.integer_layernorm import i_layernorm_core
from qasr_tpu_torch.ops.integer_sigmoid import K_SIG
from qasr_tpu_torch.ops.integer_softmax import S_IN
from qasr_tpu_torch.ops.quant_prims import dyadic_from_scale_host_static_e, f32_div
from qasr_tpu_torch.quantize.conformer_int import _ln_rq, clip8
from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig
from qasr_tpu_torch.quantize.freeze import tables_digest

# ---------------------------------------------------------------------------
# freeze (host numpy)
# ---------------------------------------------------------------------------


def _site_scale(site: Dict[str, Any], act_bit: int) -> float:
    """The static per-tensor activation scale of a calibrated site."""
    n = 2 ** (act_bit - 1) - 1
    sat = max(abs(float(site["x_min"])), abs(float(site["x_max"])), 1e-8)
    return sat / n


def _w_quant(w: np.ndarray, wbit: int, axes: Tuple[int, ...]):
    """Per-out-channel symmetric weight quantization in float64."""
    w = np.asarray(w, np.float64)
    n = 2 ** (wbit - 1) - 1
    sat = np.maximum(np.abs(w.min(axis=axes)), np.abs(w.max(axis=axes)))
    scale = np.clip(sat, 1e-8, None) / n
    w_int = np.clip(np.round(w / scale), -n, n - 1).astype(np.int8)
    return w_int, scale


def _rq_table(scale_in, scale_out: float):
    """Dyadic (m int32 per channel, e Python int) for scale_in/scale_out."""
    m, e = dyadic_from_scale_host_static_e(
        np.asarray(scale_in, np.float64) / float(scale_out))
    return np.asarray(m, np.int32), int(e)


def _lin_table(p, in_scale: float, out_scale: float, wbit: int,
               extra_bias: Optional[np.ndarray] = None, gain: float = 1.0):
    """One linear site: int8 weights, acc-domain int32 bias, and the
    dyadic requant from in_scale * w_scale * gain to out_scale."""
    w = np.asarray(p["w"], np.float64)
    w_int, w_scale = _w_quant(w, wbit, (0,))
    acc_scale = in_scale * w_scale
    b = np.asarray(p.get("b", np.zeros(w.shape[1])), np.float64)
    if extra_bias is not None:
        b = b + np.asarray(extra_bias, np.float64)
    b_acc = np.round(b / acc_scale).astype(np.int32)
    m, e = _rq_table(acc_scale * gain, out_scale)
    return {"w": w_int, "b": b_acc, "m": m, "e": e}


def _affine_rq(k: np.ndarray, c: np.ndarray, out_scale: float):
    """A per-channel affine y = acc*k + c as (sign, acc-domain bias,
    dyadic |k|/out_scale): i-LN gamma/beta and the BN fold."""
    k = np.asarray(k, np.float64)
    c = np.asarray(c, np.float64)
    sgn = np.where(k < 0, -1, 1).astype(np.int32)
    ka = np.clip(np.abs(k), 1e-8, None)
    b2 = np.clip(np.round(c / ka), -(1 << 27), 1 << 27).astype(np.int32)
    m, e = _rq_table(ka, out_scale)
    return {"sgn": sgn, "b": b2, "m": m, "e": e}


def freeze_conformer(params, cfg: ConformerConfig, qcfg: ConformerQuantConfig,
                     qstate) -> Dict[str, Any]:
    """The frozen integer tables from calibrated ranges (host), equal to
    the JAX package's ``freeze_conformer``."""
    for flag in ("quantize_attention", "integer_softmax", "integer_layernorm",
                 "integer_activations", "static_attention"):
        if not getattr(qcfg, flag):
            raise ValueError(f"freeze_conformer requires {flag}=True at calibration "
                             f"(the flag's sites provide the static scales)")
    if qcfg.dynamic:
        raise ValueError("dynamic mode has no static scales to freeze")
    if cfg.feat_out > 0 and cfg.feat_out != cfg.d_model:
        raise NotImplementedError("feat_out projection under freeze")
    if cfg.self_attention_model != "rel_pos":
        raise NotImplementedError("frozen abs-pos attention")

    ab, wb = qcfg.act_bit, qcfg.weight_bit
    d = cfg.d_model
    d_k = d // cfg.n_heads

    def s(site):
        return _site_scale(site, ab)

    layers: List[Dict[str, Any]] = []
    n_l = cfg.n_layers
    for li in range(n_l):
        lp = params["layers"][li]
        st = qstate["layers"][li]
        S = {k: s(st[k]) for k in st}
        S_next = s(qstate["layers"][li + 1]["ln_ff1"]) if li + 1 < n_l else None
        bu = np.asarray(lp.get("pos_bias_u", params.get("pos_bias_u")), np.float64).reshape(-1)
        bv = np.asarray(lp.get("pos_bias_v", params.get("pos_bias_v")), np.float64).reshape(-1)
        g2k = 1 << _K_LN

        def ln_tbl(name, out_scale):
            p_ln = lp[name]
            return _affine_rq(np.asarray(p_ln["gamma"], np.float64) / g2k,
                              np.asarray(p_ln["beta"], np.float64), out_scale)

        cv = lp["conv"]
        bn = {k: np.asarray(cv["bn"][k], np.float64) for k in cv["bn"]}
        g_eff = bn["gamma"] / np.sqrt(bn["var"] + 1e-5)
        w_dw_int, w_dw_sc = _w_quant(np.asarray(cv["dw"]["w"], np.float64), wb, (0, 1))
        k_dw = S["conv_glu"] * w_dw_sc * g_eff
        c_dw = (np.asarray(cv["dw"]["b"], np.float64) - bn["mean"]) * g_eff + bn["beta"]
        att = lp["att"]
        pw1_w, pw1_b = np.asarray(cv["pw1"]["w"][0]), np.asarray(cv["pw1"]["b"])
        s_tail = S_next if S_next is not None else s(st["ln_out"])
        layers.append({
            "ln_ff1": ln_tbl("norm_ff1", S["ff1_in"]),
            "ln_att": ln_tbl("norm_att", S["att_in"]),
            "ln_conv": ln_tbl("norm_conv", S["conv_in"]),
            "ln_ff2": ln_tbl("norm_ff2", S["ff2_in"]),
            "ln_out": (ln_tbl("norm_out", S_next) if S_next is not None else
                       {"gamma": np.asarray(lp["norm_out"]["gamma"], np.float32),
                        "beta": np.asarray(lp["norm_out"]["beta"], np.float32)}),
            "ff1_l1": _lin_table(lp["ff1"]["l1"], S["ff1_in"], S["ff1_act"], wb),
            "ff1_l2": _lin_table(lp["ff1"]["l2"], S["ff1_mid"], S["ln_att"], wb, gain=0.5),
            "ff2_l1": _lin_table(lp["ff2"]["l1"], S["ff2_in"], S["ff2_act"], wb),
            "ff2_l2": _lin_table(lp["ff2"]["l2"], S["ff2_mid"], s_tail, wb, gain=0.5),
            "ff1_grid": _rq_table(S["ff1_act"], S_IN),
            "ff1_prod": _rq_table(S["ff1_act"] / (1 << K_SIG), S["ff1_mid"]),
            "ff2_grid": _rq_table(S["ff2_act"], S_IN),
            "ff2_prod": _rq_table(S["ff2_act"] / (1 << K_SIG), S["ff2_mid"]),
            "att_q_u": _lin_table(att["q"], S["att_in"], S["att_qu"], wb, extra_bias=bu),
            "att_q_v": _lin_table(att["q"], S["att_in"], S["att_qv"], wb, extra_bias=bv),
            "att_k": _lin_table(att["k"], S["att_in"], S["att_k"], wb),
            "att_v": _lin_table(att["v"], S["att_in"], S["att_v"], wb),
            "att_pos_w": _w_quant(np.asarray(att["pos"]["w"], np.float64), wb, (0,)),
            "S_att_pos": S["att_pos"],
            "ac_grid": _rq_table(S["att_qu"] * S["att_k"] / np.sqrt(d_k), S_IN),
            "bd_grid": _rq_table(S["att_qv"] * S["att_pos"] / np.sqrt(d_k), S_IN),
            "ctx_rq": _rq_table(S["att_v"] / (2 ** (ab - 1) - 1), S["att_ctx"]),
            "att_out": _lin_table(att["out"], S["att_ctx"], S["ln_conv"], wb),
            "pw1_a": _lin_table({"w": pw1_w[:, :d], "b": pw1_b[:d]},
                                S["conv_in"], S["conv_a"], wb),
            "pw1_g": _lin_table({"w": pw1_w[:, d:], "b": pw1_b[d:]},
                                S["conv_in"], S_IN, wb),
            "glu_prod": _rq_table(S["conv_a"] / (1 << K_SIG), S["conv_glu"]),
            "dw_w": w_dw_int,
            "dw_bn": _affine_rq(k_dw, c_dw, S["conv_bn"]),
            "bn_grid": _rq_table(S["conv_bn"], S_IN),
            "bn_prod": _rq_table(S["conv_bn"] / (1 << K_SIG), S["conv_mid"]),
            "pw2": _lin_table({"w": np.asarray(cv["pw2"]["w"][0]),
                               "b": np.asarray(cv["pw2"]["b"])},
                              S["conv_mid"], S["ln_ff2"], wb),
            "j1_stream": _rq_table(S["ln_ff1"], S["ln_att"]),
            "j2_stream": _rq_table(S["ln_att"], S["ln_conv"]),
            "j3_stream": _rq_table(S["ln_conv"], S["ln_ff2"]),
            "j4_stream": _rq_table(S["ln_ff2"], s_tail),
            "S_ln_out_site": s(st["ln_out"]),
        })

    # the subsampler's flatten quantizes at pre_out; the projection requants
    # (with the sqrt(d) xscale folded in) into the first stream scale
    s_pre = _site_scale(qstate["pre_out"], ab)
    s_l0 = _site_scale(qstate["layers"][0]["ln_ff1"], ab)
    xgain = float(np.sqrt(cfg.d_model)) if cfg.xscaling else 1.0
    pre = _lin_table(params["pre_encode"]["out"] if cfg.subsampling
                     else params["pre_encode"]["linear"], s_pre, s_l0, wb, gain=xgain)
    return {"layers": layers, "pre": pre, "S_pre": s_pre,
            "subsampler": params["pre_encode"] if cfg.subsampling else None,
            "act_bit": ab}


# ---------------------------------------------------------------------------
# tables on a device
# ---------------------------------------------------------------------------


def conformer_tables_to_device(host, device) -> Dict[str, Any]:
    """Host tables -> the executors' device form: a linear site becomes
    {"wt" (dout, din) int8, "b", "m" int32, "e" int}, an affine site
    {"sgn", "b", "m" int32, "e" int}, a scalar requant (m int, e int), the
    depthwise taps (K, d) int8.  ``host`` keeps the numpy tables (digest,
    per-length pos tables); ``_pos`` caches the pos tables per length."""
    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    def lin(t):
        return {"wt": torch.from_numpy(np.ascontiguousarray(np.asarray(t["w"]).T)).to(device),
                "b": t32(t["b"]), "m": t32(t["m"]), "e": int(t["e"])}

    def affine(t):
        return {"sgn": t32(t["sgn"]), "b": t32(t["b"]), "m": t32(t["m"]), "e": int(t["e"])}

    def pair(t):
        return int(np.asarray(t[0])), int(t[1])

    layers = []
    for tbl in host["layers"]:
        dl: Dict[str, Any] = {}
        for k, v in tbl.items():
            if k in ("att_pos_w", "S_att_pos", "S_ln_out_site"):
                continue
            if k == "dw_w":
                dl[k] = torch.from_numpy(np.ascontiguousarray(v[:, 0, :])).to(device)
            elif k == "ln_out" and "m" not in v:
                dl[k] = {n: torch.from_numpy(np.asarray(v[n], np.float32)).to(device)
                         for n in ("gamma", "beta")}
            elif isinstance(v, tuple):
                dl[k] = pair(v)
            elif "w" in v:
                dl[k] = lin(v)
            else:
                dl[k] = affine(v)
        w_pos, _ = tbl["att_pos_w"]
        dl["att_pos"] = {"wt": torch.from_numpy(np.ascontiguousarray(w_pos.T)).to(device)}
        layers.append(dl)
    sub = host["subsampler"]
    return {"host": host, "layers": layers, "pre": lin(host["pre"]),
            "S_pre": float(host["S_pre"]), "act_bit": int(host["act_bit"]),
            "subsampler": None if sub is None else subsampler_to_device(sub, device),
            "device": torch.device(device), "_pos": {}}


def _pos_tables(tables, t: int):
    """(pos8 (2T-1, d) int8 on the device, [linear site per layer]) for
    length T: the relative-position table at a fixed scale and each
    layer's bias-free pos projection with its requant onto the att_pos site
    (host Decimal math, cached per length)."""
    if t not in tables["_pos"]:
        ab = tables["act_bit"]
        n = 2 ** (ab - 1) - 1
        host = tables["host"]["layers"]
        d = host[0]["att_pos_w"][0].shape[0]
        pos_np = rel_positional_encoding(t, d)
        pos_scale = float(max(abs(pos_np.min()), abs(pos_np.max()), 1e-8)) / n
        pos8 = np.clip(np.round(pos_np / pos_scale), -n, n - 1).astype(np.int8)
        sites = []
        for tbl, dev_tbl in zip(host, tables["layers"]):
            m, e = _rq_table(pos_scale * tbl["att_pos_w"][1], tbl["S_att_pos"])
            sites.append({"wt": dev_tbl["att_pos"]["wt"],
                          "m": torch.from_numpy(m).to(tables["device"]), "e": e})
        tables["_pos"][t] = (torch.from_numpy(pos8).to(tables["device"]), sites)
    return tables["_pos"][t]


def conformer_tables_digest(tables) -> str:
    """SHA-256 (``quantize.freeze.tables_digest``) of the host tables behind
    device tables."""
    return tables_digest(tables["host"])


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConformerPlan:
    """Which integer sublayers of the frozen encoder run in kernels (the
    JAX package's QASR_CONF_MOD and QASR_CONF_FUSED, passed explicitly).

    mod:   "conv" -- the att_out join + conv module in Kernel 4 (always);
           "1"    -- also both FFN halves, with their tail i-LayerNorms, in
                     Kernel 6 ``ffn_ln``.
    fused: every remaining linear (pre; q_u, q_v, k, v, pos; the FFN l1 /
           l2 under "conv") in Kernel 5 ``lin_epilogue``; else plain torch.
    Any other value raises (the JAX flags select the default on a typo)."""

    mod: str = "1"
    fused: bool = True

    def __post_init__(self):
        if self.mod not in ("conv", "1"):
            raise ValueError(f"ConformerPlan.mod must be 'conv' or '1', got {self.mod!r}")
        if not isinstance(self.fused, bool):
            raise ValueError(f"ConformerPlan.fused must be a bool, got {self.fused!r}")


# the kernel path's default: the whole integer stack in kernels
DEFAULT_PLAN = ConformerPlan("1", True)


def conformer_x8(tables, cfg: ConformerConfig, feats: torch.Tensor,
                 lens: torch.Tensor):
    """Float features (B, T, F) -> (x8 (B, T', c*f) int8, lens'): the
    subsampler and the single quantization onto the pre_out site."""
    if cfg.subsampling:
        y, lens = subsample_convs(tables["subsampler"], cfg, feats, lens)
    else:
        y = feats.to(torch.float32)
    return clip8(torch.round(f32_div(y, tables["S_pre"])), tables["act_bit"]), lens


def conformer_encode(tables, cfg: ConformerConfig, x8: torch.Tensor,
                     lens: torch.Tensor, kernels: bool = True,
                     plan: ConformerPlan = DEFAULT_PLAN):
    """x8 -> (float encodings (B, T, d), lens) through the integer layer
    stack, following the JAX layer loop (qasr_tpu/quantize/
    conformer_freeze.py:585-683) branch for branch.  ``kernels``: the
    kernels ``plan`` names (default ("1", True)) --
    Kernels 3 and 4 always, Kernel 6 ``ffn_ln`` for the FFN halves under
    mod "1", Kernel 5 ``lin_epilogue`` for the remaining linears under
    fused -- on their plain versions for CPU tensors.  ``kernels=False``:
    the plain compositions throughout, whatever the plan."""
    if not kernels:
        plan = ConformerPlan("conv", False)
    ab = tables["act_bit"]
    d, h = cfg.d_model, cfg.n_heads
    d_k = d // h
    left, right = cfg.att_context
    attend = int_attention if kernels else int_attention_plain
    conv = conv_block if kernels else conv_block_plain
    ffn = ffn_ln if kernels else ffn_ln_plain
    lin = lin_epilogue if plan.fused else lin_epilogue_plain
    lens = lens.to(device=x8.device, dtype=torch.int32)
    x = lin(x8, tables["pre"], nbits=ab)
    b, t = x.shape[:2]
    pos8, pos_sites = _pos_tables(tables, t)

    def ffn_half(tbl, x, half: str, stream_rq, tail):
        """(joined stream, tail i-LN or None) of one FFN half-step."""
        l1, l2 = tbl[f"{half}_l1"], tbl[f"{half}_l2"]
        grid, prod = tbl[f"{half}_grid"], tbl[f"{half}_prod"]
        if plan.mod == "1":
            return ffn(x, tbl[f"ln_{half}"], l1, grid, prod, l2, stream_rq, tail, nbits=ab)
        m8 = lin(_ln_rq(x, tbl[f"ln_{half}"], ab), l1, swish=(grid, prod), nbits=ab)
        x = lin(m8, l2, stream8=x, stream_rq=stream_rq, nbits=ab)
        return x, (None if tail is None else _ln_rq(x, tail, ab))

    for li, tbl in enumerate(tables["layers"]):
        last = "m" not in tbl["ln_out"]
        # FFN1 half-step with ln_att as its tail
        x, yln = ffn_half(tbl, x, "ff1", tbl["j1_stream"], tbl["ln_att"])
        # attention
        qu8, qv8, k8, v8 = (lin(yln, tbl[f"att_{s}"], nbits=ab).reshape(b, t, h, d_k)
                            for s in ("q_u", "q_v", "k", "v"))
        p8 = lin(pos8, pos_sites[li], nbits=ab).reshape(2 * t - 1, h, d_k)
        c8 = attend(qu8, qv8, k8, v8, p8, lens, ac=tbl["ac_grid"], bd=tbl["bd_grid"],
                    ctx_rq=tbl["ctx_rq"], left=left, right=right, nbits=ab)
        # att_out join + conv module
        x = conv(c8, x, lens, tbl, cfg.dw_padding, nbits=ab)
        # FFN2 half-step with ln_out as its tail: the next layer's stream
        x, x_next = ffn_half(tbl, x, "ff2", tbl["j4_stream"], None if last else tbl["ln_out"])
        if not last:
            x = x_next
            continue
        # the last layer: the float gamma/beta boundary
        y = i_layernorm_core(x).to(torch.float32) / (1 << _K_LN)
        return y * tbl["ln_out"]["gamma"] + tbl["ln_out"]["beta"], lens
    raise AssertionError("unreachable: the last layer returns")


def kernel_launches(cfg: ConformerConfig, plan: ConformerPlan = DEFAULT_PLAN
                    ) -> Dict[str, int]:
    """Kernel launches of one ``conformer_encode(kernels=True, plan=plan)``
    (default ("1", True)): one attention core and one conv block per
    layer; under mod "1" two ``ffn_ln`` per layer; under fused one
    ``lin_epilogue`` for the pre projection and five per layer (q_u, q_v,
    k, v, pos), plus the FFN halves' l1 and l2 (four per layer) when they
    are not in ``ffn_ln``."""
    n = cfg.n_layers
    lin = 1 + 5 * n + (0 if plan.mod == "1" else 4 * n) if plan.fused else 0
    return {"int_attention": n, "conv_block": n,
            "ffn_ln": 2 * n if plan.mod == "1" else 0, "lin_epilogue": lin}
