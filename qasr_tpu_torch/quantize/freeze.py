"""Freezing and frozen execution (port of qasr_tpu/quantize/freeze.py).

Host half (numpy, no tensors): ``freeze_model`` walks the port's
``encoder_forward`` with ``ScaleFreezeExec`` and emits the same tables as
the JAX package, bit for bit: int8 weights, int32 biases, int32 mantissas,
exponents that are Python ints in ``static_e``/``static_e16`` and vectors
in ``per_channel``.  ``tables_to_device`` moves them onto a torch device and
adds each conv's kernel weight layout.

Executors, over (B, T, C):
  * ``FrozenExec``        plain torch, the JAX FrozenExec's op order; the
                          port's oracle.
  * ``FrozenExecFused``   static exponents: the pending-conv design of the
                          JAX FrozenExecCMF; every conv of the walk runs
                          through Kernel 1 (dw_conv), Kernel 2 (pw_gemm)
                          or Kernel 8 (dense_conv), each conv's epilogue
                          carrying the consumer's requant and its prologue
                          the requant of a materialized input.
  * ``FrozenExecKernels`` any tables, vector exponents included: convs in
                          Kernels 1/2/8, the requants next to a depthwise
                          conv in Kernel 1's prologue and epilogue with
                          per-channel exponents, the rest in Kernel 7
                          (requant), as the JAX FrozenExec with
                          use_pallas=True.

Storage (kernels/checks.py::act_dtype): the kernel executors keep
activation codes of <= 8 bits in int8, W8A8's 9-bit codes of a post-ReLU
value (the asymmetric sites) in uint8, and its signed 9-bit codes (the
same sites after selu or swish) as two uint8 planes v = u - 256 s, each
multiplied by the conv's kernel (``_StagedExec._planes_conv``); the plain
FrozenExec keeps 9-bit codes in int32, as the JAX package does.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from qasr_tpu_torch.kernels.checks import act_dtype, join_planes, signed_planes
from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain, prologue_plain
from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
from qasr_tpu_torch.kernels.requant import requant
from qasr_tpu_torch.models.config import DecoderConfig, QuantConfig
from qasr_tpu_torch.models.jasper import (
    NONNEG_ACTIVATIONS,
    ConvSpec,
    EncoderPlan,
    _apply_activation,
    conv_out_len,
    encoder_forward,
    group_shuffle_q,
    heads_taps,
    is_dense,
    is_depthwise,
    is_pointwise,
    kernel_weight,
    mask_values,
    shuffle_channel_vector,
)
from qasr_tpu_torch.ops.quant_prims import (
    Dyadic,
    QTensor,
    clip_ceiling,
    dyadic_from_scale_host,
    dyadic_from_scale_host_static_e,
    dyadic_requant,
    dyadic_requant_static,
    dyadic_requant_static16,
    hardtanh_ceiling,
    requant_clamp,
)

log = logging.getLogger(__name__)
_warned = set()


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        log.warning(msg)


# ---------------------------------------------------------------------------
# Host half: scale propagation and tables (numpy)
# ---------------------------------------------------------------------------


def _act_scale_f32(x_min: float, x_max: float, bits: int) -> np.float32:
    n = 2 ** (bits - 1) - 1
    sat = max(abs(np.float32(x_min)), abs(np.float32(x_max)))
    return np.float32(max(sat, np.float32(1e-8)) / np.float32(n))


def _weight_tables(w: np.ndarray, b: Optional[np.ndarray], act_scale: np.float32,
                   weight_bit: int):
    """Per-out-channel weight quant + 32-bit bias in float32 semantics."""
    w = np.asarray(w, np.float32)
    n = 2 ** (weight_bit - 1) - 1
    sat = np.maximum(np.abs(w.min(axis=(0, 1))), np.abs(w.max(axis=(0, 1))))
    w_scale = (np.maximum(sat, 1e-8) / np.float32(n)).astype(np.float32)
    w_int = np.clip(np.round((np.float32(1.0) / w_scale) * w), -n, n - 1)
    out_scale = (w_scale * act_scale).astype(np.float32)
    b_int = None
    if b is not None:
        b_int = np.round((np.float32(1.0) / out_scale) * np.asarray(b, np.float32))
        b_int = b_int.astype(np.int64).clip(-(2**31), 2**31 - 1).astype(np.int32)
    return w_int, w_scale, out_scale, b_int


def _dyadic(pre_scale: np.ndarray, out_scale: np.float32, mode: str = "per_channel"):
    """new_scale = f64(pre)/f64(out); 'static_e' / 'static_e16' give one
    Python-int exponent per site, 'per_channel' a vector."""
    ns = np.asarray(pre_scale, np.float32).astype(np.float64) / np.float64(
        np.float32(out_scale))
    if mode == "static_e":
        m, e = dyadic_from_scale_host_static_e(ns)
        return Dyadic(m, e)
    if mode == "static_e16":
        m, e = dyadic_from_scale_host_static_e(ns, max_bit=16)
        if not 1 <= e <= 31:
            raise ValueError(f"static_e16 exponent out of range: {e}")
        return Dyadic(m, e)
    return dyadic_from_scale_host(ns)


class _SVal:
    """Symbolic activation: its scale (None => float input) and a
    worst-case |integer value| bound for the overflow checks."""

    __slots__ = ("scale", "bound")

    def __init__(self, scale, bound=None):
        self.scale = scale
        self.bound = bound


def planes_bound(w_int: np.ndarray, b_int: Optional[np.ndarray]) -> int:
    """The largest |int32| the byte-plane form of a conv with a signed
    9-bit input (``kernels/checks.py::act_dtype``) holds: per output
    channel o, |acc_u| <= 255 S_o + |b_o|, |256 acc_s| <= 256 S_o and
    |acc_u - 256 acc_s| = |conv(W, v) + b|_o <= 256 S_o + |b_o|, with S_o
    the sum of |w| over channel o's contraction (the low plane carries the
    bias).  Below 2^31 every partial sum and the joined one are exact
    (Jasper10x5Dr's widest contraction, Cin 768 x K 29 at 127, is 7.2e8)."""
    s = np.abs(np.asarray(w_int, np.int64)).sum(axis=(0, 1))
    b = 0 if b_int is None else np.abs(np.asarray(b_int, np.int64))
    return int((256 * s + b).max())


def plane_site(entry, activation: str) -> bool:
    """Whether a conv site's input codes are signed 9-bit, stored as two
    uint8 byte planes (``kernels/checks.py::act_dtype``): a requantized
    input (its entry has an ``act_m``; the float first input is quantized
    instead) of 9 bits after an activation that may leave it negative
    (selu, swish).  The one rule that the freeze's bound
    (``planes_bound``), the launch counts and the kernel executors read."""
    return (entry is not None and "act_m" in entry
            and signed_planes(int(entry["act_bits"]), activation in NONNEG_ACTIVATIONS))


class ScaleFreezeExec:
    """Host executor: propagates scales, emits tables (no tensor math).
    ``planes``: {site: ``planes_bound``} of every conv whose input codes
    are signed 9-bit (W8A8's asymmetric sites under selu or swish), which
    ``freeze_model`` holds below 2^31."""

    def __init__(self, params, qstate, qcfg: QuantConfig, plan: EncoderPlan,
                 dyadic_mode: str = "static_e"):
        self.params = params
        self.qstate = qstate
        self.qcfg = qcfg
        self.dyadic_mode = dyadic_mode
        self.activation_kind = plan.activation
        self.planes: Dict[Any, int] = {}
        # set when a static_e16 requant could see |z| >= 2**30
        self.e16_overflow = False
        self.tables: Dict[str, Any] = {
            "blocks": [
                {"convs": [None] * len(bp.convs), "res": [None] * len(bp.res),
                 "res_act": []}
                for bp in plan.blocks
            ],
        }

    def _state(self, path):
        node = self.qstate
        for k in path:
            node = node[k]
        return float(np.asarray(node["x_min"])), float(np.asarray(node["x_max"]))

    def _act_bits(self, asymmetric: bool) -> int:
        return self.qcfg.act_bit + (1 if asymmetric else 0)

    def _check_e16(self, x: _SVal) -> None:
        if (self.dyadic_mode == "static_e16" and x.bound is not None
                and x.bound >= (1 << 30)):
            self.e16_overflow = True

    def masked_conv(self, site, spec: ConvSpec, x: _SVal, lens):
        bi, kind, i = site
        p = self.params["blocks"][bi][kind][i]
        if "bn" in p:
            raise ValueError("freeze requires BN-folded params")
        bits = self._act_bits(spec.asymmetric)
        x_min, x_max = self._state(("blocks", bi, kind, i))
        act_scale = _act_scale_f32(x_min, x_max, bits)
        entry: Dict[str, Any] = {"act_scale": np.float32(act_scale),
                                 "act_bits": bits}
        if x.scale is not None:
            self._check_e16(x)
            d = _dyadic(x.scale, act_scale, self.dyadic_mode)
            entry["act_m"], entry["act_e"] = d.m, d.e
        w_int, w_scale, out_scale, b_int = _weight_tables(
            np.asarray(p["w"]), np.asarray(p["b"]) if "b" in p else None,
            act_scale, self.qcfg.weight_bit)
        entry["w"] = w_int.astype(np.int8)
        if b_int is not None:
            entry["b"] = b_int
        entry["out_scale"] = out_scale
        self.tables["blocks"][bi][kind][i] = entry
        if plane_site(entry, self.activation_kind):
            self.planes[site] = planes_bound(w_int, b_int)
        contraction = spec.kernel * (spec.in_ch // spec.groups)
        acc = (contraction * (1 << (bits - 1)) * int(np.abs(w_int).max())
               + (int(np.abs(b_int).max()) if b_int is not None else 0))
        if acc >= (1 << 31):
            _warn_once(f"conv site {site}: worst-case accumulator {acc} exceeds "
                       f"int32 — consider lower weight/act bits")
        return _SVal(out_scale, acc), conv_out_len(np.asarray(lens), spec)

    def residual_add(self, block_idx: int, pane: int, out: _SVal, res_out: _SVal,
                     mode: str):
        x_min, x_max = self._state(("blocks", block_idx, "res_act"))
        act_scale = _act_scale_f32(x_min, x_max, self.qcfg.act_bit)
        self._check_e16(out)
        self._check_e16(res_out)
        dx = _dyadic(out.scale, act_scale, self.dyadic_mode)
        dr = _dyadic(res_out.scale, act_scale, self.dyadic_mode)
        self.tables["blocks"][block_idx]["res_act"].append(
            {"m": dx.m, "e": dx.e, "m_r": dr.m, "e_r": dr.e,
             "scale": np.float32(act_scale)})
        return _SVal(np.float32(act_scale), 1 << (self.qcfg.act_bit - 1))

    def activation(self, x: _SVal, dropout: float) -> _SVal:
        return x  # relu/hardtanh preserve the scale grid

    def group_shuffle(self, x: _SVal, groups: int) -> _SVal:
        scale = x.scale
        if getattr(scale, "ndim", 0) == 1:
            c = scale.shape[0]
            scale = np.asarray(scale).reshape(groups, c // groups).swapaxes(0, 1).reshape(c)
        return _SVal(scale, x.bound)

    def squeeze_excite(self, block_idx, x, bp):
        raise NotImplementedError("SqueezeExcite does not support quantization")


def _mark_separable_fusion(plan: EncoderPlan, tables) -> None:
    """Flag dw->pw pairs the JAX package's fused depthwise-requant kernel
    (kernels/depthwise.py::depthwise_fused_requant) can absorb.  The port's
    Kernel 1 takes both requants wherever they occur (its prologue and
    epilogue) and reads no flag; the flag keeps the tables identical."""
    for bp, tb in zip(plan.blocks, tables["blocks"]):
        convs = bp.convs
        for i in range(len(convs) - 1):
            s, nx = convs[i], convs[i + 1]
            e0, e1 = tb["convs"][i], tb["convs"][i + 1]
            if e0 is None or e1 is None:
                continue
            if (s.groups == s.in_ch and s.groups > 1 and s.kernel > 1
                    and s.stride == 1 and s.heads == -1 and "b" not in e0
                    and nx.kernel == 1 and nx.groups == 1 and nx.stride == 1
                    and nx.heads == -1
                    and "act_m" in e0 and "act_m" in e1
                    and e1["act_bits"] <= 8
                    and isinstance(e0.get("act_e"), int)
                    and isinstance(e1.get("act_e"), int)):
                e0["fuse_next"] = True


def freeze_model(plan: EncoderPlan, enc_params, dec_params, qstate,
                 qcfg: QuantConfig, dec_cfg: DecoderConfig,
                 dyadic_mode: str = "static_e"):
    """Host pass producing the frozen integer model (numpy tables)."""
    fx = ScaleFreezeExec(enc_params, qstate, qcfg, plan, dyadic_mode)
    out_sval, _ = encoder_forward(fx, plan, _SVal(None), np.zeros((1,), np.int64))
    fx._check_e16(out_sval)  # the decoder's act requant consumes this
    wide = {site: v for site, v in fx.planes.items() if v >= 1 << 31}
    if wide:
        raise ValueError(f"signed 9-bit conv inputs whose byte-plane accumulators could "
                         f"leave int32: {wide}")
    if fx.e16_overflow:
        log.warning("static_e16 requant could overflow on this model "
                        "(worst-case accumulator >= 2**30); falling back to "
                        "dyadic_mode='static_e'")
        return freeze_model(plan, enc_params, dec_params, qstate, qcfg,
                            dec_cfg, dyadic_mode="static_e")
    tables = fx.tables
    tables["dyadic16"] = dyadic_mode == "static_e16"
    _mark_separable_fusion(plan, tables)
    x_min = float(np.asarray(qstate["decoder_act"]["x_min"]))
    x_max = float(np.asarray(qstate["decoder_act"]["x_max"]))
    act_scale = _act_scale_f32(x_min, x_max, qcfg.act_bit)
    d = _dyadic(out_sval.scale, act_scale, dyadic_mode)
    w_int, w_scale, out_scale, b_int = _weight_tables(
        np.asarray(dec_params["w"]), np.asarray(dec_params["b"]),
        act_scale, qcfg.weight_bit)
    tables["decoder"] = {
        "act_scale": np.float32(act_scale), "act_m": d.m, "act_e": d.e,
        "w": w_int.astype(np.int8), "b": b_int,
        "out_scale": out_scale,
    }
    return _tables_to_host(tables)


def _tables_to_host(t):
    """Every array-like leaf (numpy scalars included) as an ndarray, as the
    JAX package's freeze_model returns them; ints and bools unchanged."""
    if isinstance(t, dict):
        return {k: _tables_to_host(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tables_to_host(v) for v in t]
    if hasattr(t, "dtype") and hasattr(t, "shape"):
        return np.asarray(t)
    return t


def tables_all_static_e(tables) -> bool:
    """True when every requant exponent is a static Python int."""
    for tb in tables["blocks"]:
        for entry in list(tb["convs"]) + list(tb["res"]):
            if entry is not None and "act_e" in entry \
                    and not isinstance(entry["act_e"], int):
                return False
        for e in tb["res_act"]:
            if not (isinstance(e["e"], int) and isinstance(e["e_r"], int)):
                return False
    return isinstance(tables["decoder"]["act_e"], int)


# ---------------------------------------------------------------------------
# Tables on a device, and a canonical digest
# ---------------------------------------------------------------------------


def tables_to_device(tables, device) -> Dict[str, Any]:
    """numpy tables -> torch tensors on ``device``; Python ints, bools and
    0-d scale arrays (host constants) stay as they are.  Conv entries gain
    ``wk``, the kernel weight layout, and ``hcap``, hardtanh's ceiling on
    their int32 output (round(20 / out_scale), ``hardtanh_ceiling``, in the
    conv's channel order); residual-join entries gain ``hcap``, the ceiling
    on the join's codes as a Python int (before the int8 cap)."""
    def conv(t):
        if isinstance(t, dict):
            out = {k: conv(v) for k, v in t.items()}
            if "w" in out and isinstance(out["w"], torch.Tensor):
                out["wk"] = kernel_weight(out["w"])
            if isinstance(t.get("out_scale"), np.ndarray) and t["out_scale"].ndim:
                out["hcap"] = torch.from_numpy(hardtanh_ceiling(t["out_scale"])).to(device)
            if "m_r" in t:
                out["hcap"] = hardtanh_ceiling(t["scale"])
            return out
        if isinstance(t, list):
            return [conv(v) for v in t]
        if isinstance(t, np.ndarray) and t.ndim > 0:
            return torch.from_numpy(np.ascontiguousarray(t)).to(device)
        return t
    return conv(tables)


def _derived(key: str) -> bool:
    """Keys tables_to_device and the executors add to an entry."""
    return key in ("wk", "hcap") or key.startswith("_")


def tables_to_numpy(tables) -> Dict[str, Any]:
    """Inverse of tables_to_device (drops the derived entries: ``wk``,
    ``hcap`` and the executors' per-channel caches)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items() if not _derived(k)}
        if isinstance(t, list):
            return [conv(v) for v in t]
        if isinstance(t, torch.Tensor):
            return t.cpu().numpy()
        return t
    return conv(tables)


def tables_digest(tables) -> str:
    """SHA-256 over a canonical serialization of numpy tables: keys sorted,
    lists and tuples in order, arrays as dtype + shape + C-order bytes,
    Python ints and bools tagged by type (a static exponent and a 0-d array
    differ), Python floats by their exact hex form, strings tagged."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            h.update(b"{")
            for k in sorted(t):
                h.update(repr(k).encode())
                walk(t[k])
            h.update(b"}")
        elif isinstance(t, (list, tuple)):
            h.update(b"[")
            for v in t:
                walk(v)
            h.update(b"]")
        elif isinstance(t, (np.ndarray, np.generic)):
            a = np.ascontiguousarray(np.asarray(t))
            h.update(f"nd:{a.dtype.str}:{a.shape}:".encode())
            h.update(a.tobytes())
        elif isinstance(t, (bool, int)) or t is None:
            h.update(f"{type(t).__name__}:{t};".encode())
        elif isinstance(t, float):  # the Conformer's static site scales
            h.update(f"float:{t.hex()};".encode())
        elif isinstance(t, str):    # the transducer joint's activation
            h.update(f"str:{t};".encode())
        else:
            raise TypeError(f"tables_digest: unexpected leaf {type(t)}")
    walk(tables)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------


def _narrow(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Activations are stored int8 when they fit."""
    return q.to(torch.int8) if bits <= 8 else q.to(torch.int32)


def quantize_input(x: torch.Tensor, act_scale, bits: int) -> torch.Tensor:
    """First-site quantization of the float features:
    round(f32(1/scale) * x) clipped to [-n, n-1] (multiply by the float32
    reciprocal, as the JAX package and the reference do)."""
    n = 2 ** (bits - 1) - 1
    inv = float(np.float32(1.0) / np.float32(act_scale))
    return _narrow(torch.round(x.to(torch.float32) * inv).clamp(-n, n - 1), bits)


def _host(scale) -> np.ndarray:
    """A scale as host float32 numpy (tables keep 0-d scales on the host)."""
    if isinstance(scale, torch.Tensor):
        return scale.detach().cpu().numpy().astype(np.float32)
    return np.asarray(scale, np.float32)


def float_activation(values: torch.Tensor, scale, kind: str) -> torch.Tensor:
    """selu / swish on an integer activation, as the JAX FrozenExec: dequantize
    (values * scale in float32), the float function, divide by the scale
    and round half to even -> int32 on the same grid."""
    s = scale if isinstance(scale, torch.Tensor) else torch.as_tensor(
        np.asarray(scale, np.float32), device=values.device)
    y = _apply_activation(values.to(torch.float32) * s, kind) / s
    return torch.round(y).to(torch.int32)


def _per_channel(entry, key: str, c: int):
    """entry[key] as a kernel takes a per-channel operand: a one-element
    vector (the single weight scale of a ``heads`` = 1 conv, carried into
    the next site's mantissas) broadcast to the c channels it meets and
    cached in the entry ("_" + key); anything else as it is."""
    v = entry[key]
    if isinstance(v, torch.Tensor) and v.dim() == 1 and v.shape[0] == 1 and c > 1:
        k = "_" + key
        if k not in entry:
            entry[k] = v.expand(c).contiguous()
        return entry[k]
    return v


def _dw_taps(entry, spec: ConvSpec) -> torch.Tensor:
    """A depthwise conv's (K, C) taps: ``wk``, or, for a ``heads`` conv or a
    K = 1 depthwise conv (whose tables carry no spec), the taps laid out
    from ``w`` once and cached in the entry."""
    if spec.heads == -1 and spec.kernel > 1:
        return entry["wk"]
    if "_taps" not in entry:
        entry["_taps"] = heads_taps(kernel_weight(entry["w"], True), spec)
    return entry["_taps"]


def _channels(spec: ConvSpec) -> int:
    """A conv's output channels (a ``heads`` conv keeps its input's)."""
    return spec.in_ch if spec.heads != -1 else spec.out_ch


ACTIVATIONS = ("relu", "hardtanh", "selu", "swish")


class FrozenExec:
    """Plain torch deployment executor: int convs, exact dyadic requants
    from the frozen tables, no float math until the decoder's log-softmax
    (selu and swish excepted: they dequantize, apply the float function and
    round back, as the JAX FrozenExec does).  Hardtanh is the integer clip
    [0, round(20 / scale)], capped at 127 on int8 codes.  Takes tables from
    ``tables_to_device``."""

    def __init__(self, tables, qcfg: QuantConfig, *, activation: str):
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.t = tables
        self.m16 = bool(tables.get("dyadic16", False))
        self.qcfg = qcfg
        self.activation_kind = activation

    def _act_bits(self, spec: ConvSpec) -> int:
        return self.qcfg.act_bit + (1 if spec.asymmetric else 0)

    def _requant(self, z, m, e):
        if isinstance(e, int):
            if self.m16:
                return dyadic_requant_static16(z, m, e)
            return dyadic_requant_static(z, m, e)
        return dyadic_requant(z, Dyadic(m, e))

    def _requant_in(self, entry, x: Union[torch.Tensor, QTensor], lens,
                    bits: int) -> torch.Tensor:
        """Mask, then requant + clamp a QTensor or quantize the float input."""
        if isinstance(x, QTensor):
            q = self._requant(mask_values(x.values, lens), entry["act_m"],
                              entry["act_e"])
            return _narrow(requant_clamp(q, bits), bits)
        return quantize_input(mask_values(x, lens), entry["act_scale"], bits)

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        entry = self.t["blocks"][bi][kind][i]
        xq = self._requant_in(entry, x, lens, self._act_bits(spec))
        b = entry.get("b")
        if is_depthwise(spec):
            y = dw_conv_plain(xq, _dw_taps(entry, spec), stride=spec.stride,
                              padding=spec.padding, dilation=spec.dilation, bias=b)
        elif is_pointwise(spec):
            y = pw_gemm_plain(xq, entry["wk"], bias=b, groups=spec.groups)
        else:
            y = dense_conv_plain(xq, entry["wk"], stride=spec.stride, padding=spec.padding,
                                 dilation=spec.dilation, bias=b, groups=spec.groups)
        return QTensor(y, entry["out_scale"]), conv_out_len(lens, spec)

    def residual_add(self, block_idx: int, pane: int, out: QTensor,
                     res_out: QTensor, mode: str) -> QTensor:
        if mode not in ("add", "stride_add"):
            raise NotImplementedError(f"residual mode {mode!r}")
        e = self.t["blocks"][block_idx]["res_act"][pane]
        q = (self._requant(out.values, e["m"], e["e"])
             + self._requant(res_out.values, e["m_r"], e["e_r"]))
        bits = self.qcfg.act_bit
        return QTensor(_narrow(requant_clamp(q, bits), bits), e["scale"])

    def activation(self, x: QTensor, dropout: float) -> QTensor:
        kind = self.activation_kind
        if kind == "relu":
            return QTensor(x.values.clamp_min(0), x.scale)  # dtype-preserving ReLU
        if kind == "hardtanh":
            hi = hardtanh_ceiling(_host(x.scale), narrow=x.values.dtype == torch.int8)
            if not isinstance(hi, int):
                hi = torch.from_numpy(hi).to(x.values.device)
            v = clip_ceiling(x.values.clamp_min(0), hi).to(x.values.dtype)
            return QTensor(v, x.scale)
        return QTensor(float_activation(x.values, x.scale, kind), x.scale)

    def group_shuffle(self, x: QTensor, groups: int) -> QTensor:
        return group_shuffle_q(x, groups)

    def squeeze_excite(self, block_idx, x, bp):
        raise NotImplementedError("SqueezeExcite does not support quantization")

    # -- decoder -----------------------------------------------------------

    def decoder_input(self, x: QTensor) -> torch.Tensor:
        """The decoder's act requant (unmasked, as in the JAX package)."""
        t = self.t["decoder"]
        bits = self.qcfg.act_bit
        return _narrow(requant_clamp(self._requant(x.values, t["act_m"],
                                                   t["act_e"]), bits), bits)

    def decoder_logits(self, x: QTensor) -> torch.Tensor:
        """int32 logits of the 1x1 decoder conv."""
        return pw_gemm_plain(self.decoder_input(x), self.t["decoder"]["wk"],
                             bias=self.t["decoder"]["b"])


def log_probs(logits_int: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
    """Float region after the integer decoder: dequantize, log-softmax."""
    return torch.log_softmax(logits_int.to(torch.float32) * out_scale, dim=-1)


class _PendingConv:
    """A conv whose kernel has not run yet: its input (int8 or uint8 and
    already requantized, or a materialized producer output with ``pro``,
    the prologue that requantizes it inside the kernel), its table entry
    and spec, a staged ReLU (with ``hcap``: hardtanh's per-channel ceiling
    in the conv's channel order) and ``shuffle``, GroupShuffle's group
    count for the kernel's store (0: none).  The next site flushes it
    through a kernel whose epilogue applies that site's requant (or with
    the epilogue off)."""

    __slots__ = ("xq", "entry", "spec", "relu", "hcap", "shuffle", "pro")

    def __init__(self, xq, entry, spec, pro=None):
        self.xq = xq
        self.entry = entry
        self.spec = spec
        self.relu = False
        self.hcap = None
        self.shuffle = 0
        self.pro = pro or {}

    @property
    def depthwise(self) -> bool:
        return is_depthwise(self.spec)

    @property
    def channels(self) -> int:
        return _channels(self.spec)

    def out_scale(self):
        """The scale of the conv's output as stored (GroupShuffle's order,
        laid out once and cached in the entry)."""
        if not self.shuffle:
            return self.entry["out_scale"]
        if "_shuffled_scale" not in self.entry:
            self.entry["_shuffled_scale"] = shuffle_channel_vector(self.entry["out_scale"],
                                                                   self.shuffle)
        return self.entry["_shuffled_scale"]

    def run(self, **kw) -> torch.Tensor:
        """The conv in its kernel (Kernel 1, 2 or 8; grouped, with
        GroupShuffle in the store) with its prologue and these epilogue
        arguments."""
        s = self.spec
        if self.depthwise:
            return dw_conv(self.xq, _dw_taps(self.entry, s), stride=s.stride,
                           padding=s.padding, dilation=s.dilation, **self.pro, **kw)
        g = dict(groups=s.groups, shuffle=bool(self.shuffle))
        if is_pointwise(s):
            return pw_gemm(self.xq, self.entry["wk"], **g, **self.pro, **kw)
        return dense_conv(self.xq, self.entry["wk"], stride=s.stride, padding=s.padding,
                          dilation=s.dilation, **g, **self.pro, **kw)


class _Held:
    """A materialized tensor that more than one consumer reads (a block
    output: the next block and its residual branches, or the decoder): its
    values (int8 or int32), scale, and the producer's bias, ReLU and
    hardtanh ceiling (``hcap``) that each consumer still applies, so its
    value is min(relu?(values + bias), hcap); ``hmax``: the ceiling that
    a hardtanh on it would take (a join's codes); ``shuffled``: the group
    count of a GroupShuffle already applied in its producer's store (a
    grouped byte-plane conv's)."""

    __slots__ = ("values", "scale", "bias", "relu", "hcap", "hmax", "shuffled")

    def __init__(self, values, scale, bias=None, relu=False, hcap=None, hmax=None,
                 shuffled=0):
        self.values = values
        self.scale = scale
        self.bias = bias
        self.relu = relu
        self.hcap = hcap
        self.hmax = hmax
        self.shuffled = shuffled

    def with_relu(self, hcap=None) -> "_Held":
        return _Held(self.values, self.scale, self.bias, True, hcap)


def _folded_into_dw(specs, ci: int) -> bool:
    """Whether FrozenExecKernels requantizes the input of conv ``ci`` of a
    block's in-block convs inside Kernel 1: a depthwise conv's input in
    its prologue, a pointwise conv's that reads a depthwise conv in that
    conv's epilogue."""
    return is_depthwise(specs[ci]) or (is_pointwise(specs[ci]) and ci > 0
                                       and is_depthwise(specs[ci - 1]))


def _conv_kernel(spec: ConvSpec) -> str:
    """The kernel a conv runs in: "dw_conv", "pw_gemm" or "dense_conv"."""
    if is_depthwise(spec):
        return "dw_conv"
    return "pw_gemm" if is_pointwise(spec) else "dense_conv"


def _plane_sites(plan: EncoderPlan, tables):
    """{(block, kind, index): spec} of the convs whose input codes are
    signed 9-bit (``plane_site``)."""
    if tables is None:
        return {}
    return {(bp.index, kind, ci): spec
            for bp, tb in zip(plan.blocks, tables["blocks"])
            for kind, specs in (("convs", bp.convs), ("res", bp.res))
            for ci, (spec, entry) in enumerate(zip(specs, tb[kind]))
            if plane_site(entry, plan.activation)}


def _requant_sites(plan: EncoderPlan, tables) -> int:
    """Requant-kernel launches of one FrozenExecKernels forward: every conv
    input that is requantized (the entries with an ``act_m``; the float
    input is quantized instead) and that Kernel 1 does not take
    (``_folded_into_dw``), every residual join, and the decoder's input.
    A byte-plane depthwise conv (``_plane_sites``) takes neither its own
    input requant (the planes) nor its pointwise consumer's."""
    planes = _plane_sites(plan, tables)
    n = 1
    for bp, tb in zip(plan.blocks, tables["blocks"]):
        n += len(tb["res_act"])
        for kind, specs in (("convs", bp.convs), ("res", bp.res)):
            for ci, entry in enumerate(tb[kind]):
                if entry is not None and "act_m" in entry:
                    after_planes = (kind == "convs" and ci > 0
                                    and (bp.index, kind, ci - 1) in planes)
                    n += (kind == "res" or not _folded_into_dw(specs, ci)
                          or (bp.index, kind, ci) in planes or after_planes)
    return n


def kernel_launches(plan: EncoderPlan, tables=None) -> Dict[str, int]:
    """Kernel launches of one forward on the kernel path that
    ``make_frozen_fn`` picks for ``tables`` (None: static-exponent tables).
    Every conv of the walk runs exactly once, depthwise (``heads`` too) in
    dw_conv, pointwise (in-block, grouped or not, residual, and the
    decoder) in pw_gemm, dense (Jasper's, grouped or not) in dense_conv (a
    key only where the plan has some); GroupShuffle, hardtanh, selu and
    swish launch no kernel of their own.  With static exponents
    (FrozenExecFused) the requants ride in those kernels' prologues and
    epilogues, except a residual join that no pending pointwise or dense
    conv can take (a depthwise block tail, a dense block's later panes),
    which runs in the requant kernel; with vector exponents
    (FrozenExecKernels) the requants next to a depthwise conv ride in
    Kernel 1 and the rest run in the requant kernel (``_requant_sites``).
    A conv of signed 9-bit input codes (``_plane_sites``) runs twice, once
    a byte plane, after a requant launch that writes the planes; its
    output is materialized, so a dense block tail's join then runs in the
    requant kernel."""
    specs = [s for bp in plan.blocks for s in bp.convs + bp.res]
    counts = {"dw_conv": sum(map(is_depthwise, specs)),
              "pw_gemm": sum(map(is_pointwise, specs)) + 1}
    if any(map(is_dense, specs)):
        counts["dense_conv"] = sum(map(is_dense, specs))
    planes = _plane_sites(plan, tables)
    for spec in planes.values():
        counts[_conv_kernel(spec)] += 1
    if tables is not None and not tables_all_static_e(tables):
        counts["requant"] = _requant_sites(plan, tables)
        return counts
    joins = sum(pi > 0 or is_depthwise(bp.convs[-1])
                or (bp.index, "convs", len(bp.convs) - 1) in planes
                for bp in plan.blocks if bp.residual for pi in range(len(bp.res)))
    if joins + len(planes):
        counts["requant"] = joins + len(planes)
    return counts


def quant_kernel_launches(plan: EncoderPlan, act_bit: int) -> Dict[str, int]:
    """Kernel launches of one QuantExec forward with the decoder (kernels
    on, no requant kernel: its requants are torch): every conv once, and a
    second time for each conv whose operand is signed 9-bit (an asymmetric
    site of W8A8 under selu or swish: one launch a byte plane)."""
    counts = {k: v for k, v in kernel_launches(plan).items() if k != "requant"}
    if signed_planes(act_bit + 1, plan.activation in NONNEG_ACTIVATIONS):
        for spec in (s for bp in plan.blocks for s in bp.convs + bp.res if s.asymmetric):
            counts[_conv_kernel(spec)] += 1
    return counts


class _StagedExec(FrozenExec):
    """What the two kernel executors share: activations staged on a pending
    conv (ReLU and hardtanh's ceiling ride in its epilogue, GroupShuffle in
    its store) or on a materialized tensor (its consumers' prologues or
    requants apply them), and selu / swish as float glue on the int32
    accumulator flushed from its kernel (the JAX package runs them in XLA,
    not in a kernel).  A conv whose input codes are signed 9-bit (W8A8's
    asymmetric sites after selu or swish) runs on their two byte planes
    (``_planes_conv``)."""

    def _held_ceiling(self, x: _Held):
        """hardtanh's ceiling on a join's codes: the join entry's, capped at
        127 on int8 codes."""
        return min(x.hmax, 127) if self.qcfg.act_bit <= 8 else x.hmax

    def _join_held(self, q8, e) -> _Held:
        return _Held(q8, e["scale"], hmax=e["hcap"])

    def _flush_act(self, p: _PendingConv) -> torch.Tensor:
        """A pending conv through its kernel with its bias and staged
        activation, epilogue off: int32 in the stored (shuffled) order."""
        return p.run(bias=p.entry.get("b"), relu=p.relu, hcap=p.hcap)

    def activation(self, x, dropout: float):
        kind = self.activation_kind
        if isinstance(x, _PendingConv):
            if kind in ("relu", "hardtanh"):
                x.relu = True
                if kind == "hardtanh":
                    x.hcap = _per_channel(x.entry, "hcap", x.channels)
                return x
            return _Held(float_activation(self._flush_act(x), x.out_scale(), kind),
                         x.out_scale())
        if isinstance(x, _Held):
            if kind == "relu":
                return x.with_relu()
            if kind == "hardtanh":
                return x.with_relu(self._held_ceiling(x))
            return _Held(float_activation(x.values, x.scale, kind), x.scale)
        return super().activation(x, dropout)

    def group_shuffle(self, x, groups: int):
        if isinstance(x, _PendingConv) and not x.depthwise and x.spec.groups == groups:
            x.shuffle = groups
            return x
        if isinstance(x, _Held) and x.shuffled == groups:
            return x
        raise NotImplementedError("GroupShuffle runs in the store of the grouped pointwise or "
                                  "dense conv before it; this one follows another conv")

    def _planes_input(self, entry, bits: int, x) -> bool:
        """Whether a conv input's codes are two byte planes (``plane_site``;
        a code of 10 bits or more raises NotImplementedError on CUDA, int8
        holds any code of <= 8 bits)."""
        if bits <= 8 or not isinstance(x, (_PendingConv, _Held)):
            return False
        act_dtype("conv input", bits, self.activation_kind in NONNEG_ACTIVATIONS,
                  x.xq.device if isinstance(x, _PendingConv) else x.values.device)
        return plane_site(entry, self.activation_kind)

    def _planes_conv(self, entry, spec: ConvSpec, x, lens) -> _Held:
        """A conv of signed 9-bit input codes v: the requant kernel writes
        the input's two uint8 planes v = u - 256 s (mask, requant, clamp to
        [-256, 255], split), the conv's kernel (Kernel 1, 2 or 8 in its
        uint8 form) runs once a plane with the epilogue off, the bias on
        the low plane, and acc_u - 256 acc_s (``checks.join_planes``, exact:
        ``planes_bound``) is the conv's int32 output, materialized for its
        consumer's prologue or requant as a block end's is.  A grouped conv
        that GroupShuffle follows (``block_forward``: a grouped conv with
        BN) shuffles in both planes' stores."""
        if isinstance(x, _PendingConv):
            x = _Held(self._flush_act(x), x.out_scale())
        if x.bias is not None or x.hcap is not None:
            raise NotImplementedError("byte planes of a tensor with a pending bias or ceiling")
        c = spec.in_ch
        u, s = requant(x.values, _per_channel(entry, "act_m", c),
                       _per_channel(entry, "act_e", c), 9, lens=lens, planes=True)
        p = _PendingConv(u, entry, spec)
        if spec.has_bn and spec.groups > 1 and not p.depthwise:
            p.shuffle = spec.groups
        acc_u = p.run(bias=entry.get("b"))
        p.xq = s
        return _Held(join_planes(acc_u, p.run()), p.out_scale(), shuffled=p.shuffle)


class FrozenExecFused(_StagedExec):
    """Static-exponent tables with every requant inside a kernel (the
    pending-conv design of the JAX FrozenExecCMF, in (B, T, C), with
    pointwise and join fusion always on).  ``masked_conv`` returns a
    _PendingConv; the next site flushes it:

      * into a conv site: Kernel 1/2/8 with the epilogue bias -> ReLU (or
        hardtanh's clip) -> mask -> the consumer's requant -> clamp -> int8
        (uint8 for W8A8's 9-bit codes of a ReLU'd value), GroupShuffle in
        the store where the conv is grouped;
      * into a residual join: a pending block-tail pointwise or dense conv
        goes through Kernel 2's or 8's join epilogue, the residual branch's
        conv is flushed to int32 first;
      * at a block end: the raw int32 accumulator (no bias, no ReLU) is
        materialized as a _Held, since a block output feeds several
        consumers, each with its own input requant (with its bias, ReLU and
        ceiling applied in the kernel where it is shuffled or clipped).

    A materialized tensor (a block end's raw accumulator, a residual join's
    int8 output) reaches each consumer through that consumer's kernel
    prologue: bias -> ReLU (or hardtanh's clip) -> mask -> requant ->
    clamp, in shared memory (Kernel 1 at a block's first depthwise conv,
    Kernel 2 at a residual pointwise conv, a non-separable block's conv and
    the decoder, whose input is not masked, as in the JAX package; Kernel 8
    at a dense block's first conv).  Outside a kernel remain only the first
    site's quantization of the float features, selu / swish (float glue),
    and the decoder's float log-softmax.  Needs static exponents (freeze
    dyadic_mode 'static_e' or 'static_e16')."""

    def __init__(self, tables, qcfg: QuantConfig, *, activation: str):
        super().__init__(tables, qcfg, activation=activation)
        if not tables_all_static_e(tables):
            raise ValueError("FrozenExecFused needs static-exponent tables "
                             "(dyadic_mode 'static_e' or 'static_e16')")

    def _conv(self, p: _PendingConv, lens=None, **kw) -> torch.Tensor:
        """Run a pending conv in its kernel with these epilogue arguments
        (``lens``: the epilogue's output mask)."""
        return p.run(**{"out_len" if p.depthwise else "lens": lens}, **kw)

    def _flush_int8(self, p: _PendingConv, lens, entry, bits: int) -> torch.Tensor:
        return self._conv(p, lens, bias=p.entry.get("b"), relu=p.relu, hcap=p.hcap,
                          m=_per_channel(entry, "act_m", p.channels), e=entry["act_e"],
                          bits=bits)

    def _flush_int32(self, p) -> torch.Tensor:
        """A residual branch's int32 output: a pending conv flushed, or a
        byte-plane conv's joined accumulator."""
        return p.values if isinstance(p, _Held) else self._flush_act(p)

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        entry = self.t["blocks"][bi][kind][i]
        bits = self._act_bits(spec)
        if self._planes_input(entry, bits, x):
            return self._planes_conv(entry, spec, x, lens), conv_out_len(lens, spec)
        if isinstance(x, _PendingConv):
            p = _PendingConv(self._flush_int8(x, lens, entry, bits), entry, spec)
        elif isinstance(x, _Held):
            p = _PendingConv(x.values, entry, spec, pro=dict(
                in_bias=x.bias, in_relu=x.relu, in_hcap=x.hcap, in_len=lens,
                m1=_per_channel(entry, "act_m", spec.in_ch), e1=entry["act_e"], bits1=bits))
        else:
            p = _PendingConv(self._requant_in(entry, x, lens, bits), entry, spec)
        return p, conv_out_len(lens, spec)

    def residual_add(self, block_idx: int, pane: int, out, res_out, mode: str):
        if mode not in ("add", "stride_add"):
            raise NotImplementedError(f"residual mode {mode!r}")
        e = self.t["blocks"][block_idx]["res_act"][pane]
        res = self._flush_int32(res_out)
        bits = self.qcfg.act_bit
        c = res.shape[-1]
        m, m_r = _per_channel(e, "m", c), _per_channel(e, "m_r", c)
        if isinstance(out, _PendingConv) and not out.depthwise and not out.relu:
            # a pointwise or dense block tail: the join in its epilogue
            q8 = self._conv(out, bias=out.entry.get("b"), m=m, e=e["e"], res=res,
                            m_r=m_r, e_r=e["e_r"], bits=bits)
            return self._join_held(q8, e)
        if isinstance(out, _PendingConv):
            out = _Held(self._flush_int32(out), out.out_scale())
        if out.bias is not None:
            raise ValueError("residual join of a tensor with a pending bias")
        q8 = requant(out.values, m, e["e"], bits, relu=out.relu, hcap=out.hcap, identity=res,
                     m_r=m_r, e_r=e["e_r"])
        return self._join_held(q8, e)

    def block_end(self, x):
        if isinstance(x, _PendingConv):
            if x.shuffle or x.hcap is not None:
                # shuffled or clipped in the store: bias and activation there too
                return _Held(self._flush_int32(x), x.out_scale(), relu=x.relu)
            return _Held(self._conv(x), x.entry["out_scale"], x.entry.get("b"), x.relu)
        return x

    def _decoder_prologue(self, x: _Held):
        t = self.t["decoder"]
        return dict(in_bias=x.bias, in_relu=x.relu, in_hcap=x.hcap,
                    m1=_per_channel(t, "act_m", x.values.shape[-1]), e1=t["act_e"],
                    bits1=self.qcfg.act_bit)

    def decoder_input(self, x: _Held) -> torch.Tensor:
        """The decoder's int8 input, for records: on the serving path it
        exists only inside the decoder's Kernel 2 prologue."""
        return prologue_plain(x.values, **self._decoder_prologue(x))

    def decoder_logits(self, x: _Held) -> torch.Tensor:
        t = self.t["decoder"]
        return pw_gemm(x.values, t["wk"], bias=t["b"], **self._decoder_prologue(x))


class FrozenExecKernels(_StagedExec):
    """Any tables, vector exponents included (freeze dyadic_mode
    'per_channel'): the port's counterpart of the JAX FrozenExec with
    use_pallas=True.  Every conv runs in Kernel 1, 2 or 8 (a _PendingConv,
    with its staged ReLU or hardtanh clip and GroupShuffle), and the
    requants next to a depthwise conv ride in Kernel 1 with per-channel
    mantissas and exponents:

      * a depthwise conv's input requant (with its length mask) in Kernel
        1's prologue, on the materialized producer output (a _Held: a
        pointwise conv's int32 output, or a join's int8 output);
      * the input requant of a pointwise conv that reads a depthwise conv
        in that conv's epilogue (bias -> ReLU -> mask -> requant -> int8).

    Every other conv is flushed with the epilogue off (int32 out with its
    bias and activation, a _Held), and the remaining requants run in the
    requant kernel: a residual branch's pointwise input, a non-separable
    block's input (C3, and each conv of a dense block), every residual join
    and the decoder's input (unmasked).  Outside a kernel remain only the
    first site's quantization of the float features, selu / swish (float
    glue) and the decoder's float log-softmax."""

    def _flush(self, x):
        """A pending conv through its kernel, epilogue off -> _Held int32
        (its ReLU and ceiling applied, and the ReLU kept as the _Held's
        flag: every consumer's requant then knows the value is >= 0, W8A8's
        uint8 rule; a second ReLU changes nothing)."""
        if not isinstance(x, _PendingConv):
            return x
        return _Held(self._flush_act(x), x.out_scale(), relu=x.relu)

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        entry = self.t["blocks"][bi][kind][i]
        bits = self._act_bits(spec)
        out_len = conv_out_len(lens, spec)
        c = spec.in_ch
        if self._planes_input(entry, bits, x):
            return self._planes_conv(entry, spec, x, lens), out_len
        if isinstance(x, _PendingConv) and x.depthwise and is_pointwise(spec):
            xq = x.run(bias=x.entry.get("b"), relu=x.relu, hcap=x.hcap, out_len=lens,
                       m=_per_channel(entry, "act_m", c), e=_per_channel(entry, "act_e", c),
                       bits=bits)
            return _PendingConv(xq, entry, spec), out_len
        x = self._flush(x)
        if isinstance(x, _Held) and is_depthwise(spec):
            return _PendingConv(x.values, entry, spec, pro=dict(
                in_bias=x.bias, in_relu=x.relu, in_hcap=x.hcap, in_len=lens,
                m1=_per_channel(entry, "act_m", c), e1=_per_channel(entry, "act_e", c),
                bits1=bits)), out_len
        if isinstance(x, _Held):
            xq = requant(x.values, _per_channel(entry, "act_m", c),
                         _per_channel(entry, "act_e", c), bits, relu=x.relu, hcap=x.hcap,
                         lens=lens)
        else:
            xq = self._requant_in(entry, x, lens, bits)
        return _PendingConv(xq, entry, spec), out_len

    def residual_add(self, block_idx: int, pane: int, out, res_out, mode: str):
        if mode not in ("add", "stride_add"):
            raise NotImplementedError(f"residual mode {mode!r}")
        e = self.t["blocks"][block_idx]["res_act"][pane]
        out, res = self._flush(out), self._flush(res_out)
        c = res.values.shape[-1]
        q8 = requant(out.values, _per_channel(e, "m", c), _per_channel(e, "e", c),
                     self.qcfg.act_bit, relu=out.relu, hcap=out.hcap, identity=res.values,
                     m_r=_per_channel(e, "m_r", c), e_r=_per_channel(e, "e_r", c))
        return self._join_held(q8, e)

    def block_end(self, x):
        return self._flush(x)

    def decoder_input(self, x: _Held) -> torch.Tensor:
        t = self.t["decoder"]
        c = x.values.shape[-1]
        return requant(x.values, _per_channel(t, "act_m", c), _per_channel(t, "act_e", c),
                       self.qcfg.act_bit, relu=x.relu, hcap=x.hcap)

    def decoder_logits(self, x: _Held) -> torch.Tensor:
        t = self.t["decoder"]
        return pw_gemm(self.decoder_input(x), t["wk"], bias=t["b"])
