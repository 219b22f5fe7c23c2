"""Freezing and frozen execution (port of qasr_tpu/quantize/freeze.py).

Host half (numpy, no tensors): ``freeze_model`` walks the port's
``encoder_forward`` with ``ScaleFreezeExec`` and emits the same tables as
the JAX package, bit for bit: int8 weights, int32 biases, int32 mantissas,
exponents that are Python ints in ``static_e``/``static_e16`` and vectors
in ``per_channel``.  ``tables_to_device`` moves them onto a torch device and
adds each conv's kernel weight layout.

Executors, over (B, T, C):
  * ``FrozenExec``      plain torch, the JAX FrozenExec's op order; the
                        port's oracle.
  * ``FrozenExecFused`` the pending-conv design of the JAX FrozenExecCMF:
                        every conv of the walk runs through Kernel 1
                        (dw_conv) or Kernel 2 (pw_gemm), each conv's
                        epilogue carrying the consumer's requant.
"""
from __future__ import annotations

import hashlib
import logging
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
from qasr_tpu_torch.models.config import DecoderConfig, QuantConfig
from qasr_tpu_torch.models.jasper import (
    ConvSpec,
    EncoderPlan,
    conv_out_len,
    encoder_forward,
    is_depthwise,
    is_pointwise,
    mask_values,
)
from qasr_tpu_torch.ops.quant_prims import (
    Dyadic,
    QTensor,
    dyadic_from_scale_host,
    dyadic_from_scale_host_static_e,
    dyadic_requant,
    dyadic_requant_static,
    dyadic_requant_static16,
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


class ScaleFreezeExec:
    """Host executor: propagates scales, emits tables (no tensor math)."""

    def __init__(self, params, qstate, qcfg: QuantConfig, plan: EncoderPlan,
                 dyadic_mode: str = "static_e"):
        self.params = params
        self.qstate = qstate
        self.qcfg = qcfg
        self.dyadic_mode = dyadic_mode
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
    (kernels/depthwise.py::depthwise_fused_requant) can absorb.  The port
    has not ported that kernel; the flag keeps the tables identical."""
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


def _kernel_weight(w: torch.Tensor) -> Optional[torch.Tensor]:
    """The kernels' weight layout: depthwise (K, 1, C) -> (K, C); pointwise
    (1, Cin, Cout) -> (Cout, Cin).  None for other convs."""
    k, cin_g, _ = w.shape
    if k > 1 and cin_g == 1:
        return w[:, 0, :].contiguous()
    if k == 1:
        return w[0].t().contiguous()
    return None


def tables_to_device(tables, device) -> Dict[str, Any]:
    """numpy tables -> torch tensors on ``device``; Python ints, bools and
    0-d scale arrays (host constants) stay as they are.  Conv entries gain
    ``wk``, the kernel weight layout."""
    def conv(t):
        if isinstance(t, dict):
            out = {k: conv(v) for k, v in t.items()}
            if "w" in out and isinstance(out["w"], torch.Tensor):
                wk = _kernel_weight(out["w"])
                if wk is not None:
                    out["wk"] = wk
            return out
        if isinstance(t, list):
            return [conv(v) for v in t]
        if isinstance(t, np.ndarray) and t.ndim > 0:
            return torch.from_numpy(np.ascontiguousarray(t)).to(device)
        return t
    return conv(tables)


def tables_to_numpy(tables) -> Dict[str, Any]:
    """Inverse of tables_to_device (drops the derived ``wk`` layouts)."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items() if k != "wk"}
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
    differ), Python floats by their exact hex form."""
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


class FrozenExec:
    """Plain torch deployment executor: int convs, exact dyadic requants
    from the frozen tables, no float math until the decoder's log-softmax.
    Takes tables from ``tables_to_device``."""

    def __init__(self, tables, qcfg: QuantConfig, *, activation: str):
        if activation != "relu":
            raise NotImplementedError(f"frozen activation {activation!r} is not ported")
        self.t = tables
        self.m16 = bool(tables.get("dyadic16", False))
        self.qcfg = qcfg

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
            y = dw_conv_plain(xq, entry["wk"], stride=spec.stride,
                              padding=spec.padding, dilation=spec.dilation,
                              bias=b)
        elif is_pointwise(spec):
            y = pw_gemm_plain(xq, entry["wk"], bias=b)
        else:
            raise NotImplementedError(f"conv {spec} is neither depthwise nor pointwise")
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
        return QTensor(x.values.clamp_min(0), x.scale)  # dtype-preserving ReLU

    def group_shuffle(self, x, groups):
        raise NotImplementedError("grouped convs are not ported")

    def squeeze_excite(self, block_idx, x, bp):
        raise NotImplementedError("SqueezeExcite does not support quantization")

    # -- decoder -----------------------------------------------------------

    def _decoder_input(self, x: QTensor) -> torch.Tensor:
        """The decoder's act requant (unmasked, as in the JAX package)."""
        t = self.t["decoder"]
        bits = self.qcfg.act_bit
        return _narrow(requant_clamp(self._requant(x.values, t["act_m"],
                                                   t["act_e"]), bits), bits)

    def decoder_parts(self, x: QTensor):
        """(int8 decoder input, int32 logits) of the 1x1 decoder conv."""
        q = self._decoder_input(x)
        return q, pw_gemm_plain(q, self.t["decoder"]["wk"], bias=self.t["decoder"]["b"])


def log_probs(logits_int: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
    """Float region after the integer decoder: dequantize, log-softmax."""
    return torch.log_softmax(logits_int.to(torch.float32) * out_scale, dim=-1)


class _PendingConv:
    """A conv whose kernel has not run yet: its int8, already-requantized
    input, its table entry and spec, and a staged ReLU.  The next site
    flushes it through a kernel whose epilogue applies that site's
    requant."""

    __slots__ = ("xq", "entry", "spec", "relu")

    def __init__(self, xq, entry, spec):
        self.xq = xq
        self.entry = entry
        self.spec = spec
        self.relu = False

    @property
    def depthwise(self) -> bool:
        return is_depthwise(self.spec)


def kernel_launches(plan: EncoderPlan) -> Dict[str, int]:
    """Kernel launches of one FrozenExecFused forward: every conv of the
    walk runs exactly once, depthwise in dw_conv, pointwise (in-block,
    residual, and the decoder) in pw_gemm."""
    specs = [s for bp in plan.blocks for s in bp.convs + bp.res]
    return {"dw_conv": sum(map(is_depthwise, specs)),
            "pw_gemm": sum(map(is_pointwise, specs)) + 1}


class FrozenExecFused(FrozenExec):
    """FrozenExec with every conv in a kernel (pending-conv design of the
    JAX FrozenExecCMF, in (B, T, C), with pointwise and join fusion always
    on).  ``masked_conv`` returns a _PendingConv; the next site flushes it:

      * into a conv site: Kernel 1/2 with the epilogue bias -> ReLU -> mask
        -> the consumer's requant -> clamp -> int8;
      * into a residual join: a pending block-tail pointwise conv goes
        through Kernel 2's join epilogue, the residual branch's conv is
        flushed to int32 first;
      * at a block end or into the decoder: int32 through the same kernels
        with the epilogue off.

    The input requant of a materialized tensor (block outputs, which feed
    two consumers, and the decoder input) and the first-site quantization
    stay plain torch, as XLA ran them outside Pallas on the TPU.  Needs
    static exponents (freeze dyadic_mode 'static_e' or 'static_e16') and
    int8 activations."""

    def __init__(self, tables, qcfg: QuantConfig, *, activation: str):
        super().__init__(tables, qcfg, activation=activation)
        if not tables_all_static_e(tables):
            raise ValueError("FrozenExecFused needs static-exponent tables "
                             "(dyadic_mode 'static_e' or 'static_e16')")
        if qcfg.act_bit + 1 > 8:
            raise ValueError("FrozenExecFused needs int8 activations (act_bit <= 7)")

    def _flush_int8(self, p: _PendingConv, lens, entry, bits: int) -> torch.Tensor:
        kw = dict(bias=p.entry.get("b"), relu=p.relu, m=entry["act_m"],
                  e=entry["act_e"], bits=bits)
        if p.depthwise:
            s = p.spec
            return dw_conv(p.xq, p.entry["wk"], stride=s.stride, padding=s.padding,
                           dilation=s.dilation, out_len=lens, **kw)
        return pw_gemm(p.xq, p.entry["wk"], lens=lens, **kw)

    def _flush_int32(self, p: _PendingConv) -> QTensor:
        kw = dict(bias=p.entry.get("b"), relu=p.relu)
        if p.depthwise:
            s = p.spec
            y = dw_conv(p.xq, p.entry["wk"], stride=s.stride, padding=s.padding,
                        dilation=s.dilation, **kw)
        else:
            y = pw_gemm(p.xq, p.entry["wk"], **kw)
        return QTensor(y, p.entry["out_scale"])

    def masked_conv(self, site, spec: ConvSpec, x, lens):
        bi, kind, i = site
        entry = self.t["blocks"][bi][kind][i]
        if not (is_depthwise(spec) or is_pointwise(spec)):
            raise NotImplementedError(f"conv {spec} is neither depthwise nor pointwise")
        bits = self._act_bits(spec)
        if isinstance(x, _PendingConv):
            xq = self._flush_int8(x, lens, entry, bits)
        else:
            xq = self._requant_in(entry, x, lens, bits)
        return _PendingConv(xq, entry, spec), conv_out_len(lens, spec)

    def activation(self, x, dropout: float):
        if isinstance(x, _PendingConv):
            x.relu = True
            return x
        return super().activation(x, dropout)

    def residual_add(self, block_idx: int, pane: int, out, res_out, mode: str):
        if mode not in ("add", "stride_add"):
            raise NotImplementedError(f"residual mode {mode!r}")
        if isinstance(res_out, _PendingConv):
            res_out = self._flush_int32(res_out)
        if isinstance(out, _PendingConv) and not out.depthwise and not out.relu:
            e = self.t["blocks"][block_idx]["res_act"][pane]
            q8 = pw_gemm(out.xq, out.entry["wk"], bias=out.entry.get("b"),
                         m=e["m"], e=e["e"], res=res_out.values, m_r=e["m_r"],
                         e_r=e["e_r"], bits=self.qcfg.act_bit)
            return QTensor(q8, e["scale"])
        if isinstance(out, _PendingConv):
            out = self._flush_int32(out)
        return super().residual_add(block_idx, pane, out, res_out, mode)

    def block_end(self, x):
        return self._flush_int32(x) if isinstance(x, _PendingConv) else x

    def decoder_parts(self, x: QTensor):
        q = self._decoder_input(x)  # block_end materialized the encoder output
        t = self.t["decoder"]
        return q, pw_gemm(q, t["wk"], bias=t["b"])
