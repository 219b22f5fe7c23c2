"""The Conformer's quantization config, range-state layout and the int8
building blocks the frozen model's CTC head uses (port of the serving
subset of qasr_tpu/quantize/conformer_ptq.py; calibration is not ported
yet, ranges come from the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.kernels.pw_gemm import int_matmul
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.ops.quant_prims import QTensor, quantize, symmetric_scale

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


def _weight_qparams(w: torch.Tensor, wbit: int, reduce_axes: Tuple[int, ...]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-out-channel symmetric weight quantization (out axis = last):
    (int8 weights, float32 scales)."""
    w = w.to(torch.float32)
    w_scale = symmetric_scale(torch.amin(w, dim=reduce_axes),
                              torch.amax(w, dim=reduce_axes), wbit)
    return quantize(w, w_scale, wbit).to(torch.int8), w_scale


def _act_quant(state, x_f: torch.Tensor, valid: Optional[torch.Tensor],
               qcfg: ConformerQuantConfig, update: bool = False) -> Tuple[QTensor, Any]:
    """Per-tensor symmetric activation quantization with the site's
    calibrated range (float32 scalars, host or device).  Only the frozen
    form (``update=False``, static ranges) is ported; ``valid`` does not
    enter it."""
    if update or qcfg.dynamic:
        raise NotImplementedError("range calibration is not ported")
    dev = x_f.device
    scale = symmetric_scale(torch.as_tensor(state["x_min"], dtype=torch.float32, device=dev),
                            torch.as_tensor(state["x_max"], dtype=torch.float32, device=dev),
                            qcfg.act_bit)
    return QTensor(quantize(x_f, scale, qcfg.act_bit).to(torch.int8), scale), state


def _qlinear(p, xq: QTensor) -> torch.Tensor:
    """int8 x int8 -> int32 product, float epilogue acc * (S_x * S_w) + b;
    ``p`` holds the weights quantized by ``_weight_qparams``:
    {"wt" (dout, din) int8, "w_scale" (dout,) float32, "b" float32}."""
    x = xq.values
    acc = int_matmul(x.reshape(-1, x.shape[-1]), p["wt"]).reshape(*x.shape[:-1], -1)
    return acc.to(torch.float32) * (xq.scale * p["w_scale"]) + p["b"]
