"""Conformer-CTC: the frozen integer Conformer encoder and its quantized
linear CTC head (port of the serving subset of
qasr_tpu/models/conformer_ctc.py).

``ConformerCTC`` holds the host state (configs, numpy float params, the
calibrated range state) and freezes it into integer tables on a torch
device; ``make_conformer_frozen_fn`` is the serving function: int16 or
float32 PCM in, log-probs (or greedy ids) and encoder lengths out.  Below
it: the mel frontend, the float subsampler and the one quantization onto
the pre_out site, the integer encoder, the int8 CTC head, log-softmax.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np
import torch

from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.config import ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig, _linear, init_conformer_params
from qasr_tpu_torch.models.ctc_model import _pcm_f32
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.quantize.conformer_freeze import (
    DEFAULT_PLAN,
    ConformerPlan,
    conformer_encode,
    conformer_tables_to_device,
    conformer_x8,
    freeze_conformer,
)
from qasr_tpu_torch.quantize.conformer_ptq import (
    ConformerQuantConfig,
    _act_quant,
    _qlinear,
    _weight_qparams,
)


def _tree_to_json(t):
    if isinstance(t, dict):
        return {k: _tree_to_json(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree_to_json(v) for v in t]
    return float(np.asarray(t))


def _tree_from_json(t):
    if isinstance(t, dict):
        return {k: _tree_from_json(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_from_json(v) for v in t]
    return np.float32(t)


@dataclass
class ConformerCTC:
    cfg: ModelConfig               # labels and preprocessor
    ccfg: ConformerConfig
    frontend: MelFrontend
    params: Dict[str, Any]         # {'encoder', 'decoder': {'w', 'b'}} numpy
    enc_qcfg: Any = None
    enc_qstate: Any = None         # encoder ranges + the head's 'dec_in' site
    _fn_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_config(cls, cfg: ModelConfig, ccfg: ConformerConfig,
                    seed: int = 0) -> "ConformerCTC":
        """Random weights from ``seed``, equal to the JAX package's (the
        CTC head d -> V+1 is drawn first, then the encoder)."""
        rng = np.random.default_rng(seed)
        d_out = ccfg.feat_out if ccfg.feat_out > 0 else ccfg.d_model
        dec = _linear(rng, d_out, len(cfg.labels) + 1)
        return cls(cfg=cfg, ccfg=ccfg,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params={"encoder": init_conformer_params(rng, ccfg), "decoder": dec})

    @property
    def vocabulary(self) -> List[str]:
        return list(self.cfg.labels)

    @property
    def blank_id(self) -> int:
        return len(self.cfg.labels)

    # -- range state ---------------------------------------------------------

    def qstate_to_json(self) -> str:
        """The calibrated quantization config and ranges as JSON (float32
        values written as exact decimals, so they load back bit for bit)."""
        return json.dumps({"qcfg": dataclasses.asdict(self.enc_qcfg),
                           "qstate": _tree_to_json(self.enc_qstate)})

    def qstate_from_json(self, text: str) -> None:
        d = json.loads(text)
        self.enc_qcfg = ConformerQuantConfig(**d["qcfg"])
        self.enc_qstate = _tree_from_json(d["qstate"])
        self._fn_cache.clear()

    # -- freeze and serve ----------------------------------------------------

    def freeze_host(self) -> Dict[str, Any]:
        """The encoder's frozen tables as host numpy (equal to the JAX
        package's ``freeze_conformer``)."""
        if self.enc_qstate is None:
            raise ValueError("no calibrated ranges: load them with qstate_from_json")
        return freeze_conformer(self.params["encoder"], self.ccfg, self.enc_qcfg,
                                self.enc_qstate)

    def freeze(self, device=None) -> Dict[str, Any]:
        """Frozen encoder tables and the quantized CTC head on ``device``
        (None: the CUDA device, which must exist); the serving entry points
        reuse them on that device until the ranges change."""
        dev = as_device(device)
        w_int8, w_scale = _weight_qparams(torch.from_numpy(
            np.asarray(self.params["decoder"]["w"], np.float32)), self.enc_qcfg.weight_bit, (0,))
        head = {"wt": w_int8.t().contiguous().to(dev), "w_scale": w_scale.to(dev),
                "b": torch.from_numpy(np.asarray(self.params["decoder"]["b"],
                                                 np.float32)).to(dev),
                "dec_in": {k: torch.as_tensor(np.float32(v), device=dev)
                           for k, v in self.enc_qstate["dec_in"].items()}}
        tables = {"encoder": conformer_tables_to_device(self.freeze_host(), dev), "head": head}
        self._fn_cache = {("tables", str(dev)): tables}
        return tables

    def head(self, tables, enc: torch.Tensor) -> torch.Tensor:
        """The quantized CTC head: the 'dec_in' activation quant, an int8
        product, the float epilogue, log-softmax."""
        h = tables["head"]
        eq, _ = _act_quant(h["dec_in"], enc, None, self.enc_qcfg, update=False)
        return torch.log_softmax(_qlinear(h, eq), dim=-1)

    def forward(self, audio, alens, device=None, plan: ConformerPlan = DEFAULT_PLAN):
        """(log-probs (B, T', V+1), encoder lengths) of a padded PCM batch
        on ``device`` (None: the CUDA device), through the kernels that
        ``plan`` names (default: every integer sublayer)."""
        return self._serving_fn(device, argmax=False, plan=plan)(audio, alens)

    def transcribe_greedy(self, audio, alens, device=None,
                          plan: ConformerPlan = DEFAULT_PLAN) -> List[str]:
        """Greedy CTC transcripts of a padded int16 / float32 PCM batch."""
        ids, enc_lens = self._serving_fn(device, argmax=True, plan=plan)(audio, alens)
        return ctc_collapse(ids.cpu().numpy(), self.blank_id, self.vocabulary,
                            enc_lens.cpu().numpy())

    def _serving_fn(self, device, argmax: bool, plan: ConformerPlan):
        dev = as_device(device)
        key = (str(dev), argmax, plan)
        if key not in self._fn_cache:
            tables = self._fn_cache.get(("tables", str(dev))) or self.freeze(dev)
            self._fn_cache[key] = make_conformer_frozen_fn(self, tables, argmax=argmax,
                                                           plan=plan)
        return self._fn_cache[key]


def make_conformer_frozen_fn(model: ConformerCTC, tables, argmax: bool = False,
                             kernels: bool = True, plan: ConformerPlan = DEFAULT_PLAN):
    """fn(audio (B, L), lens (B,)) -> (log-probs (B, T', V+1) | ids, enc_lens)
    on the frozen integer path: frontend -> subsampler -> x8 -> integer
    encoder -> quantized CTC head -> log-softmax.  ``kernels``: the encoder
    runs the kernels ``plan`` names (default ("1", True):
    Kernel 3 attention, Kernel 4 conv block, Kernel 6 FFN halves, Kernel 5
    every other linear); False: the plain compositions.  Inputs move to
    the tables' device."""
    device = tables["encoder"]["device"]

    @torch.no_grad()
    def fn(audio, lens):
        audio = torch.as_tensor(audio).to(device)
        lens = torch.as_tensor(lens).to(device=device, dtype=torch.int32)
        feats, feat_lens = model.frontend(_pcm_f32(audio), lens, dither=0.0)
        x8, sub_lens = conformer_x8(tables["encoder"], model.ccfg, feats, feat_lens)
        enc, enc_lens = conformer_encode(tables["encoder"], model.ccfg, x8, sub_lens,
                                         kernels=kernels, plan=plan)
        lp = model.head(tables, enc)
        return (lp.argmax(dim=-1) if argmax else lp), enc_lens

    return fn
