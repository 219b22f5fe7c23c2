"""Conformer-CTC: the Conformer encoder with a linear CTC head, its
zero-shot quantization workflow and its frozen integer serving path (port
of qasr_tpu/models/conformer_ctc.py without training, checkpoints and the
LSTM head).

``ConformerCTC`` holds the host state (configs, numpy float params, the
calibrated range state, the frozen host tables).  ``quantize_encoder``
calibrates the ranges (on audio or features; its integer products on
Kernels 1 and 2), ``quantize_encoder_synthetic`` first synthesizes the
features from the BN statistics, ``freeze`` builds the integer tables.
``forward`` / ``transcribe_greedy`` dispatch as the JAX package does: the
frozen integer encoder when tables exist, else the calibrated PTQ forward
when ranges exist, else the float encoder.  ``make_conformer_frozen_fn``
is the frozen serving function: int16 or float32 PCM in, log-probs (or
greedy ids) and encoder lengths out.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.device import as_device, no_tf32
from qasr_tpu_torch.models.config import ModelConfig
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    _linear,
    conformer_encoder_apply,
    encoder_params_to_device,
    init_conformer_params,
)
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
    calibrate_conformer,
    conformer_encoder_apply_ptq,
    init_conformer_qstate,
    quantize_conformer_weights,
    quantize_linear,
)
from qasr_tpu_torch.quantize.conformer_synth import get_synthetic_conformer_data
from qasr_tpu_torch.quantize.ranges import params_to_device, qstate_to_device, qstate_to_host


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
class _OnDevice:
    """What one device holds for the model: the weights (by kind and weight
    bits), the range state as 0-d tensors, ``freeze``'s tables and the
    serving functions built on them."""

    weights: Dict[Tuple[str, Optional[int]], Any] = dataclasses.field(default_factory=dict)
    qstate: Any = None
    tables: Any = None
    fns: Dict[Any, Any] = dataclasses.field(default_factory=dict)


@dataclass
class ConformerCTC:
    cfg: ModelConfig               # labels and preprocessor
    ccfg: ConformerConfig
    frontend: MelFrontend
    params: Dict[str, Any]         # {'encoder', 'decoder': {'w', 'b'}} numpy
    enc_qcfg: Any = None
    enc_qstate: Any = None         # encoder ranges + the head's 'dec_in' site
    enc_frozen: Any = None         # the host tables after freeze()
    _devices: Dict[str, _OnDevice] = dataclasses.field(default_factory=dict)
    # the params and range objects the device state and the tables were
    # built from
    _params_used: Tuple[Any, ...] = dataclasses.field(default=(), repr=False)
    _ranges_used: Tuple[Any, ...] = dataclasses.field(default=(), repr=False)

    def __post_init__(self):
        self._params_used = self._params_now()
        self._ranges_used = (self.enc_qcfg, self.enc_qstate)

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

    # -- device state ---------------------------------------------------------

    def _params_now(self) -> Tuple[Any, ...]:
        return self.params, self.params["encoder"], self.params["decoder"]

    def _check_state(self) -> None:
        """Replaced params (``params`` or its 'encoder' / 'decoder' entry,
        e.g. by ``estimate_bn_stats``'s result): the frozen tables and
        every device's state are stale (the ranges stay).  Replaced ranges
        (``enc_qstate`` or ``enc_qcfg`` assigned): ``_ranges_changed``."""
        now = self._params_now()
        if any(a is not b for a, b in zip(now, self._params_used)):
            self.enc_frozen = None
            self._devices.clear()
            self._params_used = now
        if any(a is not b for a, b in zip((self.enc_qcfg, self.enc_qstate), self._ranges_used)):
            self._ranges_changed()

    def _on(self, dev: torch.device) -> _OnDevice:
        self._check_state()
        return self._devices.setdefault(str(dev), _OnDevice())

    def _ranges_changed(self) -> None:
        """New ranges: the frozen tables and everything built from them or
        from the old ranges are stale (the device weights stay)."""
        self.enc_frozen = None
        for od in self._devices.values():
            od.qstate = od.tables = None
            od.fns.clear()
        self._ranges_used = (self.enc_qcfg, self.enc_qstate)

    def _weights(self, dev: torch.device, kind: str, wbit: Optional[int] = None):
        """The params on ``dev``, built once for the current params:
        "float" (encoder and head, float32) or "int8" (the PTQ forward's
        at ``wbit`` weight bits, ``quantize_conformer_weights``, and the
        quantized head)."""
        od = self._on(dev)
        if (kind, wbit) not in od.weights:
            if kind == "float":
                tree = {"encoder": encoder_params_to_device(self.params["encoder"], dev),
                        "decoder": params_to_device(self.params["decoder"], dev)}
            else:
                tree = {"encoder": quantize_conformer_weights(self.params["encoder"], self.ccfg,
                                                              wbit, dev),
                        "decoder": quantize_linear(self.params["decoder"], wbit, dev)}
            od.weights[(kind, wbit)] = tree
        return od.weights[(kind, wbit)]

    def _device_qstate(self, dev: torch.device):
        od = self._on(dev)
        if od.qstate is None:
            od.qstate = qstate_to_device(self.enc_qstate, dev)
        return od.qstate

    def _tables(self, dev: torch.device):
        od = self._on(dev)
        return od.tables if od.tables is not None else self.freeze(dev)

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
        self._ranges_changed()

    # -- calibration ---------------------------------------------------------

    def quantize_encoder(self, calib_batches, *, weight_bit: int = 8, act_bit: int = 8,
                         percentile: Optional[float] = None, dynamic: bool = False,
                         momentum: float = 0.95, quantize_attention: bool = False,
                         integer_softmax: bool = False, integer_layernorm: bool = False,
                         integer_activations: bool = False, static_attention: bool = False,
                         features: bool = False, device=None, kernels: bool = True) -> None:
        """Calibrate the encoder's activation ranges and the CTC head's
        input ('dec_in') on ``device`` (None: the CUDA device): each batch
        is (audio (B, L) int16 / float32 PCM, lengths), or with
        ``features`` (features (B, T, F), lengths), e.g. the synthesizer's.
        Later forwards run the PTQ path until ``freeze``.  The quantized
        weights go to the device once; ``kernels=False`` runs Kernels 1
        and 2's plain versions."""
        qcfg = ConformerQuantConfig(weight_bit=weight_bit, act_bit=act_bit,
                                    act_momentum=momentum, percentile=percentile,
                                    dynamic=dynamic, quantize_attention=quantize_attention,
                                    integer_softmax=integer_softmax,
                                    integer_layernorm=integer_layernorm,
                                    integer_activations=integer_activations,
                                    static_attention=static_attention)
        dev = as_device(device)
        qp = self._weights(dev, "int8", weight_bit)["encoder"]
        qstate = init_conformer_qstate(self.ccfg, qcfg)
        qstate["dec_in"] = {"x_min": np.zeros((), np.float32), "x_max": np.zeros((), np.float32)}

        def feature_batches():
            for x, lens in calib_batches:
                x = torch.as_tensor(x).to(dev)
                lens = torch.as_tensor(lens).to(dev, torch.int32)
                if features:
                    yield x.to(torch.float32), lens
                else:
                    yield self.frontend(_pcm_f32(x), lens, dither=0.0)

        qs = calibrate_conformer(qp, self.ccfg, qcfg, feature_batches(),
                                 qstate_to_device(qstate, dev), kernels=kernels)
        self.enc_qcfg, self.enc_qstate = qcfg, qstate_to_host(qs)
        self._ranges_changed()

    def quantize_encoder_synthetic(self, *, num_batch: int = 2, batch_size: int = 8,
                                   seqlen: int = 128, train_iter: int = 200, lr: float = 0.02,
                                   seed: int = 0, device=None, **quant_kwargs):
        """Zero-shot quantization: synthesize calibration features from the
        encoder's BN statistics (``get_synthetic_conformer_data``) and
        calibrate on them, on ``device`` (None: the CUDA device).  Returns
        the synthesis's per-problem losses."""
        dev = as_device(device)
        batches, losses = get_synthetic_conformer_data(
            self.params["encoder"], self.ccfg, num_batch=num_batch, batch_size=batch_size,
            seqlen=seqlen, train_iter=train_iter, lr=lr, seed=seed, device=dev)
        self.quantize_encoder(batches, features=True, device=dev, **quant_kwargs)
        return losses

    # -- freeze and serve ----------------------------------------------------

    def freeze_host(self) -> Dict[str, Any]:
        """The encoder's frozen tables as host numpy (equal to the JAX
        package's ``freeze_conformer``) from the current ranges."""
        if self.enc_qstate is None:
            raise ValueError("calibrate first: quantize_encoder(...) with every integer flag "
                             "and static_attention=True, or qstate_from_json")
        return freeze_conformer(self.params["encoder"], self.ccfg, self.enc_qcfg,
                                self.enc_qstate)

    def freeze(self, device=None) -> Dict[str, Any]:
        """Freeze the encoder (host tables kept in ``enc_frozen``; forwards
        then serve the integer path) and return the tables and the
        quantized CTC head on ``device`` (None: the CUDA device, which must
        exist); serving reuses them on that device until the ranges
        change."""
        dev = as_device(device)
        od = self._on(dev)
        if self.enc_frozen is None:
            self.enc_frozen = self.freeze_host()
        head = dict(quantize_linear(self.params["decoder"], self.enc_qcfg.weight_bit, dev),
                    dec_in={k: torch.as_tensor(np.float32(v), device=dev)
                            for k, v in self.enc_qstate["dec_in"].items()})
        od.tables = {"encoder": conformer_tables_to_device(self.enc_frozen, dev), "head": head}
        od.fns.clear()
        return od.tables

    def head(self, tables, enc: torch.Tensor) -> torch.Tensor:
        """The frozen path's quantized CTC head: the 'dec_in' activation
        quant, an int8 product, the float epilogue, log-softmax."""
        h = tables["head"]
        eq, _ = _act_quant(h["dec_in"], enc, None, self.enc_qcfg, update=False)
        return torch.log_softmax(_qlinear(h, eq), dim=-1)

    def mode(self) -> str:
        """What ``forward`` runs: "frozen" (tables), "ptq" (ranges) or
        "float".  Replacing the params or the ranges drops the frozen
        tables."""
        self._check_state()
        if self.enc_frozen is not None:
            return "frozen"
        return "ptq" if self.enc_qstate is not None else "float"

    @torch.no_grad()
    def encode_decode(self, feats: torch.Tensor, feat_lens: torch.Tensor, kernels: bool = True,
                      plan: ConformerPlan = DEFAULT_PLAN):
        """Float features (B, T, F) -> (log-probs (B, T', V+1), encoder
        lengths) in ``mode()``: the frozen integer encoder (tables on the
        features' device; ``kernels``: those ``plan`` names), the PTQ
        forward with its head quantized at 'dec_in' (``kernels``: Kernels 1
        and 2), or the float encoder."""
        dev = feats.device
        mode = self.mode()
        if mode == "frozen":
            return frozen_log_probs(self, self._tables(dev), feats, feat_lens, kernels, plan)
        if mode == "float":
            p = self._weights(dev, "float")
            enc, el = conformer_encoder_apply(p["encoder"], self.ccfg, feats, feat_lens)
            with no_tf32():
                logits = enc @ p["decoder"]["w"] + p["decoder"]["b"]
        else:
            qp = self._weights(dev, "int8", self.enc_qcfg.weight_bit)
            qs = self._device_qstate(dev)
            enc, el, _ = conformer_encoder_apply_ptq(qp["encoder"], self.ccfg, self.enc_qcfg,
                                                     qs, feats, feat_lens, kernels=kernels)
            eq, _ = _act_quant(qs["dec_in"], enc, None, self.enc_qcfg)
            logits = _qlinear(qp["decoder"], eq, kernels)
        return torch.log_softmax(logits, dim=-1), el

    def forward(self, audio, alens, device=None, plan: ConformerPlan = DEFAULT_PLAN,
                kernels: bool = True):
        """(log-probs (B, T', V+1), encoder lengths) of a padded int16 /
        float32 PCM batch on ``device`` (None: the CUDA device), in
        ``mode()``: frozen through the kernels that ``plan`` names
        (default: every integer sublayer), PTQ through Kernels 1 and 2, or
        float; ``kernels=False``: the plain versions."""
        if self.mode() == "frozen":
            return self._serving_fn(device, argmax=False, plan=plan, kernels=kernels)(audio,
                                                                                     alens)
        dev = as_device(device)
        audio = torch.as_tensor(audio).to(dev)
        lens = torch.as_tensor(alens).to(device=dev, dtype=torch.int32)
        with torch.no_grad():
            feats, feat_lens = self.frontend(_pcm_f32(audio), lens, dither=0.0)
        return self.encode_decode(feats, feat_lens, kernels=kernels)

    def transcribe_greedy(self, audio, alens, device=None,
                          plan: ConformerPlan = DEFAULT_PLAN, kernels: bool = True) -> List[str]:
        """Greedy CTC transcripts of a padded int16 / float32 PCM batch, in
        ``mode()`` (as ``forward``)."""
        if self.mode() == "frozen":
            ids, enc_lens = self._serving_fn(device, argmax=True, plan=plan,
                                             kernels=kernels)(audio, alens)
        else:
            lp, enc_lens = self.forward(audio, alens, device=device, kernels=kernels)
            ids = lp.argmax(dim=-1)
        return self.ids_to_text(ids, enc_lens)

    def ids_to_text(self, ids: torch.Tensor, enc_lens: torch.Tensor) -> List[str]:
        """Greedy CTC collapse of (B, T) ids within each sample's length."""
        return ctc_collapse(ids.cpu().numpy(), self.blank_id, self.vocabulary,
                            enc_lens.cpu().numpy())

    def _serving_fn(self, device, argmax: bool, plan: ConformerPlan, kernels: bool = True):
        dev = as_device(device)
        key = (argmax, plan, kernels)
        fns = self._on(dev).fns
        if key not in fns:
            tables = self._tables(dev)
            fns[key] = make_conformer_frozen_fn(self, tables, argmax=argmax, kernels=kernels,
                                                plan=plan)
        return fns[key]


def frozen_log_probs(model: ConformerCTC, tables, feats: torch.Tensor, feat_lens: torch.Tensor,
                     kernels: bool = True, plan: ConformerPlan = DEFAULT_PLAN):
    """Float features -> (log-probs, encoder lengths) on the frozen path:
    the subsampler and the one quantization (x8), the integer encoder, the
    quantized CTC head, log-softmax."""
    x8, sub_lens = conformer_x8(tables["encoder"], model.ccfg, feats, feat_lens)
    enc, enc_lens = conformer_encode(tables["encoder"], model.ccfg, x8, sub_lens,
                                     kernels=kernels, plan=plan)
    return model.head(tables, enc), enc_lens


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
        lp, enc_lens = frozen_log_probs(model, tables, feats, feat_lens, kernels, plan)
        return (lp.argmax(dim=-1) if argmax else lp), enc_lens

    return fn
