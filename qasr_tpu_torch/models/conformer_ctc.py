"""Conformer-CTC: the Conformer encoder with a linear or LSTM CTC head, its
zero-shot quantization workflow, its frozen integer serving path and its
checkpoints and its training loss (port of qasr_tpu/models/conformer_ctc.py
without QAT).

``ConformerCTC`` holds the host state (configs, numpy float params, the
calibrated range state, the frozen host tables).  ``quantize_encoder``
calibrates the ranges (on audio or features; its integer products on
Kernels 1 and 2), ``quantize_encoder_synthetic`` first synthesizes the
features from the BN statistics, ``freeze`` builds the integer tables.
``forward`` / ``transcribe_greedy`` / ``transcribe_beam`` dispatch as the
JAX package does: the frozen integer encoder when tables exist, else the
calibrated PTQ forward when ranges exist, else the float encoder; the
linear head is quantized at its 'dec_in' site on the first two, the LSTM
head stays float everywhere.  ``make_conformer_frozen_fn`` is the frozen
serving function: int16 or float32 PCM in, log-probs (or greedy ids) and
encoder lengths out.  ``save_to`` / ``restore_from`` write and read the
``.qasr`` archive (the JAX package's layout), ``conformer_ctc_from_yaml``
/ ``_from_dict`` build the model from NeMo's Conformer YAML.
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
from qasr_tpu_torch.models.config import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    config_to_dict,
    resolve_interpolations,
)
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    _linear,
    conformer_encoder_apply,
    encoder_params_to_device,
    encoder_params_view,
    init_conformer_params,
)
from qasr_tpu_torch.models.ctc_model import _pcm_f32
from qasr_tpu_torch.models.lstm_decoder import (
    init_lstm_decoder,
    lstm_decoder_forward,
    lstm_decoder_log_probs,
    lstm_shape,
)
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.ops.spec_augment import spec_augment
from qasr_tpu_torch.quantize.conformer_freeze import (
    DEFAULT_PLAN,
    ConformerPlan,
    conformer_tables_to_device,
    freeze_conformer,
    frozen_conformer_apply,
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
from qasr_tpu_torch.train.ctc_loss import ctc_loss


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
    params: Dict[str, Any]         # {'encoder', 'decoder'} numpy
    decoder_kind: str = "linear"   # 'linear' | 'lstm'
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
    def from_config(cls, cfg: ModelConfig, ccfg: ConformerConfig, seed: int = 0,
                    decoder_kind: str = "linear", lstm_hidden: int = 640, lstm_layers: int = 1,
                    bidirectional: bool = False) -> "ConformerCTC":
        """Random weights from ``seed``, equal to the JAX package's: the
        head first (a linear d -> V+1, or the LSTM head), then the
        encoder."""
        rng = np.random.default_rng(seed)
        d_out = ccfg.feat_out if ccfg.feat_out > 0 else ccfg.d_model
        if decoder_kind == "lstm":
            dec = init_lstm_decoder(rng, d_out, len(cfg.labels), hidden=lstm_hidden,
                                    num_layers=lstm_layers, bidirectional=bidirectional)
        elif decoder_kind == "linear":
            dec = _linear(rng, d_out, len(cfg.labels) + 1)
        else:
            raise ValueError(f"unknown decoder_kind {decoder_kind!r}")
        return cls(cfg=cfg, ccfg=ccfg,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params={"encoder": init_conformer_params(rng, ccfg), "decoder": dec},
                   decoder_kind=decoder_kind)

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
                        "decoder": self._head_weights(wbit, dev)}
            od.weights[(kind, wbit)] = tree
        return od.weights[(kind, wbit)]

    def _head_weights(self, wbit: int, dev: torch.device):
        """The integer paths' head on ``dev``: the linear one quantized at
        ``wbit``, the LSTM one float."""
        if self.decoder_kind == "lstm":
            return params_to_device(self.params["decoder"], dev)
        return quantize_linear(self.params["decoder"], wbit, dev)

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
        head = self._head_weights(self.enc_qcfg.weight_bit, dev)
        if self.decoder_kind == "linear":
            head["dec_in"] = {k: torch.as_tensor(np.float32(v), device=dev)
                              for k, v in self.enc_qstate["dec_in"].items()}
        od.tables = {"encoder": conformer_tables_to_device(self.enc_frozen, dev), "head": head}
        od.fns.clear()
        return od.tables

    def head(self, tables, enc: torch.Tensor) -> torch.Tensor:
        """The frozen path's CTC head: the linear one quantized (the
        'dec_in' activation quant, an int8 product, the float epilogue,
        log-softmax), the LSTM one float."""
        h = tables["head"]
        if self.decoder_kind == "lstm":
            return lstm_decoder_forward(h, enc)
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
            if self.decoder_kind == "lstm":
                return lstm_decoder_forward(p["decoder"], enc), el
            with no_tf32():
                logits = enc @ p["decoder"]["w"] + p["decoder"]["b"]
        else:
            qp = self._weights(dev, "int8", self.enc_qcfg.weight_bit)
            qs = self._device_qstate(dev)
            enc, el, _ = conformer_encoder_apply_ptq(qp["encoder"], self.ccfg, self.enc_qcfg,
                                                     qs, feats, feat_lens, kernels=kernels)
            if self.decoder_kind == "lstm":
                return lstm_decoder_forward(qp["decoder"], enc), el
            eq, _ = _act_quant(qs["dec_in"], enc, None, self.enc_qcfg)
            logits = _qlinear(qp["decoder"], eq, kernels)
        return torch.log_softmax(logits, dim=-1), el

    # -- training -------------------------------------------------------------

    def loss_from_features(self, params, feats: torch.Tensor, feat_lens: torch.Tensor,
                           targets: torch.Tensor, tlens: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None, spec_aug=None,
                           reduction: str = "mean_batch") -> torch.Tensor:
        """The CTC loss of float features (B, T, F) through the float
        encoder and head, differentiable in ``params`` (torch leaves in the
        host layout, e.g. a trainer's).  With a ``generator`` it is the
        training loss: ``spec_aug`` masks and the encoder's dropout drawn
        from it."""
        train = generator is not None
        if spec_aug is not None and train:
            feats = spec_augment(feats, spec_aug, generator)
        enc, el = conformer_encoder_apply(encoder_params_view(params["encoder"]), self.ccfg,
                                          feats, feat_lens, train=train, generator=generator)
        if self.decoder_kind == "lstm":
            lp = lstm_decoder_log_probs(params["decoder"], enc)
        else:
            with no_tf32():
                lp = torch.log_softmax(enc @ params["decoder"]["w"] + params["decoder"]["b"],
                                       dim=-1)
        return ctc_loss(lp, el, targets, tlens, self.blank_id, reduction)

    def loss_fn(self, params, audio, alens, targets, tlens, *,
                generator: Optional[torch.Generator] = None, spec_aug=None, qat=None):
        """The CTC loss of a padded float32 PCM batch (on ``params``'
        device) for (B, L) targets: the frontend (dithered when a
        ``generator`` is given), then ``loss_from_features``.  This is the
        float training loss; the JAX package's eval-mode loss of a
        calibrated model (its PTQ forward) is not ported."""
        if qat is not None:
            raise NotImplementedError("qat=: Conformer QAT is not ported (ROADMAP queue A "
                                      "item 8, QAT)")
        feats, feat_lens = self.frontend(_pcm_f32(audio), alens, generator=generator)
        return self.loss_from_features(params, feats, feat_lens, targets, tlens,
                                       generator=generator, spec_aug=spec_aug)

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
        """Greedy CTC collapse of (B, T) ids within each sample's length;
        a model with a tokenizer detokenizes the kept ids."""
        ids, lens = ids.cpu().numpy(), enc_lens.cpu().numpy()
        tok = getattr(self, "tokenizer", None)
        if tok is None:
            return ctc_collapse(ids, self.blank_id, self.vocabulary, lens)
        out = []
        for row, n in zip(ids, lens):
            kept, prev = [], -1
            for v in row[:int(n)]:
                if v != prev and v != self.blank_id:
                    kept.append(int(v))
                prev = v
            out.append(tok.ids_to_text(kept))
        return out

    def transcribe_beam(self, audio, alens, beam_width: int = 64, lm=None, device=None,
                        plan: ConformerPlan = DEFAULT_PLAN, kernels: bool = True,
                        **beam_kwargs) -> List[str]:
        """The best CTC prefix-beam-search transcript of each sample of a
        padded PCM batch, over ``forward``'s log-probs (in ``mode()``):
        ``lm`` is a ``BeamSearchDecoderWithLM`` (with its LM), else one of
        ``beam_width`` over the vocabulary and ``beam_kwargs``."""
        from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM

        lp, enc_lens = self.forward(audio, alens, device=device, plan=plan, kernels=kernels)
        dec = lm if lm is not None else BeamSearchDecoderWithLM(
            self.vocabulary, beam_width=beam_width, **beam_kwargs)
        return [hyps[0][1] if hyps else "" for hyps in dec(lp, enc_lens)]

    # -- checkpoints ------------------------------------------------------------

    def save_to(self, path: str) -> None:
        """A ``.qasr``: the config, the params, the ranges when calibrated,
        and under '_qasr_meta' the encoder's config, the head's kind and
        shape, the quantization config and the tokenizer artifact."""
        from qasr_tpu_torch.utils.checkpoint import save_qasr

        meta: Dict[str, Any] = {"family": "conformer_ctc",
                                "conformer_cfg": dataclasses.asdict(self.ccfg),
                                "decoder_kind": self.decoder_kind}
        if self.decoder_kind == "lstm":
            meta["lstm"] = lstm_shape(self.params["decoder"])
        if self.enc_qcfg is not None:
            meta["enc_qcfg"] = dataclasses.asdict(self.enc_qcfg)
        artifacts = {}
        tok = getattr(self, "tokenizer", None)
        if tok is not None and getattr(tok, "path", None):
            artifacts["tokenizer.json"] = tok.path
            meta["tokenizer"] = "tokenizer.json"
        save_qasr(path, config_to_dict(self.cfg), self.params, self.enc_qstate, meta=meta,
                  artifacts=artifacts)

    @classmethod
    def restore_from(cls, path: str) -> "ConformerCTC":
        """The model ``save_to`` (of either package) wrote: params, ranges
        and quantization config, head and tokenizer; it serves PTQ until
        ``freeze``."""
        from qasr_tpu_torch.data.tokenizers import BPETokenizer
        from qasr_tpu_torch.utils.checkpoint import load_qasr, unflatten_into

        cfg_d, flat, artifacts = load_qasr(path)
        meta = cfg_d.pop("_qasr_meta", {}) or {}
        if meta.get("family") != "conformer_ctc":
            raise ValueError(f"{path} is not a Conformer-CTC checkpoint "
                             f"(family={meta.get('family')!r})")
        lstm = meta.get("lstm") or {}
        model = cls.from_config(ModelConfig.from_dict(cfg_d),
                                ConformerConfig(**meta["conformer_cfg"]),
                                decoder_kind=meta.get("decoder_kind", "linear"),
                                lstm_hidden=lstm.get("hidden", 640),
                                lstm_layers=lstm.get("layers", 1),
                                bidirectional=lstm.get("bidirectional", False))
        model.params = unflatten_into(model.params, flat, "params/")
        if meta.get("enc_qcfg") and any(k.startswith("qstate/") for k in flat):
            qcfg = ConformerQuantConfig(**meta["enc_qcfg"])
            tmpl = init_conformer_qstate(model.ccfg, qcfg)
            tmpl["dec_in"] = {"x_min": np.zeros((), np.float32),
                              "x_max": np.zeros((), np.float32)}
            model.enc_qcfg, model.enc_qstate = qcfg, unflatten_into(tmpl, flat, "qstate/")
        if meta.get("tokenizer") in artifacts:
            model.tokenizer = BPETokenizer(artifacts[meta["tokenizer"]])
        return model

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
    enc, enc_lens = frozen_conformer_apply(tables["encoder"], model.ccfg, feats, feat_lens,
                                           kernels, plan)
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


# ---------------------------------------------------------------------------
# NeMo's Conformer YAML
# ---------------------------------------------------------------------------


def conformer_config_from_dict(d: Dict[str, Any]) -> ConformerConfig:
    """NeMo's ConformerEncoder section as a ConformerConfig (the same field
    names; an unknown field raises; subsampling_conv_channels -1 means
    d_model)."""
    d = dict(d)
    d.pop("_target_", None)
    unknown = set(d) - {f.name for f in dataclasses.fields(ConformerConfig)}
    if unknown:
        raise ValueError(f"unsupported ConformerEncoder fields: {unknown}")
    if d.get("subsampling_conv_channels") == -1:
        d["subsampling_conv_channels"] = d.get("d_model", 256)
    return ConformerConfig(**d)


def conformer_ctc_from_yaml(path: str, tokenizer=None, seed: int = 0) -> ConformerCTC:
    """A Conformer-CTC from NeMo's Conformer YAML (conformer_char.yaml,
    conformer_bpe.yaml, ...; ``${...}`` references resolved): a char
    config's labels from the YAML, a BPE config's from ``tokenizer``."""
    from qasr_tpu_torch.utils.yaml_io import safe_load

    with open(path, encoding="utf-8") as f:
        raw = safe_load(f)
    return conformer_ctc_from_dict(resolve_interpolations(raw)["model"], tokenizer=tokenizer,
                                   seed=seed)


def conformer_ctc_from_dict(m: Dict[str, Any], tokenizer=None, seed: int = 0) -> ConformerCTC:
    """The model section of a Conformer YAML as a ConformerCTC: an
    LSTMDecoder ``_target_`` gives the LSTM head (lstm_hidden_size,
    num_layers, bidirectional), any other the linear one."""
    if tokenizer is not None:
        labels = tuple(tokenizer.vocab)
    else:
        labels = tuple(m.get("labels") or ())
        if not labels:
            raise ValueError("config has no labels (a BPE config?): pass tokenizer=")
    ccfg = conformer_config_from_dict(m["encoder"])
    d_out = ccfg.feat_out if ccfg.feat_out > 0 else ccfg.d_model
    cfg = ModelConfig(encoder=EncoderConfig(feat_in=ccfg.feat_in, blocks=()),
                      decoder=DecoderConfig(feat_in=d_out, num_classes=len(labels),
                                            vocabulary=labels),
                      preprocessor=m.get("preprocessor", {}), spec_augment=m.get("spec_augment"),
                      labels=labels, sample_rate=m.get("sample_rate", 16000))
    dec = dict(m.get("decoder", {}))
    if "LSTMDecoder" in dec.get("_target_", ""):
        model = ConformerCTC.from_config(cfg, ccfg, seed=seed, decoder_kind="lstm",
                                         lstm_hidden=dec.get("lstm_hidden_size", 640),
                                         lstm_layers=dec.get("num_layers", 1),
                                         bidirectional=bool(dec.get("bidirectional", False)))
    else:
        model = ConformerCTC.from_config(cfg, ccfg, seed=seed)
    if tokenizer is not None:
        model.tokenizer = tokenizer
    return model
