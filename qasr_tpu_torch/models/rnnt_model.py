"""The transducer ASR model's serving path and training loss (port of
qasr_tpu/models/rnnt_model.py without QAT).

``RNNTModel`` composes the mel frontend, an encoder (a Jasper / QuartzNet
block stack in float32, or a Conformer) and the transducer head of
``models/rnnt.py``.  The Conformer encoder calibrates
(``quantize_encoder``: ``quantize/conformer_ptq.py``) and freezes
(``freeze_encoder``: ``quantize/conformer_freeze.py``) as the CTC model's
does; ``freeze_decoder`` makes the prediction network and the joint
integer (``quantize/rnnt_freeze.py``, Kernel 9 on the card).  ``encode``
dispatches as the JAX package does: the frozen integer encoder (Kernels
3-6) when frozen, else the PTQ forward when calibrated, else float.
Greedy decoding runs the frozen integer decoder when ``freeze_decoder``
has run, else the float one; beam search is float.  ``save_to`` /
``restore_from`` read and write the JAX package's ``.qasr`` layout
(family "rnnt").

Params and ranges are host numpy, as in the JAX package; what a device
needs (float weights, int8 weights, ranges, frozen tables) is built there
once and rebuilt when the host object it came from is replaced.  Entry
points given ``device=None`` run on the CUDA device or raise; the tests
pass ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.config import ModelConfig, config_to_dict
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    conformer_encoder_apply,
    encoder_params_to_device,
    encoder_params_view,
    init_conformer_params,
)
from qasr_tpu_torch.models.ctc_model import _pcm_f32
from qasr_tpu_torch.models.jasper import (
    FloatExec,
    build_encoder_plan,
    encoder_forward,
    init_encoder_params,
)
from qasr_tpu_torch.models.rnnt import (
    RNNTConfig,
    beam_decode_one,
    greedy_decode,
    init_rnnt_params,
    joint_logits,
    pred_outputs,
    rnnt_loss_from_logits,
)
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.ops.spec_augment import spec_augment
from qasr_tpu_torch.quantize.conformer_freeze import (
    conformer_tables_to_device,
    freeze_conformer,
    frozen_conformer_apply,
)
from qasr_tpu_torch.quantize.conformer_ptq import (
    ConformerQuantConfig,
    calibrate_conformer,
    conformer_encoder_apply_ptq,
    init_conformer_qstate,
    quantize_conformer_weights,
)
from qasr_tpu_torch.quantize.ranges import params_to_device, qstate_to_device, qstate_to_host
from qasr_tpu_torch.quantize.rnnt_freeze import (
    calibrate_decoder_ranges,
    freeze_rnnt_decoder,
    greedy_decode_frozen,
    rnnt_tables_to_device,
)


def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@dataclass
class RNNTModel:
    cfg: ModelConfig
    rnnt_cfg: RNNTConfig
    plan: Any                      # EncoderPlan or ConformerConfig
    frontend: MelFrontend
    params: Dict[str, Any]         # {'encoder', 'rnnt'} numpy
    encoder_kind: str = "jasper"   # 'jasper' | 'conformer'
    enc_qcfg: Any = None           # ConformerQuantConfig after quantize_encoder
    enc_qstate: Any = None         # calibrated ranges (host numpy)
    enc_frozen: Any = None         # the encoder's host tables after freeze_encoder
    dec_frozen: Any = None         # the decoder's host tables after freeze_decoder
    # (device, kind) -> (the host objects it was built from, the built value)
    _devices: Dict[Tuple[str, str], Any] = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_config(cls, cfg: ModelConfig, rnnt_cfg: Optional[RNNTConfig] = None,
                    seed: int = 0) -> "RNNTModel":
        """A Jasper-family encoder (float) and the transducer head, random
        weights from ``seed``, equal to the JAX package's."""
        plan = build_encoder_plan(cfg.encoder)
        rng = np.random.default_rng(seed)
        if rnnt_cfg is None:
            rnnt_cfg = RNNTConfig(num_classes=len(cfg.labels), enc_hidden=plan.feat_out)
        params = {"encoder": init_encoder_params(rng, plan),
                  "rnnt": init_rnnt_params(rng, rnnt_cfg)}
        return cls(cfg=cfg, rnnt_cfg=rnnt_cfg, plan=plan,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params=params)

    @classmethod
    def conformer_transducer(cls, cfg: ModelConfig, conformer_cfg,
                             rnnt_cfg: Optional[RNNTConfig] = None,
                             seed: int = 0) -> "RNNTModel":
        """A Conformer encoder and the transducer head (the encoder drawn
        first, then the head, as in the JAX package)."""
        rng = np.random.default_rng(seed)
        d_out = conformer_cfg.feat_out if conformer_cfg.feat_out > 0 else conformer_cfg.d_model
        if rnnt_cfg is None:
            rnnt_cfg = RNNTConfig(num_classes=len(cfg.labels), enc_hidden=d_out)
        params = {"encoder": init_conformer_params(rng, conformer_cfg),
                  "rnnt": init_rnnt_params(rng, rnnt_cfg)}
        return cls(cfg=cfg, rnnt_cfg=rnnt_cfg, plan=conformer_cfg,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params=params, encoder_kind="conformer")

    @property
    def ccfg(self):
        """The Conformer encoder's config (the streamers read its receptive
        field); None for a Jasper-family encoder."""
        return self.plan if self.encoder_kind == "conformer" else None

    # -- device state ---------------------------------------------------------

    def _cached(self, dev: torch.device, kind: str, sources: Tuple[Any, ...],
                build: Callable[[], Any]):
        """``build()`` for ``dev``, kept while every object of ``sources``
        is the one it was built from (identity: a replaced params leaf,
        range state or host table rebuilds it)."""
        key = (str(dev), kind)
        hit = self._devices.get(key)
        if hit is None or len(hit[0]) != len(sources) or any(
                a is not b for a, b in zip(hit[0], sources)):
            hit = self._devices[key] = (sources, build())
        return hit[1]

    def float_decoder(self, dev: torch.device):
        """The prediction network's and joint's float params on ``dev``."""
        p = self.params["rnnt"]
        return self._cached(dev, "dec_float", tuple(_leaves(p)),
                            lambda: params_to_device(p, dev))

    def decoder_tables(self, dev: torch.device):
        """The frozen decoder's tables on ``dev`` (``rnnt_tables_to_device``)."""
        if self.dec_frozen is None:
            raise ValueError("freeze_decoder first")
        return self._cached(dev, "dec_tables", (self.dec_frozen,),
                            lambda: rnnt_tables_to_device(self.dec_frozen, dev))

    def encoder_tables(self, dev: torch.device):
        """The frozen encoder's tables on ``dev``."""
        if self.enc_frozen is None:
            raise ValueError("freeze_encoder first")
        return self._cached(dev, "enc_tables", (self.enc_frozen,),
                            lambda: conformer_tables_to_device(self.enc_frozen, dev))

    def _enc_float(self, dev: torch.device):
        p = self.params["encoder"]
        if self.encoder_kind == "conformer":
            return self._cached(dev, "enc_float", tuple(_leaves(p)),
                                lambda: encoder_params_to_device(p, dev))
        return self._cached(dev, "enc_float", tuple(_leaves(p)),
                            lambda: params_to_device(p, dev))

    def _enc_ptq(self, dev: torch.device):
        """(int8 weights at the calibrated weight bits, the ranges) on ``dev``."""
        p, wbit = self.params["encoder"], self.enc_qcfg.weight_bit
        qp = self._cached(dev, f"enc_int8_{wbit}", tuple(_leaves(p)),
                          lambda: quantize_conformer_weights(p, self.plan, wbit, dev))
        qs = self._cached(dev, "enc_qstate", (self.enc_qstate,),
                          lambda: qstate_to_device(self.enc_qstate, dev))
        return qp, qs

    # -- calibrate and freeze -------------------------------------------------

    def quantize_encoder(self, calib_batches, *, weight_bit: int = 8, act_bit: int = 8,
                         percentile: Optional[float] = None, dynamic: bool = False,
                         momentum: float = 0.95, quantize_attention: bool = False,
                         integer_softmax: bool = False, integer_layernorm: bool = False,
                         integer_activations: bool = False, static_attention: bool = False,
                         features: bool = False, device=None) -> None:
        """Calibrate the Conformer encoder's ranges on ``device`` (None: the
        CUDA device) over (audio, lengths) batches, or with ``features``
        (features (B, T, F), lengths), its integer products on Kernels 1
        and 2; ``encode`` then runs the PTQ forward (and drops frozen
        encoder tables).  The Jasper family does not
        quantize here (its CTC model does)."""
        if self.encoder_kind != "conformer":
            raise ValueError("quantize_encoder is the Conformer PTQ path; the "
                             "Jasper/QuartzNet family quantizes through ASRModel")
        qcfg = ConformerQuantConfig(weight_bit=weight_bit, act_bit=act_bit,
                                    act_momentum=momentum, percentile=percentile,
                                    dynamic=dynamic, quantize_attention=quantize_attention,
                                    integer_softmax=integer_softmax,
                                    integer_layernorm=integer_layernorm,
                                    integer_activations=integer_activations,
                                    static_attention=static_attention)
        dev = as_device(device)
        p = self.params["encoder"]
        qp = self._cached(dev, f"enc_int8_{weight_bit}", tuple(_leaves(p)),
                          lambda: quantize_conformer_weights(p, self.plan, weight_bit, dev))

        def feature_batches():
            for x, lens in calib_batches:
                x = torch.as_tensor(x).to(dev)
                lens = torch.as_tensor(lens).to(dev, torch.int32)
                if features:
                    yield x.to(torch.float32), lens
                else:
                    yield self.frontend(_pcm_f32(x), lens, dither=0.0)

        qs = calibrate_conformer(qp, self.plan, qcfg, feature_batches(),
                                 qstate_to_device(init_conformer_qstate(self.plan, qcfg), dev))
        self.enc_qstate, self.enc_qcfg = qstate_to_host(qs), qcfg
        self.enc_frozen = None   # stale tables

    def freeze_encoder(self):
        """The Conformer encoder's frozen integer tables (host numpy, equal to
        the JAX package's); ``encode`` then runs the integer encoder."""
        if self.encoder_kind != "conformer" or self.enc_qstate is None:
            raise ValueError("calibrate a Conformer encoder first (quantize_encoder with "
                             "every integer flag and static_attention=True)")
        self.enc_frozen = freeze_conformer(self.params["encoder"], self.plan, self.enc_qcfg,
                                           self.enc_qstate)
        return self.enc_frozen

    def freeze_decoder(self, calib_batches, weight_bit: int = 8, device=None):
        """Freeze the prediction network and the joint to integers
        (``quantize/rnnt_freeze.py``): their two ranges from a float greedy
        pass over (audio, lengths) batches on ``device`` (None: the CUDA
        device).  Returns the host tables."""
        enc_range, joint_range = calibrate_decoder_ranges(self, calib_batches, device=device)
        self.dec_frozen = freeze_rnnt_decoder(self.params["rnnt"], self.rnnt_cfg,
                                              enc_range=enc_range, joint_range=joint_range,
                                              weight_bit=weight_bit)
        return self.dec_frozen

    # -- encode and decode ----------------------------------------------------

    @torch.no_grad()
    def _encode(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """Float features -> (encodings (B, T', D) float32, lengths) on the
        features' device: frozen (Kernels 3-6), then PTQ (Kernels 1-2),
        then float, as the JAX package's ``_encode``."""
        dev = feats.device
        if self.encoder_kind == "conformer":
            if self.enc_frozen is not None:
                return frozen_conformer_apply(self.encoder_tables(dev), self.plan, feats,
                                              feat_lens)
            if self.enc_qstate is not None:
                qp, qs = self._enc_ptq(dev)
                enc, lens, _ = conformer_encoder_apply_ptq(qp, self.plan, self.enc_qcfg, qs,
                                                           feats, feat_lens)
                return enc, lens
            return conformer_encoder_apply(self._enc_float(dev), self.plan, feats, feat_lens)
        ex = FloatExec(self._enc_float(dev), activation=self.plan.activation)
        return encoder_forward(ex, self.plan, feats, feat_lens)

    # -- training -------------------------------------------------------------

    def loss_from_features(self, params, feats: torch.Tensor, feat_lens: torch.Tensor,
                           targets: torch.Tensor, tlens: torch.Tensor, *,
                           generator: Optional[torch.Generator] = None, spec_aug=None,
                           reduction: str = "mean_batch") -> torch.Tensor:
        """The RNNT loss of float features (B, T, F) through the float
        encoder, the prediction network and the joint, differentiable in
        ``params`` (torch leaves in the host layout); the loss in Kernel 10
        from the joint's logits on CUDA.  With a ``generator``: ``spec_aug`` and the encoder's
        dropout drawn from it."""
        train = generator is not None
        if spec_aug is not None and train:
            feats = spec_augment(feats, spec_aug, generator)
        if self.encoder_kind == "conformer":
            enc, enc_lens = conformer_encoder_apply(encoder_params_view(params["encoder"]),
                                                    self.plan, feats, feat_lens, train=train,
                                                    generator=generator)
        else:
            ex = FloatExec(params["encoder"], activation=self.plan.activation, train=train,
                           generator=generator)
            enc, enc_lens = encoder_forward(ex, self.plan, feats, feat_lens)
        pred = pred_outputs(params["rnnt"], self.rnnt_cfg, targets)
        logits = joint_logits(params["rnnt"], self.rnnt_cfg, enc, pred)
        return rnnt_loss_from_logits(logits, targets, enc_lens, tlens, self.rnnt_cfg.blank_id,
                                     reduction)

    def loss_fn(self, params, audio, alens, targets, tlens, *,
                generator: Optional[torch.Generator] = None, spec_aug=None, qat=None):
        """The RNNT loss of a padded float32 PCM batch for (B, U) targets:
        the frontend (dithered when a ``generator`` is given), then
        ``loss_from_features``; the float training loss (the JAX package's
        eval-mode loss of a calibrated encoder is not ported)."""
        if qat is not None:
            raise NotImplementedError("qat=: Conformer QAT is not ported (ROADMAP queue A "
                                      "item 8, QAT)")
        feats, feat_lens = self.frontend(_pcm_f32(audio), alens, generator=generator)
        return self.loss_from_features(params, feats, feat_lens, targets, tlens,
                                       generator=generator, spec_aug=spec_aug)

    @torch.no_grad()
    def encode(self, audio, alens, device=None):
        """A padded int16 / float32 PCM batch -> (encodings (B, T', D)
        float32, lengths (B,) int32) on ``device`` (None: the CUDA device)."""
        dev = as_device(device)
        audio = torch.as_tensor(audio).to(dev)
        lens = torch.as_tensor(alens).to(device=dev, dtype=torch.int32)
        feats, feat_lens = self.frontend(_pcm_f32(audio), lens, dither=0.0)
        return self._encode(feats, feat_lens)

    def _greedy_hyps(self, enc: torch.Tensor, enc_lens,
                     stats: Optional[Dict[str, int]] = None) -> List[List[int]]:
        """Greedy ids on the encodings' device: the frozen integer decoder
        (Kernel 9) when ``freeze_decoder`` has run, else the float one."""
        dev = enc.device
        if self.dec_frozen is not None:
            return greedy_decode_frozen(self.decoder_tables(dev), self.rnnt_cfg, enc, enc_lens,
                                        stats=stats)
        return greedy_decode(self.float_decoder(dev), self.rnnt_cfg, enc, enc_lens)

    def _text(self, ids) -> str:
        labels = list(self.cfg.labels)
        return "".join(labels[int(i)] for i in ids)

    def transcribe_greedy(self, audio, alens, device=None) -> List[str]:
        enc, enc_lens = self.encode(audio, alens, device=device)
        return [self._text(h) for h in self._greedy_hyps(enc, enc_lens)]

    def transcribe_beam(self, audio, alens, beam_size: int = 4, search_type: str = "beam",
                        device=None, **beam_kwargs) -> List[str]:
        """The best beam-search transcript of each sample (float decoder):
        search_type in {'beam', 'tsd', 'alsd'}; beam_kwargs forward
        tsd_max_sym_exp / alsd_max_target_len / score_norm."""
        enc, enc_lens = self.encode(audio, alens, device=device)
        params = self.float_decoder(enc.device)
        lens = enc_lens.cpu().numpy()
        return [self._text(beam_decode_one(params, self.rnnt_cfg, enc[i, :int(lens[i])],
                                           beam_size, search_type=search_type, **beam_kwargs))
                for i in range(enc.shape[0])]

    # -- checkpoints ----------------------------------------------------------

    def save_to(self, path: str) -> None:
        """A ``.qasr`` in the JAX package's layout: the config, the params,
        the ranges when calibrated, and under '_qasr_meta' the family, the
        encoder's kind and config, the transducer config, the quantization
        config and the tokenizer artifact."""
        from qasr_tpu_torch.utils.checkpoint import save_qasr

        meta: Dict[str, Any] = {"family": "rnnt", "encoder_kind": self.encoder_kind,
                                "rnnt_cfg": dataclasses.asdict(self.rnnt_cfg)}
        if self.encoder_kind == "conformer":
            meta["conformer_cfg"] = dataclasses.asdict(self.plan)
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
    def restore_from(cls, path: str) -> "RNNTModel":
        """The model ``save_to`` (of either package) wrote: params, ranges
        and quantization config, tokenizer; frozen tables are rebuilt by
        ``freeze_encoder`` / ``freeze_decoder``."""
        from qasr_tpu_torch.utils.checkpoint import load_qasr, unflatten_into

        cfg_d, flat, artifacts = load_qasr(path)
        meta = cfg_d.pop("_qasr_meta", {}) or {}
        if meta.get("family") != "rnnt":
            raise ValueError(f"{path} is not a transducer checkpoint "
                             f"(family={meta.get('family')!r}); use the owning model "
                             f"class's restore_from")
        cfg = ModelConfig.from_dict(cfg_d)
        rnnt_cfg = RNNTConfig(**meta["rnnt_cfg"])
        if meta.get("encoder_kind") == "conformer":
            model = RNNTModel.conformer_transducer(cfg, ConformerConfig(**meta["conformer_cfg"]),
                                                   rnnt_cfg=rnnt_cfg)
        else:
            model = RNNTModel.from_config(cfg, rnnt_cfg=rnnt_cfg)
        model.params = unflatten_into(model.params, flat, "params/")
        if meta.get("enc_qcfg") and any(k.startswith("qstate/") for k in flat):
            model.enc_qcfg = ConformerQuantConfig(**meta["enc_qcfg"])
            model.enc_qstate = unflatten_into(init_conformer_qstate(model.plan, model.enc_qcfg),
                                              flat, "qstate/")
        if meta.get("tokenizer") and meta["tokenizer"] in artifacts:
            from qasr_tpu_torch.data.tokenizers import BPETokenizer

            model.__class__ = EncDecRNNTBPEModel
            model.tokenizer = BPETokenizer(artifacts[meta["tokenizer"]])
        return model


class EncDecRNNTBPEModel(RNNTModel):
    """A transducer with a subword tokenizer: the label space is the
    tokenizer's vocabulary and hypotheses detokenize through it."""

    tokenizer = None

    @classmethod
    def from_config_and_tokenizer(cls, cfg: ModelConfig, tokenizer,
                                  rnnt_cfg: Optional[RNNTConfig] = None,
                                  seed: int = 0) -> "EncDecRNNTBPEModel":
        vocab = tuple(tokenizer.vocab)
        cfg = dataclasses.replace(cfg, labels=vocab)
        if rnnt_cfg is None:
            rnnt_cfg = RNNTConfig(num_classes=len(vocab),
                                  enc_hidden=build_encoder_plan(cfg.encoder).feat_out)
        model = super().from_config(cfg, rnnt_cfg=rnnt_cfg, seed=seed)
        model.__class__ = cls
        model.tokenizer = tokenizer
        return model

    def _text(self, ids) -> str:
        return self.tokenizer.ids_to_text([int(i) for i in ids])
