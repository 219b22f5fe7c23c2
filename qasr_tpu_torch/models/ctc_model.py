"""The CTC model's frozen serving path in torch (port of a subset of
qasr_tpu/models/ctc_model.py).

``ASRModel`` holds the host state (config, plan, numpy float params, the
activation-range state, quant bits) and freezes it into integer tables on
a torch device; ``make_frozen_fn`` is the serving function: int16 or
float32 PCM in, greedy ids (or log-probs) and encoder lengths out.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from qasr_tpu_torch.data.audio import read_audio_pcm16
from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.config import PRESETS, ModelConfig, QuantConfig
from qasr_tpu_torch.models.jasper import (
    EncoderPlan,
    build_encoder_plan,
    encoder_forward,
    fold_bn_encoder,
    init_decoder_params,
    init_encoder_params,
    init_qstate,
    pad_frames_aligned,
)
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.quantize.freeze import (
    FrozenExec,
    FrozenExecFused,
    freeze_model,
    log_probs,
    tables_to_device,
)


def _pcm_f32(audio: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1) (x * 2**-15, bit-exact with the wav
    reader's x / 32768); float input passes through."""
    if audio.dtype == torch.int16:
        return audio.to(torch.float32) * (2.0 ** -15)
    return audio.to(torch.float32)


def make_frozen_fn(model: "ASRModel", tables, argmax: bool = False,
                   fused: bool = True):
    """fn(audio (B, L), lens (B,)) -> (ids (B, T) | log-probs (B, T, V+1),
    enc_lens) on the frozen integer path, in the JAX package's (B, T, C)
    form: features padded to a multiple of 64 frames, so shapes equal the
    JAX make_frozen_fn's on the CPU.  ``fused`` runs FrozenExecFused (every
    conv in Kernel 1/2; their plain versions for CPU tensors), else the
    plain FrozenExec.  Inputs move to the tables' device."""
    device = tables["decoder"]["w"].device

    @torch.no_grad()
    def fn(audio, lens):
        audio = torch.as_tensor(audio).to(device)
        lens = torch.as_tensor(lens).to(device=device, dtype=torch.int32)
        feats, feat_lens = model.frontend(_pcm_f32(audio), lens, dither=0.0)
        _, logits, enc_lens = frozen_forward(model, tables, feats, feat_lens, fused)
        lp = log_probs(logits, tables["decoder"]["out_scale"])
        return (lp.argmax(dim=-1) if argmax else lp), enc_lens

    return fn


def frozen_forward(model: "ASRModel", tables, feats: torch.Tensor,
                   feat_lens: torch.Tensor, fused: bool = True):
    """Float features (B, T, C) -> (decoder int8 input, int32 logits,
    enc_lens) through the frozen encoder and decoder; T is padded to a
    multiple of 64 first."""
    exec_cls = FrozenExecFused if fused else FrozenExec
    fx = exec_cls(tables, model.qcfg, activation=model.plan.activation)
    enc, enc_lens = encoder_forward(fx, model.plan, pad_frames_aligned(feats), feat_lens)
    dec_in, logits = fx.decoder_parts(enc)
    return dec_in, logits, enc_lens


@dataclass
class ASRModel:
    cfg: ModelConfig
    plan: EncoderPlan
    frontend: MelFrontend
    params: Dict[str, Any]          # {'encoder': ..., 'decoder': ...} numpy
    qstate: Dict[str, Any]
    qcfg: QuantConfig
    folded: bool = False
    _fn_cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_config(cls, cfg: ModelConfig, seed: int = 0) -> "ASRModel":
        plan = build_encoder_plan(cfg.encoder)
        rng = np.random.default_rng(seed)
        params = {
            "encoder": init_encoder_params(rng, plan),
            "decoder": init_decoder_params(rng, cfg.decoder),
        }
        return cls(cfg=cfg, plan=plan,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params=params, qstate=init_qstate(plan), qcfg=QuantConfig())

    @classmethod
    def from_pretrained(cls, name: str, seed: int = 0,
                        allow_random_weights: bool = False) -> "ASRModel":
        """A preset by name, with random weights from ``seed``.  Checkpoint
        loading (.nemo) is not ported: without ``allow_random_weights`` this
        raises rather than hand back fabricated weights."""
        if name not in PRESETS:
            raise ValueError(f"unknown model: {name}")
        if not allow_random_weights:
            raise FileNotFoundError(
                f"no checkpoint loader in the port for '{name}'; pass "
                f"allow_random_weights=True for an architecture-only model")
        return cls.from_config(PRESETS[name](), seed=seed)

    @property
    def vocabulary(self) -> Sequence[str]:
        return self.cfg.decoder.vocabulary

    @property
    def blank_id(self) -> int:
        return len(self.vocabulary)

    def set_quant_bit(self, bit: int, mode: str = "all") -> None:
        if mode not in ("all", "weight", "act"):
            raise ValueError(mode)
        kw = {}
        if mode in ("all", "weight"):
            kw["weight_bit"] = bit
        if mode in ("all", "act"):
            kw["act_bit"] = bit
        self.qcfg = replace(self.qcfg, **kw)
        self._fn_cache.clear()

    def bn_folding(self) -> None:
        if not self.folded:
            self.params = dict(self.params, encoder=fold_bn_encoder(self.params["encoder"]))
            self.folded = True
            self._fn_cache.clear()

    def qstate_to_json(self) -> str:
        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            if isinstance(t, (list, tuple)):
                return [conv(v) for v in t]
            return float(np.asarray(t))
        return json.dumps(conv(self.qstate))

    def qstate_from_json(self, text: str) -> None:
        def conv(t):
            if isinstance(t, dict):
                return {k: conv(v) for k, v in t.items()}
            if isinstance(t, list):
                return [conv(v) for v in t]
            return np.float32(t)
        self.qstate = conv(json.loads(text))
        self._fn_cache.clear()

    def freeze_host(self, dyadic_mode: str = "static_e"):
        """The frozen tables as host numpy (identical to the JAX package's)."""
        if not self.folded:
            raise RuntimeError("call bn_folding() before freeze()")
        return freeze_model(self.plan, self.params["encoder"], self.params["decoder"],
                            self.qstate, self.qcfg, self.cfg.decoder,
                            dyadic_mode=dyadic_mode)

    def freeze(self, dyadic_mode: str = "static_e", device=None):
        """Frozen tables as torch tensors on ``device`` (None: the CUDA
        device, which must exist; pass "cpu" for the CPU)."""
        return tables_to_device(self.freeze_host(dyadic_mode), as_device(device))

    def transcribe(self, audio: List[Any], batch_size: int = 4, device=None,
                   dyadic_mode: str = "static_e") -> List[str]:
        """Greedy transcripts of wav paths or 1-D int16/float32 PCM arrays,
        padded into batches of ``batch_size``, on the fused frozen path, on
        ``device`` (None: the CUDA device)."""
        dev = as_device(device)
        key = (dyadic_mode, str(dev), self.qcfg)
        if key not in self._fn_cache:
            self._fn_cache[key] = make_frozen_fn(
                self, self.freeze(dyadic_mode, dev), argmax=True)
        fn = self._fn_cache[key]
        hyps: List[str] = []
        for i in range(0, len(audio), batch_size):
            sigs = [read_audio_pcm16(a, self.cfg.sample_rate) if isinstance(a, str)
                    else np.asarray(a) for a in audio[i:i + batch_size]]
            lens = np.asarray([len(s) for s in sigs], np.int32)
            batch = np.zeros((len(sigs), int(lens.max())), sigs[0].dtype)
            for j, s in enumerate(sigs):
                batch[j, :len(s)] = s
            hyps.extend(self.ids_to_text(*fn(torch.from_numpy(batch),
                                             torch.from_numpy(lens))))
        return hyps

    def ids_to_text(self, ids: torch.Tensor, enc_lens: torch.Tensor) -> List[str]:
        """Greedy CTC collapse of (B, T) ids within each sample's length."""
        return ctc_collapse(ids.cpu().numpy(), self.blank_id, self.vocabulary,
                            enc_lens.cpu().numpy())
