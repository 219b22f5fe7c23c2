"""The CTC model (port of qasr_tpu/models/ctc_model.py): the zero-shot
quantization workflow and the frozen serving path.

``ASRModel`` holds the host state (config, plan, numpy float params, the
activation-range state, the quantization knobs).  Its workflow is the
reference's: ``set_quant_bit`` / ``set_percentile`` / ``set_quant_mode``,
``bn_folding``, ``calibrate`` (on synthetic features, audio or noise:
QuantExec with range updates, its convs in Kernels 1, 2 and 8), ``freeze``
into integer tables, and ``forward`` / ``transcribe`` in the model's mode:
fp32 (FloatExec), quant (QuantExec on static or, with ``set_dynamic``,
per-batch ranges) or frozen.  ``make_frozen_fn`` is the serving function:
int16 or float32 PCM in, greedy ids (or log-probs) and encoder lengths
out.  Entry points run on the CUDA device unless given ``device="cpu"``.

Checkpoints: ``from_pretrained`` (a ``.nemo`` path, a name found as
``$QASR_PRETRAINED_DIR/<name>.nemo``, or a model card's cached or fetched
file), ``save_to`` / ``restore_from`` (``.nemo``: NeMo's layout, float
params; ``.qasr``: config, params, ranges and the quantization knobs, a
folded model too), archive artifacts (a BPE model's tokenizer), and
``change_vocabulary``.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qasr_tpu_torch.data.audio import read_audio_pcm16
from qasr_tpu_torch.data.dataset import bucket_pad
from qasr_tpu_torch.decode.ctc import ctc_collapse
from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.config import PRESETS, ModelConfig, QuantConfig, config_to_dict
from qasr_tpu_torch.models.jasper import (
    EncoderPlan,
    FloatExec,
    QuantExec,
    build_encoder_plan,
    decoder_forward_float,
    decoder_forward_quant,
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
    FrozenExecKernels,
    freeze_model,
    log_probs,
    tables_all_static_e,
    tables_to_device,
)
from qasr_tpu_torch.quantize.ranges import params_to_device, qstate_to_device, qstate_to_host

log = logging.getLogger(__name__)


def _pcm_f32(audio: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1) (x * 2**-15, bit-exact with the wav
    reader's x / 32768); float input passes through."""
    if audio.dtype == torch.int16:
        return audio.to(torch.float32) * (2.0 ** -15)
    return audio.to(torch.float32)


def frozen_executor(tables, fused: bool = True):
    """The executor class for these tables: the plain FrozenExec when not
    ``fused``; else FrozenExecFused (every requant in a kernel's prologue
    or epilogue) for static-exponent tables, FrozenExecKernels (the
    requants next to a depthwise conv in Kernel 1, the rest in the requant
    kernel) for vector exponents ('per_channel')."""
    if not fused:
        return FrozenExec
    return FrozenExecFused if tables_all_static_e(tables) else FrozenExecKernels


def make_frozen_fn(model: "ASRModel", tables, argmax: bool = False,
                   fused: bool = True):
    """fn(audio (B, L), lens (B,)) -> (ids (B, T) | log-probs (B, T, V+1),
    enc_lens) on the frozen integer path, in the JAX package's (B, T, C)
    form: features padded to a multiple of 64 frames, so shapes equal the
    JAX make_frozen_fn's on the CPU.  ``fused`` runs the kernel executor
    that ``frozen_executor`` picks from the tables (their plain versions
    for CPU tensors), else the plain FrozenExec.  Inputs move to the
    tables' device."""
    device = tables["decoder"]["w"].device
    exec_cls = frozen_executor(tables, fused)

    @torch.no_grad()
    def fn(audio, lens):
        audio = torch.as_tensor(audio).to(device)
        lens = torch.as_tensor(lens).to(device=device, dtype=torch.int32)
        feats, feat_lens = model.frontend(_pcm_f32(audio), lens, dither=0.0)
        fx, enc, enc_lens = _encode(model, tables, feats, feat_lens, exec_cls)
        lp = log_probs(fx.decoder_logits(enc), tables["decoder"]["out_scale"])
        return (lp.argmax(dim=-1) if argmax else lp), enc_lens

    return fn


def _encode(model: "ASRModel", tables, feats, feat_lens, exec_cls):
    fx = exec_cls(tables, model.qcfg, activation=model.plan.activation)
    enc, enc_lens = encoder_forward(fx, model.plan, pad_frames_aligned(feats), feat_lens)
    return fx, enc, enc_lens


def frozen_forward(model: "ASRModel", tables, feats: torch.Tensor,
                   feat_lens: torch.Tensor, fused: bool = True, executor=None):
    """Float features (B, T, C) -> (decoder int8 input, int32 logits,
    enc_lens) through the frozen encoder and decoder; T is padded to a
    multiple of 64 first.  ``executor`` (a class) overrides the choice of
    ``frozen_executor(tables, fused)``.  The decoder's int8 input is
    computed for the record: on FrozenExecFused's serving path it exists
    only inside a kernel."""
    fx, enc, enc_lens = _encode(model, tables, feats, feat_lens,
                                executor or frozen_executor(tables, fused))
    return fx.decoder_input(enc), fx.decoder_logits(enc), enc_lens


@dataclass
class ASRModel:
    cfg: ModelConfig
    plan: EncoderPlan
    frontend: MelFrontend
    params: Dict[str, Any]          # {'encoder': ..., 'decoder': ...} numpy
    qstate: Dict[str, Any]
    qcfg: QuantConfig
    folded: bool = False
    # {archive name: local file}: packed into save_to's archives, resolved
    # again on restore (a BPE model's tokenizer.json)
    artifacts: Dict[str, str] = dataclasses.field(default_factory=dict)
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
    def from_pretrained(cls, name_or_path: str, seed: int = 0,
                        allow_random_weights: bool = False, refresh_cache: bool = False,
                        fetcher=None) -> "ASRModel":
        """A ``.nemo`` path; else ``$QASR_PRETRAINED_DIR/<name>.nemo``;
        else (unless ``allow_random_weights`` without a ``fetcher``) a
        model card's file from the md5-keyed cache, fetched on a miss only
        through ``fetcher`` or ``utils.cloud.set_default_fetcher`` (no
        network attempt otherwise).  A preset name that resolves to no file
        raises, unless ``allow_random_weights`` asks for the architecture
        with random weights from ``seed``."""
        if name_or_path.endswith(".nemo"):
            return cls._from_nemo(name_or_path)
        cache_dir = os.environ.get("QASR_PRETRAINED_DIR")
        if cache_dir:
            local = os.path.join(cache_dir, name_or_path + ".nemo")
            if os.path.exists(local):
                return cls._from_nemo(local)
        # a caller that asked for random weights is not held up by the cards
        # unless it passed a fetcher
        if fetcher is not None or not allow_random_weights:
            from qasr_tpu_torch.utils import cloud

            try:
                path = cloud.resolve_pretrained(name_or_path, refresh_cache=refresh_cache,
                                                fetcher=fetcher)
            except RuntimeError as e:       # not cached, and no fetcher or a failed fetch
                log.warning(f"pretrained checkpoint for {name_or_path!r} not found: {e}")
                path = None
            if path is not None:
                return cls._from_nemo(path)
        if name_or_path in PRESETS:
            if not allow_random_weights:
                raise FileNotFoundError(
                    f"no checkpoint for preset '{name_or_path}' (pass a .nemo path, set "
                    f"$QASR_PRETRAINED_DIR, or pass allow_random_weights=True for an "
                    f"architecture-only random-weight model)")
            return cls.from_config(PRESETS[name_or_path](), seed=seed)
        raise ValueError(f"unknown model: {name_or_path}")

    @classmethod
    def _from_nemo(cls, path: str) -> "ASRModel":
        from qasr_tpu_torch.compat.nemo_loader import load_nemo

        cfg, params, artifacts = load_nemo(path)
        plan = build_encoder_plan(cfg.encoder)
        model = cls(cfg=cfg, plan=plan,
                    frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                    params=params, qstate=init_qstate(plan), qcfg=QuantConfig(),
                    artifacts=artifacts)
        model._attach_tokenizer()
        return model

    def register_artifact(self, arcname: str, src_path: str) -> str:
        """Pack ``src_path`` as ``arcname`` into the archives ``save_to``
        writes."""
        self.artifacts[arcname] = src_path
        return arcname

    def _attach_tokenizer(self) -> None:
        """A config with a tokenizer section: resolve its model file
        against the artifacts and become the BPE model."""
        tok_cfg = self.cfg.tokenizer
        if not tok_cfg:
            return
        from qasr_tpu_torch.data.tokenizers import tokenizer_from_config
        from qasr_tpu_torch.models.ctc_bpe_model import EncDecCTCModelBPE

        tok_cfg = dict(tok_cfg)
        if tok_cfg.get("model_path") in self.artifacts:
            tok_cfg["model_path"] = self.artifacts[tok_cfg["model_path"]]
        self.__class__ = EncDecCTCModelBPE
        self.tokenizer = tokenizer_from_config(tok_cfg)

    def save_to(self, path: str) -> None:
        """A ``.nemo`` (NeMo's layout: config and float params; a folded
        model raises) or a ``.qasr`` (config, params, ranges, and the
        folding and quantization knobs), with the artifacts."""
        if path.endswith(".nemo"):
            if self.folded:
                raise ValueError(".nemo export requires unfolded params (save before "
                                 "bn_folding)")
            from qasr_tpu_torch.compat.nemo_loader import save_nemo

            save_nemo(path, config_to_dict(self.cfg), self.plan, self.params,
                      artifacts=self.artifacts)
            return
        from qasr_tpu_torch.utils.checkpoint import save_qasr

        meta = {"folded": self.folded, "qcfg": dataclasses.asdict(self.qcfg)}
        save_qasr(path, config_to_dict(self.cfg), self.params, self.qstate, meta=meta,
                  artifacts=self.artifacts)

    @classmethod
    def restore_from(cls, path: str) -> "ASRModel":
        """The model ``save_to`` wrote (either format); a folded ``.qasr``
        folds its template first, so the trees line up."""
        if path.endswith(".nemo"):
            return cls._from_nemo(path)
        from qasr_tpu_torch.utils.checkpoint import load_qasr, unflatten_into

        cfg_d, flat, artifacts = load_qasr(path)
        meta = cfg_d.pop("_qasr_meta", {}) or {}
        model = cls.from_config(ModelConfig.from_dict(cfg_d))
        model.artifacts = artifacts
        if meta.get("folded"):
            model.bn_folding()
        model.params = unflatten_into(model.params, flat, "params/")
        if any(k.startswith("qstate/") for k in flat):
            model.qstate = unflatten_into(model.qstate, flat, "qstate/")
        if meta.get("qcfg"):
            model.qcfg = QuantConfig(**meta["qcfg"])
        model._attach_tokenizer()
        return model

    @staticmethod
    def list_available_models():
        """The model cards: name, checkpoint file, published float WERs."""
        return [
            {"name": "QuartzNet15x5Base-En", "artifact": "QuartzNet15x5Base-En.nemo",
             "dev_clean_wer": 3.79, "dev_other_wer": 10.05},
            {"name": "QuartzNet5x5LS-En", "artifact": "QuartzNet5x5LS-En.nemo",
             "dev_clean_wer": 5.37, "dev_other_wer": 15.69},
            {"name": "QuartzNet15x5NR-En", "artifact": "QuartzNet15x5NR-En.nemo",
             "dev_clean_wer": 3.96, "dev_other_wer": 10.14},
            {"name": "Jasper10x5Dr-En", "artifact": "Jasper10x5Dr-En.nemo",
             "dev_clean_wer": 3.37, "dev_other_wer": 9.81},
            {"name": "MatchboxNet-3x1x64", "artifact": None,
             "task": "speech-commands classification"},
        ]

    def change_vocabulary(self, new_vocabulary: Sequence[str]) -> None:
        """A new label set: a new decoder head (drawn from seed 0, as the
        JAX package's), the encoder kept, the head's input range reset and
        every device state and serving function dropped."""
        if list(new_vocabulary) == list(self.vocabulary):
            return
        dec_cfg = replace(self.cfg.decoder, num_classes=len(new_vocabulary),
                          vocabulary=tuple(new_vocabulary))
        self.cfg = replace(self.cfg, decoder=dec_cfg, labels=tuple(new_vocabulary))
        self.params = dict(self.params,
                           decoder=init_decoder_params(np.random.default_rng(0), dec_cfg))
        self.qstate["decoder_act"] = {"x_min": np.zeros((), np.float32),
                                      "x_max": np.zeros((), np.float32)}
        self._drop_cached()

    @property
    def vocabulary(self) -> Sequence[str]:
        return self.cfg.decoder.vocabulary

    @property
    def blank_id(self) -> int:
        return len(self.vocabulary)

    # -- the workflow's knobs ---------------------------------------------

    def set_quant_bit(self, bit: int, mode: str = "all") -> None:
        if mode not in ("all", "weight", "act"):
            raise ValueError(mode)
        kw = {}
        if mode in ("all", "weight"):
            kw["weight_bit"] = bit
        if mode in ("all", "act"):
            kw["act_bit"] = bit
        self._set_qcfg(**kw)

    def set_quant_mode(self, mode: str) -> None:
        """'symmetric' (integer paths) or 'none' (fp32)."""
        self._set_qcfg(mode=mode)

    def set_percentile(self, percentile: Optional[float]) -> None:
        self._set_qcfg(percentile=percentile)

    def set_dynamic(self, dynamic: bool) -> None:
        self._set_qcfg(dynamic=dynamic)

    def _set_qcfg(self, **kw) -> None:
        self.qcfg = replace(self.qcfg, **kw)
        self._drop_cached(params=False)

    def _drop_cached(self, params: bool = True) -> None:
        """Forget the built serving functions, and with ``params`` the
        device params too."""
        for k in [k for k in self._fn_cache if params or k[0] != "params"]:
            del self._fn_cache[k]

    def bn_folding(self) -> None:
        if not self.folded:
            self.params = dict(self.params, encoder=fold_bn_encoder(self.params["encoder"]))
            self.folded = True
            self._drop_cached()

    def _device_state(self, dev: torch.device) -> Dict[str, Any]:
        key = ("params", str(dev))
        state = self._fn_cache.get(key)
        if state is None or state["src"] is not self.params:
            state = {"src": self.params, "tree": params_to_device(self.params, dev),
                     "qweights": {}}
            self._fn_cache[key] = state
        return state

    def device_params(self, device) -> Dict[str, Any]:
        """The float params as torch tensors on ``device``, uploaded once
        and kept while ``self.params`` is the same object."""
        return self._device_state(as_device(device))["tree"]

    def _quant_weights(self, dev: torch.device) -> Dict[Any, Any]:
        """QuantExec's per-site quantized weights at the current weight
        bits, kept across batches and forwards."""
        return self._device_state(dev)["qweights"].setdefault(self.qcfg.weight_bit, {})

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
        self._drop_cached(params=False)

    # -- forward paths -------------------------------------------------------

    def _quant_exec(self, qstate, dev, update_ranges: bool, kernels: bool) -> QuantExec:
        return QuantExec(self.device_params(dev)["encoder"], qstate, self.qcfg,
                         activation=self.plan.activation, update_ranges=update_ranges,
                         kernels=kernels, weights=self._quant_weights(dev))

    def encode_decode_fp32(self, feats: torch.Tensor, feat_lens: torch.Tensor):
        """Float features (B, T, C) -> (log-probs, enc_lens) in float32."""
        params = self.device_params(feats.device)
        ex = FloatExec(params["encoder"], activation=self.plan.activation)
        enc, enc_lens = encoder_forward(ex, self.plan, feats, feat_lens)
        return decoder_forward_float(params["decoder"], enc), enc_lens

    def encode_decode_quant(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                            qstate=None, update_ranges: bool = False,
                            kernels: bool = True):
        """Float features (B, T, C) -> (log-probs, enc_lens, the new range
        state) on QuantExec; ``qstate`` (None: the model's) is a range state
        on the features' device (``qstate_to_device``)."""
        dev = feats.device
        if qstate is None:
            qstate = qstate_to_device(self.qstate, dev)
        ex = self._quant_exec(qstate, dev, update_ranges, kernels)
        enc, enc_lens = encoder_forward(ex, self.plan, feats, feat_lens)
        return decoder_forward_quant(ex, self.device_params(dev)["decoder"], enc), \
            enc_lens, ex.new_qstate

    def _frozen_fn(self, dyadic_mode: str, dev: torch.device, argmax: bool):
        """The cached serving function for the current tables, on the
        kernel executor ``frozen_executor`` picks for them (W8A8's 9-bit
        codes of post-ReLU values ride the kernels as uint8)."""
        key = ("frozen", dyadic_mode, str(dev), self.qcfg, argmax)
        if key not in self._fn_cache:
            self._fn_cache[key] = make_frozen_fn(self, self.freeze(dyadic_mode, dev),
                                                 argmax=argmax)
        return self._fn_cache[key]

    def resolve_mode(self, mode: Optional[str] = None) -> str:
        """The forward's mode: fp32 when quantization is off (or the model
        is not BN-folded yet), else quant when dynamic, else frozen."""
        if mode is not None:
            return mode
        if self.qcfg.mode == "none":
            return "fp32"
        if not self.folded:
            log.warning("model not BN-folded; running the fp32 forward (call "
                        "bn_folding() and calibrate() for integer evaluation)")
            return "fp32"
        return "quant" if self.qcfg.dynamic else "frozen"

    @torch.no_grad()
    def forward(self, audio, lengths, mode: Optional[str] = None, device=None,
                dyadic_mode: str = "static_e", kernels: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(log-probs (B, T, V+1), encoded lengths, greedy ids) of audio
        (B, L) (int16 PCM, or float32 in [-1, 1)) on ``device`` (None: the
        CUDA device), in ``mode`` ('fp32', 'quant' or 'frozen'; None:
        ``resolve_mode``).  The frozen path uses ``dyadic_mode``'s tables;
        ``kernels=False`` runs QuantExec's convs in their plain versions."""
        dev = as_device(device)
        mode = self.resolve_mode(mode)
        audio = torch.as_tensor(audio).to(dev)
        lengths = torch.as_tensor(lengths).to(device=dev, dtype=torch.int32)
        if mode == "frozen":
            lp, enc_lens = self._frozen_fn(dyadic_mode, dev, argmax=False)(audio, lengths)
        else:
            feats, feat_lens = self.frontend(_pcm_f32(audio), lengths, dither=0.0)
            if mode == "fp32":
                lp, enc_lens = self.encode_decode_fp32(feats, feat_lens)
            elif mode == "quant":
                lp, enc_lens, _ = self.encode_decode_quant(feats, feat_lens, kernels=kernels)
            else:
                raise ValueError(f"unknown forward mode {mode!r}")
        return lp, enc_lens, lp.argmax(dim=-1)

    # -- calibration and freezing -------------------------------------------

    def _feature_batch(self, item, seqlen: Optional[int], dev):
        """A calibration item -> ((B, T, C) float32, lengths) on ``dev``."""
        x, lens = item if isinstance(item, tuple) else (item, None)
        x = torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor)
                            else x).to(dev, torch.float32)
        if x.shape[1] == self.plan.feat_in and x.shape[2] != self.plan.feat_in:
            x = x.transpose(1, 2).contiguous()  # reference (B, C, T) order
        if lens is None:
            t = x.shape[1] if seqlen is None else seqlen
            lens = torch.full((x.shape[0],), t, dtype=torch.int32, device=dev)
        return x, torch.as_tensor(lens).to(dev, torch.int32)

    @torch.no_grad()
    def calibrate(self, batches: Iterable[Any], seqlen: Optional[int] = None,
                  device=None, kernels: bool = True) -> None:
        """Update the activation ranges from feature batches on ``device``
        (None: the CUDA device): each item is a (B, T, C) or reference
        (B, C, T) array or tensor (order told by C == feat_in on axis 1), or
        a (features, lengths) pair.  The params stay on the device across
        batches; ``kernels=False`` runs the convs' plain versions."""
        if not self.folded:
            raise RuntimeError("call bn_folding() before calibrate()")
        dev = as_device(device)
        qstate = qstate_to_device(self.qstate, dev)
        for item in batches:
            x, lens = self._feature_batch(item, seqlen, dev)
            _, _, qstate = self.encode_decode_quant(x, lens, qstate, update_ranges=True,
                                                    kernels=kernels)
        self.qstate = qstate_to_host(qstate)
        self._drop_cached(params=False)

    def calibrate_on_audio(self, loader, max_batches: Optional[int] = None,
                           device=None) -> None:
        """Calibrate on waveform batches (audio (B, L), lengths, ...): each
        goes through the frontend on ``device`` first."""
        dev = as_device(device)

        def feats():
            for bi, batch in enumerate(loader):
                if max_batches is not None and bi >= max_batches:
                    return
                audio = torch.as_tensor(batch[0]).to(dev)
                lens = torch.as_tensor(batch[1]).to(dev, torch.int32)
                yield self.frontend(_pcm_f32(audio), lens, dither=0.0)
        self.calibrate(feats(), device=dev)

    def calibrate_on_noise(self, batches: int = 2, batch_size: int = 2,
                           seconds: float = 1.0, seed: int = 0, device=None) -> None:
        """Calibrate on seeded Gaussian noise audio (0.1 sigma; numpy's
        default_rng(seed), as the JAX package draws it)."""
        n = int(self.cfg.sample_rate * seconds)
        rng = np.random.default_rng(seed)
        loader = [(rng.normal(size=(batch_size, n)).astype(np.float32) * 0.1,
                   np.full((batch_size,), n, np.int32)) for _ in range(batches)]
        self.calibrate_on_audio(loader, device=device)

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

    # -- transcription ---------------------------------------------------------

    def transcribe(self, audio: List[Any], batch_size: int = 4, logprobs: bool = False,
                   device=None, dyadic_mode: str = "static_e") -> List[Any]:
        """Greedy transcripts (or, with ``logprobs``, each sample's
        (T, V+1) log-probs as numpy) of wav paths or 1-D int16 / float32 PCM
        arrays, ``batch_size`` at a time padded by ``bucket_pad``, through
        ``forward`` in the model's mode on ``device`` (None: the CUDA
        device); the frozen mode serves on the kernel path that
        ``dyadic_mode``'s tables select (``frozen_executor``)."""
        dev = as_device(device)
        hyps: List[Any] = []
        for i in range(0, len(audio), batch_size):
            sigs = [read_audio_pcm16(a, self.cfg.sample_rate) if isinstance(a, str)
                    else np.asarray(a) for a in audio[i:i + batch_size]]
            batch, lens = bucket_pad(sigs)
            lp, el, ids = self.forward(batch, lens, device=dev, dyadic_mode=dyadic_mode)
            if logprobs:
                lp, el = lp.cpu().numpy(), el.cpu().numpy()
                hyps.extend(lp[j, :int(el[j])] for j in range(len(sigs)))
            else:
                hyps.extend(self.ids_to_text(ids, el))
        return hyps

    def ids_to_text(self, ids: torch.Tensor, enc_lens: torch.Tensor) -> List[str]:
        """Greedy CTC collapse of (B, T) ids within each sample's length."""
        return ctc_collapse(ids.cpu().numpy(), self.blank_id, self.vocabulary,
                            enc_lens.cpu().numpy())
