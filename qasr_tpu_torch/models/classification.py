"""Classification (MatchboxNet) and speaker-label (SpeakerNet) heads and
models (port of qasr_tpu/models/classification.py).

  * ``masked_time_pool`` / ``stats_pool``: time pooling over valid frames
    (avg / max; mean + std, the time-averaged Gram matrix, or both);
  * ``classification_decoder``: pooling -> linear -> logits;
  * ``speaker_decoder``: stats pooling -> [linear + BN + ReLU] embedding
    layers -> final linear, or the angular (L2-normalized) output;
  * ``cross_entropy_loss`` / ``angular_softmax_loss``: the training losses
    as forward functions;
  * ``EncDecClassificationModel`` / ``EncDecSpeakerLabelModel``: frontend
    + Jasper-family encoder (FloatExec) + head, ``.qasr`` archives through
    ``utils/checkpoint.py``.

Both models build a log-mel ``MelFrontend`` from the config's
preprocessor, as the JAX package's do (MatchboxNet's NeMo config names an
MFCC preprocessor; the port mirrors the JAX package, see ROADMAP queue
C).  They are float models, as in the JAX package: their convs are float32
``conv1d`` with TF32 off, and no Pallas kernel stands behind them there.
Entry points run on the CUDA device unless given ``device="cpu"``.
Layout: encoder outputs (B, T, C) channels-last.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import as_device, no_tf32
from qasr_tpu_torch.models.config import ModelConfig, config_to_dict
from qasr_tpu_torch.models.jasper import (
    EncoderPlan,
    FloatExec,
    build_encoder_plan,
    encoder_forward,
    init_encoder_params,
)
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.quantize.ranges import params_to_device


def _valid(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, T, 1) mask of the frames t < lens[b]."""
    return (torch.arange(x.shape[1], device=x.device)[None, :] < lens[:, None])[:, :, None]


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------


def masked_time_pool(x: torch.Tensor, lens: torch.Tensor, mode: str = "avg") -> torch.Tensor:
    """(B, T, C) -> (B, C), pooling only over valid frames."""
    mask = _valid(x, lens)
    if mode == "avg":
        return (torch.where(mask, x, torch.zeros((), device=x.device)).sum(dim=1)
                / lens[:, None].clamp_min(1).to(x.dtype))
    if mode == "max":
        return torch.where(mask, x, torch.full((), -math.inf, device=x.device)).amax(dim=1)
    raise ValueError(mode)


def stats_pool(x: torch.Tensor, lens: torch.Tensor, pool_mode: str = "xvector") -> torch.Tensor:
    """StatsPoolLayer: concat(mean, std) over valid frames (Bessel's
    correction); 'gram' the Gram matrix of the masked frames over the full
    T (the reference divides by T); 'superVector' both."""
    mask = _valid(x, lens)
    zero = torch.zeros((), device=x.device)
    cnt = lens[:, None].clamp_min(1).to(x.dtype)
    mean = torch.where(mask, x, zero).sum(dim=1) / cnt
    var = (torch.where(mask, torch.square(x - mean[:, None, :]), zero).sum(dim=1)
           / torch.clamp_min(cnt - 1.0, 1.0))
    pooled = torch.cat([mean, torch.sqrt(var)], dim=-1)
    if pool_mode == "xvector":
        return pooled
    xm = torch.where(mask, x, zero)
    with no_tf32():
        gram = torch.einsum("btc,btd->bcd", xm, xm) / x.shape[1]
    gram = gram.reshape(x.shape[0], -1)
    if pool_mode == "gram":
        return gram
    if pool_mode == "superVector":
        return torch.cat([pooled, gram], dim=-1)
    raise ValueError(pool_mode)


def stats_pool_feat_dim(feat_in: int, pool_mode: str) -> int:
    if pool_mode == "xvector":
        return 2 * feat_in
    if pool_mode == "gram":
        return feat_in * feat_in
    return feat_in * feat_in + 2 * feat_in   # superVector


# ---------------------------------------------------------------------------
# heads (host numpy init, the JAX package's draws)
# ---------------------------------------------------------------------------


def _linear_init(rng: np.random.Generator, din: int, dout: int) -> Dict[str, np.ndarray]:
    a = math.sqrt(6.0 / (din + dout))
    return {"w": rng.uniform(-a, a, (din, dout)).astype(np.float32),
            "b": np.zeros((dout,), np.float32)}


def _rng(seed) -> np.random.Generator:
    return seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)


def init_classification_decoder(seed, feat_in: int, num_classes: int):
    return {"linear": _linear_init(_rng(seed), feat_in, num_classes)}


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
    with no_tf32():
        y = torch.matmul(x, w)
    return y if b is None else y + b


def classification_decoder(params, enc: torch.Tensor, lens: torch.Tensor,
                           pooling: str = "avg", return_logits: bool = True) -> torch.Tensor:
    """ConvASRDecoderClassification: time pooling -> linear -> logits (or
    their softmax)."""
    logits = _linear(masked_time_pool(enc, lens, pooling), params["linear"]["w"],
                     params["linear"]["b"])
    return logits if return_logits else torch.softmax(logits, dim=-1)


def init_speaker_decoder(seed, feat_in: int, num_classes: int,
                         emb_sizes: Sequence[int] = (512, 512),
                         pool_mode: str = "xvector", angular: bool = False):
    rng = _rng(seed)
    din = stats_pool_feat_dim(feat_in, pool_mode)
    layers = []
    for size in emb_sizes:
        layers.append({
            "linear": _linear_init(rng, din, size),
            "bn": {"gamma": np.ones((size,), np.float32),
                   "beta": np.zeros((size,), np.float32),
                   "mean": np.zeros((size,), np.float32),
                   "var": np.ones((size,), np.float32)},
        })
        din = size
    final = _linear_init(rng, din, num_classes)
    if angular:
        final.pop("b")
    return {"emb_layers": layers, "final": final}


def speaker_decoder(params, enc: torch.Tensor, lens: torch.Tensor, *,
                    pool_mode: str = "xvector",
                    angular: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """SpeakerDecoder: (logits, embedding), the embedding being the last
    embedding layer's pre-BN linear output; ``angular``: logits are the
    cosines of the L2-normalized embedding and class weights."""
    pooled = stats_pool(enc, lens, pool_mode)
    emb = pooled
    for lp in params["emb_layers"]:
        lin = _linear(pooled, lp["linear"]["w"], lp["linear"]["b"])
        bn = lp["bn"]
        pooled = torch.relu((lin - bn["mean"]) / torch.sqrt(bn["var"] + 1e-5) * bn["gamma"]
                            + bn["beta"])
        emb = lin
    w = params["final"]["w"]
    if angular:
        w = w / torch.linalg.norm(w, dim=0, keepdim=True)
        pooled = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True)
        return _linear(pooled, w), emb
    return _linear(pooled, w, params["final"]["b"]), emb


def angular_softmax_loss(logits: torch.Tensor, labels: torch.Tensor, scale: float = 20.0,
                         margin: float = 1.35) -> torch.Tensor:
    """Additive-angular-margin cross entropy on cosine logits."""
    theta = torch.arccos(torch.clamp(logits, -1 + 1e-7, 1 - 1e-7))
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    marged = torch.cos(theta + margin * onehot)
    return -torch.mean(torch.sum(onehot * torch.log_softmax(scale * marged, dim=-1), dim=-1))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return -torch.mean(torch.sum(onehot * torch.log_softmax(logits, dim=-1), dim=-1))


# ---------------------------------------------------------------------------
# composed models
# ---------------------------------------------------------------------------


def _unflatten_params(template, flat):
    from qasr_tpu_torch.utils.checkpoint import unflatten_into

    return unflatten_into(template, flat, "params/")


class _OnDevice:
    """The float params on one device, rebuilt when ``params`` is replaced
    (a strong reference compared with ``is``) or the device changes."""

    def __init__(self):
        self.src = self.device = self.params = None

    def get(self, params, device: torch.device):
        if params is not self.src or device != self.device:
            self.params = params_to_device(params, device)
            self.src, self.device = params, device
        return self.params


def _encode(model, params, audio, alens, device):
    """Frontend -> FloatExec encoder on ``device``: (enc, enc_lens)."""
    audio = torch.as_tensor(audio).to(device=device, dtype=torch.float32)
    alens = torch.as_tensor(alens).to(device=device, dtype=torch.int32)
    feats, feat_lens = model.frontend(audio, alens, dither=0.0)
    ex = FloatExec(params["encoder"], activation=model.plan.activation)
    return encoder_forward(ex, model.plan, feats, feat_lens)


@dataclass
class EncDecClassificationModel:
    """MatchboxNet-style command / VAD classification."""

    cfg: ModelConfig
    plan: EncoderPlan
    frontend: MelFrontend
    params: Dict[str, Any]
    num_classes: int
    pooling: str = "avg"
    labels: Optional[Tuple[str, ...]] = None   # class names, checkpointed
    _dev: _OnDevice = field(default_factory=_OnDevice, repr=False)

    @classmethod
    def from_config(cls, cfg: ModelConfig, num_classes: int, seed: int = 0,
                    pooling: str = "avg", labels=None) -> "EncDecClassificationModel":
        plan = build_encoder_plan(cfg.encoder)
        rng = np.random.default_rng(seed)
        params = {"encoder": init_encoder_params(rng, plan),
                  "decoder": init_classification_decoder(rng, plan.feat_out, num_classes)}
        return cls(cfg=cfg, plan=plan,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params=params, num_classes=num_classes, pooling=pooling,
                   labels=tuple(labels) if labels else None)

    @torch.no_grad()
    def logits(self, audio, alens, device=None) -> torch.Tensor:
        """(B, num_classes) float32 logits of audio (B, L) float32 with
        lengths (B,), on ``device`` (None: the CUDA device)."""
        dev = as_device(device)
        params = self._dev.get(self.params, dev)
        enc, enc_lens = _encode(self, params, audio, alens, dev)
        return classification_decoder(params["decoder"], enc, enc_lens, self.pooling)

    def loss_fn(self, audio, alens, labels, device=None) -> torch.Tensor:
        return cross_entropy_loss(self.logits(audio, alens, device),
                                  torch.as_tensor(labels).to(as_device(device)))

    def predict(self, audio, alens, device=None) -> np.ndarray:
        return self.logits(audio, alens, device).argmax(dim=-1).cpu().numpy()

    def save_to(self, path: str) -> None:
        from qasr_tpu_torch.utils.checkpoint import save_qasr

        meta = {"model_type": "classification", "num_classes": self.num_classes,
                "pooling": self.pooling}
        if self.labels:
            meta["labels"] = list(self.labels)
        save_qasr(path, config_to_dict(self.cfg), self.params, meta=meta)

    @classmethod
    def restore_from(cls, path: str) -> "EncDecClassificationModel":
        """A ``.qasr`` this class or the JAX package's wrote."""
        from qasr_tpu_torch.utils.checkpoint import load_qasr

        cfg_d, flat, _ = load_qasr(path)
        meta = cfg_d.pop("_qasr_meta", {}) or {}
        if meta.get("model_type") != "classification":
            raise ValueError(f"{path} is not a classification checkpoint "
                             f"(model_type={meta.get('model_type')!r})")
        model = cls.from_config(ModelConfig.from_dict(cfg_d),
                                num_classes=int(meta["num_classes"]),
                                pooling=meta.get("pooling", "avg"), labels=meta.get("labels"))
        model.params = _unflatten_params(model.params, flat)
        return model


@dataclass
class EncDecSpeakerLabelModel:
    """SpeakerNet: verification embeddings and speaker-id logits."""

    cfg: ModelConfig
    plan: EncoderPlan
    frontend: MelFrontend
    params: Dict[str, Any]
    num_speakers: int
    angular: bool = False
    pool_mode: str = "xvector"
    _dev: _OnDevice = field(default_factory=_OnDevice, repr=False)

    @classmethod
    def from_config(cls, cfg: ModelConfig, num_speakers: int, seed: int = 0,
                    emb_sizes=(512, 512), pool_mode: str = "xvector",
                    angular: bool = False) -> "EncDecSpeakerLabelModel":
        plan = build_encoder_plan(cfg.encoder)
        rng = np.random.default_rng(seed)
        params = {"encoder": init_encoder_params(rng, plan),
                  "decoder": init_speaker_decoder(rng, plan.feat_out, num_speakers,
                                                  emb_sizes, pool_mode, angular)}
        return cls(cfg=cfg, plan=plan,
                   frontend=MelFrontend(preprocessor_config_from_dict(cfg.preprocessor)),
                   params=params, num_speakers=num_speakers, angular=angular,
                   pool_mode=pool_mode)

    @torch.no_grad()
    def forward(self, audio, alens, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits, embeddings) on ``device`` (None: the CUDA device)."""
        dev = as_device(device)
        params = self._dev.get(self.params, dev)
        enc, enc_lens = _encode(self, params, audio, alens, dev)
        return speaker_decoder(params["decoder"], enc, enc_lens, pool_mode=self.pool_mode,
                               angular=self.angular)

    def loss_fn(self, audio, alens, labels, device=None) -> torch.Tensor:
        logits, _ = self.forward(audio, alens, device)
        labels = torch.as_tensor(labels).to(logits.device)
        if self.angular:
            return angular_softmax_loss(logits, labels)
        return cross_entropy_loss(logits, labels)

    def embeddings(self, audio, alens, device=None) -> np.ndarray:
        _, emb = self.forward(audio, alens, device)
        return emb.cpu().numpy()

    def save_to(self, path: str) -> None:
        from qasr_tpu_torch.utils.checkpoint import save_qasr

        emb_sizes = [int(np.asarray(lp["linear"]["w"]).shape[-1])
                     for lp in self.params["decoder"]["emb_layers"]]
        meta = {"model_type": "speaker", "num_speakers": self.num_speakers,
                "pool_mode": self.pool_mode, "angular": self.angular,
                "emb_sizes": emb_sizes}
        save_qasr(path, config_to_dict(self.cfg), self.params, meta=meta)

    @classmethod
    def restore_from(cls, path: str) -> "EncDecSpeakerLabelModel":
        """A ``.qasr`` this class or the JAX package's wrote."""
        from qasr_tpu_torch.utils.checkpoint import load_qasr

        cfg_d, flat, _ = load_qasr(path)
        meta = cfg_d.pop("_qasr_meta", {}) or {}
        if meta.get("model_type") != "speaker":
            raise ValueError(f"{path} is not a speaker checkpoint "
                             f"(model_type={meta.get('model_type')!r})")
        model = cls.from_config(ModelConfig.from_dict(cfg_d),
                                num_speakers=int(meta["num_speakers"]),
                                emb_sizes=tuple(meta.get("emb_sizes", (512, 512))),
                                pool_mode=meta.get("pool_mode", "xvector"),
                                angular=bool(meta.get("angular", False)))
        model.params = _unflatten_params(model.params, flat)
        return model
