"""Log-mel frontend in torch (port of qasr_tpu/ops/features.py).

dither (off at inference) -> preemphasis -> STFT (torch.stft framing:
reflect padding, periodic=False window zero-padded to n_fft) -> |.|^2 ->
slaney mel -> log(x + guard) -> per-feature normalization over valid
frames (Bessel's correction) -> zero the padded tail -> pad T to pad_to.

This is the float region in front of the integer network.  TF32 is pinned
off for it: a lower-precision mel projection flips first-site int8 codes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qasr_tpu_torch.device import no_tf32

LOG_GUARD = 2.0 ** -24
STD_GUARD = 1e-5


def hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    safe = np.maximum(f, 1e-10)
    return np.where(f >= min_log_hz, min_log_mel + np.log(safe / min_log_hz) / logstep, mels)


def mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int = 16000, n_fft: int = 512, n_mels: int = 64,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular slaney-normalized filterbank."""
    fmax = fmax or sample_rate / 2.0
    n_freqs = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel_slaney(fmin), hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)


def make_window(kind: str, win_length: int, n_fft: int) -> np.ndarray:
    """torch.{hann,hamming,blackman,bartlett}_window(periodic=False),
    zero-padded centered to n_fft; 'none' is a rectangular window."""
    n = np.arange(win_length, dtype=np.float64)
    theta = 2.0 * np.pi * n / (win_length - 1)
    if kind == "hann":
        w = 0.5 - 0.5 * np.cos(theta)
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(theta)
    elif kind == "blackman":
        w = 0.42 - 0.5 * np.cos(theta) + 0.08 * np.cos(2.0 * theta)
    elif kind == "bartlett":
        w = 1.0 - np.abs(2.0 * n / (win_length - 1) - 1.0)
    elif kind in ("none", None, ""):
        w = np.ones(win_length, dtype=np.float64)
    else:
        raise ValueError(f"unsupported window: {kind!r}")
    pad_l = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float32)
    out[pad_l: pad_l + win_length] = w.astype(np.float32)
    return out


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, center: bool = True) -> torch.Tensor:
    """(B, L) -> (B, n_frames, n_fft), torch.stft framing."""
    if center:
        x = F.pad(x[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    return x.unfold(1, n_fft, hop)


def stft_power(x: torch.Tensor, window: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT|^2 -> (B, n_frames, n_fft//2 + 1)."""
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * window, dim=-1)
    return spec.real ** 2 + spec.imag ** 2


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """AudioToMelSpectrogramPreprocessor's schema (same fields and defaults
    as the JAX package's FeatureConfig, minus its TPU-only stft_matmul)."""

    sample_rate: int = 16000
    window_size: float = 0.02
    window_stride: float = 0.01
    window: str = "hann"
    normalize: str = "per_feature"
    n_fft: int = 512
    preemph: float = 0.97
    features: int = 64
    lowfreq: float = 0.0
    highfreq: Optional[float] = None
    log: bool = True
    log_zero_guard_type: str = "add"
    log_zero_guard_value: float = LOG_GUARD
    dither: float = 1e-5
    pad_to: int = 16
    pad_value: float = 0.0
    mag_power: float = 2.0
    frame_splicing: int = 1
    max_duration: float = 16.7

    @property
    def win_length(self) -> int:
        return int(self.window_size * self.sample_rate)

    @property
    def hop_length(self) -> int:
        return int(self.window_stride * self.sample_rate)


_PREPROCESSOR_KEYS = (
    "features", "sample_rate", "window_size", "window_stride", "window",
    "normalize", "n_fft", "preemph", "dither", "pad_to", "pad_value",
    "mag_power", "lowfreq", "highfreq", "log", "frame_splicing",
    "max_duration", "log_zero_guard_type", "log_zero_guard_value")


def preprocessor_config_from_dict(d: dict) -> FeatureConfig:
    """NeMo preprocessor YAML keys -> the port's FeatureConfig (the JAX
    package's mapper builds its own, jax-importing, FeatureConfig)."""
    return FeatureConfig(**{k: d[k] for k in _PREPROCESSOR_KEYS
                            if k in d and d[k] is not None})


class MelFrontend:
    """Log-mel features; ``__call__(x (B, L) f32, lengths (B,))`` returns
    ((B, T, n_mels) f32, (B,) int32) with T padded to ``pad_to``."""

    def __init__(self, cfg: FeatureConfig):
        self.cfg = cfg
        if cfg.normalize != "per_feature":
            raise NotImplementedError(f"normalize={cfg.normalize!r} is not ported")
        if cfg.pad_to == "max" or cfg.frame_splicing != 1 or cfg.mag_power != 2.0 \
                or not cfg.log or cfg.log_zero_guard_type != "add":
            raise NotImplementedError("only the QuartzNet frontend options are ported "
                                      "(numeric pad_to, mag_power 2, log add-guard)")
        if isinstance(cfg.log_zero_guard_value, str):
            raise NotImplementedError("string log_zero_guard_value is not ported")
        self.log_guard = float(cfg.log_zero_guard_value)
        self.window = torch.from_numpy(make_window(cfg.window, cfg.win_length, cfg.n_fft))
        self.fb = torch.from_numpy(mel_filterbank(
            cfg.sample_rate, cfg.n_fft, cfg.features, cfg.lowfreq, cfg.highfreq))

    def out_length(self, lengths: torch.Tensor) -> torch.Tensor:
        return torch.ceil(lengths.to(torch.float32) / self.cfg.hop_length).to(torch.int32)

    def __call__(self, x: torch.Tensor, lengths: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 dither: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        seq_len = self.out_length(lengths)
        d = cfg.dither if dither is None else dither
        if d > 0 and generator is not None:
            x = x + d * torch.randn(x.shape, generator=generator, device=x.device)
        if cfg.preemph is not None and cfg.preemph > 0:
            x = torch.cat([x[:, :1], x[:, 1:] - cfg.preemph * x[:, :-1]], dim=1)
        with no_tf32():
            p = stft_power(x, self.window.to(x.device), cfg.n_fft, cfg.hop_length)
            mel = torch.matmul(p, self.fb.to(x.device))
        mel = torch.log(mel + self.log_guard)
        t = mel.shape[1]
        mask = torch.arange(t, device=x.device)[None, :] < seq_len[:, None]
        mel = _normalize_per_feature(mel, mask, seq_len)
        mel = torch.where(mask[:, :, None], mel, torch.full((), cfg.pad_value, device=x.device))
        if cfg.pad_to and t % cfg.pad_to:
            mel = F.pad(mel, (0, 0, 0, cfg.pad_to - t % cfg.pad_to), value=cfg.pad_value)
        return mel, seq_len


def _normalize_per_feature(x: torch.Tensor, mask: torch.Tensor,
                           seq_len: torch.Tensor) -> torch.Tensor:
    """(x - mean)/(std + 1e-5) per (sample, feature) over valid frames;
    std with Bessel's correction like torch.std."""
    m = mask[:, :, None].to(x.dtype)
    cnt = seq_len.to(x.dtype)[:, None, None]
    mean = torch.sum(x * m, dim=1, keepdim=True) / cnt
    var = torch.sum(torch.square(x - mean) * m, dim=1, keepdim=True) / (cnt - 1.0)
    return (x - mean) / (torch.sqrt(var) + STD_GUARD)
