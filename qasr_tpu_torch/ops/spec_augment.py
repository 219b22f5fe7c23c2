"""Spectrogram augmentation at training time (port of
qasr_tpu/ops/spec_augment.py), split into a draw and an apply.

  - SpecAugment: ``freq_masks`` bands of width U[0, freq_width] and
    ``time_masks`` bands of width U[0, time_width], each starting at
    U[0, max(size - width, 1)), zeroed;
  - SpecCutout: ``rect_masks`` rectangles of rect_time x rect_freq, starting
    at U[0, max(T - rect_time, 1)) x U[0, max(C - rect_freq, 1)), zeroed.

``draw_masks`` draws the bands and rectangles from a ``torch.Generator``
(the JAX package draws from ``jax.random``, so the two streams differ;
``apply_masks`` takes masks from either).  Layout (B, T, C).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    freq_masks: int = 0
    time_masks: int = 0
    freq_width: int = 10
    time_width: int = 10
    rect_masks: int = 0
    rect_time: int = 5
    rect_freq: int = 20

    @classmethod
    def from_dict(cls, d: dict) -> "SpecAugmentConfig":
        d = dict(d)
        d.pop("_target_", None)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def _randint(generator, low: torch.Tensor, high, shape, device) -> torch.Tensor:
    """Integers in [low, high) elementwise (high a tensor or an int)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float64)
    return (low + torch.floor(u * (high - low))).to(torch.int64)


def _band_mask(generator, b: int, size: int, max_width: int, n_masks: int, device):
    """(B, size) bool, True where zeroed."""
    zero = torch.zeros((b, n_masks), dtype=torch.int64, device=device)
    widths = _randint(generator, zero, max_width + 1, (b, n_masks), device)
    starts = _randint(generator, zero, (size - widths).clamp_min(1), (b, n_masks), device)
    pos = torch.arange(size, device=device)[None, None, :]
    m = (pos >= starts[:, :, None]) & (pos < (starts + widths)[:, :, None])
    return m.any(dim=1)


def draw_masks(cfg: SpecAugmentConfig, b: int, t: int, c: int,
               generator: Optional[torch.Generator], device=None) -> Dict[str, torch.Tensor]:
    """The masks of one batch: {'freq': (B, C), 'time': (B, T), 'rect':
    (B, T, C)} bool, True where zeroed, each present when its count is > 0.
    ``device``: the generator's device (default the CPU)."""
    dev = torch.device(device) if device is not None else (
        generator.device if generator is not None else torch.device("cpu"))
    out = {}
    if cfg.freq_masks > 0:
        out["freq"] = _band_mask(generator, b, c, cfg.freq_width, cfg.freq_masks, dev)
    if cfg.time_masks > 0:
        out["time"] = _band_mask(generator, b, t, cfg.time_width, cfg.time_masks, dev)
    if cfg.rect_masks > 0:
        zero = torch.zeros((b, cfg.rect_masks), dtype=torch.int64, device=dev)
        ts = _randint(generator, zero, max(t - cfg.rect_time, 1), zero.shape, dev)
        fs = _randint(generator, zero, max(c - cfg.rect_freq, 1), zero.shape, dev)
        tpos = torch.arange(t, device=dev)[None, None, :]
        fpos = torch.arange(c, device=dev)[None, None, :]
        tin = (tpos >= ts[:, :, None]) & (tpos < ts[:, :, None] + cfg.rect_time)
        fin = (fpos >= fs[:, :, None]) & (fpos < fs[:, :, None] + cfg.rect_freq)
        out["rect"] = (tin[:, :, :, None] & fin[:, :, None, :]).any(dim=1)
    return out


def apply_masks(x: torch.Tensor, masks: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x (B, T, C) with the masked entries zeroed (in the JAX package's
    order: frequency bands, time bands, rectangles)."""
    if "freq" in masks:
        x = torch.where(masks["freq"][:, None, :].to(x.device), 0.0, x)
    if "time" in masks:
        x = torch.where(masks["time"][:, :, None].to(x.device), 0.0, x)
    if "rect" in masks:
        x = torch.where(masks["rect"].to(x.device), 0.0, x)
    return x


def spec_augment(x: torch.Tensor, cfg: SpecAugmentConfig,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Draw one batch's masks on x's device and apply them."""
    b, t, c = x.shape
    return apply_masks(x, draw_masks(cfg, b, t, c, generator, x.device))
