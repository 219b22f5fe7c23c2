"""Data-free synthetic calibration data for the Conformer (port of
qasr_tpu/quantize/conformer_synth.py).

Each encoder layer's conv module holds one BatchNorm, so the
distillation signal is the n_layers pre-BN depthwise outputs: random
feature batches are optimized until their batch statistics there match
the BN running statistics under the Gaussian KL of ``quantize/synth.py``,
with its Adam and plateau schedule (``optimize_input``: one CUDA graph
replay an iteration on the card), forward and backward in float32 with
TF32 off.  ``estimate_bn_stats`` gives a model whose BN statistics carry
no data information new ones from feature batches, with the affine
compensation that leaves the float model's outputs unchanged.
"""
from __future__ import annotations

import copy
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.models.conformer import (
    ConformerConfig,
    conformer_encoder_apply,
    encoder_params_to_device,
)
from qasr_tpu_torch.quantize.synth import EPS, _kl_loss, optimize_input, start_points

BN_EPS = 1e-5  # the Conformer's BatchNorm epsilon


def conformer_bn_targets(params) -> Tuple[tuple, tuple]:
    """(running mean, sqrt(running var + 1e-6)) of every layer's BN, in
    layer order; params are torch tensors (``encoder_params_to_device``)."""
    means, stds = [], []
    for lp in params["layers"]:
        bn = lp["conv"]["bn"]
        means.append(bn["mean"])
        stds.append(torch.sqrt(bn["var"] + EPS))
    return tuple(means), tuple(stds)


def conformer_distill_loss(params, cfg: ConformerConfig, x: torch.Tensor,
                           lens: torch.Tensor, targets) -> torch.Tensor:
    """The sum over layers of the KL between the BN running statistics and
    the pad-masked batch statistics of x's pre-BN depthwise outputs."""
    stats: List = []
    conformer_encoder_apply(params, cfg, x, lens, bn_stats=stats)
    total = 0.0
    for (m, v), bm, bs in zip(stats, *targets):
        total = total + _kl_loss(bm, bs, m, torch.sqrt(v + EPS))
    return total


def synthesize_conformer_batch(params, cfg: ConformerConfig, x0: torch.Tensor, *,
                               train_iter: int, lr: float, targets
                               ) -> Tuple[torch.Tensor, List[float]]:
    """One distillation problem from the start point x0 (B, T, F), every
    frame valid: (the feature batch, the losses)."""
    lens = torch.full((x0.shape[0],), x0.shape[1], dtype=torch.int32, device=x0.device)
    return optimize_input(lambda x: conformer_distill_loss(params, cfg, x, lens, targets),
                          x0, train_iter=train_iter, lr=lr)


def get_synthetic_conformer_data(params, cfg: ConformerConfig, *, batch_size: int = 8,
                                 seqlen: int = 128, train_iter: int = 200,
                                 num_batch: int = 1, lr: float = 0.02, seed: int = 0,
                                 verbose: bool = False, device=None,
                                 x0: Optional[Sequence] = None):
    """``num_batch`` synthetic feature batches on ``device`` (None: the CUDA
    device) from the host encoder params: ([(features (B, T, F), lens)],
    per-problem loss lists), ready for ``quantize_encoder(...,
    features=True)``.  Start points are ``start_points(..., seed)``; ``x0``
    replaces them."""
    dev = as_device(device)
    tree = encoder_params_to_device(params, dev)
    targets = conformer_bn_targets(tree)
    starts = start_points(num_batch, batch_size, seqlen, cfg.feat_in, seed) if x0 is None else x0
    out, all_losses = [], []
    for i, start in enumerate(starts):
        t0 = time.perf_counter()
        if not isinstance(start, torch.Tensor):
            start = torch.from_numpy(np.array(start, np.float32))
        start = start.to(dev, torch.float32)
        x, losses = synthesize_conformer_batch(tree, cfg, start, train_iter=train_iter, lr=lr,
                                               targets=targets)
        out.append((x, torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=dev)))
        all_losses.append(losses)
        if verbose:
            print(f"conformer distillation: {i + 1} / {len(starts)} (final loss "
                  f"{losses[-1]:.4f}; {(time.perf_counter() - t0) / max(train_iter, 1) * 1e3:.1f}"
                  f" ms an iteration)", flush=True)
    return out, all_losses


@torch.no_grad()
def estimate_bn_stats(params, cfg: ConformerConfig, feat_batches, device=None):
    """New host params whose conv-module BN running statistics come from
    the (features, lens) batches, gamma / beta compensating so that BN(y)
    is the same transform:
      g' = g sqrt(v2 + eps) / sqrt(v + eps),  b' = b + g (m2 - m) / sqrt(v + eps).
    The statistics pool second moments over batches, v2 = E[v_i + m_i^2]
    - E[m_i]^2, in float32 on ``device`` (None: the CUDA device); the
    compensation in float64 on the host."""
    dev = as_device(device)
    tree = encoder_params_to_device(params, dev)
    acc_m: List = [None] * cfg.n_layers
    acc_v: List = [None] * cfg.n_layers
    n = 0
    for feats, lens in feat_batches:
        st: List = []
        conformer_encoder_apply(tree, cfg, torch.as_tensor(feats).to(dev, torch.float32),
                                torch.as_tensor(lens).to(dev, torch.int32), bn_stats=st)
        for i, (m, v) in enumerate(st):
            s2 = v + m * m
            acc_m[i] = m if acc_m[i] is None else acc_m[i] + m
            acc_v[i] = s2 if acc_v[i] is None else acc_v[i] + s2
        n += 1
    out = copy.deepcopy(params)
    for i in range(cfg.n_layers):
        bn = out["layers"][i]["conv"]["bn"]
        m1, v1, g1, b1 = (np.asarray(bn[k], np.float64) for k in ("mean", "var", "gamma", "beta"))
        m2 = acc_m[i].cpu().numpy().astype(np.float64) / n
        v2 = np.maximum(acc_v[i].cpu().numpy().astype(np.float64) / n - m2 * m2, 0.0)
        s1 = np.sqrt(v1 + BN_EPS)
        bn["mean"] = np.asarray(m2, np.float32)
        bn["var"] = np.asarray(v2, np.float32)
        bn["gamma"] = np.asarray(g1 * np.sqrt(v2 + BN_EPS) / s1, np.float32)
        bn["beta"] = np.asarray(b1 + g1 * (m2 - m1) / s1, np.float32)
    return out
