"""The LSTM CTC head (port of qasr_tpu/models/lstm_decoder.py): encoder
output (B, T, D) -> stacked, optionally bidirectional LSTM -> linear ->
log-softmax over the classes and the blank.

Host params are numpy, drawn in the JAX package's order, so a seed gives
the same arrays; the forward takes them as torch tensors
(``quantize.ranges.params_to_device``).  The cell is written out in plain
tensor ops as the JAX package's (gates in the order i, f, g, o; the
reverse direction scans from the last frame, padding included), in
float32 with TF32 off.  The head stays float on every path of the model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from qasr_tpu_torch.device import no_tf32


def init_lstm_decoder(rng: np.random.Generator, feat_in: int, num_classes: int,
                      hidden: int = 640, num_layers: int = 1,
                      bidirectional: bool = False) -> Dict[str, Any]:
    """{'lstm': [[{'wi' (din, 4H), 'wh' (H, 4H), 'b' (4H,)} per direction]
    per layer], 'w' (H*dirs, V+1), 'b' (V+1,)}, U(-1/sqrt(fan_in), ...)."""
    def lstm_params(din, h):
        s = 1.0 / np.sqrt(max(din, 1))
        return {"wi": rng.uniform(-s, s, (din, 4 * h)).astype(np.float32),
                "wh": rng.uniform(-s, s, (h, 4 * h)).astype(np.float32),
                "b": np.zeros((4 * h,), np.float32)}

    dirs = 2 if bidirectional else 1
    layers = []
    din = feat_in
    for _ in range(num_layers):
        layers.append([lstm_params(din, hidden) for _ in range(dirs)])
        din = hidden * dirs
    s = 1.0 / np.sqrt(din)
    return {"lstm": layers,
            "w": rng.uniform(-s, s, (din, num_classes + 1)).astype(np.float32),
            "b": np.zeros((num_classes + 1,), np.float32)}


def lstm_shape(params: Dict[str, Any]) -> Dict[str, Any]:
    """The head's hidden size, layers and directions, from its weights."""
    layer0 = params["lstm"][0]
    return {"hidden": int(np.asarray(layer0[0]["wh"]).shape[0]), "layers": len(params["lstm"]),
            "bidirectional": len(layer0) == 2}


def _run_lstm(p, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """(B, T, D) -> (B, T, H): the cell over T (from the end if
    ``reverse``), zero initial state."""
    b, t, _ = x.shape
    h = torch.zeros((b, p["wh"].shape[0]), dtype=torch.float32, device=x.device)
    c = h
    xw = x @ p["wi"]
    out = [None] * t
    for step in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = xw[:, step] + h @ p["wh"] + p["b"]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[step] = h
    return torch.stack(out, dim=1)


@torch.no_grad()
def lstm_decoder_forward(params: Dict[str, Any], enc: torch.Tensor) -> torch.Tensor:
    """enc (B, T, D) float32 -> log-probs (B, T, V+1); ``params`` as torch
    tensors on enc's device."""
    return lstm_decoder_log_probs(params, enc)


def lstm_decoder_log_probs(params: Dict[str, Any], enc: torch.Tensor) -> torch.Tensor:
    """``lstm_decoder_forward`` with gradients (the training path)."""
    with no_tf32():
        x = enc.to(torch.float32)
        for layer in params["lstm"]:
            outs = [_run_lstm(layer[0], x, reverse=False)]
            if len(layer) == 2:
                outs.append(_run_lstm(layer[1], x, reverse=True))
            x = torch.cat(outs, dim=-1) if len(outs) == 2 else outs[0]
        return torch.log_softmax(x @ params["w"] + params["b"], dim=-1)
