"""Greedy CTC collapse (a copy of qasr_tpu/decode/ctc.py's; the port
imports nothing of the JAX package).

``ctc_collapse`` reproduces NeMo's WER.ctc_decoder_predictions_tensor:
repeats collapse, blanks drop.  Predictions at or after a sample's valid
length are ignored, so padded batches do not leak pad-region ids.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def ctc_collapse(predictions: np.ndarray, blank_id: int, labels: Sequence[str],
                 lengths: Optional[np.ndarray] = None) -> List[str]:
    """Repeat-collapse + blank removal of (B, T) ids."""
    hyps: List[str] = []
    labels_map = dict(enumerate(labels))
    for i in range(predictions.shape[0]):
        seq = predictions[i]
        if lengths is not None:
            seq = seq[: int(lengths[i])]
        previous = blank_id
        out = []
        for p in seq:
            p = int(p)
            if (p != previous or previous == blank_id) and p != blank_id:
                out.append(labels_map[p])
            previous = p
        hyps.append("".join(out))
    return hyps
