"""Greedy CTC decoding and WER (a copy of qasr_tpu/decode/ctc.py; the
port imports nothing of the JAX package).

``ctc_collapse`` reproduces NeMo's WER.ctc_decoder_predictions_tensor:
repeats collapse, blanks drop.  Predictions at or after a sample's valid
length are ignored, so padded batches do not leak pad-region ids.
``word_error_rate`` and the accumulating ``WER`` count word (or character)
edit distances over the reference's words.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def greedy_predictions(log_probs) -> np.ndarray:
    """argmax over the vocabulary axis: (B, T, V+1) -> (B, T)."""
    return np.argmax(np.asarray(log_probs), axis=-1)


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


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, a two-row O(len(a) len(b)) DP."""
    if len(a) < len(b):
        a, b = b, a
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def word_error_rate(hypotheses: List[str], references: List[str],
                    use_cer: bool = False) -> float:
    """Edit distance over reference length, summed over the pairs (inf
    when the references hold no words)."""
    if len(hypotheses) != len(references):
        raise ValueError(
            "In word error rate calculation, hypotheses and reference lists "
            f"must have the same number of elements. But I got: {len(hypotheses)} "
            f"and {len(references)} correspondingly")
    scores = words = 0
    for h, r in zip(hypotheses, references):
        h_list = list(h) if use_cer else h.split()
        r_list = list(r) if use_cer else r.split()
        words += len(r_list)
        scores += edit_distance(h_list, r_list)
    return 1.0 * scores / words if words != 0 else float("inf")


class WER:
    """Accumulating WER: greedy hypotheses from (B, T) ids against label-id
    targets, summed as edit-distance and word counters."""

    def __init__(self, vocabulary: Sequence[str], use_cer: bool = False):
        self.labels = list(vocabulary)
        self.blank_id = len(vocabulary)
        self.use_cer = use_cer
        self.scores = 0
        self.words = 0

    def update(self, predictions: np.ndarray, targets: np.ndarray,
               target_lengths: np.ndarray,
               pred_lengths: Optional[np.ndarray] = None) -> None:
        hyps = ctc_collapse(predictions, self.blank_id, self.labels, pred_lengths)
        for i, h in enumerate(hyps):
            ref = "".join(self.labels[int(c)] for c in targets[i][:int(target_lengths[i])])
            h_list = list(h) if self.use_cer else h.split()
            r_list = list(ref) if self.use_cer else ref.split()
            self.words += len(r_list)
            self.scores += edit_distance(h_list, r_list)

    def compute(self) -> float:
        return self.scores / self.words if self.words else float("inf")
