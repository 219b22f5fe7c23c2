"""Speech-label dataset for classification, speaker and VAD tasks (port of
qasr_tpu/data/audio_to_label.py).

A JSON-lines manifest {"audio_filepath", "duration", "label" | "command",
"offset"} gives (signal, label id) samples, with duration filters,
fixed-length slices for speaker / VAD training (``time_length``), and
sliding windows for VAD inference (``vad_windows``, ``shift_length``).
numpy only: the model moves batches to its device.
"""
from __future__ import annotations

import json
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from qasr_tpu_torch.data.audio import read_audio


def _repeat_pad(sig: np.ndarray, n: int) -> np.ndarray:
    """sig repeated to n samples (shorter input), or its first n."""
    reps = -(-n // max(len(sig), 1))
    return np.tile(sig, reps)[:n]


class AudioToSpeechLabelDataset:
    def __init__(self, manifest_filepath: str, labels: Sequence[str],
                 sample_rate: int = 16000, min_duration: Optional[float] = 0.1,
                 max_duration: Optional[float] = None, trim: bool = False,
                 time_length: Optional[float] = None,
                 shift_length: Optional[float] = None,
                 augmentor=None, keep_unknown_labels: bool = False):
        # keep_unknown_labels: inference manifests often carry dummy labels
        # (VAD's "infer"); such rows stay, with label -1, instead of dropping
        self.labels = list(labels)
        self.label2id = {lab: i for i, lab in enumerate(self.labels)}
        self.sample_rate = sample_rate
        self.trim = trim
        self.time_length = time_length
        self.shift_length = shift_length
        self.augmentor = augmentor
        self.items: List[dict] = []
        for p in manifest_filepath.split(","):
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    d = json.loads(line)
                    dur = float(d.get("duration", 0.0))
                    if min_duration and dur < min_duration:
                        continue
                    if max_duration and dur > max_duration:
                        continue
                    lid = self.label2id.get(str(d.get("label", d.get("command"))), -1)
                    if lid < 0 and not keep_unknown_labels:
                        continue
                    self.items.append({
                        "audio_file": d.get("audio_filepath") or d["audio_file"],
                        "offset": float(d.get("offset", 0.0)),
                        "duration": dur,
                        "label": lid,
                    })

    def __len__(self) -> int:
        return len(self.items)

    def _read(self, item) -> np.ndarray:
        return read_audio(item["audio_file"], self.sample_rate, offset=item["offset"],
                          duration=item["duration"] or None, trim=self.trim)

    def _signal(self, item) -> np.ndarray:
        sig = self._read(item)
        if self.augmentor is not None:
            sig = self.augmentor.perturb(sig, self.sample_rate)
        if self.time_length:
            # a fixed-length slice: center crop, or repeat-pad
            n = int(self.time_length * self.sample_rate)
            if len(sig) >= n:
                start = (len(sig) - n) // 2
                sig = sig[start:start + n]
            else:
                sig = _repeat_pad(sig, n)
        return np.asarray(sig, np.float32)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        item = self.items[i]
        return self._signal(item), item["label"]

    def vad_windows(self, i: int) -> Iterator[Tuple[np.ndarray, int]]:
        """Sliding windows of time_length seconds, shift_length apart, over
        one utterance (repeat-padded to one window when shorter)."""
        if not (self.time_length and self.shift_length):
            raise ValueError("vad_windows needs time_length and shift_length")
        item = self.items[i]
        sig = self._read(item)
        n = int(self.time_length * self.sample_rate)
        step = int(self.shift_length * self.sample_rate)
        if len(sig) < n:
            sig = _repeat_pad(sig, n)
        for start in range(0, max(len(sig) - n, 0) + 1, step):
            yield np.asarray(sig[start:start + n], np.float32), item["label"]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """(audio (B, Lmax), lens (B,), labels (B,)) batches, zero-padded."""
        order = np.arange(len(self.items))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(order), batch_size):
            sel = order[i:i + batch_size]
            sigs = [self[j][0] for j in sel]
            labels = np.asarray([self.items[j]["label"] for j in sel], np.int32)
            audio = np.zeros((len(sigs), max(len(s) for s in sigs)), np.float32)
            lens = np.zeros((len(sigs),), np.int32)
            for k, s in enumerate(sigs):
                audio[k, :len(s)] = s
                lens[k] = len(s)
            yield audio, lens, labels
