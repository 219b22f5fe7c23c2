"""Manifest-driven character dataset and batching (port of
qasr_tpu/data/dataset.py).

``read_manifest`` parses JSON-lines manifests; ``AudioToCharDataset``
keeps the entries within the duration limits whose transcripts parse;
``bucket_pad`` pads a batch to a whole number of seconds (``quantum``
samples), so a run sees a handful of shapes; ``DataLoader`` batches in
order or shuffled by an explicit seeded generator.  Batches are numpy,
as the JAX package's, and a forward moves them to its device.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from qasr_tpu_torch.data.audio import read_audio
from qasr_tpu_torch.data.parsers import make_parser

BUCKET_QUANTUM = 16000  # 1 s of 16 kHz audio, ~100 frames a bucket step


@dataclass
class ManifestEntry:
    audio_file: str
    duration: float
    text: str
    offset: float = 0.0
    speaker: Optional[int] = None


def read_manifest(path: str) -> List[ManifestEntry]:
    """A JSON-lines manifest: ``audio_filepath`` (or ``audio_file``),
    ``duration``, ``text`` (or ``text_filepath``), ``offset``, ``speaker``."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            text = d.get("text")
            if text is None and "text_filepath" in d:
                with open(d["text_filepath"]) as tf:
                    text = tf.read().strip()
            out.append(ManifestEntry(
                audio_file=d.get("audio_filepath") or d.get("audio_file"),
                duration=float(d.get("duration", 0.0)), text=text or "",
                offset=float(d.get("offset", 0.0) or 0.0), speaker=d.get("speaker")))
    return out


class AudioToCharDataset:
    """(float32 audio, label ids) pairs from one or more comma-separated
    manifests: entries outside [min_duration, max_duration] or whose
    transcript does not parse are dropped; ``trim`` cuts each item's
    leading and trailing silence (``trim_silence``)."""

    def __init__(self, manifest_filepath: str, labels: Sequence[str],
                 sample_rate: int = 16000, max_duration: Optional[float] = None,
                 min_duration: Optional[float] = None, normalize_transcripts: bool = True,
                 parser: str = "en", trim: bool = False):
        self.labels = list(labels)
        self.sample_rate = sample_rate
        self.trim = trim
        self.parser = make_parser(self.labels, parser, do_normalize=normalize_transcripts)
        self.items = []
        for path in manifest_filepath.split(","):
            for e in read_manifest(path):
                if max_duration and e.duration > max_duration:
                    continue
                if min_duration and e.duration < min_duration:
                    continue
                tokens = self.parser(e.text)
                if tokens is not None:
                    self.items.append((e, tokens))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        e, tokens = self.items[i]
        sig = read_audio(e.audio_file, self.sample_rate, offset=e.offset,
                         duration=e.duration or None, trim=self.trim)
        return sig, np.asarray(tokens, np.int32)


def bucket_pad(signals: Sequence[np.ndarray], quantum: int = BUCKET_QUANTUM
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad 1-D signals to the longest one's length rounded up to a
    multiple of ``quantum``: ((B, T), lengths int32)."""
    lens = np.asarray([len(s) for s in signals], np.int32)
    t = int(max(1, -(-int(lens.max()) // quantum)) * quantum)
    out = np.zeros((len(signals), t), signals[0].dtype)
    for i, s in enumerate(signals):
        out[i, :len(s)] = s
    return out, lens


def collate_batch(batch, quantum: int = BUCKET_QUANTUM):
    """[(audio, tokens)] -> (audio (B, T), audio lengths, tokens (B, L) with
    L a multiple of 16, token lengths)."""
    sigs, toks = zip(*batch)
    audio, alens = bucket_pad(sigs, quantum)
    tl = np.asarray([len(t) for t in toks], np.int32)
    lmax = int(max(1, -(-int(tl.max()) // 16)) * 16)
    tokens = np.zeros((len(toks), lmax), np.int32)
    for i, t in enumerate(toks):
        tokens[i, :len(t)] = t
    return audio, alens, tokens, tl


class DataLoader:
    """Batches of ``collate_batch`` over a dataset, in order or shuffled by
    ``np.random.default_rng(seed)`` (the JAX package's order for the same
    seed); ``drop_last`` drops a short last batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        idx = list(range(len(self.ds)))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(idx)
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield collate_batch([self.ds[j] for j in chunk])
