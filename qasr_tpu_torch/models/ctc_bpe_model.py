"""The BPE-vocabulary CTC model (port of qasr_tpu/models/ctc_bpe_model.py):
the char model's encoder, decoder and quantization workflow over a subword
tokenizer's vocabulary, whose hypotheses are detokenized; and
``AudioToBPEDataset``, a manifest tokenized by it.
"""
from __future__ import annotations

from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from qasr_tpu_torch.data.audio import read_audio
from qasr_tpu_torch.data.dataset import read_manifest
from qasr_tpu_torch.data.tokenizers import TokenizerSpec
from qasr_tpu_torch.models.config import ModelConfig
from qasr_tpu_torch.models.ctc_model import ASRModel


class EncDecCTCModelBPE(ASRModel):
    """An ASRModel whose vocabulary is a subword tokenizer's."""

    tokenizer: TokenizerSpec = None

    @classmethod
    def from_config_and_tokenizer(cls, cfg: ModelConfig, tokenizer: TokenizerSpec,
                                  seed: int = 0) -> "EncDecCTCModelBPE":
        """``cfg`` with the tokenizer's vocabulary; a tokenizer read from a
        file is registered as the 'tokenizer.json' artifact, so archives
        carry it."""
        vocab = tuple(tokenizer.vocab)
        cfg = replace(cfg, decoder=replace(cfg.decoder, num_classes=len(vocab), vocabulary=vocab),
                      labels=vocab)
        if hasattr(tokenizer, "path"):
            cfg = replace(cfg, tokenizer={"type": "bpe", "model_path": "tokenizer.json"})
        model = super().from_config(cfg, seed=seed)
        model.__class__ = cls
        model.tokenizer = tokenizer
        if hasattr(tokenizer, "path"):
            model.register_artifact("tokenizer.json", tokenizer.path)
        return model

    def decode_hypotheses(self, predictions: np.ndarray,
                          lengths: Optional[np.ndarray] = None) -> List[str]:
        """CTC-collapse (B, T) token ids, then detokenize."""
        hyps = []
        blank = self.blank_id
        for i in range(predictions.shape[0]):
            seq = predictions[i] if lengths is None else predictions[i][:int(lengths[i])]
            ids, prev = [], blank
            for p in seq:
                p = int(p)
                if p != prev and p != blank:
                    ids.append(p)
                prev = p
            hyps.append(self.tokenizer.ids_to_text(ids))
        return hyps

    def ids_to_text(self, ids: torch.Tensor, enc_lens: torch.Tensor) -> List[str]:
        return self.decode_hypotheses(ids.cpu().numpy(), enc_lens.cpu().numpy())


class AudioToBPEDataset:
    """(float32 audio, token ids) pairs from one or more comma-separated
    manifests, tokenized by ``tokenizer``: entries outside the duration
    limits or with no tokens are dropped; ``trim`` cuts each item's leading
    and trailing silence (``trim_silence``)."""

    def __init__(self, manifest_filepath: str, tokenizer: TokenizerSpec,
                 sample_rate: int = 16000, max_duration: Optional[float] = None,
                 min_duration: Optional[float] = None, trim: bool = False):
        self.tokenizer = tokenizer
        self.sample_rate = sample_rate
        self.trim = trim
        self.items = []
        for path in manifest_filepath.split(","):
            for e in read_manifest(path):
                if max_duration and e.duration > max_duration:
                    continue
                if min_duration and e.duration < min_duration:
                    continue
                ids = tokenizer.text_to_ids(e.text)
                if ids:
                    self.items.append((e, ids))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, i: int):
        e, ids = self.items[i]
        sig = read_audio(e.audio_file, self.sample_rate, offset=e.offset,
                         duration=e.duration or None, trim=self.trim)
        return sig, np.asarray(ids, np.int32)
