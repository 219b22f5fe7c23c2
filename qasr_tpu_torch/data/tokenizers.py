"""Tokenizers of the BPE-vocabulary models (port of
qasr_tpu/data/tokenizers.py without training).

``CharTokenizer`` and ``WordTokenizer`` as the JAX package's, and a
``BPETokenizer`` that reads the HuggingFace ``tokenizer.json`` the JAX
package's ``BPETokenizer.train`` writes, without the ``tokenizers``
library (the GPU machine has none): special tokens split out first, then
the Metaspace pre-tokenizer (spaces to '▁', '▁' prepended to a segment
that lacks it, a piece starting at each '▁'), then BPE on each piece
(characters outside the vocabulary become '<unk>' one each, merges applied
lowest rank first, leftmost first among equal ranks).  Merges may be pairs
(``[["a", "t"], ...]``) or strings (``["a t", ...]``).  Training stays
with the JAX package, which needs the library.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple


class TokenizerSpec:
    """text <-> ids; the ids exclude the CTC blank (the model appends it
    at vocab_size)."""

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def vocab(self) -> List[str]:
        raise NotImplementedError

    def text_to_ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def ids_to_text(self, ids: Sequence[int]) -> str:
        raise NotImplementedError


class CharTokenizer(TokenizerSpec):
    def __init__(self, vocab: Sequence[str]):
        self._vocab = list(vocab)
        self._map = {c: i for i, c in enumerate(self._vocab)}

    @property
    def vocab(self) -> List[str]:
        return self._vocab

    def text_to_ids(self, text: str) -> List[int]:
        return [self._map[c] for c in text if c in self._map]

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return "".join(self._vocab[i] for i in ids)


class WordTokenizer(TokenizerSpec):
    def __init__(self, vocab: Sequence[str], unk: str = "<unk>"):
        self._vocab = list(vocab)
        if unk not in self._vocab:
            self._vocab.append(unk)
        self._map = {w: i for i, w in enumerate(self._vocab)}
        self._unk = self._map[unk]

    @property
    def vocab(self) -> List[str]:
        return self._vocab

    def text_to_ids(self, text: str) -> List[int]:
        return [self._map.get(w, self._unk) for w in text.split()]

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return " ".join(self._vocab[i] for i in ids)


class BPETokenizer(TokenizerSpec):
    """A BPE model from a HuggingFace ``tokenizer.json`` (a Metaspace
    pre-tokenizer, no normalizer, no byte fallback).  Decoded text turns
    '▁' back into spaces, as the JAX package's."""

    def __init__(self, tokenizer_path: str):
        self.path = tokenizer_path  # packed as an archive artifact
        with open(tokenizer_path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "BPE" or spec.get("normalizer") is not None \
                or model.get("byte_fallback") or model.get("continuing_subword_prefix") \
                or model.get("end_of_word_suffix") or model.get("dropout") \
                or model.get("fuse_unk"):
            raise NotImplementedError(f"{tokenizer_path}: only a plain BPE model (no fused "
                                      f"unknowns) is read")
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") != "Metaspace" or pre.get("prepend_scheme", "always") != "always" \
                or not pre.get("split", True):
            raise NotImplementedError(f"{tokenizer_path}: only the Metaspace pre-tokenizer "
                                      f"(prepend_scheme 'always', split) is read")
        self.replacement = pre.get("replacement", "▁")
        self.token_to_id: Dict[str, int] = dict(model["vocab"])
        self.special = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        self.token_to_id.update(self.special)
        self.id_to_token = {i: t for t, i in self.token_to_id.items()}
        unk = model.get("unk_token")
        self.unk_id = self.token_to_id[unk] if unk is not None else None
        self.ranks: Dict[Tuple[str, str], int] = {}
        for rank, m in enumerate(model.get("merges", [])):
            pair = tuple(m) if isinstance(m, list) else tuple(m.split(" ", 1))
            self.ranks.setdefault(pair, rank)

    @property
    def vocab(self) -> List[str]:
        return [self.id_to_token[i] for i in range(len(self.id_to_token))]

    def _pieces(self, segment: str) -> List[str]:
        """Metaspace: spaces to the replacement, prepended when the segment
        does not start with it, a piece starting at each one."""
        r = self.replacement
        s = segment.replace(" ", r)
        if not s.startswith(r):
            s = r + s
        pieces: List[str] = []
        for ch in s:
            if ch == r or not pieces:
                pieces.append(ch)
            else:
                pieces[-1] += ch
        return pieces

    def _bpe(self, piece: str) -> List[int]:
        symbols: List[str] = []
        ids: List[int] = []
        for ch in piece:
            if ch in self.token_to_id:
                symbols.append(ch)
                ids.append(self.token_to_id[ch])
            elif self.unk_id is None:
                raise ValueError(f"character {ch!r} is not in the vocabulary")
            else:
                symbols.append(None)    # an unknown character merges with nothing
                ids.append(self.unk_id)
        while len(symbols) > 1:
            best = None
            for i in range(len(symbols) - 1):
                if symbols[i] is None or symbols[i + 1] is None:
                    continue
                rank = self.ranks.get((symbols[i], symbols[i + 1]))
                if rank is not None and (best is None or rank < best[0]):
                    best = (rank, i)
            if best is None:
                break
            i = best[1]
            merged = symbols[i] + symbols[i + 1]
            symbols[i:i + 2] = [merged]
            ids[i:i + 2] = [self.token_to_id[merged]]
        return ids

    def text_to_ids(self, text: str) -> List[int]:
        out: List[int] = []
        for seg, special in self._split_special(text):
            if special:
                out.append(self.special[seg])
            elif seg:
                for piece in self._pieces(seg):
                    out += self._bpe(piece)
        return out

    def _split_special(self, text: str) -> List[Tuple[str, bool]]:
        """The text cut at each added token's occurrence (longest first)."""
        segs: List[Tuple[str, bool]] = []
        i = start = 0
        toks = sorted(self.special, key=len, reverse=True)
        while i < len(text):
            tok = next((t for t in toks if t and text.startswith(t, i)), None)
            if tok is None:
                i += 1
                continue
            segs += [(text[start:i], False), (tok, True)]
            i = start = i + len(tok)
        segs.append((text[start:], False))
        return segs

    def ids_to_text(self, ids: Sequence[int]) -> str:
        text = "".join(self.id_to_token.get(int(i), "") for i in ids)
        return text.replace(self.replacement, " ").strip()


def tokenizer_from_config(cfg: dict) -> TokenizerSpec:
    """A NeMo-style tokenizer section: {'type': 'bpe' | 'char' | 'word',
    'model_path' or 'dir' (bpe), 'vocab' (char, word)}."""
    t = cfg.get("type", "bpe").lower()
    if t in ("bpe", "wpe", "sentencepiece"):
        return BPETokenizer(cfg.get("model_path") or os.path.join(cfg["dir"], "tokenizer.json"))
    if t == "char":
        return CharTokenizer(cfg["vocab"])
    if t == "word":
        return WordTokenizer(cfg["vocab"])
    raise ValueError(f"unknown tokenizer type {t}")
