"""Transcript parsing and cleaning (a copy of qasr_tpu/data/parsers.py;
the port imports nothing of the JAX package).

``CharParser`` maps text to label ids and drops a transcript with a
character outside the vocabulary; ``ENCharParser`` first normalizes
English (lowercase, abbreviations, digits to words, punctuation stripped).
"""
from __future__ import annotations

import re
import string
from typing import List, Optional, Sequence

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**12, "trillion"), (10**9, "billion"), (10**6, "million"),
          (10**3, "thousand"), (100, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + ("" if o == 0 else " " + _ONES[o])
    for base, name in _SCALE:
        if n >= base:
            head, rest = divmod(n, base)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _ONES[0]


_ABBREVIATIONS = {
    "mrs": "misess", "mr": "mister", "dr": "doctor", "st": "saint",
    "co": "company", "jr": "junior", "maj": "major", "gen": "general",
    "drs": "doctors", "rev": "reverend", "lt": "lieutenant", "hon": "honorable",
    "sgt": "sergeant", "capt": "captain", "esq": "esquire", "ltd": "limited",
    "col": "colonel", "ft": "fort",
}
_ABBR_RE = re.compile(r"\b(" + "|".join(_ABBREVIATIONS) + r")\.", re.IGNORECASE)
_NUM_RE = re.compile(r"\d+")
_WS_RE = re.compile(r"\s+")


def clean_text(text: str) -> str:
    """English normalization: lowercase, abbreviations, digits to words,
    strip punctuation (cleaners.py:93-204 behavior)."""
    t = text.lower()
    t = _ABBR_RE.sub(lambda m: _ABBREVIATIONS[m.group(1).lower()], t)
    t = _NUM_RE.sub(lambda m: " " + number_to_words(int(m.group(0))) + " ", t)
    t = t.replace("-", " ").replace("_", " ").replace("&", " and ")
    keep = set(string.ascii_lowercase) | {" ", "'"}
    t = "".join(c if c in keep else " " for c in t)
    return _WS_RE.sub(" ", t).strip()


class CharParser:
    """Text -> label ids; returns None when a char is out of vocabulary
    (sample dropped, parsers.py:22-90 semantics)."""

    def __init__(self, labels: Sequence[str], *, unk_id: int = -1,
                 do_normalize: bool = True, do_lowercase: bool = True):
        self.labels = list(labels)
        self.label_map = {c: i for i, c in enumerate(self.labels)}
        self.unk_id = unk_id
        self.do_normalize = do_normalize
        self.do_lowercase = do_lowercase

    def normalize(self, text: str) -> Optional[str]:
        if self.do_lowercase:
            text = text.lower()
        return text

    def __call__(self, text: str) -> Optional[List[int]]:
        if self.do_normalize:
            text = self.normalize(text)
            if text is None:
                return None
        out = []
        for c in text:
            if c in self.label_map:
                out.append(self.label_map[c])
            elif self.unk_id >= 0:
                out.append(self.unk_id)
            else:
                return None
        return out


class ENCharParser(CharParser):
    """English parser with full cleaning (parsers.py:93-148)."""

    def normalize(self, text: str) -> Optional[str]:
        try:
            return clean_text(text)
        except Exception:
            return None


NAME_TO_PARSER = {"base": CharParser, "en": ENCharParser}


def make_parser(labels: Sequence[str], name: str = "base", **kwargs) -> CharParser:
    cls = NAME_TO_PARSER.get(name, CharParser)
    return cls(labels, **kwargs)
