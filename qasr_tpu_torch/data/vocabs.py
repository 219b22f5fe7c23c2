"""Character and phoneme vocabularies for dataset parsers (port of
qasr_tpu/data/vocabs.py).

A Base encode / decode interface (pad, blank and oov first), a Chars vocab
(lowercase letters, optional punctuation and spaces), and a Phonemes vocab
(ARPAbet with stress variants) whose text-to-phoneme step is a g2p
callable: the ``g2p_en`` package's when it is installed, else one passed
in; without either, ``encode`` raises.
"""
from __future__ import annotations

import abc
import itertools
import string
from typing import Callable, List, Optional, Sequence

PAD = "<pad>"
BLANK = "<blank>"
OOV = "<oov>"

_PUNCT = "!'(),-.:;? "


class Base(abc.ABC):
    def __init__(self, labels: Sequence[str], *, pad: str = PAD,
                 blank: str = BLANK, oov: str = OOV):
        self.labels = [pad, blank, oov] + list(labels)
        self.pad, self.blank, self.oov = 0, 1, 2
        self._map = {l: i for i, l in enumerate(self.labels)}

    def __len__(self) -> int:
        return len(self.labels)

    @abc.abstractmethod
    def encode(self, text: str) -> List[int]:
        ...

    def decode(self, tokens: Sequence[int]) -> str:
        return "".join(self.labels[t] for t in tokens
                       if t not in (self.pad, self.blank))


class Chars(Base):
    """Character vocabulary: lowercase ascii, optional punctuation, a space
    when punctuation or ``spaces`` asks for one."""

    def __init__(self, punct: bool = True, spaces: bool = False):
        labels = list(string.ascii_lowercase)
        if spaces or punct:
            labels.append(" ")
        if punct:
            labels.extend(c for c in _PUNCT if c != " ")
        super().__init__(labels)
        self.punct = punct

    def encode(self, text: str) -> List[int]:
        out = []
        for c in text.lower():
            if c in self._map:
                out.append(self._map[c])
            elif c.isspace() and " " in self._map:
                out.append(self._map[" "])
            else:
                out.append(self.oov)
        return out


# the ARPAbet phoneme inventory, vowels with their stress markers
_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
           "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
               "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
               "Z", "ZH"]
ARPABET = list(itertools.chain(
    (f"{v}{s}" for v in _VOWELS for s in (0, 1, 2)), _CONSONANTS))


class Phonemes(Base):
    """Phoneme vocabulary; ``g2p`` maps text to a phoneme sequence (by
    default the g2p_en package's G2p, when installed)."""

    def __init__(self, punct: bool = True,
                 g2p: Optional[Callable[[str], Sequence[str]]] = None):
        labels = list(ARPABET)
        labels.append(" ")
        if punct:
            labels.extend(c for c in _PUNCT if c != " ")
        super().__init__(labels)
        if g2p is None:
            try:
                import g2p_en

                g2p = g2p_en.G2p()
            except ImportError:
                g2p = None
        self._g2p = g2p

    def encode(self, text: str) -> List[int]:
        if self._g2p is None:
            raise ImportError(
                "Phonemes needs a g2p callable (the g2p_en package is not "
                "installed); pass g2p= to the constructor")
        out = []
        for tok in self._g2p(text):
            out.append(self._map.get(tok, self.oov))
        return out
