"""CTC prefix beam search with an optional n-gram LM (port of
qasr_tpu/decode/beam_search.py).

The search is native: ``qasr_tpu_torch/native/ctc_beam_search.cpp`` (the
JAX package's source, copied), built with g++ at first use into
``qasr_tpu_torch/native/build/`` and bound with ctypes, the JAX package's
signatures.  A failed build raises; nothing falls back to
``beam_search_python``, which is the tests' oracle.  Log-probs come in as
numpy or CPU / CUDA tensors ((B, T, V+1), the blank last) and are searched
on the host.
"""
from __future__ import annotations

import ctypes
import math
import os
import subprocess
import tempfile
import threading
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "native")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _build_native() -> str:
    """The library's path, compiled first when it is missing or older than
    the source (into a temporary name, then renamed: concurrent builders
    never load a half-written file).  Raises RuntimeError with g++'s
    output when the build fails."""
    src = os.path.abspath(os.path.join(_NATIVE_DIR, "ctc_beam_search.cpp"))
    out = os.path.abspath(os.path.join(_BUILD_DIR, "libctc_beam.so"))
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp, "-pthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"cannot build the CTC beam search: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building the CTC beam search failed ({' '.join(cmd)}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(_build_native()))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.qasr_lm_load.restype = ctypes.c_void_p
    lib.qasr_lm_load.argtypes = [ctypes.c_char_p]
    lib.qasr_lm_free.argtypes = [ctypes.c_void_p]
    lib.qasr_lm_order.restype = ctypes.c_int
    lib.qasr_lm_order.argtypes = [ctypes.c_void_p]
    lib.qasr_lm_convert.restype = ctypes.c_int
    lib.qasr_lm_convert.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.qasr_beam_search_batch.restype = ctypes.c_int
    lib.qasr_beam_search_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.qasr_beam_stream_create.restype = ctypes.c_void_p
    lib.qasr_beam_stream_create.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.qasr_beam_stream_feed.restype = ctypes.c_int
    lib.qasr_beam_stream_feed.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.qasr_beam_stream_best.restype = ctypes.c_int
    lib.qasr_beam_stream_best.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.qasr_beam_stream_reset.argtypes = [ctypes.c_void_p]
    lib.qasr_beam_stream_free.argtypes = [ctypes.c_void_p]
    lib.qasr_beam_stream_feed_batch.restype = ctypes.c_int
    lib.qasr_beam_stream_feed_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _host(x, dtype) -> np.ndarray:
    """numpy or a (CPU / CUDA) tensor -> a contiguous host array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


def _max_symbol_bytes(vocab: Sequence[str]) -> int:
    """The longest symbol in UTF-8 bytes (at least 1): text buffers sized by
    it never cut a multi-byte codepoint short."""
    return max((len(s.encode("utf-8")) for s in vocab), default=1) or 1


def convert_arpa_to_binary(arpa_path: str, out_path: str) -> str:
    """Convert a text ARPA LM to the memory-mapped '.qlm' binary (an
    open-addressing table of 64-bit n-gram fingerprints, KenLM's 'probing'
    layout): loading it is a mmap, not a text parse."""
    rc = _lib().qasr_lm_convert(arpa_path.encode(), out_path.encode())
    if rc != 0:
        raise RuntimeError(f"ARPA->qlm conversion failed: rc={rc}")
    return out_path


class BeamSearchDecoderWithLM:
    """NeMo's BeamSearchDecoderWithLM: vocab, beam_width, alpha (LM
    weight), beta (word bonus), lm_path (a text ARPA or a '.qlm' binary,
    told apart by content), num_cpus, cutoff_prob, cutoff_top_n; called on
    (log_probs (B, T, V+1), lengths) it returns each sample's n-best
    [(score, text), ...]."""

    def __init__(self, vocab: Sequence[str], beam_width: int = 128,
                 alpha: float = 0.0, beta: float = 0.0,
                 lm_path: Optional[str] = None, num_cpus: int = 4,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40):
        self.vocab = list(vocab)
        self.beam_width = beam_width
        self.alpha = alpha
        self.beta = beta
        self.num_cpus = num_cpus
        self.cutoff_prob = cutoff_prob
        self.cutoff_top_n = cutoff_top_n
        self._lm = None
        if lm_path:
            self._lm = _lib().qasr_lm_load(lm_path.encode())
            if not self._lm:
                raise FileNotFoundError(f"cannot load ARPA LM: {lm_path}")

    def __del__(self):
        if getattr(self, "_lm", None):
            try:
                _lib().qasr_lm_free(self._lm)
            except Exception:
                pass

    def __call__(self, log_probs: np.ndarray, log_probs_length: np.ndarray,
                 n_best: int = 1) -> List[List[Tuple[float, str]]]:
        lp = _host(log_probs, np.float32)
        lens = _host(log_probs_length, np.int32)
        b, t, v = lp.shape
        if v != len(self.vocab) + 1:
            raise ValueError(f"log-probs have {v} classes, the vocabulary {len(self.vocab)} "
                             f"and the blank (last) {len(self.vocab) + 1}")
        # at most one emitted symbol per frame; symbols may be multi-byte
        # UTF-8 (or multi-char BPE pieces), so size by the longest one
        max_text = t * _max_symbol_bytes(self.vocab) + 1
        texts = ctypes.create_string_buffer(b * n_best * max_text)
        scores = (ctypes.c_double * (b * n_best))()
        blob = "\x1f".join(self.vocab).encode("utf-8")
        rc = _lib().qasr_beam_search_batch(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b, t, v, blob, self.beam_width, self.alpha, self.beta,
            self.cutoff_prob, self.cutoff_top_n,
            self._lm, n_best, max_text, texts, scores, self.num_cpus)
        if rc != 0:
            raise RuntimeError(f"beam search failed: rc={rc}")
        out: List[List[Tuple[float, str]]] = []
        for i in range(b):
            cand = []
            for j in range(n_best):
                s = scores[i * n_best + j]
                if s == -math.inf:
                    break
                raw = texts.raw[(i * n_best + j) * max_text:
                                (i * n_best + j + 1) * max_text]
                cand.append((float(s),
                             raw.split(b"\x00")[0].decode("utf-8",
                                                          errors="replace")))
            out.append(cand)
        return out

    def forward(self, log_probs, log_probs_length):  # NeMo's method name
        return self(log_probs, log_probs_length)


class StreamingBeamDecoder:
    """Resumable CTC prefix beam search over log-prob chunks: the native
    beam map is the whole search state, so feeding chunks equals decoding
    the concatenated frames offline; ``best()`` does not end the stream
    (a running partial hypothesis after each chunk)."""

    def __init__(self, vocab: Sequence[str], beam_width: int = 128,
                 alpha: float = 0.0, beta: float = 0.0,
                 lm: Optional["BeamSearchDecoderWithLM"] = None,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40):
        self.vocab = list(vocab)
        self._v = len(self.vocab) + 1
        # keep the (optional) owning decoder alive: the LM handle must
        # outlive the stream
        self._lm_owner = lm
        lm_handle = lm._lm if lm is not None else None
        blob = "\x1f".join(self.vocab).encode("utf-8")
        self._h = _lib().qasr_beam_stream_create(
            self._v, blob, beam_width, alpha, beta, cutoff_prob,
            cutoff_top_n, lm_handle)
        if not self._h:
            raise ValueError("bad vocabulary for streaming beam decoder")
        self._frames = 0

    def feed(self, log_probs: np.ndarray) -> None:
        """Advance the search by a (T, V+1) float32 log-prob chunk."""
        lp = _host(log_probs, np.float32)
        if lp.ndim != 2 or lp.shape[1] != self._v:
            raise ValueError(f"expected a (T, {self._v}) chunk, got {lp.shape}")
        rc = _lib().qasr_beam_stream_feed(
            self._h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lp.shape[0])
        if rc != 0:
            raise RuntimeError(f"beam stream feed failed: rc={rc}")
        self._frames += lp.shape[0]

    def best(self, n_best: int = 1) -> List[Tuple[float, str]]:
        """Current n-best [(score, text)] — the stream keeps going after."""
        max_text = self._frames * _max_symbol_bytes(self.vocab) + 2
        texts = ctypes.create_string_buffer(n_best * max_text)
        scores = (ctypes.c_double * n_best)()
        n = _lib().qasr_beam_stream_best(self._h, n_best, max_text, texts,
                                         scores)
        if n < 0:
            raise RuntimeError("beam stream best failed")
        out = []
        for i in range(min(n, n_best)):
            raw = texts.raw[i * max_text:(i + 1) * max_text]
            out.append((float(scores[i]),
                        raw.split(b"\x00")[0].decode("utf-8",
                                                     errors="replace")))
        return out

    def reset(self) -> None:
        _lib().qasr_beam_stream_reset(self._h)
        self._frames = 0

    def __del__(self):
        if getattr(self, "_h", None):
            try:
                _lib().qasr_beam_stream_free(self._h)
            except Exception:
                pass


class StreamingBeamBatch:
    """S streaming beam searches advanced together by one (S, T, V+1)
    batch of log-prob chunks a tick, in one native call over a thread pool
    (qasr_beam_stream_feed_batch); each stream's state equals feeding it
    alone."""

    def __init__(self, n_streams: int, vocab: Sequence[str],
                 beam_width: int = 128, alpha: float = 0.0, beta: float = 0.0,
                 lm: Optional["BeamSearchDecoderWithLM"] = None,
                 cutoff_prob: float = 1.0, cutoff_top_n: int = 40,
                 num_threads: int = 4):
        self.streams = [
            StreamingBeamDecoder(vocab, beam_width, alpha, beta, lm,
                                 cutoff_prob, cutoff_top_n)
            for _ in range(n_streams)
        ]
        self.num_threads = num_threads
        self._v = len(vocab) + 1
        self._handles = (ctypes.c_void_p * n_streams)(
            *[s._h for s in self.streams])

    def __len__(self):
        return len(self.streams)

    def feed(self, log_probs: np.ndarray,
             lengths: Optional[np.ndarray] = None) -> None:
        """Advance every stream: log_probs (S, T, V+1) float32; lengths (S,)
        valid frames per stream (default: all T)."""
        lp = _host(log_probs, np.float32)
        s, t, v = lp.shape
        if s != len(self.streams) or v != self._v:
            raise ValueError(f"expected ({len(self.streams)}, T, {self._v}), got {lp.shape}")
        if lengths is None:
            lengths = np.full((s,), t, np.int32)
        lens = _host(lengths, np.int32)
        if lens.size and int(lens.max()) > t:
            # the native call would clamp to T while the frame counts took
            # the lengths: the stream would drift from the offline decode
            raise ValueError(f"lengths.max()={int(lens.max())} exceeds "
                             f"chunk frames T={t}")
        rc = _lib().qasr_beam_stream_feed_batch(
            self._handles, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            s, t, v, self.num_threads)
        if rc != 0:
            raise RuntimeError(f"batched beam stream feed failed: rc={rc}")
        for st, n in zip(self.streams, lens):
            st._frames += int(n)

    def best(self, n_best: int = 1) -> List[List[Tuple[float, str]]]:
        return [s.best(n_best) for s in self.streams]

    def reset(self) -> None:
        for s in self.streams:
            s.reset()


# ---------------------------------------------------------------------------
# the same search in Python (the tests' oracle; nothing falls back to it)
# ---------------------------------------------------------------------------


def beam_search_python(log_probs: np.ndarray, vocab: Sequence[str],
                       beam_width: int = 16, n_best: int = 1,
                       cutoff_top_n: int = 0) -> List[Tuple[float, str]]:
    """Prefix beam search on one utterance (T, V+1), blank last, no LM."""
    t_len, v = log_probs.shape
    blank = v - 1
    NEG = -math.inf

    def lse(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + math.log1p(math.exp(-abs(a - b)))

    beams = {(): (0.0, NEG)}  # prefix(tuple of ids) -> (p_b, p_nb)
    for t in range(t_len):
        row = log_probs[t]
        order = np.argsort(row)[::-1]
        if cutoff_top_n > 0:
            order = order[:cutoff_top_n]
        nxt = defaultdict(lambda: (NEG, NEG))
        for ids, (p_b, p_nb) in beams.items():
            last = ids[-1] if ids else -1
            ptot = lse(p_b, p_nb)
            for s in order:
                p = float(row[s])
                if s == blank:
                    b_, nb_ = nxt[ids]
                    nxt[ids] = (lse(b_, ptot + p), nb_)
                    continue
                if s == last:
                    b_, nb_ = nxt[ids]
                    nxt[ids] = (b_, lse(nb_, p_nb + p))
                    base = p_b
                else:
                    base = ptot
                nids = ids + (int(s),)
                b_, nb_ = nxt[nids]
                nxt[nids] = (b_, lse(nb_, base + p))
        ranked = sorted(nxt.items(), key=lambda kv: -lse(*kv[1]))
        beams = dict(ranked[:beam_width])
    finals = sorted(((lse(pb, pnb), "".join(vocab[i] for i in ids))
                     for ids, (pb, pnb) in beams.items()), key=lambda x: -x[0])
    return finals[:n_best]
