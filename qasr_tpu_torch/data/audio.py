"""WAV input and output (a copy of the parts of qasr_tpu/data/audio.py
the port uses; the port imports nothing of the JAX package).

16-bit mono WAVs at the target rate are read as int16 PCM without a float
pass; other widths, channel counts or rates go through a float decode,
scipy's polyphase resampler and an exact re-grid to int16, as in the JAX
package's ``read_audio_pcm16`` at its default options.  ``read_audio``
gives float32 samples from an offset for a duration; ``write_wav`` writes
16-bit mono.
"""
from __future__ import annotations

import math
import wave
from typing import Optional, Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """(float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        ch, width = w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def read_wav_pcm16(path: str) -> Tuple[np.ndarray, int]:
    """(int16 mono samples, sample_rate); 16-bit mono is read as is."""
    with wave.open(path, "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        ch, width = w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2 and ch == 1:
        return np.frombuffer(raw, dtype="<i2"), sr
    x, sr = read_wav(path)
    return float_to_pcm16(x), sr


def float_to_pcm16(x: np.ndarray) -> np.ndarray:
    """Exact inverse of the /32768 decode for int16-representable floats;
    rounds (ties to even) and clips otherwise."""
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return x
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(x, target_sr // g, orig_sr // g).astype(np.float32)


def read_audio(path: str, target_sr: int = 16000, offset: float = 0.0,
               duration: Optional[float] = None) -> np.ndarray:
    """A WAV file as float32 samples at ``target_sr``, from ``offset``
    seconds for ``duration`` seconds (None: to the end)."""
    x, sr = read_wav(path)
    if offset:
        x = x[int(offset * sr):]
    if duration:
        x = x[: int(duration * sr)]
    return resample(x, sr, target_sr)


def read_audio_pcm16(path: str, target_sr: int = 16000) -> np.ndarray:
    """A WAV file as int16 PCM at ``target_sr``."""
    x16, sr = read_wav_pcm16(path)
    if sr == target_sr:
        return x16
    return float_to_pcm16(resample(x16.astype(np.float32) / 32768.0, sr, target_sr))


def write_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """Float samples in [-1, 1] as a 16-bit mono WAV (x * 32767, clipped)."""
    x16 = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x16.tobytes())
