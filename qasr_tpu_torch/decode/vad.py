"""VAD post-processing: overlap posterior smoothing + segment tables +
speaker-diarization manifests (the port's copy of qasr_tpu/decode/vad.py:
numpy only, the same functions).

Downstream tooling for cli/vad_infer.py frame probabilities, with the same
behavior as the reference's scripts (cited per function):

  * ``smooth_overlap``     <- scripts/vad_overlap_posterior.py:42-124
                              (gen_overlap_seq: mean/median smoothing of
                              overlapping window predictions)
  * ``frames_to_segments`` <- scripts/vad_overlap_posterior.py:127-173
                              (gen_seg_table: threshold -> start/end/state)
  * ``segments_to_manifest`` <- scripts/vad_to_manifest.py:33-49
                              (speech segments -> diarization manifest)

The reference loops per target position in Python (a per-element list for the
median filter); here both filters are vectorized — the overlapping windows at
a fixed stride form a strided view, so the per-position median/mean is one
numpy reduction over a (windows, positions) matrix.
"""
from __future__ import annotations

import glob
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


def smooth_overlap(frame: np.ndarray, *, method: str = "median",
                   overlap: float = 0.875, seg_len: float = 0.63,
                   shift_len: float = 0.01) -> np.ndarray:
    """Smooth per-window speech probabilities into per-10ms-unit posteriors.

    ``frame[i]`` is the model's prediction for the window starting at
    ``i * shift_len``; windows are ``seg_len`` long, and only every
    ``jump_on_frame``-th window contributes (the reference evaluates a
    sparser set of overlapping segments, vad_overlap_posterior.py:66-78).
    Positions covered by no window inherit the last covered value
    (vad_overlap_posterior.py:96-97,112-114); output rounded to 4 decimals
    (:119).
    """
    frame = np.asarray(frame, np.float64).reshape(-1)
    shift = int(shift_len / 0.01)            # units per input frame
    seg = int(seg_len / 0.01 + 1)            # units per window
    jump_on_target = int(seg * (1 - overlap))
    jump_on_frame = int(jump_on_target / shift)
    if jump_on_frame < 1:
        raise ValueError(
            f"jump_on_frame={jump_on_frame} < 1: the window stride rounds to "
            f"zero — use a larger seg_len/smaller overlap (reference "
            f"vad_overlap_posterior.py:72-79 rejects this too)")
    target_len = len(frame) * shift
    used = frame[::jump_on_frame]            # contributing windows
    starts = np.arange(len(frame), step=jump_on_frame) * shift

    if method == "mean":
        preds = np.zeros(target_len)
        count = np.zeros(target_len)
        # scatter-add each window's value over its span (bounded by the
        # reference's preds[start:end] slice semantics: spans clip at the end)
        for s, v in zip(starts, used):
            e = min(s + seg, target_len)
            preds[s:e] += v
            count[s:e] += 1
        covered = count != 0
        preds[covered] /= count[covered]
        preds[~covered] = preds[covered][-1]
    elif method == "median":
        # per-position median over the windows covering it; with a fixed
        # stride every position is covered by at most ceil(seg/stride)
        # windows — build a (max_cover, target_len) matrix with NaN holes
        stride = jump_on_frame * shift
        max_cover = -(-seg // stride)
        mat = np.full((max_cover, target_len), np.nan)
        for s, v in zip(starts, used):
            e = min(s + seg, target_len)
            row = (s // stride) % max_cover
            mat[row, s:e] = v
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN tail
            preds = np.nanmedian(mat, axis=0)
        nan_idx = np.isnan(preds)
        if nan_idx.all():
            raise ValueError("no window covers any position")
        preds[nan_idx] = preds[~nan_idx][-1]
    else:
        raise ValueError("method should be either mean or median")
    return np.round(preds, 4)


def frames_to_segments(sequence: np.ndarray, *, threshold: float = 0.5,
                       shift_len: float = 0.01
                       ) -> List[Tuple[float, float, str]]:
    """Threshold a posterior sequence into (start, end, state) segments.

    state is 'speech' when p > threshold else 'non-speech'; boundaries fall
    at state flips, with the flip unit's end extended by one shift (the
    reference's ``end = i*shift_len + shift_len`` "for handling joint",
    vad_overlap_posterior.py:155-167).

    Documented deviation: the reference labels the *final* segment with the
    state of the second-to-last element (its loop variable leaks,
    vad_overlap_posterior.py:166-167 uses ``current_sate`` from i=len-2), so
    a flip at the very last element gets the wrong label there; here the
    final segment is labeled by the last element's own state.  It also
    crashes on single-element sequences; here they yield one segment.
    """
    seq = np.asarray(sequence, np.float64).reshape(-1)
    if len(seq) == 0:
        return []
    speech = seq > threshold
    flips = np.flatnonzero(speech[1:] != speech[:-1])  # state changes at i
    segs: List[Tuple[float, float, str]] = []
    start = 0.0
    for i in flips:
        state = "speech" if speech[i] else "non-speech"
        segs.append((start, i * shift_len + shift_len, state))
        start = (i + 1) * shift_len
    last = len(seq) - 1
    segs.append((start, last * shift_len + shift_len,
                 "speech" if speech[last] else "non-speech"))
    return segs


def write_segment_table(segs: Sequence[Tuple[float, float, str]],
                        path: str) -> str:
    """Tab-separated start/end/state rows, no header — the reference's
    rttm-like csv (vad_overlap_posterior.py:169-173)."""
    with open(path, "w") as f:
        for s, e, st in segs:
            f.write(f"{_fmt(s)}\t{_fmt(e)}\t{st}\n")
    return path


def _fmt(x: float) -> str:
    # pandas prints floats shortest-round-trip; match "0.01" not "0.010000"
    return repr(round(float(x), 6))


def read_segment_table(path: str) -> List[Tuple[float, float, str]]:
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                segs.append((float(parts[0]), float(parts[1]), parts[2]))
    return segs


def segments_to_manifest(vad_directory: str, audio_directory: str,
                         manifest_file: str, *,
                         audio_ext: str = ".wav") -> str:
    """Convert segment tables (*.txt of 'start end state') into a speaker-
    diarization manifest: one JSON line per speech segment with
    audio_filepath/offset/duration/label='UNK' (vad_to_manifest.py:33-49;
    the audio file is assumed to share the table's basename)."""
    with open(manifest_file, "w") as out:
        for vad_file in sorted(glob.glob(os.path.join(vad_directory, "*.txt"))):
            audio_name = os.path.basename(vad_file).split(".")[0]
            for start, end, state in read_segment_table(vad_file):
                if state.lower() == "speech":
                    meta = {
                        "audio_filepath": os.path.join(
                            audio_directory, audio_name + audio_ext),
                        "offset": start,
                        "duration": end - start,
                        "label": "UNK",
                    }
                    out.write(json.dumps(meta) + "\n")
    return manifest_file


def process_frame_dir(frame_folder: str, *, method: str = "median",
                      overlap: float = 0.875, seg_len: float = 0.63,
                      shift_len: float = 0.01, threshold: float = 0.5,
                      overlap_out_dir: Optional[str] = None,
                      table_out_dir: Optional[str] = None,
                      gen_overlap_seq: bool = True,
                      gen_seg_table: bool = True) -> Tuple[str, str]:
    """Directory driver with the reference CLI's defaults and output naming
    (vad_overlap_posterior.py:176-259): '*.frame' inputs, smoothed copies
    named '<base>.<method>', tables '<base>.txt'."""
    overlap_out_dir = overlap_out_dir or f"overlap_smoothing_output_{method}_{overlap}"
    table_out_dir = table_out_dir or f"table_output_{threshold}"
    if gen_overlap_seq:
        os.makedirs(overlap_out_dir, exist_ok=True)
        for fp in sorted(glob.glob(os.path.join(frame_folder, "*.frame"))):
            frame = np.loadtxt(fp, ndmin=1)
            sm = smooth_overlap(frame, method=method, overlap=overlap,
                                seg_len=seg_len, shift_len=shift_len)
            name = os.path.basename(fp).split(".frame")[0] + "." + method
            np.savetxt(os.path.join(overlap_out_dir, name), sm, delimiter="\n")
    if gen_seg_table:
        os.makedirs(table_out_dir, exist_ok=True)
        src = overlap_out_dir if gen_overlap_seq else frame_folder
        # segment the smoothed posteriors (unit = 10 ms) or raw frames
        sl = 0.01 if gen_overlap_seq else shift_len
        for fp in sorted(glob.glob(os.path.join(src, f"*.{method}"))):
            seq = np.loadtxt(fp, ndmin=1)
            segs = frames_to_segments(seq, threshold=threshold, shift_len=sl)
            name = os.path.basename(fp).rsplit(".", 1)[0] + ".txt"
            write_segment_table(segs, os.path.join(table_out_dir, name))
    return overlap_out_dir, table_out_dir
