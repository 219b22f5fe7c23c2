"""Voice-activity-detection inference (port of qasr_tpu/cli/vad_infer.py).

    python -m qasr_tpu_torch.cli.vad_infer --dataset manifest.json \
        [--vad_model vad.qasr] [--out_dir vad_frame] [--time_length 0.63] \
        [--shift_length 0.01] [--labels background,speech] [--device cpu]

Slides a (time_length, shift_length) window over each manifest utterance,
runs the classification model (MatchboxNet-3x1x64 with random weights from
seed 0 when no ``--vad_model`` is given: smoke testing) on the windows, 64
a batch (the last batch zero-padded to 64, as the JAX CLI pads to keep one
compiled shape), and writes each window's class probabilities, one line of
``%.4f`` values per window, to ``<out_dir>/<utterance>.frame``.  Runs on
the CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

CHUNK = 64   # windows a batch

log = logging.getLogger(__name__)


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description="VAD inference: per-window speech probabilities")
    p.add_argument("--vad_model", default=None,
                   help=".qasr classification checkpoint (omit for a random-weight "
                        "MatchboxNet-VAD: smoke testing)")
    p.add_argument("--dataset", required=True,
                   help="label manifest (labels may be dummies at inference)")
    p.add_argument("--out_dir", default="vad_frame")
    p.add_argument("--time_length", type=float, default=0.63)
    p.add_argument("--shift_length", type=float, default=0.01)
    p.add_argument("--labels", default="background,speech")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; 'cpu' to run there)")
    return p


def load_model(vad_model, labels):
    """The checkpoint's classification model (its classes and their order
    checked against ``labels``), or a random-weight MatchboxNet-3x1x64."""
    from qasr_tpu_torch.models.classification import EncDecClassificationModel
    from qasr_tpu_torch.models.config import matchboxnet3x1x64

    if not vad_model:
        return EncDecClassificationModel.from_config(matchboxnet3x1x64(),
                                                     num_classes=len(labels))
    model = EncDecClassificationModel.restore_from(vad_model)
    if model.num_classes != len(labels):
        raise ValueError(f"checkpoint has {model.num_classes} classes, --labels has "
                         f"{len(labels)}")
    if model.labels and list(model.labels) != labels:
        # a silent order mismatch would swap which column is 'speech'
        raise ValueError(f"checkpoint was trained with labels {list(model.labels)}; "
                         f"--labels gives {labels}: pass them in the training order")
    return model


def window_probs(model, windows, device):
    """Class probabilities (N, classes) of (N, L) windows, CHUNK a batch."""
    import numpy as np
    import torch

    rows = []
    for c0 in range(0, len(windows), CHUNK):
        chunk = windows[c0:c0 + CHUNK]
        pad = CHUNK - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
        lens = np.full((CHUNK,), windows.shape[1], np.int32)
        probs = torch.softmax(model.logits(chunk, lens, device), dim=-1).cpu().numpy()
        rows.extend(probs[:CHUNK - pad])
    return rows


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from qasr_tpu_torch.data.audio_to_label import AudioToSpeechLabelDataset
    from qasr_tpu_torch.device import as_device

    device = as_device(args.device)
    labels = args.labels.split(",")
    model = load_model(args.vad_model, labels)
    ds = AudioToSpeechLabelDataset(
        args.dataset, labels, sample_rate=model.cfg.sample_rate, min_duration=None,
        time_length=args.time_length, shift_length=args.shift_length,
        keep_unknown_labels=True)
    os.makedirs(args.out_dir, exist_ok=True)
    outputs, seen = [], set()
    for i in range(len(ds)):
        windows = np.stack([w for w, _ in ds.vad_windows(i)])
        rows = window_probs(model, windows, device)
        name = os.path.splitext(os.path.basename(ds.items[i]["audio_file"]))[0]
        if name in seen:   # the same basename in different directories: keep both
            name = f"{name}_{i}"
        seen.add(name)
        out = os.path.join(args.out_dir, f"{name}.frame")
        with open(out, "w") as f:
            for p in rows:
                f.write(" ".join(f"{x:.4f}" for x in p) + "\n")
        outputs.append(out)
        log.info(f"{name}: {len(windows)} frames -> {out}")
    return outputs


if __name__ == "__main__":
    main()
