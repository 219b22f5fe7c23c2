"""Synthetic calibration data as pickles (port of
qasr_tpu/compat/pickle_io.py).

The format is the reference's: a pickled list of float32 torch tensors in
(B, C, T) order, named ``{prefix}_nb{N}_iter{I}_lr{lr:.3f}.pkl``; the JAX
package writes and reads the same files.  ``load_synthetic`` unpickles
through a restricted unpickler that admits only tensor and array payloads.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import List, Optional, Sequence

import numpy as np
import torch


def synthetic_filename(prefix: str, num_batch: int, train_iter: int, lr: float,
                       dump_path: Optional[str] = None) -> str:
    name = "%s_nb%d_iter%d_lr%.3f.pkl" % (prefix, num_batch, train_iter, lr)
    if dump_path:
        os.makedirs(dump_path, exist_ok=True)
        name = os.path.join(dump_path, name)
    return name


def save_synthetic(path: str, batches_btc: Sequence) -> None:
    """(B, T, C) batches (torch tensors or arrays) -> the pickle, as CPU
    float32 tensors in the reference's (B, C, T) layout."""
    payload = [torch.as_tensor(b).detach().to("cpu", torch.float32).transpose(1, 2).contiguous()
               for b in batches_btc]
    with open(path, "wb") as f:
        pickle.dump(payload, f)


# what a tensor or array payload references: numpy's array reconstruction
# and torch's tensor and storage rebuilds; none of these runs code
_SAFE_GLOBALS = {
    ("collections", "OrderedDict"),
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_tensor"),
    ("torch.serialization", "_get_layout"),
}


def _safe_load_from_bytes(b):
    """Stands in for torch.storage._load_from_bytes, which runs a full
    torch.load; the nested storage loads with weights_only=True."""
    return torch.load(io.BytesIO(b), map_location="cpu", weights_only=True)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("torch.storage", "_load_from_bytes"):
            return _safe_load_from_bytes
        if (module, name) in _SAFE_GLOBALS or (module == "torch" and name.endswith("Storage")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"blocked unpickling of {module}.{name}; synthetic-data pickles may only "
            f"contain numpy arrays / torch tensors")


def load_synthetic(path: str) -> List[torch.Tensor]:
    """The pickle's batches as CPU float32 tensors, (B, C, T) as stored
    (``ASRModel.calibrate`` takes either order).  Only tensor and array
    payloads load."""
    with open(path, "rb") as f:
        data = _RestrictedUnpickler(f).load()
    return [t.detach().to("cpu", torch.float32) if isinstance(t, torch.Tensor)
            else torch.from_numpy(np.asarray(t, np.float32)) for t in data]
