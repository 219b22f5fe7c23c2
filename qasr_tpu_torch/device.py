"""Explicit device selection: the port never picks a device silently."""
from __future__ import annotations

import torch


def require_cuda(index: int = 0) -> torch.device:
    """The CUDA device ``index``; raises when no GPU is visible (there is
    no quiet fall back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("qasr_tpu_torch: CUDA is not available "
                           "(no GPU visible to this process)")
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"qasr_tpu_torch: no CUDA device {index} "
                           f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def as_device(device) -> torch.device:
    """Normalize a device spec.  ``None`` means the CUDA device, which must
    exist (``require_cuda`` raises otherwise); the CPU is used only when
    asked for by name."""
    if device is None:
        return require_cuda(0)
    dev = torch.device(device)
    if dev.type == "cuda":
        return require_cuda(dev.index or 0)
    return dev
