"""Explicit device selection: the port never picks a device silently.
Also ``no_tf32``, the float32 precision its float regions run at."""
from __future__ import annotations

from contextlib import contextmanager

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


@contextmanager
def no_tf32():
    """float32 matmuls and convs in full float32 (TF32 off), the flags
    restored after: the float regions are held to the JAX package's
    float32 results."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
