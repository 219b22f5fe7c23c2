"""The latency floor of a launch (kernels/csrc/latency_floor.cu): an
empty kernel on the grid, block, cluster and dynamic shared memory of a
real launch, which chip_smoke.py times beside the cache forms of Kernels
3 and 4.  A measurement launch, on no serving path."""
from __future__ import annotations

from typing import Tuple

import torch

from qasr_tpu_torch.kernels import _build


def empty_launch(grid: Tuple[int, int, int], threads: int, cluster: int = 1, smem: int = 0,
                 device=None) -> None:
    """Launch the empty kernel on ``grid`` (x, y, z) blocks of ``threads``
    threads, in clusters of ``cluster`` blocks along x, with ``smem``
    bytes of dynamic shared memory a block, on the current stream."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"empty_launch: unsupported device {dev}")
    gx, gy, gz = (int(g) for g in grid)
    rc = _build.library().qasr_empty_launch(
        gx, gy, gz, int(threads), int(cluster), int(smem),
        torch._C._cuda_getCurrentRawStream(torch.cuda.current_device() if dev.index is None
                                           else dev.index))
    _build.check(rc, "empty_launch")
