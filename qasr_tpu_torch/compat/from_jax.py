"""Carry state from the JAX package into the port.

The JAX package keeps params, range state and frozen tables as numpy
pytrees on the host (or arrays convertible with ``np.asarray``); the port
takes the same host structures and puts frozen tables on a torch device
(``quantize.freeze.tables_to_numpy`` goes back).  This holds for both
model families: QuartzNet and Jasper (``tables_from_jax``: Jasper's dense
weights (K, Cin, Cout) gain Kernel 8's (Cout, K, Cin) layout, and a dense
residual block's panes stay a list, one requant entry and join a pane)
and the Conformer (``conformer_tables_from_jax``; its params and range
state carry over through ``state_from_jax`` too).  Nothing here imports
jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.quantize.conformer_freeze import conformer_tables_to_device
from qasr_tpu_torch.quantize.freeze import tables_to_device


def state_from_jax(tree: Any) -> Any:
    """JAX params or range state -> the port's: a deep copy with every
    array leaf a numpy array; Python scalars and numpy scalars keep their
    type."""
    if isinstance(tree, dict):
        return {k: state_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v) for v in tree)
    if isinstance(tree, (bool, int, float, np.generic)) or tree is None:
        return tree
    return np.array(tree)


def tables_from_jax(tables: Any, device=None) -> Any:
    """JAX frozen tables -> the port's torch tables on ``device`` (None:
    the CUDA device); static exponents stay Python ints."""
    return tables_to_device(state_from_jax(tables), as_device(device))


def conformer_tables_from_jax(tables: Any, device=None) -> Any:
    """JAX frozen Conformer tables (``freeze_conformer``) -> the port's
    device tables on ``device`` (None: the CUDA device)."""
    return conformer_tables_to_device(state_from_jax(tables), as_device(device))
