"""The native ``.qasr`` model archive, array trees on disk and the
training checkpoints (port of qasr_tpu/utils/checkpoint.py).

A ``.qasr`` is a tar.gz of ``model_config.yaml`` (the model's config dict,
with the restore metadata under the reserved ``_qasr_meta`` key),
``arrays.npz`` (the params, and the range state if any, flattened) and
``artifacts/`` (tokenizer models, vocabularies).  Trees flatten to
'/'-joined keys with list indices as numbers (``params/encoder/blocks/0/
convs/1/w``), the JAX package's spelling, so archives written by either
package restore in the other.  The YAML goes through ``utils/yaml_io.py``
(no PyYAML).

A training checkpoint is one ``.npz``: ``params/...`` (the host params),
``opt/<i>`` (the optimizer state's leaves in optax's order: for Novograd
NovogradState(step, m, v)), ``step`` and optional ``qstate/...``, so a JAX
checkpoint resumes in the port and the port's in the JAX package.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tarfile
import tempfile
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from qasr_tpu_torch.utils.yaml_io import safe_dump, safe_load


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """A dict / list tree as {'a/0/b': array}; None leaves are dropped."""
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_into(template: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    """The arrays of ``flat`` in the structure of ``template``."""
    if isinstance(template, dict):
        return {k: unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        t = [unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
        return tuple(t) if isinstance(template, tuple) else t
    if template is None:
        return None
    return flat[prefix[:-1]]


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing; save and load agree on it."""
    return path if path.endswith(".npz") else path + ".npz"


def save_arrays(path: str, tree: Any) -> None:
    np.savez(_npz_path(path), **flatten_tree(tree))


def load_arrays(path: str, template: Any) -> Any:
    with np.load(_npz_path(path), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_into(template, flat)


def save_qasr(path: str, cfg_dict: Dict[str, Any], params: Any,
              qstate: Optional[Any] = None, meta: Optional[Dict[str, Any]] = None,
              artifacts: Optional[Dict[str, str]] = None) -> None:
    """Write a ``.qasr``: ``meta`` (e.g. {'folded': True, 'qcfg': {...}})
    goes under the config's '_qasr_meta' key, so restore can rebuild the
    model's state (a BN-folded tree has no BN leaves: its template must be
    folded too); ``artifacts`` maps archive names to the files packed under
    artifacts/.  gzip level 1, as ``save_nemo``'s."""
    cfg_dict = dict(cfg_dict)
    if meta:
        cfg_dict["_qasr_meta"] = meta
    tree = {"params": params}
    if qstate is not None:
        tree["qstate"] = qstate
    with tempfile.TemporaryDirectory() as td:
        cfg_path = os.path.join(td, "model_config.yaml")
        with open(cfg_path, "w", encoding="utf-8") as f:
            safe_dump(cfg_dict, f)
        np.savez(os.path.join(td, "arrays.npz"), **flatten_tree(tree))
        with tarfile.open(path, "w:gz", compresslevel=1) as tar:
            tar.add(cfg_path, arcname="model_config.yaml")
            tar.add(os.path.join(td, "arrays.npz"), arcname="arrays.npz")
            for arcname, src in (artifacts or {}).items():
                tar.add(src, arcname=f"artifacts/{arcname}")


def persist_artifacts(src_dir: str, names: Iterable[str]) -> Dict[str, str]:
    """Copy an unpacked archive's artifact files into a directory that
    outlives the unpacking (a restored model keeps their paths, e.g. its
    tokenizer's); the directory is removed at interpreter exit."""
    names = list(names)
    if not names:
        return {}
    keep = tempfile.mkdtemp(prefix="qasr_artifacts_")
    atexit.register(shutil.rmtree, keep, ignore_errors=True)
    out = {}
    for name in names:
        dst = os.path.join(keep, name)
        shutil.copy2(os.path.join(src_dir, name), dst)
        out[name] = dst
    return out


def extract_artifacts(td: str) -> Dict[str, str]:
    """The artifacts/ files of an unpacked ``.qasr``, persisted."""
    src = os.path.join(td, "artifacts")
    if not os.path.isdir(src):
        return {}
    return persist_artifacts(src, os.listdir(src))


def load_qasr(path: str) -> Tuple[Dict[str, Any], Dict[str, np.ndarray], Dict[str, str]]:
    """(the config dict, the flat arrays with 'params/...' and 'qstate/...'
    keys, the artifacts {name: extracted path}) of a ``.qasr``."""
    with tempfile.TemporaryDirectory() as td:
        with tarfile.open(path, "r:*") as tar:
            tar.extractall(td, filter="data")
        with open(os.path.join(td, "model_config.yaml"), encoding="utf-8") as f:
            cfg = safe_load(f)
        with np.load(os.path.join(td, "arrays.npz"), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
        artifacts = extract_artifacts(td)
    return cfg, flat, artifacts


# ---------------------------------------------------------------------------
# training checkpoints
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_training_ckpt(path: str, params: Any, opt_state: Any, step: int,
                       qstate: Optional[Any] = None) -> None:
    """``opt_state``: an optimizer with ``state_leaves()`` (train/optim.py)
    or the list of its leaves."""
    leaves = opt_state.state_leaves() if hasattr(opt_state, "state_leaves") else opt_state
    tree = {"params": params, "opt": [_host(x) for x in leaves], "step": np.asarray(step)}
    if qstate is not None:
        tree["qstate"] = qstate
    save_arrays(path, tree)


def load_training_ckpt(path: str, params_tpl: Any, opt_state_tpl: Any = None,
                       qstate_tpl: Optional[Any] = None):
    """(params in ``params_tpl``'s structure, the optimizer's state leaves
    (a list, in order; their count checked against ``opt_state_tpl``'s
    ``state_leaves()`` when given), the step, the range state or None)."""
    with np.load(_npz_path(path), allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    params = unflatten_into(params_tpl, flat, "params/")
    n = sum(1 for k in flat if k.startswith("opt/"))
    opt = [flat[f"opt/{i}"] for i in range(n)]
    if opt_state_tpl is not None and hasattr(opt_state_tpl, "state_leaves") \
            and len(opt_state_tpl.state_leaves()) != n:
        raise ValueError(f"{path}: {n} optimizer leaves, the optimizer has "
                         f"{len(opt_state_tpl.state_leaves())}")
    step = int(flat["step"])
    qstate = unflatten_into(qstate_tpl, flat, "qstate/") if qstate_tpl is not None else None
    return params, opt, step, qstate
