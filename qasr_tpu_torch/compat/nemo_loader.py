""".nemo checkpoints both ways (port of qasr_tpu/compat/nemo_loader.py).

NeMo stores a model as a tar.gz of ``model_config.yaml``,
``model_weights.ckpt`` (a torch state dict) and artifacts at the archive
root (tokenizer models, vocabularies).  This module maps that state dict
to and from the port's numpy parameter trees, key for key as the JAX
package does, so NGC's QuartzNet / Jasper checkpoints load and a ``.nemo``
written by either package restores in the other.

The state dict's layout (NeMo 1.0's module tree):
  encoder.encoder.{block}.mconv.{i}.conv.weight      MaskedConv1d's Conv1d
  encoder.encoder.{block}.mconv.{i}.{weight,bias,running_mean,running_var}
                                                     BatchNorm1d
  encoder.encoder.{block}.res.{pane}.{0,1}....       residual conv + BN
  decoder.decoder_layers.0.{weight,bias}             the 1x1 decoder conv
mconv indices advance by [conv (+ conv), bn, act, dropout] a repeat: a
separable repeat takes 5 slots, a plain one 4, and the block's last repeat
has no act or dropout.
"""
from __future__ import annotations

import os
import tarfile
import tempfile
from typing import Any, Dict, Tuple

import numpy as np
import torch

from qasr_tpu_torch.models.config import ModelConfig
from qasr_tpu_torch.models.jasper import EncoderPlan, build_encoder_plan
from qasr_tpu_torch.utils.checkpoint import persist_artifacts
from qasr_tpu_torch.utils.yaml_io import safe_dump, safe_load

_RESERVED_NEMO = {"model_config.yaml", "model_weights.ckpt"}


def block_slot_map(bp) -> Dict[int, Tuple[int, int]]:
    """conv index in the block -> (mconv index of the conv, mconv index of
    its BN or -1)."""
    mapping: Dict[int, Tuple[int, int]] = {}
    idx = ci = 0
    n = len(bp.convs)
    while ci < n:
        spec = bp.convs[ci]
        if not spec.has_bn and ci + 1 < n and bp.convs[ci + 1].kernel == 1 \
                and bp.convs[ci + 1].has_bn and spec.groups == spec.in_ch:
            # a separable pair: depthwise at idx, pointwise at idx+1, BN at idx+2
            mapping[ci] = (idx, -1)
            mapping[ci + 1] = (idx + 1, idx + 2)
            idx += 3 + (0 if ci + 1 == n - 1 else 2)
            ci += 2
        else:
            mapping[ci] = (idx, idx + 1)
            idx += 2 + (0 if ci == n - 1 else 2)
            ci += 1
    return mapping


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def _conv_w(sd, key) -> np.ndarray:
    """A torch conv weight (Cout, Cin/g, K) as the port's (K, Cin/g, Cout)."""
    return np.ascontiguousarray(_np(sd[key]).transpose(2, 1, 0))


def _bn(sd, prefix) -> Dict[str, np.ndarray]:
    return {"gamma": _np(sd[prefix + ".weight"]), "beta": _np(sd[prefix + ".bias"]),
            "mean": _np(sd[prefix + ".running_mean"]), "var": _np(sd[prefix + ".running_var"])}


def encoder_params_from_state_dict(plan: EncoderPlan, sd: Dict[str, Any]) -> Dict[str, Any]:
    """The ``encoder.*`` keys as the encoder's params; a missing weight
    raises KeyError (load_state_dict's strict check)."""
    blocks = []
    for bp in plan.blocks:
        slots = block_slot_map(bp)
        convs = []
        for ci, spec in enumerate(bp.convs):
            mi, bni = slots[ci]
            base = f"encoder.encoder.{bp.index}.mconv.{mi}"
            p = {"w": _conv_w(sd, base + ".conv.weight")}
            if base + ".conv.bias" in sd:
                p["b"] = _np(sd[base + ".conv.bias"])
            if spec.has_bn:
                p["bn"] = _bn(sd, f"encoder.encoder.{bp.index}.mconv.{bni}")
            convs.append(p)
        res = [{"w": _conv_w(sd, f"encoder.encoder.{bp.index}.res.{pi}.0.conv.weight"),
                "bn": _bn(sd, f"encoder.encoder.{bp.index}.res.{pi}.1")}
               for pi in range(len(bp.res))]
        blocks.append({"convs": convs, "res": res})
    return {"blocks": blocks}


def params_from_state_dict(plan: EncoderPlan, sd: Dict[str, Any]) -> Dict[str, Any]:
    return {"encoder": encoder_params_from_state_dict(plan, sd),
            "decoder": {"w": _conv_w(sd, "decoder.decoder_layers.0.weight"),
                        "b": _np(sd["decoder.decoder_layers.0.bias"])}}


def state_dict_from_params(plan: EncoderPlan, params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The params as NeMo's state dict, in its float key layout."""
    sd: Dict[str, torch.Tensor] = {}

    def put_w(base, w, b=None):
        sd[base + ".weight"] = torch.from_numpy(np.asarray(w).transpose(2, 1, 0).copy())
        if b is not None:
            sd[base + ".bias"] = torch.from_numpy(np.asarray(b).copy())

    def put_bn(prefix, bnp):
        for key, name in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                          ("running_var", "var")):
            sd[f"{prefix}.{key}"] = torch.from_numpy(np.asarray(bnp[name]).copy())
        sd[prefix + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long)

    for bp, bparams in zip(plan.blocks, params["encoder"]["blocks"]):
        slots = block_slot_map(bp)
        for ci, spec in enumerate(bp.convs):
            mi, bni = slots[ci]
            conv = bparams["convs"][ci]
            put_w(f"encoder.encoder.{bp.index}.mconv.{mi}.conv", conv["w"], conv.get("b"))
            if spec.has_bn and "bn" in conv:
                put_bn(f"encoder.encoder.{bp.index}.mconv.{bni}", conv["bn"])
        for pi in range(len(bp.res)):
            base = f"encoder.encoder.{bp.index}.res.{pi}"
            put_w(base + ".0.conv", bparams["res"][pi]["w"])
            if "bn" in bparams["res"][pi]:
                put_bn(base + ".1", bparams["res"][pi]["bn"])
    put_w("decoder.decoder_layers.0", params["decoder"]["w"], params["decoder"]["b"])
    return sd


def load_nemo(path: str) -> Tuple[ModelConfig, Dict[str, Any], Dict[str, str]]:
    """(config, params, artifacts {name: path}) of a ``.nemo``: the other
    root files are artifacts, copied to a directory that outlives the
    unpacking.  The weights load with ``weights_only=True`` (a .nemo is a
    file users exchange: no pickled code runs)."""
    with tempfile.TemporaryDirectory() as td:
        with tarfile.open(path, "r:*") as tar:
            tar.extractall(td, filter="data")
        with open(os.path.join(td, "model_config.yaml"), encoding="utf-8") as f:
            cfg = ModelConfig.from_dict(safe_load(f))
        sd = torch.load(os.path.join(td, "model_weights.ckpt"), map_location="cpu",
                        weights_only=True)
        extra = [n for n in os.listdir(td)
                 if n not in _RESERVED_NEMO and os.path.isfile(os.path.join(td, n))]
        artifacts = persist_artifacts(td, extra)
    return cfg, params_from_state_dict(build_encoder_plan(cfg.encoder), sd), artifacts


def save_nemo(path: str, cfg_dict: Dict[str, Any], plan: EncoderPlan, params: Dict[str, Any],
              artifacts: Dict[str, str] = None) -> None:
    """Write a NeMo-layout ``.nemo``; artifacts ({arcname: source path})
    sit at the archive root.  gzip level 1: float weights barely compress,
    and level 1 writes several times faster than the default 9."""
    sd = state_dict_from_params(plan, params)
    with tempfile.TemporaryDirectory() as td:
        cfg_path = os.path.join(td, "model_config.yaml")
        with open(cfg_path, "w", encoding="utf-8") as f:
            safe_dump(cfg_dict, f)
        torch.save(sd, os.path.join(td, "model_weights.ckpt"))
        with tarfile.open(path, "w:gz", compresslevel=1) as tar:
            tar.add(cfg_path, arcname="model_config.yaml")
            tar.add(os.path.join(td, "model_weights.ckpt"), arcname="model_weights.ckpt")
            for arcname, src in (artifacts or {}).items():
                if arcname in _RESERVED_NEMO:
                    raise ValueError(f"artifact name {arcname!r} is reserved")
                tar.add(src, arcname=arcname)
