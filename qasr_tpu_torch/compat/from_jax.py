"""Carry state from the JAX package into the port.

The JAX package keeps params, range state and frozen tables as numpy
pytrees on the host (or arrays convertible with ``np.asarray``); the port
takes the same host structures and puts frozen tables on a torch device
(``quantize.freeze.tables_to_numpy`` goes back).  This holds for both
model families: QuartzNet and Jasper (``tables_from_jax``: Jasper's dense
weights (K, Cin, Cout) gain Kernel 8's (Cout, K, Cin) layout, and a dense
residual block's panes stay a list, one requant entry and join a pane)
and the Conformer (``conformer_tables_from_jax``; its params and range
state carry over through ``state_from_jax`` too).  ``model_from_jax``
rebuilds a JAX package CTC, classification or speaker model as the port's,
its params whole: SqueezeExcite's fc1 / fc2, the classification head's
linear, the speaker head's embedding layers (linear + BN) and final layer.
``stream_state_from_jax`` carries a cache-aware Conformer stream's state
(``frozen_stream_init`` / ``frozen_stream_step``) across;
``rnnt_model_from_jax`` a transducer (``RNNTModel``) with its ranges and
frozen host tables; ``novograd_state_from_jax`` a training optimizer's
state (its leaves in optax's order).
Nothing here imports jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from qasr_tpu_torch.device import as_device
from qasr_tpu_torch.quantize.conformer_freeze import conformer_tables_to_device
from qasr_tpu_torch.quantize.freeze import tables_to_device


def state_from_jax(tree: Any) -> Any:
    """JAX params or range state -> the port's: a deep copy with every
    array leaf a numpy array; Python scalars, strings and numpy scalars
    keep their type."""
    if isinstance(tree, dict):
        return {k: state_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_jax(v) for v in tree)
    if isinstance(tree, (bool, int, float, str, np.generic)) or tree is None:
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


def stream_state_from_jax(state: Any, device=None) -> Any:
    """A JAX cache-aware stream state (per layer int8 ``k8``, ``v8``,
    ``glu8``; ``seen`` a 0-d int32) -> the port's on ``device`` (None: the
    CUDA device): the caches as torch int8 tensors, ``seen`` a Python
    int."""
    import torch

    dev = as_device(device)
    layers = [{k: torch.from_numpy(np.array(v, np.int8)).to(dev) for k, v in lc.items()}
              for lc in state["layers"]]
    return {"layers": layers, "seen": int(np.asarray(state["seen"]))}


def model_from_jax(jm: Any):
    """A JAX package model (``ASRModel``, ``EncDecClassificationModel`` or
    ``EncDecSpeakerLabelModel``) as the port's: the same config (through
    the YAML-shaped dict both packages read), its params (every leaf,
    numpy) and, for a CTC model, its range state, quantization knobs and
    folded flag."""
    import dataclasses

    from qasr_tpu_torch.models.classification import (
        EncDecClassificationModel,
        EncDecSpeakerLabelModel,
    )
    from qasr_tpu_torch.models.config import ModelConfig, QuantConfig, config_to_dict
    from qasr_tpu_torch.models.ctc_model import ASRModel

    cfg = ModelConfig.from_dict(config_to_dict(jm.cfg))
    kind = type(jm).__name__
    if kind == "EncDecClassificationModel":
        pm = EncDecClassificationModel.from_config(cfg, num_classes=jm.num_classes,
                                                   pooling=jm.pooling, labels=jm.labels)
    elif kind == "EncDecSpeakerLabelModel":
        sizes = tuple(int(np.shape(lp["linear"]["w"])[-1])
                      for lp in jm.params["decoder"]["emb_layers"])
        pm = EncDecSpeakerLabelModel.from_config(cfg, num_speakers=jm.num_speakers,
                                                 emb_sizes=sizes, pool_mode=jm.pool_mode,
                                                 angular=jm.angular)
    else:
        pm = ASRModel.from_config(cfg)
        pm.qstate = state_from_jax(jm.qstate)
        pm.qcfg = QuantConfig(**{f.name: getattr(jm.qcfg, f.name)
                                 for f in dataclasses.fields(QuantConfig)})
        pm.folded = bool(getattr(jm, "folded", False))
    pm.params = state_from_jax(jm.params)
    return pm


def rnnt_model_from_jax(jm: Any):
    """A JAX package ``RNNTModel`` (or ``EncDecRNNTBPEModel``) as the
    port's: the same config, encoder kind and transducer config, its params
    (encoder and 'rnnt', numpy), the encoder's quantization config and
    ranges, and the frozen encoder and decoder host tables (numpy; the
    JAX package's cached closures left behind).  The BPE model's tokenizer
    is read again from its file."""
    import dataclasses

    from qasr_tpu_torch.models.config import ModelConfig, config_to_dict
    from qasr_tpu_torch.models.rnnt import RNNTConfig
    from qasr_tpu_torch.models.rnnt_model import EncDecRNNTBPEModel, RNNTModel

    cfg = ModelConfig.from_dict(config_to_dict(jm.cfg))
    rnnt_cfg = RNNTConfig(**dataclasses.asdict(jm.rnnt_cfg))
    if jm.encoder_kind == "conformer":
        from qasr_tpu_torch.models.conformer import ConformerConfig

        pm = RNNTModel.conformer_transducer(cfg, ConformerConfig(**dataclasses.asdict(jm.plan)),
                                            rnnt_cfg=rnnt_cfg)
    else:
        pm = RNNTModel.from_config(cfg, rnnt_cfg=rnnt_cfg)
    pm.params = state_from_jax(jm.params)
    if jm.enc_qcfg is not None:
        from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig

        pm.enc_qcfg = ConformerQuantConfig(**dataclasses.asdict(jm.enc_qcfg))
        pm.enc_qstate = state_from_jax(jm.enc_qstate)

    def host(tables):
        if tables is None:
            return None
        return state_from_jax({k: v for k, v in tables.items() if not k.startswith("_")})

    pm.enc_frozen, pm.dec_frozen = host(jm.enc_frozen), host(jm.dec_frozen)
    tok = getattr(jm, "tokenizer", None)
    if tok is not None:
        from qasr_tpu_torch.data.tokenizers import BPETokenizer

        pm.__class__ = EncDecRNNTBPEModel
        pm.tokenizer = BPETokenizer(tok.path)
    return pm


def novograd_state_from_jax(opt_state: Any) -> list:
    """A JAX package optimizer state (``NovogradState(step, m, v)``, or the
    tuple ``optax.chain`` keeps, e.g. with a clip's empty state first) as
    its leaves in optax's order (numpy), what the port's optimizers'
    ``load_state_leaves`` (and ``Trainer.restore``) take.  Walks the
    named tuples, tuples, lists and dicts (keys sorted) without jax."""
    if isinstance(opt_state, dict):
        return [x for k in sorted(opt_state) for x in novograd_state_from_jax(opt_state[k])]
    if isinstance(opt_state, (list, tuple)):
        return [x for v in opt_state for x in novograd_state_from_jax(v)]
    if opt_state is None:
        return []
    return [np.asarray(opt_state)]
