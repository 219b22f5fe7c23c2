"""The flagship models and the golden checks of the port's frozen paths.

QuartzNet.  The golden records hold what the JAX package's FrozenExec
computes for full-width QuartzNet15x5 at W6A6 (random weights from seed
0, the committed noise-calibrated ranges) on seeded float features: a
digest of the tables, the ids and encoder lengths, and SHA-256s of the
decoder's int8 input and int32 logits; one record per dyadic mode,
``assets/quartznet15x5_w6a6_s0_golden.json`` for ``static_e`` and
``assets/quartznet15x5_w6a6_per_channel_s0_golden.json`` for
``per_channel`` (vector exponents).  ``experiments/torch_golden.py``
writes them with the JAX package; the port is held to them without
importing jax.  Starting from features keeps float frontend differences
out of an exact check.

Conformer-CTC.  ``assets/conformer16x256_noise_qstate_w8a8_s0.json`` holds
the quantization config and ranges of the flagship (16 x 256, 4 heads,
striding subsampling x4, conv kernel 31, 80 mels, W8A8, every integer
flag), calibrated by the JAX package on 4 x 15 s of seed-0 noise.  The
golden record (``conformer16x256_w8a8_s0_golden.json`` + ``.npz``) holds
what the JAX package computes on seeded float features (B=2, 160 frames,
unequal lengths): the table digest, the quantized subsampler output x8,
the SHA-256 of the float encodings, encoder lengths, greedy ids and
log-probs.  ``experiments/torch_conformer_golden.py`` writes both.  The
port's float32 subsampler may flip a few x8 codes against XLA's, so the
check has two parts: (a) the port's x8 differs from the golden one in at
most 0.1% of codes, each by +-1; (b) the port's integer stack, run from
the golden x8, reproduces the encodings' hash, the lengths and the ids
exactly, and the log-probs within 1e-4.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from qasr_tpu_torch.models.config import DecoderConfig, EncoderConfig, ModelConfig
from qasr_tpu_torch.models.conformer import ConformerConfig
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
from qasr_tpu_torch.models.ctc_model import ASRModel, frozen_forward
from qasr_tpu_torch.quantize.conformer_freeze import (
    DEFAULT_PLAN,
    ConformerPlan,
    conformer_encode,
    conformer_tables_digest,
    conformer_x8,
)
from qasr_tpu_torch.quantize.freeze import (
    FrozenExec,
    FrozenExecFused,
    log_probs,
    tables_digest,
    tables_to_numpy,
)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
GOLDEN_PATHS = {
    "static_e": os.path.join(ASSETS, "quartznet15x5_w6a6_s0_golden.json"),
    "per_channel": os.path.join(ASSETS, "quartznet15x5_w6a6_per_channel_s0_golden.json"),
}
# a byte-for-byte copy of the JAX package's committed noise-calibrated ranges
QSTATE_PATH = os.path.join(ASSETS, "quartznet15x5_noise_qstate_w6a6_s0.json")
# seeded float features: B=2, T a multiple of 64, unequal lengths
FEATURE_SEED, FEATURE_T, FEATURE_LENS = 1234, 320, (320, 251)


def quartznet15x5_w6a6(seed: int = 0) -> ASRModel:
    """QuartzNet15x5 at full width, W6A6, BN-folded, with the committed
    noise-calibrated ranges: the model bench.py and entry() serve."""
    model = ASRModel.from_pretrained("QuartzNet15x5Base-En", seed=seed,
                                     allow_random_weights=True)
    model.set_quant_bit(6, "weight")
    model.set_quant_bit(6, "act")
    model.bn_folding()
    with open(QSTATE_PATH) as f:
        model.qstate_from_json(f.read())
    return model


def golden_features(feat_in: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """(features (2, 320, feat_in) float32, lengths (2,) int32)."""
    rng = np.random.default_rng(FEATURE_SEED)
    feats = rng.normal(size=(len(FEATURE_LENS), FEATURE_T, feat_in)).astype(np.float32)
    return feats, np.asarray(FEATURE_LENS, np.int32)


def array_sha256(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}:{a.shape}:".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def golden_record(tables_sha256: str, dec_in: np.ndarray, logits: np.ndarray,
                  ids: np.ndarray, enc_lens: np.ndarray) -> Dict[str, Any]:
    return {
        "tables_sha256": tables_sha256,
        "decoder_input_int8_sha256": array_sha256(np.asarray(dec_in, np.int8)),
        "logits_int32_sha256": array_sha256(np.asarray(logits, np.int32)),
        "ids": np.asarray(ids).astype(int).tolist(),
        "enc_lens": np.asarray(enc_lens).astype(int).tolist(),
    }


@torch.no_grad()
def frozen_from_features(model: ASRModel, tables, feats: np.ndarray,
                         lens: np.ndarray, fused: bool = True, executor=None):
    """Run float features through the frozen encoder and decoder on the
    tables' device: (decoder int8 input, int32 logits, ids, enc_lens).
    ``executor`` is the executor class; None means FrozenExecFused when
    ``fused`` (it refuses vector exponents), else the plain FrozenExec."""
    dev = tables["decoder"]["w"].device
    dec_in, logits, enc_lens = frozen_forward(
        model, tables, torch.from_numpy(feats).to(dev), torch.from_numpy(lens).to(dev),
        executor=executor or (FrozenExecFused if fused else FrozenExec))
    ids = log_probs(logits, tables["decoder"]["out_scale"]).argmax(dim=-1)
    return dec_in, logits, ids, enc_lens


def port_record(model: ASRModel, tables, feats, lens, fused: bool = True,
                executor=None):
    """The golden record of the port's run (tables from ``tables``)."""
    outs = [t.cpu().numpy() for t in frozen_from_features(model, tables, feats,
                                                           lens, fused, executor)]
    return golden_record(tables_digest(tables_to_numpy(tables)), *outs)


def load_golden(dyadic_mode: str = "static_e") -> Dict[str, Any]:
    """The committed QuartzNet golden record of this dyadic mode."""
    if dyadic_mode not in GOLDEN_PATHS:
        raise ValueError(f"no QuartzNet golden record for dyadic_mode {dyadic_mode!r} "
                         f"(have {sorted(GOLDEN_PATHS)})")
    with open(GOLDEN_PATHS[dyadic_mode]) as f:
        return json.load(f)


def compare_golden(got: Dict[str, Any], want: Dict[str, Any]) -> list:
    """Names of the golden fields that differ (empty when all match)."""
    return [k for k in ("tables_sha256", "decoder_input_int8_sha256",
                        "logits_int32_sha256", "ids", "enc_lens")
            if got.get(k) != want.get(k)]


# ---------------------------------------------------------------------------
# Conformer-CTC
# ---------------------------------------------------------------------------

CONF_QSTATE_PATH = os.path.join(ASSETS, "conformer16x256_noise_qstate_w8a8_s0.json")
CONF_GOLDEN_PATH = os.path.join(ASSETS, "conformer16x256_w8a8_s0_golden.json")
CONF_GOLDEN_NPZ = os.path.join(ASSETS, "conformer16x256_w8a8_s0_golden.npz")
CONF_LABELS = tuple(" abcdefghijklmnopqrstuvwxyz'")
CONF_FEATURE_SEED, CONF_FEATURE_T, CONF_FEATURE_LENS = 4321, 160, (160, 121)
# tolerances of the Conformer golden check
X8_FLIP_SHARE, LOGPROB_ATOL = 1e-3, 1e-4


def conformer_flagship_configs(layers: int = 16, d_model: int = 256):
    """(ModelConfig, ConformerConfig) of bench.py's Conformer leg."""
    cfg = ModelConfig(encoder=EncoderConfig(feat_in=80, blocks=()),
                      decoder=DecoderConfig(feat_in=d_model, num_classes=len(CONF_LABELS)),
                      labels=CONF_LABELS, preprocessor={"features": 80, "dither": 0.0})
    ccfg = ConformerConfig(feat_in=80, n_layers=layers, d_model=d_model, n_heads=4,
                           subsampling="striding", subsampling_factor=4,
                           subsampling_conv_channels=d_model, conv_kernel_size=31,
                           dropout=0.0)
    return cfg, ccfg


def conformer16x256_w8a8(seed: int = 0) -> ConformerCTC:
    """The flagship Conformer-CTC with the committed calibrated ranges: it
    runs the PTQ forward until ``freeze(device)``, which serving callers
    call first."""
    model = ConformerCTC.from_config(*conformer_flagship_configs(), seed=seed)
    with open(CONF_QSTATE_PATH) as f:
        model.qstate_from_json(f.read())
    return model


def conformer_golden_features(feat_in: int = 80) -> Tuple[np.ndarray, np.ndarray]:
    """(features (2, 160, feat_in) float32, lengths (2,) int32)."""
    rng = np.random.default_rng(CONF_FEATURE_SEED)
    feats = rng.normal(size=(len(CONF_FEATURE_LENS), CONF_FEATURE_T, feat_in))
    return feats.astype(np.float32), np.asarray(CONF_FEATURE_LENS, np.int32)


def conformer_record(tables_sha256: str, x8: np.ndarray, enc: np.ndarray,
                     enc_lens: np.ndarray, lp: np.ndarray) -> Dict[str, Any]:
    """The JSON part of a Conformer golden record (x8 and the log-probs go
    to the .npz)."""
    return {"tables_sha256": tables_sha256,
            "x8_sha256": array_sha256(np.asarray(x8, np.int8)),
            "encodings_f32_sha256": array_sha256(np.asarray(enc, np.float32)),
            "enc_lens": np.asarray(enc_lens).astype(int).tolist(),
            "ids": np.asarray(lp).argmax(-1).astype(int).tolist()}


def load_conformer_golden():
    """(record dict, x8 int8 array, log-probs float32 array)."""
    with open(CONF_GOLDEN_PATH) as f:
        rec = json.load(f)
    with np.load(CONF_GOLDEN_NPZ) as z:
        return rec, z["x8"], z["log_probs"]


@torch.no_grad()
def check_conformer_golden(model: ConformerCTC, tables, kernels: bool = True,
                           plan: ConformerPlan = DEFAULT_PLAN) -> Dict[str, Any]:
    """Hold the port's frozen Conformer (tables from ``model.freeze``) to
    the golden record on the tables' device, its encoder run with
    ``kernels`` under ``plan``.  Every plan is
    bit-identical to the JAX package's XLA composition, so one record holds
    them all.  Returns the numbers of the check and the list of failures
    under "bad" (empty when it passes)."""
    rec, gx8, glp = load_conformer_golden()
    enc_t = tables["encoder"]
    dev = enc_t["device"]
    bad = []
    if conformer_tables_digest(enc_t) != rec["tables_sha256"]:
        bad.append("tables_sha256")
    feats, lens = conformer_golden_features(model.ccfg.feat_in)
    x8, sub_lens = conformer_x8(enc_t, model.ccfg, torch.from_numpy(feats).to(dev),
                                torch.from_numpy(lens).to(dev))
    x8 = x8.cpu().numpy()
    diff = np.abs(x8.astype(np.int32) - gx8.astype(np.int32)) if x8.shape == gx8.shape \
        else None
    flips = float((diff != 0).mean()) if diff is not None else 1.0
    if diff is None or flips > X8_FLIP_SHARE or diff.max() > 1:
        bad.append("x8")
    enc, enc_lens = conformer_encode(enc_t, model.ccfg, torch.from_numpy(gx8).to(dev),
                                     sub_lens, kernels=kernels, plan=plan)
    lp = model.head(tables, enc).cpu().numpy()
    got = conformer_record(rec["tables_sha256"], gx8, enc.cpu().numpy(),
                           enc_lens.cpu().numpy(), lp)
    bad += [k for k in ("encodings_f32_sha256", "enc_lens", "ids") if got[k] != rec[k]]
    lp_err = float(np.abs(lp - glp).max()) if lp.shape == glp.shape else float("inf")
    if lp_err > LOGPROB_ATOL:
        bad.append("log_probs")
    return {"bad": bad, "x8_flips": int((diff != 0).sum()) if diff is not None else -1,
            "x8_size": int(gx8.size), "x8_max_diff": int(diff.max()) if diff is not None else -1,
            "log_prob_max_err": lp_err, "enc_lens": rec["enc_lens"]}
