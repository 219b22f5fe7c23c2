"""The flagship models and the golden checks of the port's frozen paths.

QuartzNet and Jasper.  The golden records hold what the JAX package's
FrozenExec computes for a full-width model (random weights from seed 0,
ranges from the JAX package's seed-0 noise recipe) on seeded float
features: a digest of the tables, the ids and encoder lengths, and
SHA-256s of the decoder's int8 input and int32 logits.  ``RECORDS`` names
them by (model, bits, dyadic mode): QuartzNet15x5 at W6A6 and W8A8 in
``static_e`` and ``per_channel`` (vector exponents), Jasper10x5Dr at W6A6
and W8A8 in ``static_e`` (its features shorter: a Jasper forward is ~25
times QuartzNet's work), QuartzNet15x5-g4 (groups 4 on B1-B15, GroupShuffle
after each grouped conv) at W6A6 in both modes and QuartzNet15x5 with
hardtanh at W6A6 ``static_e``; ``QSTATES`` names the ranges (W6A6
QuartzNet's is a byte-for-byte copy of the JAX package's asset).
``experiments/torch_golden.py`` writes them with the JAX package; the
port is held to them without importing jax.  Starting from features
keeps float frontend differences out of an exact check.

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

Conformer-Transducer.  ``rnnt_conformer16x256_w8a8`` builds the CTC
flagship's encoder config with the transducer head at its defaults (seed
0, its own committed ranges, the out bias nudged); its record (written
by the same script with ``--model rnnt``) starts from seeded audio and
holds the two decoder ranges, the subsampler's x8, the encoder frames,
their enc8 codes and the frozen decoder's ids.  ``check_rnnt_golden``
holds the ids exactly from the record's frames and x8; the float front
from audio is held at the x8 tolerance above.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from qasr_tpu_torch.models.config import (
    DecoderConfig,
    EncoderConfig,
    ModelConfig,
    jasper10x5dr,
    quartznet15x5,
    quartznet15x5_g4,
    quartznet15x5_hardtanh,
)
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
# the flagship CTC models: name -> (config factory, JAX package model card;
# None: a variant the JAX package builds from the same config)
FLAGSHIPS = {"quartznet15x5": (quartznet15x5, "QuartzNet15x5Base-En"),
             "jasper10x5dr": (jasper10x5dr, "Jasper10x5Dr-En"),
             "quartznet15x5_g4": (quartznet15x5_g4, None),
             "quartznet15x5_hardtanh": (quartznet15x5_hardtanh, None)}
# golden records by (model, weight and act bits, dyadic mode)
RECORDS = {
    ("quartznet15x5", 6, "static_e"): "quartznet15x5_w6a6_s0_golden.json",
    ("quartznet15x5", 6, "per_channel"): "quartznet15x5_w6a6_per_channel_s0_golden.json",
    ("quartznet15x5", 8, "static_e"): "quartznet15x5_w8a8_s0_golden.json",
    ("quartznet15x5", 8, "per_channel"): "quartznet15x5_w8a8_per_channel_s0_golden.json",
    ("jasper10x5dr", 6, "static_e"): "jasper10x5dr_w6a6_s0_golden.json",
    ("jasper10x5dr", 8, "static_e"): "jasper10x5dr_w8a8_s0_golden.json",
    ("quartznet15x5_g4", 6, "static_e"): "quartznet15x5_g4_w6a6_s0_golden.json",
    ("quartznet15x5_g4", 6, "per_channel"): "quartznet15x5_g4_w6a6_per_channel_s0_golden.json",
    ("quartznet15x5_hardtanh", 6, "static_e"): "quartznet15x5_hardtanh_w6a6_s0_golden.json",
}
# ranges by (model, bits): calibrate_on_noise(2, 2, 4 s, seed 0) in the JAX
# package; W6A6 QuartzNet's is a byte-for-byte copy of its committed asset
QSTATES = {("quartznet15x5", 6): "quartznet15x5_noise_qstate_w6a6_s0.json",
           ("quartznet15x5", 8): "quartznet15x5_noise_qstate_w8a8_s0.json",
           ("jasper10x5dr", 6): "jasper10x5dr_noise_qstate_w6a6_s0.json",
           ("jasper10x5dr", 8): "jasper10x5dr_noise_qstate_w8a8_s0.json",
           ("quartznet15x5_g4", 6): "quartznet15x5_g4_noise_qstate_w6a6_s0.json",
           ("quartznet15x5_hardtanh", 6): "quartznet15x5_hardtanh_noise_qstate_w6a6_s0.json"}
QSTATE_PATH = os.path.join(ASSETS, QSTATES["quartznet15x5", 6])
# seeded float features: B=2, unequal lengths; QuartzNet's T a multiple of
# 64, Jasper's padded to one
FEATURE_SEED, FEATURE_T, FEATURE_LENS = 1234, 320, (320, 251)
JASPER_FEATURE_T, JASPER_FEATURE_LENS = 160, (160, 121)


def flagship(name: str = "quartznet15x5", bits: int = 6, seed: int = 0,
             ranges: bool = True) -> ASRModel:
    """A flagship CTC model at full width, W<bits>A<bits>, BN-folded, with
    its committed noise-calibrated ranges (``ranges``)."""
    model = ASRModel.from_config(FLAGSHIPS[name][0](), seed=seed)
    model.set_quant_bit(bits, "weight")
    model.set_quant_bit(bits, "act")
    model.bn_folding()
    if ranges:
        with open(os.path.join(ASSETS, QSTATES[name, bits])) as f:
            model.qstate_from_json(f.read())
    return model


def quartznet15x5_w6a6(seed: int = 0) -> ASRModel:
    """QuartzNet15x5 at full width, W6A6, BN-folded, with the committed
    noise-calibrated ranges: the model bench.py and entry() serve."""
    return flagship("quartznet15x5", 6, seed)


def golden_features(feat_in: int = 64, name: str = "quartznet15x5"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(features (2, T, feat_in) float32, lengths (2,) int32): T 320 for
    QuartzNet, 160 for Jasper."""
    t, lens = ((JASPER_FEATURE_T, JASPER_FEATURE_LENS) if name == "jasper10x5dr"
               else (FEATURE_T, FEATURE_LENS))
    rng = np.random.default_rng(FEATURE_SEED)
    feats = rng.normal(size=(len(lens), t, feat_in)).astype(np.float32)
    return feats, np.asarray(lens, np.int32)


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


def load_golden(dyadic_mode: str = "static_e", name: str = "quartznet15x5",
                bits: int = 6) -> Dict[str, Any]:
    """The committed golden record of this model, bit width and dyadic
    mode (by default W6A6 QuartzNet15x5's)."""
    key = (name, bits, dyadic_mode)
    if key not in RECORDS:
        raise ValueError(f"no golden record for {key} (have {sorted(RECORDS)})")
    with open(os.path.join(ASSETS, RECORDS[key])) as f:
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
# the Conformer-Transducer flagship (the same encoder config, seed 0, whose
# encoder draws differ from the CTC flagship's: ranges of its own); its
# golden record starts from audio: 2 utterances of seeded noise
RNNT_QSTATE_PATH = os.path.join(ASSETS, "rnnt_conformer16x256_noise_qstate_w8a8_s0.json")
RNNT_GOLDEN_PATH = os.path.join(ASSETS, "rnnt_conformer16x256_w8a8_s0_golden.json")
RNNT_GOLDEN_NPZ = os.path.join(ASSETS, "rnnt_conformer16x256_w8a8_s0_golden.npz")
RNNT_AUDIO_SEED, RNNT_AUDIO_LENS = 16, (64000, 56000)
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


def rnnt_golden_audio() -> Tuple[np.ndarray, np.ndarray]:
    """(audio (2, 64000) float32 noise at 0.1 rms, the second zero past its
    length; lengths (2,) int32): the transducer record's input."""
    rng = np.random.default_rng(RNNT_AUDIO_SEED)
    n = max(RNNT_AUDIO_LENS)
    audio = np.zeros((len(RNNT_AUDIO_LENS), n), np.float32)
    for i, k in enumerate(RNNT_AUDIO_LENS):
        audio[i, :k] = (rng.normal(size=k) * 0.1).astype(np.float32)
    return audio, np.asarray(RNNT_AUDIO_LENS, np.int32)


def nudged_out_bias(b, blank_id: int, seed: int = 0, blank_bias: float = 0.0) -> np.ndarray:
    """The joint's out bias with uniform(0.5, 1.5) added to every non-blank
    entry (``default_rng(seed)``), as the JAX package's streaming
    transducer tests do, and ``blank_bias`` added to the blank's.  The
    flagship's seed-0 head emits the cap of symbols at every frame with
    ``blank_bias`` 0 (so does its un-nudged head); +2.0 makes blank end
    most frames, as a trained head's does."""
    b = np.asarray(b, np.float32).copy()
    b[:blank_id] += np.random.default_rng(seed).uniform(0.5, 1.5, size=b.size - 1)
    b[blank_id] += np.float32(blank_bias)
    return b


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

# ---------------------------------------------------------------------------
# the Conformer-Transducer
# ---------------------------------------------------------------------------


def load_rnnt_golden():
    """(record dict, encoder frames (2, T', 256) float32, their enc8 codes
    int8, the subsampler's quantized output x8 int8)."""
    with open(RNNT_GOLDEN_PATH) as f:
        rec = json.load(f)
    with np.load(RNNT_GOLDEN_NPZ) as z:
        return rec, z["enc"], z["enc8"], z["x8"]


def rnnt_conformer16x256_w8a8(seed: int = 0, frozen: bool = True, blank_bias: float = 0.0,
                              **ccfg_changes):
    """The flagship Conformer-Transducer: the CTC flagship's encoder config
    (``ccfg_changes`` replace fields, e.g. a streaming att_context_size),
    the transducer head at its defaults (prediction network and joint 320
    wide, one LSTM layer), seed 0, the joint's out bias nudged
    (``nudged_out_bias`` with ``blank_bias``; the golden record's is 0),
    the committed encoder ranges and, with ``frozen``, the encoder frozen
    and the decoder frozen from the golden record's two ranges (host
    tables equal to the JAX package's; a head with another
    ``blank_bias`` is not calibrated again)."""
    import dataclasses

    from qasr_tpu_torch.models.rnnt_model import RNNTModel
    from qasr_tpu_torch.quantize.rnnt_freeze import freeze_rnnt_decoder

    cfg, ccfg = conformer_flagship_configs()
    model = RNNTModel.conformer_transducer(cfg, dataclasses.replace(ccfg, **ccfg_changes),
                                           seed=seed)
    out = model.params["rnnt"]["joint"]["out"]
    out["b"] = nudged_out_bias(out["b"], model.rnnt_cfg.blank_id, blank_bias=blank_bias)
    with open(RNNT_QSTATE_PATH) as f:
        d = json.load(f)
    from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig

    model.enc_qcfg = ConformerQuantConfig(**d["qcfg"])
    model.enc_qstate = _qstate_from_json(d["qstate"])
    if frozen:
        model.freeze_encoder()
        enc_range, joint_range = load_rnnt_golden()[0]["ranges"]
        model.dec_frozen = freeze_rnnt_decoder(model.params["rnnt"], model.rnnt_cfg,
                                               enc_range=enc_range, joint_range=joint_range)
    return model


def _qstate_from_json(t):
    if isinstance(t, dict):
        return {k: _qstate_from_json(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_qstate_from_json(v) for v in t]
    return np.float32(t)


@torch.no_grad()
def check_rnnt_golden(model, device, audio: bool = True) -> Dict[str, Any]:
    """Hold the frozen transducer (``rnnt_conformer16x256_w8a8()``) to its
    golden record on ``device``: the host tables' digests, then
    (a) the integer decoder fed the record's encoder frames gives the
    record's ids;
    (b) the integer encoder run from the record's x8 (Kernels 3-6 on a
    CUDA device) gives the record's frames bit for bit (their hash; so
    (a)'s ids) and their enc8 codes;
    (c) with ``audio``, from the record's audio, the float frontend and
    subsampler give an x8 within 0.1% of codes at +-1 of the record's (as
    the CTC record's check).  The random-weight 16-layer encoder carries such a flip into
    most frames (7 flips of 1,001,984 codes moved 81% of the enc8 codes on
    the CPU), so the audio path's enc8 codes and ids are counted and
    compared, not gated.
    Returns the numbers and the failures under "bad"."""
    from qasr_tpu_torch.quantize.conformer_freeze import (
        conformer_encode,
        conformer_tables_digest,
        conformer_x8,
    )
    from qasr_tpu_torch.quantize.rnnt_freeze import (
        decoder_tables_digest,
        greedy_decode_frozen,
        quantize_frame,
    )

    rec, genc, genc8, gx8 = load_rnnt_golden()
    dev = torch.device(device)
    enc_t = model.encoder_tables(dev)
    bad = []
    if conformer_tables_digest(enc_t) != rec["encoder_tables_sha256"]:
        bad.append("encoder_tables_sha256")
    if decoder_tables_digest(model.dec_frozen) != rec["decoder_tables_sha256"]:
        bad.append("decoder_tables_sha256")
    tables = model.decoder_tables(dev)
    lens = torch.tensor(rec["enc_lens"], dtype=torch.int32, device=dev)
    if greedy_decode_frozen(tables, model.rnnt_cfg, torch.from_numpy(genc).to(dev),
                            lens) != rec["ids"]:
        bad.append("ids from the record's frames")
    enc, enc_lens = conformer_encode(enc_t, model.ccfg, torch.from_numpy(gx8).to(dev), lens)
    if array_sha256(enc.cpu().numpy().astype(np.float32)) != rec["encodings_f32_sha256"]:
        bad.append("encodings from x8")
    if array_sha256(quantize_frame(tables, enc).cpu().numpy()) != rec["enc8_sha256"]:
        bad.append("enc8 from x8")
    if enc_lens.cpu().numpy().tolist() != rec["enc_lens"]:
        bad.append("enc_lens from x8")
    res = {"bad": bad, "x8_size": int(gx8.size), "enc8_size": int(genc8.size),
           "symbols": [len(h) for h in rec["ids"]]}
    if not audio:
        return res
    audio, alens = rnnt_golden_audio()
    a = torch.from_numpy(audio).to(dev)
    feats, feat_lens = model.frontend(a, torch.from_numpy(alens).to(dev), dither=0.0)
    x8, _ = conformer_x8(enc_t, model.ccfg, feats, feat_lens)
    x8 = x8.cpu().numpy().astype(np.int32)
    diff = np.abs(x8 - gx8) if x8.shape == gx8.shape else None
    if diff is None or (diff != 0).mean() > X8_FLIP_SHARE or diff.max() > 1:
        bad.append("x8 from audio")
    enc_a, lens_a = model.encode(audio, alens, device=dev)
    enc8_a = quantize_frame(tables, enc_a).cpu().numpy()
    ids_audio = model._greedy_hyps(enc_a, lens_a)
    same = [next((i for i, (p, q) in enumerate(zip(g, w)) if p != q),
                 None if len(g) == len(w) else min(len(g), len(w)))
            for g, w in zip(ids_audio, rec["ids"])]
    res.update({"x8_flips": int((diff != 0).sum()) if diff is not None else -1,
                "enc8_differing_from_audio": int((enc8_a != genc8).sum())
                if enc8_a.shape == genc8.shape else -1,
                "ids_audio": ids_audio, "audio_ids_equal": ids_audio == rec["ids"],
                "audio_ids_first_difference": same})
    return res
