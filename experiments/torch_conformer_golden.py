"""Write the committed range state and the golden record that hold the
PyTorch port's frozen Conformer-CTC to the JAX package.

Builds bench.py's Conformer leg with the JAX package on the CPU: 16 x 256,
4 heads, striding subsampling x4, conv kernel 31, 80 mels, seed 0, and
calibrates it as bench.py does (``quantize_encoder`` with every integer
flag on 4 x 15 s of seed-0 noise, W8A8).  Writes into qasr_tpu_torch/assets/:

  conformer16x256_noise_qstate_w8a8_s0.json   quantization config + ranges
  conformer16x256_w8a8_s0_golden.json         table digest, hashes, ids, lens
  conformer16x256_w8a8_s0_golden.npz          x8 (int8) and log-probs

The record comes from ``frozen_conformer_apply`` on seeded float features
(B=2, 160 frames, unequal lengths) with the JAX package's default flags.
It also checks that the integer stack can be rerun from x8 alone (the
same function with ``subsampling=""`` on x8 * S_pre reproduces x8 and the
encodings), which is how the port's check (b) starts from the golden x8.
jax is imported here only.

With ``--model rnnt`` it writes the Conformer-Transducer's instead: the
same encoder config with the RNNT head at its defaults (pred / joint 320,
one layer), ``RNNTModel.conformer_transducer(seed=0)`` with the joint's
out bias nudged (``golden.nudged_out_bias``), its encoder calibrated on
the same recipe (its seed-0 encoder differs from the CTC flagship's, which
draws its head first; the script compares the digests), frozen, and its
decoder frozen on the record's audio (``golden.rnnt_golden_audio``: 4 s
and 3.5 s of seeded noise).  Under ``jax.disable_jit()`` it records the
two decoder ranges, the subsampler's quantized output x8 (checking that the
integer stack rerun from x8 alone gives the same frames), the frozen
encoder's float frames, their enc8 codes on the joint's input grid and the
frozen decoder's greedy ids, and says whether the jitted path gives the
same ids (``--reuse-ranges`` reads the committed encoder ranges instead of
calibrating again):

  rnnt_conformer16x256_noise_qstate_w8a8_s0.json   encoder ranges
  rnnt_conformer16x256_w8a8_s0_golden.json         digests, ranges, ids, lens
  rnnt_conformer16x256_w8a8_s0_golden.npz          frames (float32), enc8, x8

    JAX_PLATFORMS=cpu python experiments/torch_conformer_golden.py [--model rnnt]

tests/test_torch_conformer.py::test_conformer_golden_recomputed_by_jax (a
``slow`` test) recomputes the assets with the same functions and compares.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
             integer_activations=True, static_attention=True)


def jax_configs():
    """(ModelConfig, ConformerConfig) of bench.py::_conformer_build in the
    JAX package."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qasr_tpu.models.config import DecoderConfig, EncoderConfig, ModelConfig
    from qasr_tpu.models.conformer import ConformerConfig
    from qasr_tpu_torch.golden import CONF_LABELS

    d_model = 256
    cfg = ModelConfig(encoder=EncoderConfig(feat_in=80, blocks=[]),
                      decoder=DecoderConfig(feat_in=d_model, num_classes=len(CONF_LABELS)),
                      labels=CONF_LABELS, preprocessor={"features": 80, "dither": 0.0})
    ccfg = ConformerConfig(feat_in=80, n_layers=16, d_model=d_model, n_heads=4,
                           subsampling="striding", subsampling_factor=4,
                           subsampling_conv_channels=d_model, conv_kernel_size=31,
                           dropout=0.0)
    return cfg, ccfg


def calibration_batches():
    """bench.py's recipe: 4 x 15 s of seed-0 noise."""
    n = int(16000 * 15.0)
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(32, n)) * 0.1).astype(np.float32)
    alens = np.full((32,), n, np.int32)
    return [(audio[:4], alens[:4])]


def jax_flagship():
    """The JAX ConformerCTC of bench.py::_conformer_build, calibrated."""
    from qasr_tpu.models.conformer_ctc import ConformerCTC

    m = ConformerCTC.from_config(*jax_configs(), seed=0)
    m.quantize_encoder(calibration_batches(), **FLAGS)
    return m


def qstate_json(m) -> str:
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return float(np.asarray(t))
    return json.dumps({"qcfg": dataclasses.asdict(m.enc_qcfg), "qstate": conv(m.enc_qstate)})


def jax_golden(m):
    """(record, x8, log-probs) as the JAX package computes them (CPU)."""
    import jax
    import jax.numpy as jnp

    from qasr_tpu.models.conformer import subsample_convs
    from qasr_tpu.quantize.conformer_freeze import frozen_conformer_apply
    from qasr_tpu_torch.golden import conformer_golden_features, conformer_record
    from qasr_tpu_torch.quantize.freeze import tables_digest

    tables = m.freeze()
    feats, lens = conformer_golden_features()
    ab = tables["act_bit"]
    n = 2 ** (ab - 1) - 1

    @jax.jit
    def run(x, lengths):
        y, sub_lens = subsample_convs(tables["subsampler"], m.ccfg, x, lengths)
        x8 = jnp.clip(jnp.round(y / tables["S_pre"]), -n, n - 1).astype(jnp.int8)
        enc, enc_lens = frozen_conformer_apply(tables, m.ccfg, x, lengths)
        return x8, sub_lens, enc, enc_lens, m._head(m.params, enc)

    x8, sub_lens, enc, enc_lens, lp = (np.asarray(o) for o in run(jnp.asarray(feats),
                                                                 jnp.asarray(lens)))
    # the integer stack from x8 alone: no subsampler, features x8 * S_pre
    ccfg0 = dataclasses.replace(m.ccfg, subsampling="")
    f0 = x8.astype(np.float32) * np.float32(tables["S_pre"])
    back = np.clip(np.round(f0 / np.float32(tables["S_pre"])), -n, n - 1).astype(np.int8)
    if not np.array_equal(back, x8):
        raise SystemExit("x8 * S_pre does not quantize back to x8")
    enc0, lens0 = jax.jit(lambda f, l: frozen_conformer_apply(tables, ccfg0, f, l))(
        jnp.asarray(f0), jnp.asarray(sub_lens))
    if not (np.array_equal(np.asarray(enc0), enc) and np.array_equal(np.asarray(lens0),
                                                                     enc_lens)):
        raise SystemExit("the integer stack rerun from x8 differs from the full run")
    return conformer_record(tables_digest(tables), x8, enc, enc_lens, lp), x8, lp


def _f32_tree(t):
    if isinstance(t, dict):
        return {k: _f32_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_f32_tree(v) for v in t]
    return np.float32(t)


def jax_transducer(reuse_ranges: bool = False):
    """The JAX Conformer-Transducer flagship, out bias nudged, encoder
    calibrated on bench.py's recipe (or the CTC flagship's ranges, if its
    encoder's digest is the same; or, with ``reuse_ranges``, the committed
    transducer ranges)."""
    from qasr_tpu.models.conformer_ctc import ConformerCTC
    from qasr_tpu.models.rnnt_model import RNNTModel
    from qasr_tpu_torch.golden import CONF_QSTATE_PATH, RNNT_QSTATE_PATH, nudged_out_bias
    from qasr_tpu_torch.quantize.freeze import tables_digest

    cfg, ccfg = jax_configs()
    m = RNNTModel.conformer_transducer(cfg, ccfg, seed=0)
    out = m.params["rnnt"]["joint"]["out"]
    out["b"] = nudged_out_bias(out["b"], m.rnnt_cfg.blank_id)
    ctc_enc = ConformerCTC.from_config(cfg, ccfg, seed=0).params["encoder"]
    same = tables_digest(ctc_enc) == tables_digest(m.params["encoder"])
    print(f"transducer encoder digest equals the CTC flagship's: {same}", flush=True)
    if same or reuse_ranges:
        with open(CONF_QSTATE_PATH if same else RNNT_QSTATE_PATH) as f:
            d = json.load(f)
        from qasr_tpu.quantize.conformer_ptq import ConformerQuantConfig

        m.enc_qcfg = ConformerQuantConfig(**d["qcfg"])
        m.enc_qstate = _f32_tree(d["qstate"])
    else:
        m.quantize_encoder(calibration_batches(), **FLAGS)
    return m


def rnnt_main(reuse_ranges: bool = False):
    """Write the transducer's ranges and golden record."""
    import jax
    import jax.numpy as jnp

    from qasr_tpu.models.conformer import subsample_convs
    from qasr_tpu.quantize.conformer_freeze import frozen_conformer_apply

    from qasr_tpu.quantize.rnnt_freeze import (
        calibrate_decoder_ranges, freeze_rnnt_decoder, greedy_decode_frozen,
    )
    from qasr_tpu_torch.golden import (
        RNNT_AUDIO_LENS, RNNT_AUDIO_SEED, RNNT_GOLDEN_NPZ, RNNT_GOLDEN_PATH,
        RNNT_QSTATE_PATH, array_sha256, rnnt_golden_audio,
    )
    from qasr_tpu_torch.quantize.freeze import tables_digest

    m = jax_transducer(reuse_ranges)
    text = qstate_json(m)
    audio, alens = rnnt_golden_audio()
    with jax.disable_jit():
        enc_tables = m.freeze_encoder()
        # the subsampler's quantized output, and the integer stack rerun
        # from it alone (no subsampler, features x8 * S_pre)
        feats, feat_lens = m.frontend(jnp.asarray(audio), jnp.asarray(alens), dither=0.0)
        y, sub_lens = subsample_convs(enc_tables["subsampler"], m.plan, feats, feat_lens)
        n = 2 ** (enc_tables["act_bit"] - 1) - 1
        x8 = np.clip(np.round(np.asarray(y) / np.float32(enc_tables["S_pre"])), -n,
                     n - 1).astype(np.int8)
        f0 = x8.astype(np.float32) * np.float32(enc_tables["S_pre"])
        enc0, _ = frozen_conformer_apply(enc_tables, dataclasses.replace(m.plan, subsampling=""),
                                         jnp.asarray(f0), jnp.asarray(sub_lens))
        # RNNTModel.freeze_decoder, its ranges kept
        ranges = calibrate_decoder_ranges(m, [(audio, alens)])
        m.dec_frozen = freeze_rnnt_decoder(m.params["rnnt"], m.rnnt_cfg, enc_range=ranges[0],
                                           joint_range=ranges[1], weight_bit=8)
        enc, enc_lens = (np.asarray(o) for o in m.encode(audio, alens))
        ids = greedy_decode_frozen(m.dec_frozen, m.rnnt_cfg, enc, enc_lens)
    if not all(ids):
        raise SystemExit(f"golden ids are empty in a row: {ids}")
    if not np.array_equal(np.asarray(enc0), enc):
        raise SystemExit("the integer stack rerun from x8 differs from the full run")
    # the jitted path on the same model and tables
    m._q_version = getattr(m, "_q_version", 0) + 1
    enc_j, lens_j = (np.asarray(o) for o in m.encode(audio, alens))
    ids_jit = greedy_decode_frozen(m.dec_frozen, m.rnnt_cfg, enc, enc_lens)
    ids_jit_enc = greedy_decode_frozen(m.dec_frozen, m.rnnt_cfg, enc_j, lens_j)
    dec = {k: v for k, v in m.dec_frozen.items() if not k.startswith("_")}
    jt = dec["joint"]
    n8 = 2 ** (dec["act_bit"] - 1) - 1
    enc8 = np.clip(np.round(enc / np.float32(jt["S_enc"])), -n8, n8).astype(np.int8)
    rec = {"encoder_tables_sha256": tables_digest(
               {k: v for k, v in enc_tables.items() if not k.startswith("_")}),
           "decoder_tables_sha256": tables_digest(dec),
           "ranges": [float(r) for r in ranges],
           "audio_seed": RNNT_AUDIO_SEED, "audio_lens": list(RNNT_AUDIO_LENS),
           "enc_lens": enc_lens.astype(int).tolist(),
           "x8_sha256": array_sha256(x8),
           "encodings_f32_sha256": array_sha256(enc.astype(np.float32)),
           "enc8_sha256": array_sha256(enc8),
           "ids": [[int(i) for i in h] for h in ids],
           "jit_ids_equal": ids_jit == ids,
           "jit_encoder_ids_equal": ids_jit_enc == ids,
           "jit_encodings_equal": bool(np.array_equal(enc_j, enc))}
    with open(RNNT_QSTATE_PATH, "w") as f:
        f.write(text)
    with open(RNNT_GOLDEN_PATH, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    np.savez_compressed(RNNT_GOLDEN_NPZ, enc=enc.astype(np.float32), enc8=enc8, x8=x8)
    print(f"wrote {RNNT_QSTATE_PATH}, {RNNT_GOLDEN_PATH}, {RNNT_GOLDEN_NPZ}: "
          f"enc_lens={rec['enc_lens']} ranges={rec['ranges']} "
          f"ids lens={[len(h) for h in ids]} jit ids equal={rec['jit_ids_equal']} "
          f"(jitted encoder: {rec['jit_encoder_ids_equal']}, encodings equal "
          f"{rec['jit_encodings_equal']})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("ctc", "rnnt"), default="ctc")
    ap.add_argument("--reuse-ranges", action="store_true",
                    help="rnnt: read the committed encoder ranges instead of calibrating")
    args = ap.parse_args()
    if args.model == "rnnt":
        return rnnt_main(args.reuse_ranges)
    from qasr_tpu_torch.golden import (
        CONF_GOLDEN_NPZ, CONF_GOLDEN_PATH, CONF_QSTATE_PATH, conformer16x256_w8a8,
    )
    from qasr_tpu_torch.quantize.freeze import tables_digest

    m = jax_flagship()
    text = qstate_json(m)
    rec, x8, lp = jax_golden(m)
    if len(set(x for row in rec["ids"] for x in row)) < 2:
        raise SystemExit("golden ids are degenerate")
    with open(CONF_QSTATE_PATH, "w") as f:
        f.write(text)
    port_digest = tables_digest(conformer16x256_w8a8().freeze_host())
    if port_digest != rec["tables_sha256"]:
        raise SystemExit(f"port tables differ from JAX tables: {port_digest} vs "
                         f"{rec['tables_sha256']}")
    with open(CONF_GOLDEN_PATH, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    np.savez_compressed(CONF_GOLDEN_NPZ, x8=x8, log_probs=lp.astype(np.float32))
    print(f"wrote {CONF_QSTATE_PATH}, {CONF_GOLDEN_PATH}, {CONF_GOLDEN_NPZ}: "
          f"enc_lens={rec['enc_lens']} tables={rec['tables_sha256'][:16]}")


if __name__ == "__main__":
    main()
