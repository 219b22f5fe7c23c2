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

    JAX_PLATFORMS=cpu python experiments/torch_conformer_golden.py

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


def jax_flagship():
    """The JAX ConformerCTC of bench.py::_conformer_build, calibrated."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qasr_tpu.models.config import DecoderConfig, EncoderConfig, ModelConfig
    from qasr_tpu.models.conformer import ConformerConfig
    from qasr_tpu.models.conformer_ctc import ConformerCTC
    from qasr_tpu_torch.golden import CONF_LABELS

    d_model = 256
    cfg = ModelConfig(encoder=EncoderConfig(feat_in=80, blocks=[]),
                      decoder=DecoderConfig(feat_in=d_model, num_classes=len(CONF_LABELS)),
                      labels=CONF_LABELS, preprocessor={"features": 80, "dither": 0.0})
    ccfg = ConformerConfig(feat_in=80, n_layers=16, d_model=d_model, n_heads=4,
                           subsampling="striding", subsampling_factor=4,
                           subsampling_conv_channels=d_model, conv_kernel_size=31,
                           dropout=0.0)
    m = ConformerCTC.from_config(cfg, ccfg, seed=0)
    n = int(16000 * 15.0)
    rng = np.random.default_rng(0)
    audio = (rng.normal(size=(32, n)) * 0.1).astype(np.float32)
    alens = np.full((32,), n, np.int32)
    m.quantize_encoder([(audio[:4], alens[:4])], quantize_attention=True,
                       integer_softmax=True, integer_layernorm=True,
                       integer_activations=True, static_attention=True)
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


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
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
