"""Write the golden records that hold the PyTorch port's frozen QuartzNet
and Jasper paths to the JAX package, bit for bit.

Builds a full-width flagship (QuartzNet15x5 or Jasper10x5Dr, or the
QuartzNet15x5-g4 / hardtanh variants, which the JAX package builds from
the port's config; random weights from seed 0, as bench.py and entry()
build QuartzNet) at W<bits>A<bits>,
BN-folded, with the ranges of ``qasr_tpu_torch.golden.QSTATES``: read
from the asset, or, where the asset is missing, calibrated by the JAX
package on its seed-0 noise recipe (``calibrate_on_noise(2, 2, 4 s,
seed 0)``, as the W6A6 QuartzNet asset was made) and written there.  It
freezes the model in one dyadic mode (static_e: one exponent per site;
per_channel: per-channel exponents, the reference's fixedpoint_mul), runs
the plain JAX FrozenExec on the CPU over the seeded float features of
``qasr_tpu_torch.golden``, and records the table digest, ids, encoder
lengths and SHA-256s of the decoder's int8 input and int32 logits into
``golden.RECORDS``' file.  jax is imported here only; the port reads the
records without it.

    JAX_PLATFORMS=cpu python experiments/torch_golden.py                        # W6A6 QuartzNet static_e
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --dyadic per_channel --bits 8
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --model jasper10x5dr --bits 8
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --model quartznet15x5_g4 --dyadic per_channel
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --check                # compare every record
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def jax_flagship(name: str, bits: int):
    """The JAX package's flagship at W<bits>A<bits>, BN-folded, with the
    committed ranges (calibrated on the noise recipe and written to the
    port's assets where they are missing)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qasr_tpu.models.config import ModelConfig
    from qasr_tpu.models.ctc_model import ASRModel
    from qasr_tpu_torch.golden import ASSETS, FLAGSHIPS, QSTATES
    from qasr_tpu_torch.models.config import config_to_dict

    factory, card = FLAGSHIPS[name]
    if card is None:
        model = ASRModel.from_config(ModelConfig.from_dict(config_to_dict(factory())), seed=0)
    else:
        model = ASRModel.from_pretrained(card, seed=0, allow_random_weights=True)
    model.set_quant_bit(bits, "weight")
    model.set_quant_bit(bits, "act")
    model.bn_folding()
    path = os.path.join(ASSETS, QSTATES[name, bits])
    if os.path.exists(path):
        with open(path) as f:
            model.qstate_from_json(f.read())
    else:
        t0 = time.perf_counter()
        model.calibrate_on_noise(batches=2, batch_size=2, seconds=4.0, seed=0)
        with open(path, "w") as f:
            f.write(model.qstate_to_json())
        print(f"wrote {path} ({time.perf_counter() - t0:.0f} s of JAX calibration on the CPU)")
    return model


def jax_golden(name: str = "quartznet15x5", bits: int = 6, dyadic_mode: str = "static_e"):
    """The golden record of this model, bit width and dyadic mode as the
    JAX package computes it (CPU)."""
    import jax
    import jax.numpy as jnp

    from qasr_tpu.models.jasper import (
        conv_nwc, decoder_spec, encoder_forward, pad_frames_aligned,
    )
    from qasr_tpu.ops.quant_prims import requant_clamp
    from qasr_tpu.quantize.freeze import FrozenExec
    from qasr_tpu_torch.golden import golden_features, golden_record
    from qasr_tpu_torch.quantize.freeze import tables_digest

    model = jax_flagship(name, bits)
    tables = model.freeze(dyadic_mode=dyadic_mode)
    feats, lens = golden_features(model.plan.feat_in, name)

    def run(x, lengths):
        fx = FrozenExec(tables, model.qcfg, activation=model.plan.activation)
        enc, enc_lens = encoder_forward(fx, model.plan, pad_frames_aligned(x), lengths)
        t = tables["decoder"]
        # FrozenExec.decoder, with its int8 input and int32 logits kept
        q = requant_clamp(fx._requant(enc.values, t["act_m"], t["act_e"]),
                          model.qcfg.act_bit).astype(jnp.int8)
        spec = decoder_spec(q.shape[-1], t["w"].shape[-1])
        logits = conv_nwc(q, t["w"], spec, preferred=jnp.int32) + t["b"]
        lp = jax.nn.log_softmax(logits.astype(jnp.float32) * t["out_scale"], axis=-1)
        return q, logits, jnp.argmax(lp, axis=-1), enc_lens

    # Jasper runs op by op: under jit its ~330 M int8 weights would be
    # program literals for XLA to fold (integer results are the same)
    fn = run if name == "jasper10x5dr" else jax.jit(run)
    outs = [jax.device_get(o) for o in fn(jnp.asarray(feats), jnp.asarray(lens))]
    return golden_record(tables_digest(tables), *outs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", choices=("quartznet15x5", "jasper10x5dr", "quartznet15x5_g4",
                                        "quartznet15x5_hardtanh"),
                    default="quartznet15x5")
    ap.add_argument("--bits", type=int, choices=(6, 8), default=6,
                    help="weight and activation bits")
    ap.add_argument("--dyadic", choices=("static_e", "per_channel"), default="static_e",
                    help="the dyadic mode of the record to write")
    ap.add_argument("--check", action="store_true",
                    help="compare every committed record instead of writing one")
    args = ap.parse_args()
    from qasr_tpu_torch.golden import ASSETS, RECORDS, compare_golden, flagship, load_golden
    from qasr_tpu_torch.quantize.freeze import tables_digest

    bad = {}
    keys = sorted(RECORDS) if args.check else [(args.model, args.bits, args.dyadic)]
    for key in keys:
        if key not in RECORDS:
            raise SystemExit(f"no golden record is named for {key}")
        name, bits, mode = key
        t0 = time.perf_counter()
        rec = jax_golden(name, bits, mode)
        port_digest = tables_digest(flagship(name, bits).freeze_host(mode))
        if port_digest != rec["tables_sha256"]:
            raise SystemExit(f"{key}: port tables differ from JAX tables: {port_digest} "
                             f"vs {rec['tables_sha256']}")
        if len(set(x for row in rec["ids"] for x in row)) < 2:
            raise SystemExit(f"{key}: golden ids are degenerate")
        took = time.perf_counter() - t0
        if args.check:
            bad[key] = compare_golden(rec, load_golden(mode, name, bits))
            print(f"{key}: " + ("golden matches" if not bad[key]
                                else f"golden differs in {bad[key]}") + f" ({took:.0f} s)")
            continue
        path = os.path.join(ASSETS, RECORDS[key])
        with open(path, "w") as f:
            json.dump(rec, f)
            f.write("\n")
        print(f"wrote {path}: enc_lens={rec['enc_lens']} tables={rec['tables_sha256'][:16]} "
              f"({took:.0f} s)")
    if any(bad.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
