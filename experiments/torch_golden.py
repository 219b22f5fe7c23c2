"""Write the golden records that hold the PyTorch port's frozen QuartzNet
path to the JAX package, bit for bit.

Builds full-width QuartzNet15x5 W6A6 exactly as bench.py and entry() do
(random weights from seed 0, the committed noise-calibrated ranges),
freezes it in one dyadic mode (static_e: one exponent per site;
per_channel: per-channel exponents, the reference's fixedpoint_mul), runs
the plain JAX FrozenExec on the CPU over the seeded float features of
``qasr_tpu_torch.golden``, and records the table digest, ids, encoder
lengths and SHA-256s of the decoder's int8 input and int32 logits.  jax is
imported here only; the port reads the records without it.

    JAX_PLATFORMS=cpu python experiments/torch_golden.py                        # write static_e
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --dyadic per_channel   # write per_channel
    JAX_PLATFORMS=cpu python experiments/torch_golden.py --check                # compare both
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def jax_golden(dyadic_mode: str = "static_e"):
    """The golden record of this dyadic mode as the JAX package computes it
    (CPU)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from __graft_entry__ import _calibrated_frozen_quartznet
    from qasr_tpu.models.jasper import (
        conv_nwc, decoder_spec, encoder_forward, pad_frames_aligned,
    )
    from qasr_tpu.ops.quant_prims import requant_clamp
    from qasr_tpu.quantize.freeze import FrozenExec
    from qasr_tpu_torch.golden import golden_features, golden_record
    from qasr_tpu_torch.quantize.freeze import tables_digest

    model = _calibrated_frozen_quartznet(weight_bit=6, act_bit=6, seed=0)
    tables = model.freeze(dyadic_mode=dyadic_mode)
    feats, lens = golden_features(model.plan.feat_in)

    @jax.jit
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

    outs = [jax.device_get(o) for o in run(jnp.asarray(feats), jnp.asarray(lens))]
    return golden_record(tables_digest(tables), *outs)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dyadic", choices=("static_e", "per_channel"), default="static_e",
                    help="the dyadic mode of the record to write")
    ap.add_argument("--check", action="store_true",
                    help="compare both committed records instead of writing one")
    args = ap.parse_args()
    from qasr_tpu_torch.golden import (
        GOLDEN_PATHS, compare_golden, load_golden, quartznet15x5_w6a6,
    )
    from qasr_tpu_torch.quantize.freeze import tables_digest

    bad = {}
    for mode in (sorted(GOLDEN_PATHS) if args.check else [args.dyadic]):
        rec = jax_golden(mode)
        port_digest = tables_digest(quartznet15x5_w6a6().freeze_host(mode))
        if port_digest != rec["tables_sha256"]:
            raise SystemExit(f"{mode}: port tables differ from JAX tables: {port_digest} "
                             f"vs {rec['tables_sha256']}")
        if len(set(x for row in rec["ids"] for x in row)) < 2:
            raise SystemExit(f"{mode}: golden ids are degenerate")
        if args.check:
            bad[mode] = compare_golden(rec, load_golden(mode))
            print(f"{mode}: " + ("golden matches" if not bad[mode]
                                 else f"golden differs in {bad[mode]}"))
            continue
        with open(GOLDEN_PATHS[mode], "w") as f:
            json.dump(rec, f)
            f.write("\n")
        print(f"wrote {GOLDEN_PATHS[mode]}: enc_lens={rec['enc_lens']} "
              f"tables={rec['tables_sha256'][:16]}")
    if any(bad.values()):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
