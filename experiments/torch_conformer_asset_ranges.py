"""How far the port's Conformer calibration lies from the committed asset's
ranges, and how far a float front's rounding alone moves it.

    python3 experiments/torch_conformer_asset_ranges.py [--device cpu|cuda] [--out PATH]

The flagship Conformer-CTC (16 x 256, W8A8, random weights from seed 0),
calibrated by ``quantize_encoder`` with every integer flag and static
attention on the recipe of ``assets/conformer16x256_noise_qstate_w8a8_s0.json``
(one batch of 4 x 15 s of seed-0 noise x 0.1, chip_smoke.recipe_noise).
Prints, as a share of each site's committed range (chip_smoke.site_deviations):
the port's worst and median site and pre_out against the asset; how far
the port's own ranges move when the features are scaled by
(1 + 1e-5 N(0, 1)) for three seeds; and what planted faults of the recipe
read against the asset (another noise seed, percentile 99.9, momentum
0.9).  chip_smoke.py phase 8c's limit L is set from these readings.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.device import as_device
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
    from qasr_tpu_torch.models.ctc_model import _pcm_f32

    dev = as_device(args.device)
    ref = golden.conformer16x256_w8a8().enc_qstate
    model = ConformerCTC.from_config(*golden.conformer_flagship_configs(), seed=0)

    def calibrated(batch, **kw):
        model.quantize_encoder([batch], device=dev, **dict(cs.CONF_FLAGS, **kw))
        return model.enc_qstate

    def worst(q, against=ref):
        return cs.site_deviations(q, against)[0]

    port = calibrated(cs.recipe_noise(0))
    devs = cs.site_deviations(port, ref)
    res = {"device": str(dev), "worst": devs[0][:2],
           "median": sorted(d[0] for d in devs)[len(devs) // 2],
           "pre_out": next(d[0] for d in devs if d[1] == ".pre_out"), "top": devs[:8]}
    audio, lens = (torch.from_numpy(v).to(dev) for v in cs.recipe_noise(0))
    feats, fl = model.frontend(_pcm_f32(audio), lens, dither=0.0)
    res["perturbed"] = {}
    for seed in cs.PERTURBATION_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        f = feats * (1 + cs.FRONT_PERTURBATION * torch.randn(feats.shape, generator=gen,
                                                              device=dev))
        res["perturbed"][seed] = worst(calibrated((f, fl), features=True), port)[:2]
    res["faults"] = {"seed 1": worst(calibrated(cs.recipe_noise(1)))[:2],
                     "percentile 99.9": worst(calibrated(cs.recipe_noise(0), percentile=99.9))[:2],
                     "momentum 0.9": worst(calibrated(cs.recipe_noise(0), momentum=0.9))[:2]}
    print(json.dumps(res, indent=1, default=float))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
