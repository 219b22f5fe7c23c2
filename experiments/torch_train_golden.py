"""Write the golden training records that hold the PyTorch port's training
path to the JAX package (qasr_tpu_torch/train/golden.py says what they
hold).

For each model the JAX package builds the same seed-0 model, takes
``golden.STEPS`` Novograd steps (its ``make_optimizer`` at lr 0.01, no
warmup) from the record's seeded features and targets on the CPU, each
step one jitted value_and_grad of the model's loss (the trainers' loss,
from features: FloatExec / the float Conformer, the float head, optax's
CTC loss or the RNNT wavefront) and records the losses, the step-1
gradient norms and the step-3 param norms into
qasr_tpu_torch/assets/train_<model>_s0.json.  ``--check`` then runs the
port on the CPU and prints its worst relative errors against the record.
jax is imported here only.

    JAX_PLATFORMS=cpu python experiments/torch_train_golden.py [--model quartznet15x5] [--check]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def jax_model(name: str):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qasr_tpu_torch.train import golden as G

    if name == "quartznet15x5":
        from qasr_tpu.models.config import ModelConfig
        from qasr_tpu.models.ctc_model import ASRModel
        from qasr_tpu_torch.models.config import config_to_dict, quartznet15x5

        return ASRModel.from_config(ModelConfig.from_dict(config_to_dict(quartznet15x5())),
                                    seed=0)
    from torch_conformer_golden import jax_configs

    cfg, ccfg = jax_configs()
    if name == "conformer16x256":
        from qasr_tpu.models.conformer_ctc import ConformerCTC

        return ConformerCTC.from_config(cfg, ccfg, seed=0)
    from qasr_tpu.models.rnnt_model import RNNTModel
    from qasr_tpu_torch.golden import nudged_out_bias

    jm = RNNTModel.conformer_transducer(cfg, ccfg, seed=0)
    out = jm.params["rnnt"]["joint"]["out"]
    out["b"] = nudged_out_bias(out["b"], jm.rnnt_cfg.blank_id)
    assert G.MODELS[2] == name
    return jm


def jax_loss(name: str, jm):
    """loss(params, feats, lens, targets, tlens) as the JAX trainers compute
    it, from features, without dropout draws."""
    import jax

    from qasr_tpu.train.ctc_loss import ctc_loss

    if name == "quartznet15x5":
        from qasr_tpu.models.jasper import FloatExec, decoder_forward_float, encoder_forward

        def loss(params, x, lens, tg, tl):
            ex = FloatExec(params["encoder"], activation=jm.plan.activation, train=True, rng=None)
            enc, el = encoder_forward(ex, jm.plan, x, lens)
            return ctc_loss(decoder_forward_float(params["decoder"], enc), el, tg, tl,
                            jm.blank_id)
    elif name == "conformer16x256":
        def loss(params, x, lens, tg, tl):
            lp, el = jm._apply(params, x, lens, train=True, rng=None)
            return ctc_loss(lp, el, tg, tl, jm.blank_id)
    else:
        from qasr_tpu.models.rnnt import joint, pred_network, rnnt_loss

        def loss(params, x, lens, tg, tl):
            enc, el = jm._encode(params, x, lens, train=True, rng=None)
            logits = joint(params["rnnt"], jm.rnnt_cfg, enc,
                           pred_network(params["rnnt"], jm.rnnt_cfg, tg))
            return rnnt_loss(jax.nn.log_softmax(logits, axis=-1), tg, el, tl,
                             jm.rnnt_cfg.blank_id)
    return loss


def jax_record(name: str):
    import jax
    import jax.numpy as jnp
    import optax

    from qasr_tpu.train.trainer import TrainConfig, make_optimizer
    from qasr_tpu_torch.train import golden as G
    from qasr_tpu_torch.utils.checkpoint import flatten_tree

    jm = jax_model(name)
    loss = jax_loss(name, jm)
    tx, _ = make_optimizer(TrainConfig(lr=G.LR, warmup_steps=0))
    params = jax.tree_util.tree_map(jnp.asarray, jm.params)
    state = tx.init(params)

    @jax.jit
    def step(params, state, *batch):
        value, grads = jax.value_and_grad(loss)(params, *batch)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, value, grads

    batch = [jnp.asarray(a) for a in G.train_inputs(name)]
    losses, grad_norms = [], None

    def norms(tree):
        return {k: float(np.linalg.norm(np.asarray(v, np.float64)))
                for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}
    for i in range(G.STEPS):
        params, state, value, grads = step(params, state, *batch)
        losses.append(float(value))
        if i == 0:
            grad_norms = norms(grads)
    return {"model": name, "losses": losses, "grad_norms": grad_norms,
            "param_norms": norms(params)}


def main() -> int:
    from qasr_tpu_torch.train import golden as G

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=G.MODELS, action="append")
    ap.add_argument("--check", action="store_true",
                    help="also run the port on the CPU and compare")
    args = ap.parse_args()
    for name in args.model or G.MODELS:
        t0 = time.perf_counter()
        rec = jax_record(name)
        with open(G.RECORD[name], "w") as f:
            f.write(G.record_json(rec))
        print(f"{name}: wrote {os.path.relpath(G.RECORD[name], ROOT)} in "
              f"{time.perf_counter() - t0:.1f} s, losses {rec['losses']}")
        if args.check:
            model = G.train_model(name)
            start = G.start_norms(model)
            got = G.train_record(name, "cpu", G.make_trainer(name, model, "cpu"))
            print(f"{name}: port (CPU) vs record {G.compare_train_record(got, rec, start)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
