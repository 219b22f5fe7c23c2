"""The port's training path (qasr_tpu_torch/train, ops/spec_augment.py,
ops/dropout.py, the trainers, the training checkpoints) against the JAX
package's, on the CPU.

(a) The CTC loss in its four reductions within 1e-5 relative of
    qasr_tpu.train.ctc_loss, and its gradient with respect to the logits
    within 1e-5 relative + 2e-6 absolute (F.ctc_loss's backward is the logits' gradient
    under a log_softmax; optax applies its own).  An impossible alignment
    gets optax's large finite value (its log-epsilon recursion) within
    1e-6 relative and its gradient within 1e-3 absolute (both sides sum
    values near 1e5 in float32).
(b) Novograd and each get_optimizer entry against optax over 3 steps on a
    tree with a scalar leaf and a zero-gradient leaf, with and without
    clipping: params within 1e-6 absolute, the state leaves (in optax's
    leaf order) within 1e-6 relative.
(c) The seven schedules at every step 0..max_steps + 2 within 1e-6
    relative + 1e-9 absolute (base lr 0.01) of the JAX package's (float32
    there, float64 here).
(d) Spec-augment: masks drawn by the JAX package, through the port's
    apply_masks, equal its spec_augment bit for bit; the port's own draws
    stay inside the JAX package's ranges.  Dropout keeps its share within
    0.003 of 1 - rate and scales the kept by 1 / (1 - rate) exactly;
    FloatExec and the Conformer drop only in train mode.  Dither 0 leaves
    the features exactly as without a generator.
(e) Trainer (tiny QuartzNet) and ConformerCTCTrainer (2 layers, d 64)
    against the JAX trainers over 3 steps from weights carried across
    (dither 0, no spec-augment, dropout 0): losses within 1e-5 relative,
    every param within 1e-4 absolute, except the attention's key biases:
    their gradient is zero analytically (a bias shifts every score of a row
    alike), so both packages' Novograd steps normalize rounding noise;
    those are held to moving no farther (L2) than Novograd's steps reach.
(f) Training checkpoints interchange: the JAX package's after 2 steps
    resumes in the port, whose step 3 equals the JAX step 3 within (e)'s
    tolerance; the port's after 2 steps resumes in the JAX package, the
    same.
(g) The trainers raise without a GPU unless given the CPU, and on mesh= /
    qat=.
(h) The port's CPU run of QuartzNet15x5's golden training record (3
    Novograd steps at full width, experiments/torch_train_golden.py) within
    train/golden.py's bounds, the card's: the step-1 loss 1e-6 relative,
    the step-1 gradient norms 1e-3 and the step-3 param norms 5e-4 relative
    for the leaves with a gradient, the weak leaves as golden.py says.
The JAX steps are compiled once per module (the trainers' fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.conformer_ctc import ConformerCTC as JaxConformerCTC
from qasr_tpu.models.ctc_model import ASRModel as JaxASRModel
from qasr_tpu.ops import spec_augment as JS
from qasr_tpu.train import optim as JO
from qasr_tpu.train.ctc_loss import ctc_loss as jax_ctc_loss
from qasr_tpu.train.trainer import ConformerCTCTrainer as JaxConformerTrainer
from qasr_tpu.train.trainer import TrainConfig as JaxTrainConfig
from qasr_tpu.train.trainer import Trainer as JaxTrainer
from qasr_tpu.utils import checkpoint as JC
from qasr_tpu_torch.compat.from_jax import model_from_jax, novograd_state_from_jax
from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
from qasr_tpu_torch.models.jasper import FloatExec
from qasr_tpu_torch.ops import dropout as PD
from qasr_tpu_torch.ops import spec_augment as PS
from qasr_tpu_torch.ops.features import MelFrontend, preprocessor_config_from_dict
from qasr_tpu_torch.train import optim as PO
from qasr_tpu_torch.train.ctc_loss import ctc_loss
from qasr_tpu_torch.train.golden import novograd_reach
from qasr_tpu_torch.train.trainer import ConformerCTCTrainer, TrainConfig, Trainer, tree_leaves
from qasr_tpu_torch.utils import checkpoint as PC
from test_jasper_model import FEAT, tiny_encoder_cfg
from test_torch_conformer import _configs

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
STEPS = 3


# ---------------------------------------------------------------------------
# (a) CTC loss
# ---------------------------------------------------------------------------


def _ctc_inputs():
    rng = np.random.default_rng(0)
    b, t, v, n = 4, 12, 6, 5
    logits = rng.normal(size=(b, t, v + 1)).astype(np.float32)
    il = np.asarray([12, 10, 3, 7], np.int32)
    tl = np.asarray([5, 3, 3, 0], np.int32)
    tg = rng.integers(0, v, size=(b, n)).astype(np.int32)
    tg[2, :3] = [1, 1, 2]          # 3 labels and a repeat need 4 frames: row 2 has 3
    return logits, il, tg, tl, v


@pytest.mark.parametrize("reduction", ["mean_batch", "sum", "mean", "none"])
def test_ctc_loss_matches_jax(reduction):
    logits, il, tg, tl, blank = _ctc_inputs()

    def jf(x):
        return jax_ctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(il), jnp.asarray(tg),
                            jnp.asarray(tl), blank, reduction)
    want = np.asarray(jax.jit(jf)(jnp.asarray(logits)))
    want_g = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jf(x))))(jnp.asarray(logits)))
    x = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(torch.log_softmax(x, -1), torch.tensor(il), torch.tensor(tg), torch.tensor(tl),
                   blank, reduction)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)
    g = x.grad.numpy()
    possible = [0, 1, 3]
    np.testing.assert_allclose(g[possible], want_g[possible], rtol=1e-5, atol=2e-6)
    # the impossible row: optax's log-epsilon gradient, float32 sums near 1e5
    np.testing.assert_allclose(g[2], want_g[2], atol=1e-3)


def test_ctc_impossible_alignment_is_optax_value():
    logits, il, tg, tl, blank = _ctc_inputs()
    per = ctc_loss(torch.log_softmax(torch.tensor(logits), -1), torch.tensor(il),
                   torch.tensor(tg), torch.tensor(tl), blank, "none").numpy()
    want = np.asarray(jax.jit(lambda x: jax_ctc_loss(jax.nn.log_softmax(x, -1), jnp.asarray(il),
                                                     jnp.asarray(tg), jnp.asarray(tl), blank,
                                                     "none"))(jnp.asarray(logits)))
    assert np.isfinite(per).all() and per[2] > 1e4
    np.testing.assert_allclose(per[2], want[2], rtol=1e-6)


# ---------------------------------------------------------------------------
# (b) optimizers, (c) schedules
# ---------------------------------------------------------------------------


def _opt_tree_and_grads():
    rng = np.random.default_rng(1)
    tree = {"b": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "s": np.asarray(0.7, np.float32)},
            "a": rng.normal(size=(5,)).astype(np.float32),
            "z": rng.normal(size=(2, 2)).astype(np.float32)}
    grads = [{"b": {"w": rng.normal(size=(3, 4)).astype(np.float32) * 3,
                    "s": np.asarray(rng.normal(), np.float32)},
              "a": rng.normal(size=(5,)).astype(np.float32),
              "z": np.zeros((2, 2), np.float32)} for _ in range(STEPS)]
    return tree, grads


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("name", ["novograd", "adam", "adamw", "sgd", "adadelta", "rmsprop",
                                  "adagrad"])
def test_optimizers_match_optax(name, clip):
    tree, grads = _opt_tree_and_grads()
    kw = dict(betas=(0.8, 0.5), weight_decay=0.001) if name == "novograd" else {}
    tx = JO.get_optimizer(name, JO.cosine_annealing(0.05, 10, warmup_steps=2), **kw)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jp)
    ps = [torch.tensor(np.asarray(x)) for x in jax.tree_util.tree_leaves(tree)]
    opt = PO.get_optimizer(name, ps, PO.cosine_annealing(0.05, 10, warmup_steps=2),
                           max_norm=clip, **kw)
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gl in zip(ps, jax.tree_util.tree_leaves(g)):
            p.grad = torch.tensor(np.asarray(gl))
        opt.step()
    for want, got in zip(jax.tree_util.tree_leaves(jp), ps):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    jl, pl = jax.tree_util.tree_leaves(state), opt.state_leaves()
    assert len(jl) == len(pl)
    for want, got in zip(jl, pl):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-6, atol=1e-12)


SCHED_CASES = [
    ("CosineAnnealing", dict(warmup_steps=3, min_lr=1e-4)),
    ("CosineAnnealing", dict(warmup_ratio=0.2)),
    ("WarmupHoldCosineAnnealing", dict(warmup_steps=2, hold_steps=3, min_lr=1e-4)),
    ("SquareAnnealing", dict(warmup_steps=2)),
    ("SquareRootAnnealing", dict(warmup_steps=2)),
    ("PolynomialDecayAnnealing", dict(warmup_steps=2, power=2.0, min_lr=1e-4)),
    ("InverseSquareRootAnnealing", dict(warmup_steps=4)),
    ("NoamAnnealing", dict(d_model=256, warmup_steps=4)),
]


@pytest.mark.parametrize("name,kw", SCHED_CASES)
def test_schedules_match_jax(name, kw):
    max_steps = 20
    js, ps = JO.SCHEDULES[name](0.01, max_steps=max_steps, **kw), \
        PO.SCHEDULES[name](0.01, max_steps=max_steps, **kw)
    for step in range(max_steps + 3):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6, atol=1e-9,
                                   err_msg=f"{name} step {step}")


# ---------------------------------------------------------------------------
# (d) spec-augment, dropout, dither
# ---------------------------------------------------------------------------

SPEC = dict(freq_masks=2, time_masks=2, freq_width=6, time_width=9, rect_masks=3,
            rect_time=5, rect_freq=7)


def _jax_masks(key, b, t, c, cfg):
    """The masks qasr_tpu.ops.spec_augment.spec_augment draws from ``key``
    (its own key splits and draws)."""
    out = {}
    key, k = jax.random.split(key)
    out["freq"] = JS._band_mask(k, b, c, cfg.freq_width, cfg.freq_masks)
    key, k = jax.random.split(key)
    out["time"] = JS._band_mask(k, b, t, cfg.time_width, cfg.time_masks)
    key, kt, kf = jax.random.split(key, 3)
    ts = jax.random.randint(kt, (b, cfg.rect_masks), 0, max(t - cfg.rect_time, 1))
    fs = jax.random.randint(kf, (b, cfg.rect_masks), 0, max(c - cfg.rect_freq, 1))
    tpos, fpos = jnp.arange(t)[None, None, :], jnp.arange(c)[None, None, :]
    tin = (tpos >= ts[:, :, None]) & (tpos < ts[:, :, None] + cfg.rect_time)
    fin = (fpos >= fs[:, :, None]) & (fpos < fs[:, :, None] + cfg.rect_freq)
    out["rect"] = (tin[:, :, :, None] & fin[:, :, None, :]).any(axis=1)
    return out


def test_spec_augment_jax_masks_apply_bit_for_bit():
    b, t, c = 3, 40, 24
    x = np.random.default_rng(2).normal(size=(b, t, c)).astype(np.float32)
    jcfg, pcfg = JS.SpecAugmentConfig(**SPEC), PS.SpecAugmentConfig(**SPEC)
    augment = jax.jit(lambda k, v: JS.spec_augment(k, v, jcfg))
    masks = jax.jit(lambda k: _jax_masks(k, b, t, c, jcfg))
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(augment(key, jnp.asarray(x)))
        got = PS.apply_masks(torch.tensor(x), {k: torch.from_numpy(np.array(v))
                                               for k, v in masks(key).items()}).numpy()
        np.testing.assert_array_equal(got, want)
    assert PS.SpecAugmentConfig.from_dict({"_target_": "x", "rect_masks": 5, "other": 1}) == \
        PS.SpecAugmentConfig(rect_masks=5)


def _runs(mask_row):
    """[(start, width)] of the True runs of a 1-D bool array."""
    runs, start = [], None
    for i, v in enumerate(list(mask_row) + [False]):
        if v and start is None:
            start = i
        if not v and start is not None:
            runs.append((start, i - start))
            start = None
    return runs


def test_spec_augment_own_draws_within_jax_ranges():
    b, t, c = 400, 50, 30
    g = torch.Generator().manual_seed(0)
    cfg = PS.SpecAugmentConfig(freq_masks=1, time_masks=1, freq_width=6, time_width=9,
                               rect_masks=1, rect_time=5, rect_freq=7)
    m = PS.draw_masks(cfg, b, t, c, g)
    fw = [sum(w for _, w in _runs(r)) for r in m["freq"].numpy()]
    assert max(fw) <= 6 and set(range(7)) <= set(fw)      # widths U[0, 6]
    for r in m["time"].numpy():
        for s, w in _runs(r):
            assert w <= 9 and s + w <= t and s < max(t - w, 1)
    for r in m["rect"].numpy():   # one whole 5 x 7 rectangle inside the image
        rows, cols = np.nonzero(r)
        assert len(rows) == 35 and rows.min() + 4 == rows.max() and cols.min() + 6 == cols.max()
        assert rows.min() < t - 5 and cols.min() < c - 7


def test_dropout_share_and_scale():
    rate = 0.3
    g = torch.Generator().manual_seed(0)
    keep = PD.draw_keep((1000, 1000), rate, g, "cpu")
    assert abs(keep.float().mean().item() - (1 - rate)) < 0.003
    x = torch.randn(1000, 1000, generator=g)
    y = PD.apply_keep(x, keep, rate)
    assert torch.equal(y[keep], x[keep] / (1 - rate)) and (y[~keep] == 0).all()
    assert PD.dropout(x, rate, None) is x and PD.dropout(x, 0.0, g) is x


def test_train_mode_drops_only_in_train():
    ex = FloatExec({}, activation="relu", train=True, generator=torch.Generator().manual_seed(0))
    x = torch.rand(4, 50, 8) + 0.1
    y = ex.activation(x, 0.5)
    assert (y == 0).any() and torch.allclose(y[y != 0], 2 * x[y != 0])
    assert torch.equal(FloatExec({}, activation="relu").activation(x, 0.5), x)


def test_dither_zero_is_exact_and_draws_from_generator():
    fe = MelFrontend(preprocessor_config_from_dict({"features": 16}))
    pcm = torch.tensor(np.random.default_rng(3).normal(size=(2, 4000)) * 0.1, dtype=torch.float32)
    lens = torch.tensor([4000, 3000])
    plain, _ = fe(pcm, lens, dither=0.0)
    assert torch.equal(fe(pcm, lens, generator=torch.Generator().manual_seed(1), dither=0.0)[0],
                       plain)
    d1, _ = fe(pcm, lens, generator=torch.Generator().manual_seed(1))
    d2, _ = fe(pcm, lens, generator=torch.Generator().manual_seed(1))
    assert torch.equal(d1, d2) and not torch.equal(d1, plain)


# ---------------------------------------------------------------------------
# (e) the trainers against the JAX package's, (f) checkpoints
# ---------------------------------------------------------------------------


def _batch(seed=0, n=8000):
    rng = np.random.default_rng(seed)
    audio = (rng.normal(size=(3, n)) * 0.1).astype(np.float32)
    alens = np.asarray([n, n * 3 // 4, n * 5 // 8], np.int32)
    toks = rng.integers(0, 28, size=(3, 6)).astype(np.int32)
    return audio, alens, toks, np.asarray([6, 4, 3], np.int32)


def _tcfg(cls):
    return cls(lr=0.01, warmup_steps=0, max_steps=100)


ZERO_GRAD_LEAF = "['att']['k']['b']"    # analytically zero gradient


def _assert_params(jax_params, port_params, start=None, steps=STEPS, lr=0.01):
    """Every leaf within PARAM_ATOL; a zero-gradient leaf moved from
    ``start`` no farther than Novograd's steps reach, in both packages."""
    jl = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    pl = tree_leaves(port_params)
    sl = tree_leaves(start) if start is not None else [None] * len(pl)
    assert len(jl) == len(pl) == len(sl)
    for (path, a), b, p0 in zip(jl, pl, sl):
        if jax.tree_util.keystr(path).endswith(ZERO_GRAD_LEAF):
            reach = novograd_reach(lr, steps, p_norm=float(np.linalg.norm(p0)) * 1.1)
            assert np.linalg.norm(np.asarray(b) - p0) <= reach
            assert np.linalg.norm(np.asarray(a) - p0) <= reach
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=PARAM_ATOL)


@pytest.fixture(scope="module")
def jasper_run(tmp_path_factory):
    """The JAX Trainer's 3 steps on a tiny QuartzNet (its checkpoint after
    step 2 saved), and the port's 3 steps from the same weights."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = JModel(encoder=tiny_encoder_cfg(), decoder=JDec(feat_in=40, num_classes=28),
                 preprocessor={"features": FEAT, "dither": 0.0})
    jm = JaxASRModel.from_config(cfg)
    pm = model_from_jax(jm)
    jt = JaxTrainer(jm, _tcfg(JaxTrainConfig))
    pt = Trainer(pm, _tcfg(TrainConfig), device="cpu")
    batch = _batch()
    out = {"jax_loss": [], "port_loss": [], "jt": jt, "pt": pt, "batch": batch,
           "jax_ckpt": str(d / "jax.npz"), "port_ckpt": str(d / "port.npz")}
    for step in range(STEPS):
        out["jax_loss"].append(jt.train_step(batch))
        out["port_loss"].append(pt.train_step(batch))
        if step == 1:
            JC.save_training_ckpt(out["jax_ckpt"], jm.params, jt.opt_state, jt.step)
            PC.save_training_ckpt(out["port_ckpt"], pm.params, pt.opt, pt.step)
            out["params2"] = jax.tree_util.tree_map(np.asarray, jm.params)
            out["opt2"] = jt.opt_state
    out["jax_params3"] = jax.tree_util.tree_map(np.asarray, jm.params)
    out["jm"], out["pm"] = jm, pm
    return out


def test_trainer_matches_jax(jasper_run):
    np.testing.assert_allclose(jasper_run["port_loss"], jasper_run["jax_loss"], rtol=LOSS_RTOL)
    _assert_params(jasper_run["jax_params3"], jasper_run["pm"].params)
    assert jasper_run["pt"].step == STEPS


def test_jax_checkpoint_resumes_in_port(jasper_run):
    jm = jasper_run["jm"]
    pm = model_from_jax(jm)
    pt = Trainer(pm, _tcfg(TrainConfig), device="cpu")
    params, opt, step, _ = PC.load_training_ckpt(jasper_run["jax_ckpt"], pm.params, pt.opt)
    assert step == 2
    pt.restore(params, opt, step)
    for a, b in zip(opt, novograd_state_from_jax(jasper_run["opt2"])):
        np.testing.assert_array_equal(a, b)
    loss = pt.train_step(jasper_run["batch"])
    np.testing.assert_allclose(loss, jasper_run["jax_loss"][2], rtol=LOSS_RTOL)
    _assert_params(jasper_run["jax_params3"], pm.params)


def test_port_checkpoint_resumes_in_jax(jasper_run):
    jm, jt = jasper_run["jm"], jasper_run["jt"]    # the compiled JAX step, restored
    params, opt, step, _ = JC.load_training_ckpt(jasper_run["port_ckpt"], jm.params,
                                                 jt.opt_state)
    assert step == 2
    jm.params, jt.opt_state, jt.step = params, opt, step
    jt.model.params = params
    loss = jt.train_step(jasper_run["batch"])
    np.testing.assert_allclose(loss, jasper_run["port_loss"][2], rtol=LOSS_RTOL)
    _assert_params(jm.params, jasper_run["pm"].params)


def test_conformer_ctc_trainer_matches_jax():
    jcfg, jccfg, pcfg, pccfg = _configs("striding")
    jm = JaxConformerCTC.from_config(jcfg, dataclasses.replace(jccfg, dropout=0.0), seed=0)
    pm = ConformerCTC.from_config(pcfg, dataclasses.replace(pccfg, dropout=0.0), seed=0)
    start = pm.params
    jt = JaxConformerTrainer(jm, _tcfg(JaxTrainConfig))
    pt = ConformerCTCTrainer(pm, _tcfg(TrainConfig), device="cpu")
    batch = _batch(1)
    for _ in range(STEPS):
        lj, lp = jt.train_step(batch), pt.train_step(batch)
        np.testing.assert_allclose(lp, lj, rtol=LOSS_RTOL)
    assert pm.params is not start            # replaced, not mutated
    _assert_params(jm.params, pm.params, start)
    assert pm.mode() == "float" and pm.params is not pt.params


# ---------------------------------------------------------------------------
# (g) devices and what is not ported
# ---------------------------------------------------------------------------


def test_trainers_default_to_cuda_and_refuse_mesh_qat():
    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.models.rnnt_model import RNNTModel
    from qasr_tpu_torch.train.trainer import RNNTTrainer

    _, _, pcfg, pccfg = _configs("striding")
    pm = ConformerCTC.from_config(pcfg, pccfg, seed=0)
    from qasr_tpu_torch.models.config import ModelConfig as PModel
    from qasr_tpu_torch.models.config import config_to_dict

    qn = ASRModel.from_config(PModel.from_dict(config_to_dict(JModel(
        encoder=tiny_encoder_cfg(), decoder=JDec(feat_in=40, num_classes=28)))))
    if not torch.cuda.is_available():
        for call in (lambda: ConformerCTCTrainer(pm, TrainConfig()),
                     lambda: Trainer(qn, TrainConfig()),
                     lambda: RNNTTrainer(RNNTModel.from_config(qn.cfg), TrainConfig())):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    with pytest.raises(NotImplementedError, match="QAT"):
        Trainer(qn, TrainConfig(), qat=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        ConformerCTCTrainer(pm, TrainConfig(), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="QAT"):
        ConformerCTCTrainer(pm, TrainConfig(), qat=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="QAT"):
        pm.loss_fn({}, None, None, None, None, qat=object())


# ---------------------------------------------------------------------------
# the golden training record
# ---------------------------------------------------------------------------


def test_quartznet15x5_golden_training_record():
    """The port's plain path (the CPU) against the JAX package's record of 3
    Novograd steps of full-width QuartzNet15x5 (B=2 x 200 frames), at the
    bounds chip_smoke.py holds the card to (train/golden.py)."""
    from qasr_tpu_torch.train import golden as G

    model = G.train_model("quartznet15x5")
    start = G.start_norms(model)
    got = G.train_record("quartznet15x5", "cpu", G.make_trainer("quartznet15x5", model, "cpu"))
    cmp = G.compare_train_record(got, G.load_record("quartznet15x5"), start)
    assert cmp["failures"] == [], cmp
