"""Training loops (port of qasr_tpu/train/trainer.py): CTC training of the
Jasper family (``Trainer``) and the Conformer-CTC (``ConformerCTCTrainer``),
transducer training (``RNNTTrainer``).

A trainer holds its own trainable copy of the model's params on its device:
leaf tensors with ``requires_grad`` in the model's host layout, one set per
trainer.  A step runs frontend -> spec-augment -> encoder (train mode:
dropout) -> head -> loss, in float32 with TF32 off, backward, the optimizer
(optax's update, ``train/optim.py``), and then replaces the model's
``params`` with a new host tree of the updated values (one device-to-host
copy), as the JAX trainers replace theirs: the models rebuild their device
state when their params object is replaced, never when a leaf changes in
place.  Every float leaf trains, BN's mean and var included (FloatExec
normalizes with them in train mode), as in the JAX package.

Random draws (dither, spec-augment masks, dropout) come from one
``torch.Generator`` on the device, seeded at each step from (seed, step),
so a resumed run draws what an uninterrupted one would.  ``device=None``
is the CUDA device (``require_cuda``); the CPU runs only when asked for.
Not taken here: ``mesh=`` (data / model parallel training, ROADMAP queue A
item 9) and ``qat=`` (item 8's QAT).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.decode.ctc import WER, edit_distance
from qasr_tpu_torch.device import as_device, no_tf32
from qasr_tpu_torch.models.ctc_model import _pcm_f32
from qasr_tpu_torch.models.jasper import FloatExec, decoder_forward_float, encoder_forward
from qasr_tpu_torch.ops.spec_augment import SpecAugmentConfig, spec_augment
from qasr_tpu_torch.train.ctc_loss import ctc_loss
from qasr_tpu_torch.train.optim import SCHEDULES, get_optimizer


@dataclass
class TrainConfig:
    optimizer: str = "novograd"
    lr: float = 0.01
    betas: Tuple[float, float] = (0.8, 0.5)   # quartznet_15x5.yaml's
    weight_decay: float = 0.001
    sched: str = "CosineAnnealing"
    warmup_steps: Optional[int] = 1000
    warmup_ratio: Optional[float] = None
    min_lr: float = 0.0
    max_steps: int = 100000
    grad_clip: Optional[float] = None
    log_every: int = 50
    seed: int = 0                             # the random draws' generator


def make_schedule(cfg: TrainConfig):
    kw = dict(max_steps=cfg.max_steps, min_lr=cfg.min_lr)
    if cfg.warmup_steps is not None:
        kw["warmup_steps"] = cfg.warmup_steps
    elif cfg.warmup_ratio is not None:
        kw["warmup_ratio"] = cfg.warmup_ratio
    return SCHEDULES[cfg.sched](cfg.lr, **kw)


def make_optimizer(cfg: TrainConfig, params: List[torch.Tensor]):
    """(the optimizer over ``params``, its schedule): Novograd with the
    config's betas and weight decay, any other optimizer at optax's
    defaults; ``grad_clip`` clips by the global norm first."""
    sched = make_schedule(cfg)
    kw = (dict(betas=cfg.betas, weight_decay=cfg.weight_decay)
          if cfg.optimizer.lower() == "novograd" else {})
    return get_optimizer(cfg.optimizer, params, sched, max_norm=cfg.grad_clip or None, **kw), sched


# ---------------------------------------------------------------------------
# param trees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[Any]:
    """The leaves of a dict / list tree in jax.tree_util's order (dict keys
    sorted; None dropped), the order of optax's state."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def trainable(tree, device) -> Any:
    """A host params tree as float32 leaf tensors with requires_grad."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
                    .requires_grad_(), tree)


def to_host(tree) -> Any:
    """A tree of tensors as a new numpy tree: one concatenation on the
    device, one copy into a fresh host buffer (page-locked for a CUDA
    source, from PyTorch's caching host allocator, so the copy runs at the
    link's rate; the buffer returns to the cache when the last view of it
    is dropped), the leaves views of that one buffer."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree_map(lambda t: t, tree)
    flat = torch.cat([t.detach().reshape(-1) for t in leaves])
    if flat.is_cuda:
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat)
        flat = host
    flat = flat.numpy()
    views, at = {}, 0
    for t in leaves:
        n = t.numel()
        views[id(t)] = flat[at:at + n].reshape(tuple(t.shape))
        at += n
    return tree_map(lambda t: views[id(t)], tree)


class Trainer:
    """CTC training of an ``ASRModel`` (QuartzNet / Jasper family)."""

    def __init__(self, model, cfg: TrainConfig, spec_aug: Optional[SpecAugmentConfig] = None,
                 mesh=None, qat: bool = False, device=None):
        if mesh is not None:
            raise NotImplementedError("mesh=: data / model parallel training is not ported "
                                      "(ROADMAP queue A item 9)")
        if qat:
            raise NotImplementedError("qat=True: QAT is not ported (ROADMAP queue A item 8, QAT)")
        self.model = model
        self.cfg = cfg
        self.device = as_device(device)
        if spec_aug is None and model.cfg.spec_augment:
            spec_aug = SpecAugmentConfig.from_dict(model.cfg.spec_augment)
        self.spec_aug = spec_aug
        self.params = trainable(model.params, self.device)
        self.opt, self.sched = make_optimizer(cfg, tree_leaves(self.params))
        self.step = 0
        self.generator = torch.Generator(device=self.device)

    @property
    def blank_id(self) -> int:
        return self.model.blank_id

    # -- the loss -----------------------------------------------------------

    def loss_from_features(self, params, feats, feat_lens, tokens, tlens,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The CTC loss of float features (B, T, C) on ``params``; with a
        ``generator``, spec-augment and the blocks' dropout."""
        model = self.model
        train = generator is not None
        if self.spec_aug is not None and train:
            feats = spec_augment(feats, self.spec_aug, generator)
        ex = FloatExec(params["encoder"], activation=model.plan.activation, train=train,
                       generator=generator)
        enc, enc_lens = encoder_forward(ex, model.plan, feats, feat_lens)
        log_probs = decoder_forward_float(params["decoder"], enc)
        return ctc_loss(log_probs, enc_lens, tokens, tlens, self.blank_id)

    def loss(self, params, audio, alens, tokens, tlens,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats, feat_lens = self.model.frontend(_pcm_f32(audio), alens, generator=generator)
        return self.loss_from_features(params, feats, feat_lens, tokens, tlens, generator)

    # -- a step ---------------------------------------------------------------

    def _on_device(self, batch):
        audio, alens, tokens, tlens = batch
        dev = self.device
        return (torch.as_tensor(np.asarray(audio) if not isinstance(audio, torch.Tensor)
                                else audio).to(dev),
                torch.as_tensor(alens).to(dev, torch.int32),
                torch.as_tensor(tokens).to(dev, torch.int64),
                torch.as_tensor(tlens).to(dev, torch.int32))

    def seed_step(self, step: int) -> None:
        """Seed the generator for ``step``'s draws from (cfg.seed, step)."""
        self.generator.manual_seed((self.cfg.seed << 32) + step)

    def _zero_grads(self) -> None:
        for p in self.opt.params:
            p.grad = None

    def backward(self, batch) -> torch.Tensor:
        """Forward and backward of one batch at the current step's draws;
        leaves the gradients on the params and returns the loss tensor."""
        audio, alens, tokens, tlens = self._on_device(batch)
        self.seed_step(self.step)
        self._zero_grads()
        with no_tf32():
            loss = self.loss(self.params, audio, alens, tokens, tlens, self.generator)
            loss.backward()
        return loss

    def backward_features(self, feats: torch.Tensor, feat_lens: torch.Tensor,
                          tokens: torch.Tensor, tlens: torch.Tensor,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``backward`` from float features (B, T, C) on the device, without
        random draws unless a ``generator`` is given."""
        self._zero_grads()
        with no_tf32():
            loss = self.loss_from_features(self.params, feats, feat_lens, tokens, tlens,
                                           generator)
            loss.backward()
        return loss

    def apply(self) -> None:
        """The optimizer's update from the params' gradients, then the step
        count and the model's params."""
        self.opt.step()
        self.step += 1
        self.sync_model()

    def train_step(self, batch) -> float:
        """One optimizer step on (audio (B, L), lengths, tokens (B, U),
        token lengths); returns the loss."""
        loss = self.backward(batch)
        self.apply()
        return float(loss.detach())

    def sync_model(self) -> None:
        """Replace the model's params with the trained values (host numpy)."""
        self.model.params = to_host(self.params)

    def restore(self, params, opt_leaves, step: int) -> None:
        """Resume: the params (a host tree), the optimizer state (its leaves
        in optax's order) and the step."""
        with torch.no_grad():
            for p, a in zip(tree_leaves(self.params), tree_leaves(params)):
                p.copy_(torch.as_tensor(np.asarray(a, np.float32)).reshape(p.shape))
        self.opt.load_state_leaves(opt_leaves)
        self.step = int(step)
        self.sync_model()

    # -- loops ------------------------------------------------------------------

    def fit(self, train_loader: Iterable, max_steps: Optional[int] = None,
            val_loader: Optional[Iterable] = None, log=print,
            val_every: Optional[int] = None) -> Dict[str, Any]:
        """Steps over the loader's epochs until ``max_steps``; ``val_every``
        runs the greedy-WER validation every that many steps."""
        max_steps = max_steps or self.cfg.max_steps
        t0 = time.time()
        losses, history = [], []
        while self.step < max_steps:
            made_progress = False
            for batch in train_loader:
                made_progress = True
                loss = self.train_step(batch)
                losses.append(loss)
                if self.step % self.cfg.log_every == 0:
                    log(f"step {self.step} loss {loss:.4f} lr {self.sched(self.step):.5f} "
                        f"({(time.time() - t0):.1f}s)")
                if val_loader is not None and val_every and self.step % val_every == 0:
                    wer = self.evaluate(val_loader)
                    history.append({"step": self.step, "val_wer": wer})
                    log(f"step {self.step} val WER {wer:.4f}")
                if self.step >= max_steps:
                    break
            if not made_progress:
                raise RuntimeError("train_loader yielded no batches this epoch (one-shot "
                                   "iterator exhausted? pass a re-iterable loader)")
        out = {"final_loss": losses[-1] if losses else None, "steps": self.step,
               "val_history": history}
        if val_loader is not None:
            out["val_wer"] = self.evaluate(val_loader)
        return out

    def evaluate_multi(self, loaders: Dict[str, Iterable]) -> Dict[str, float]:
        return {name: self.evaluate(loader) for name, loader in loaders.items()}

    def evaluate(self, loader: Iterable) -> float:
        """Greedy WER over a loader, on the float forward."""
        wer = WER(self.model.vocabulary)
        for audio, alens, tokens, tlens in loader:
            _, el, preds = self.model.forward(audio, alens, mode="fp32", device=self.device)
            wer.update(preds.cpu().numpy(), np.asarray(tokens), np.asarray(tlens),
                       el.cpu().numpy())
        return wer.compute()

    def _text_wer(self, loader: Iterable, labels, tok, transcribe) -> float:
        wer = WER(labels)
        for audio, alens, tokens, tlens in loader:
            for i, h in enumerate(transcribe(audio, alens)):
                ids = [int(c) for c in np.asarray(tokens)[i][:int(tlens[i])]]
                ref = tok.ids_to_text(ids) if tok is not None else "".join(labels[c] for c in ids)
                wer.words += len(ref.split())
                wer.scores += edit_distance(h.split(), ref.split())
        return wer.compute()


class ConformerCTCTrainer(Trainer):
    """Conformer-CTC training on the model's own loss
    (``ConformerCTC.loss_from_features``)."""

    def __init__(self, model, cfg: TrainConfig, spec_aug: Optional[SpecAugmentConfig] = None,
                 mesh=None, qat=None, device=None):
        if qat is not None:
            raise NotImplementedError("qat=: Conformer QAT is not ported (ROADMAP queue A "
                                      "item 8, QAT)")
        super().__init__(model, cfg, spec_aug=spec_aug, mesh=mesh, device=device)

    def loss_from_features(self, params, feats, feat_lens, tokens, tlens, generator=None):
        return self.model.loss_from_features(params, feats, feat_lens, tokens, tlens,
                                             generator=generator, spec_aug=self.spec_aug)

    def evaluate(self, loader: Iterable) -> float:
        m = self.model
        return self._text_wer(loader, m.vocabulary, getattr(m, "tokenizer", None),
                              lambda a, l: m.transcribe_greedy(a, l, device=self.device))


class RNNTTrainer(Trainer):
    """Transducer training on the RNNT loss (``RNNTModel.loss_from_features``,
    its lattice in Kernel 10 on the card)."""

    @property
    def blank_id(self) -> int:
        return self.model.rnnt_cfg.blank_id

    def loss_from_features(self, params, feats, feat_lens, tokens, tlens, generator=None):
        return self.model.loss_from_features(params, feats, feat_lens, tokens, tlens,
                                             generator=generator, spec_aug=self.spec_aug)

    def evaluate(self, loader: Iterable) -> float:
        m = self.model
        return self._text_wer(loader, list(m.cfg.labels), getattr(m, "tokenizer", None),
                              lambda a, l: m.transcribe_greedy(a, l, device=self.device))
