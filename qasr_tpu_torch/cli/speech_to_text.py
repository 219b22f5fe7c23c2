"""CTC ASR training (port of qasr_tpu/cli/speech_to_text.py).

    python -m qasr_tpu_torch.cli.speech_to_text --config-path model.yaml \
        [--tokenizer tokenizer.json] [--device cpu] \
        [model.train_ds.manifest_filepath=train.json trainer.max_steps=1000 ...]

The JAX package's YAML schema (NeMo's conf/quartznet_15x5.yaml: model.{
labels, preprocessor, spec_augment, encoder, decoder, optim, train_ds,
validation_ds}, trainer.max_steps, exp_manager) with dotted key=value
overrides applied before ``${...}`` interpolation; an encoder whose
``_target_`` ends in ConformerEncoder trains a Conformer-CTC, any other the
Jasper / QuartzNet family; ``--tokenizer`` (a HuggingFace tokenizer.json)
trains the BPE model.  Checkpoints (step_<n>.npz and last.npz under
exp_dir/name/version_N/checkpoints, the JAX package's layout) are written
every ``exp_manager.checkpoint_every_n_steps`` and at the end; a run whose
directory holds last.npz resumes from it.  On the CUDA device unless
``--device cpu``.  Data parallel training over several devices is not
taken here.
"""
from __future__ import annotations

from argparse import ArgumentParser
from typing import Any, Dict, List


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Dotted key=value overrides, each value read as YAML."""
    from qasr_tpu_torch.utils.yaml_io import safe_load

    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = safe_load(val)
    return cfg


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="CTC ASR training")
    parser.add_argument("--config-path", dest="config_path", type=str, required=True,
                        help="model YAML (NeMo conf/ schema)")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="BPE tokenizer json -> EncDecCTCModelBPE; default = chars")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    parser.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    return parser


def build_model(mcfg: Dict[str, Any], tokenizer):
    """(the model, its trainer class, the model section with the labels the
    datasets use)."""
    from qasr_tpu_torch.models.config import ModelConfig
    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.train.trainer import ConformerCTCTrainer, Trainer

    if (mcfg.get("encoder") or {}).get("_target_", "").endswith("ConformerEncoder"):
        from qasr_tpu_torch.models.conformer_ctc import conformer_ctc_from_dict

        model = conformer_ctc_from_dict(mcfg, tokenizer=tokenizer)
        trainer_cls = ConformerCTCTrainer
    elif tokenizer is not None:
        from qasr_tpu_torch.models.ctc_bpe_model import EncDecCTCModelBPE

        model = EncDecCTCModelBPE.from_config_and_tokenizer(ModelConfig.from_dict(mcfg),
                                                             tokenizer)
        trainer_cls = Trainer
    else:
        model, trainer_cls = ASRModel.from_config(ModelConfig.from_dict(mcfg)), Trainer
    if tokenizer is not None:
        mcfg = dict(mcfg, labels=list(tokenizer.vocab))
    return model, trainer_cls, mcfg


def train_config(raw: Dict[str, Any]):
    from qasr_tpu_torch.train.trainer import TrainConfig

    opt = raw["model"].get("optim", {})
    sched = opt.get("sched", {})
    return TrainConfig(
        optimizer=opt.get("name", "novograd"), lr=float(opt.get("lr", 0.01)),
        betas=tuple(opt.get("betas", (0.8, 0.5))),
        weight_decay=float(opt.get("weight_decay", 0.001)),
        sched=sched.get("name", "CosineAnnealing"),
        warmup_steps=sched.get("warmup_steps", 1000), warmup_ratio=sched.get("warmup_ratio"),
        min_lr=float(sched.get("min_lr", 0.0)),
        max_steps=int(raw.get("trainer", {}).get("max_steps") or 100000))


def make_dataset(dcfg: Dict[str, Any], labels, tokenizer):
    from qasr_tpu_torch.data.dataset import AudioToCharDataset

    kw = dict(sample_rate=dcfg.get("sample_rate", 16000), max_duration=dcfg.get("max_duration"),
              min_duration=dcfg.get("min_duration"), trim=dcfg.get("trim_silence", False))
    if tokenizer is not None:
        from qasr_tpu_torch.models.ctc_bpe_model import AudioToBPEDataset

        return AudioToBPEDataset(manifest_filepath=dcfg["manifest_filepath"],
                                 tokenizer=tokenizer, **kw)
    return AudioToCharDataset(manifest_filepath=dcfg["manifest_filepath"], labels=labels, **kw)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from qasr_tpu_torch.data.dataset import DataLoader
    from qasr_tpu_torch.models.config import resolve_interpolations
    from qasr_tpu_torch.utils.checkpoint import load_training_ckpt
    from qasr_tpu_torch.utils.exp_manager import ExpManager, ExpManagerConfig
    from qasr_tpu_torch.utils.logging import logging
    from qasr_tpu_torch.utils.yaml_io import safe_load

    with open(args.config_path, encoding="utf-8") as f:
        raw = safe_load(f)
    # overrides land before ${...} resolution, so an overridden source key
    # reaches its references
    raw = resolve_interpolations(apply_overrides(raw, args.overrides))
    tokenizer = None
    if args.tokenizer:
        from qasr_tpu_torch.data.tokenizers import BPETokenizer

        tokenizer = BPETokenizer(args.tokenizer)
    model, trainer_cls, mcfg = build_model(raw["model"], tokenizer)
    tcfg = train_config(raw)
    exp = ExpManager(ExpManagerConfig(
        **{k: v for k, v in raw.get("exp_manager", {}).items()
           if k in ExpManagerConfig.__dataclass_fields__}), run_config=raw)
    trainer = trainer_cls(model, tcfg, device=args.device)

    resume = exp.check_resume()
    if resume:
        params, opt_leaves, step, _ = load_training_ckpt(resume, model.params, trainer.opt)
        trainer.restore(params, opt_leaves, step)
        logging.info(f"resumed from {resume} at step {step}")

    tds = mcfg["train_ds"]
    train_loader = DataLoader(make_dataset(tds, mcfg["labels"], tokenizer),
                              batch_size=tds.get("batch_size", 32),
                              shuffle=tds.get("shuffle", True), drop_last=True)
    val_loader = None
    vds = mcfg.get("validation_ds")
    if vds and vds.get("manifest_filepath"):
        val_loader = DataLoader(make_dataset(vds, mcfg["labels"], tokenizer),
                                batch_size=vds.get("batch_size", 32))

    while trainer.step < tcfg.max_steps:
        for batch in train_loader:
            loss = trainer.train_step(batch)
            if trainer.step % tcfg.log_every == 0:
                exp.log_metrics(trainer.step, train_loss=loss, lr=trainer.sched(trainer.step))
                logging.info(f"step {trainer.step} loss {loss:.4f}")
            exp.maybe_checkpoint(trainer.step, model.params, trainer.opt)
            if trainer.step >= tcfg.max_steps:
                break
    exp.maybe_checkpoint(trainer.step, model.params, trainer.opt, force=True)
    if val_loader is not None:
        wer = trainer.evaluate(val_loader)
        exp.log_metrics(trainer.step, val_wer=wer)
        logging.info(f"final val WER: {wer:.4f}")
    exp.close()
    return trainer


if __name__ == "__main__":
    main()
