"""RNN-Transducer training (port of qasr_tpu/cli/speech_to_text_rnnt.py).

    python -m qasr_tpu_torch.cli.speech_to_text_rnnt --config model.yaml \
        --train_manifest train.json [--val_manifest val.json] \
        [--tokenizer tokenizer.json] [--batch_size 4] [--max_steps 50] \
        [--lr 0.01] [--pred_hidden 64] [--joint_hidden 64] [--device cpu]

A char (or, with ``--tokenizer``, BPE) transducer over the YAML's Jasper /
QuartzNet encoder, trained on the RNNT loss (its lattice in Kernel 10 on
the card); prints the final loss and, with a validation manifest, the
greedy WER.  On the CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description="RNN-Transducer training")
    p.add_argument("--config", required=True, help="model YAML (encoder etc.)")
    p.add_argument("--train_manifest", required=True)
    p.add_argument("--val_manifest", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer.json for a BPE transducer; default = chars")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--pred_hidden", type=int, default=64)
    p.add_argument("--joint_hidden", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; 'cpu' to run there)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.models.config import ModelConfig
    from qasr_tpu_torch.models.jasper import build_encoder_plan
    from qasr_tpu_torch.models.rnnt import RNNTConfig
    from qasr_tpu_torch.models.rnnt_model import EncDecRNNTBPEModel, RNNTModel
    from qasr_tpu_torch.train.trainer import RNNTTrainer, TrainConfig
    from qasr_tpu_torch.utils.logging import logging

    cfg = ModelConfig.from_yaml(args.config)
    plan = build_encoder_plan(cfg.encoder)
    tok = None
    if args.tokenizer:
        from qasr_tpu_torch.data.tokenizers import BPETokenizer

        tok = BPETokenizer(args.tokenizer)
    labels = list(tok.vocab) if tok is not None else list(cfg.labels)
    rnnt_cfg = RNNTConfig(num_classes=len(labels), enc_hidden=plan.feat_out,
                          pred_hidden=args.pred_hidden, joint_hidden=args.joint_hidden)
    if tok is not None:
        model = EncDecRNNTBPEModel.from_config_and_tokenizer(cfg, tok, rnnt_cfg=rnnt_cfg,
                                                             seed=args.seed)
    else:
        model = RNNTModel.from_config(cfg, rnnt_cfg=rnnt_cfg, seed=args.seed)

    def dataset(manifest):
        if tok is not None:
            from qasr_tpu_torch.models.ctc_bpe_model import AudioToBPEDataset

            return AudioToBPEDataset(manifest, tok, sample_rate=cfg.sample_rate)
        return AudioToCharDataset(manifest_filepath=manifest, labels=labels,
                                  sample_rate=cfg.sample_rate)

    loader = DataLoader(dataset(args.train_manifest), batch_size=args.batch_size, shuffle=True)
    trainer = RNNTTrainer(model, TrainConfig(lr=args.lr, warmup_steps=0,
                                             max_steps=args.max_steps, log_every=10,
                                             seed=args.seed), device=args.device)
    out = trainer.fit(loader, max_steps=args.max_steps, log=logging.info)
    print(f"final loss: {out['final_loss']:.4f}")
    if args.val_manifest:
        wer = trainer.evaluate(DataLoader(dataset(args.val_manifest),
                                          batch_size=args.batch_size))
        out["val_wer"] = wer
        print(f"val WER: {wer:.4f}")
    return out


if __name__ == "__main__":
    main()
