"""Synthetic calibration data from a model's BN statistics.

    python -m qasr_tpu_torch.cli.synthesize --asr_model QuartzNet15x5Base-En \
        --num_batch 50 --batch_size 8 --seqlen 500 --train_iter 200 \
        --dump_path out/ [--device cpu] [--allow_random_weights]

The reference's flags (``--seq_len`` too); the problems run one after
another on the CUDA device unless ``--device cpu``.  Writes the pickle
``{dump_prefix}_nb{N}_iter{I}_lr{lr:.3f}.pkl`` in the reference's format and
prints its name.
"""
from __future__ import annotations

from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Synthesize calibration data from BN statistics")
    parser.add_argument("--asr_model", type=str, default="QuartzNet15x5Base-En", required=True,
                        help="Pass: 'QuartzNet15x5Base-En'")
    parser.add_argument("--dataset", type=str, default=None,
                        help="unused: synthesis reads no audio (kept for the reference's "
                             "command lines)")
    parser.add_argument("--num_batch", type=int, default=50,
                        help="number of batches of the synthetic data")
    parser.add_argument("--batch_size", type=int, default=8,
                        help="batch size of the synthetic data")
    parser.add_argument("--seqlen", "--seq_len", dest="seqlen", type=int, default=500,
                        help="sequence length of the synthetic data")
    parser.add_argument("--train_iter", type=int, default=200,
                        help="training iterations for the synthetic data generation")
    parser.add_argument("--dump_path", type=str, default=None,
                        help="path to dump the synthetic data")
    parser.add_argument("--dump_prefix", type=str, default="syn",
                        help="prefix for the filename of the dumped synthetic data")
    parser.add_argument("--lr", type=float, default=0.01,
                        help="learning rate for the synthetic data generation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="permit a preset name with no checkpoint (architecture-only "
                             "random weights; testing)")
    return parser


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from qasr_tpu_torch.compat.pickle_io import save_synthetic, synthetic_filename
    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.quantize.synth import get_synthetic_data

    print(f"Using ASR model {args.asr_model}")
    model = ASRModel.from_pretrained(args.asr_model,
                                     allow_random_weights=args.allow_random_weights)
    model.set_quant_mode("none")  # the teacher runs in float
    print("Num batches: %d, Batch size: %d, Training iterations: %d, Learning rate: %.3f "
          % (args.num_batch, args.batch_size, args.train_iter, args.lr))
    print("Synthesizing...")
    data = get_synthetic_data(model.plan, model.params["encoder"], batch_size=args.batch_size,
                              dim=model.plan.feat_in, seqlen=args.seqlen,
                              num_batch=args.num_batch, train_iter=args.train_iter,
                              lr=args.lr, seed=args.seed, device=args.device)
    file_name = synthetic_filename(args.dump_prefix, args.num_batch, args.train_iter, args.lr,
                                   args.dump_path)
    print("Synthetic data dumped as ", file_name)
    save_synthetic(file_name, data)
    return file_name


if __name__ == "__main__":
    main()
