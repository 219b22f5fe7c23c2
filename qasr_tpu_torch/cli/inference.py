"""Integer-only quantized evaluation: the reference's workflow on a manifest.

    python -m qasr_tpu_torch.cli.inference --asr_model QuartzNet15x5Base-En \
        --dataset manifest.json --load syn_nb50_iter200_lr0.010.pkl \
        --weight_bit 6 --act_bit 6 [--percentile 99.9] [--dynamic | --no_quant] \
        [--device cpu] [--allow_random_weights]

Set the bits and the percentile, fold BN, calibrate on the synthetic pickle
(or real audio from ``--calib_manifest``), evaluate on the frozen integer
tables (``--dynamic``: per-batch ranges; ``--no_quant``: float32), collapse
greedily and print ``WER: <value>``.  Runs on the CUDA device unless
``--device cpu``.  ``--decoder beam`` is not ported.
"""
from __future__ import annotations

from argparse import ArgumentParser
from typing import List, Tuple


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Integer-only quantized evaluation")
    parser.add_argument("--asr_model", type=str, default="QuartzNet15x5Base-En", required=True,
                        help="Pass: 'QuartzNet15x5Base-En'")
    parser.add_argument("--dataset", type=str, required=True,
                        help="path to evaluation data (JSON-lines manifest)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--normalize_text", default=True, type=bool,
                        help="Normalize transcripts or not. Set to False for non-English.")
    parser.add_argument("--shuffle", action="store_true", help="Shuffle test data.")
    parser.add_argument("--load", type=str, default=None,
                        help="load path for the synthetic data")
    parser.add_argument("--calib_manifest", type=str, default=None,
                        help="calibrate on real audio from this manifest instead")
    parser.add_argument("--num_calib_batch", type=int, default=None,
                        help="number of real-data calibration batches")
    parser.add_argument("--percentile", type=float, default=None,
                        help="Max/min percentile for outlier handling. e.g., 99.9")
    parser.add_argument("--weight_bit", type=int, default=8, help="quantization bit for weights")
    parser.add_argument("--act_bit", type=int, default=8,
                        help="quantization bit for activations")
    parser.add_argument("--dynamic", action="store_true", help="Dynamic quantization mode.")
    parser.add_argument("--no_quant", action="store_true", help="No quantization mode.")
    parser.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    parser.add_argument("--beam_width", type=int, default=128)
    parser.add_argument("--alpha", type=float, default=0.0, help="LM weight")
    parser.add_argument("--beta", type=float, default=0.0, help="word bonus")
    parser.add_argument("--lm_path", type=str, default=None,
                        help="ARPA n-gram LM for beam rescoring")
    parser.add_argument("--eval_early_stop", type=int, default=None,
                        help="early stop for debugging")
    parser.add_argument("--calib_early_stop", type=int, default=None,
                        help="early stop calibration")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device; 'cpu' to run there)")
    parser.add_argument("--allow_random_weights", action="store_true",
                        help="permit a preset name with no checkpoint (architecture-only "
                             "random weights; testing)")
    return parser


def run(argv=None) -> Tuple[float, List[str], List[str], object]:
    """The workflow; returns (WER, hypotheses, references, the model)."""
    args = build_parser().parse_args(argv)
    if args.decoder == "beam":
        raise NotImplementedError("--decoder beam: CTC beam search with an LM is not ported "
                                  "(ROADMAP queue A item 10)")

    from qasr_tpu_torch.compat.pickle_io import load_synthetic
    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.decode.ctc import word_error_rate
    from qasr_tpu_torch.device import as_device
    from qasr_tpu_torch.models.ctc_model import ASRModel

    dev = as_device(args.device)
    print(f"Using ASR model {args.asr_model}")
    model = ASRModel.from_pretrained(args.asr_model,
                                     allow_random_weights=args.allow_random_weights)
    parser = "en" if args.normalize_text else "base"

    def dataset(path):
        return AudioToCharDataset(manifest_filepath=path, labels=list(model.vocabulary),
                                  sample_rate=model.cfg.sample_rate,
                                  normalize_transcripts=args.normalize_text, parser=parser)

    loader = DataLoader(dataset(args.dataset), batch_size=args.batch_size,
                        shuffle=args.shuffle)
    distilled = None
    if args.load is not None:
        print("Data loaded from %s" % args.load)
        distilled = load_synthetic(args.load)
        if args.calib_early_stop is not None:
            distilled = distilled[:args.calib_early_stop]
    elif args.calib_manifest is None and not (args.dynamic or args.no_quant):
        raise ValueError("synthetic data must be loaded (--load) unless running with "
                         "--dynamic, --no_quant or --calib_manifest")

    model.set_quant_bit(args.weight_bit, mode="weight")
    model.set_quant_bit(args.act_bit, mode="act")
    if args.percentile is not None:
        model.set_percentile(args.percentile)
    if args.no_quant:
        model.set_quant_mode("none")
    else:
        model.bn_folding()
    if not args.dynamic and not args.no_quant:
        print("Calibrating...")
        if distilled is not None:
            model.calibrate(distilled, device=dev)
        else:
            model.calibrate_on_audio(DataLoader(dataset(args.calib_manifest),
                                                batch_size=args.batch_size),
                                     max_batches=args.num_calib_batch, device=dev)

    print("Evaluating...")
    model.set_dynamic(args.dynamic)
    hypotheses: List[str] = []
    references: List[str] = []
    labels_map = dict(enumerate(model.vocabulary))
    for i, (audio, alens, tokens, tlens) in enumerate(loader):
        if i == args.eval_early_stop:
            break
        _, enc_lens, ids = model.forward(audio, alens, device=dev)
        hypotheses += model.ids_to_text(ids, enc_lens)
        references += ["".join(labels_map[int(c)] for c in tokens[b][:int(tlens[b])])
                       for b in range(tokens.shape[0])]
    wer_value = word_error_rate(hypotheses=hypotheses, references=references)
    print("WER:", wer_value)
    return wer_value, hypotheses, references, model


def main(argv=None) -> float:
    return run(argv)[0]


if __name__ == "__main__":
    main()
