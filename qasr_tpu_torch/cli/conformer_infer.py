"""Quantized Conformer-CTC evaluation: calibrate, quantize, evaluate, WER.

    # calibrate on real audio, the PTQ forward
    python -m qasr_tpu_torch.cli.conformer_infer --restore model.qasr \
        --dataset dev.json --calib_manifest train.json --num_calib_batch 4

    # zero-shot: calibrate on features synthesized from the BN statistics
    python -m qasr_tpu_torch.cli.conformer_infer --restore model.qasr \
        --dataset dev.json --synthetic --num_batch 4 --train_iter 200

    # the integer-only serving path: every integer flag, then freeze
    ... --integer --freeze [--decoder beam [--lm_path lm.arpa]] [--device cpu]

Restores a ``.qasr`` (``ConformerCTC.save_to``), calibrates (real audio,
synthetic features or ``--dynamic`` per-batch ranges; ``--no_quant``:
float), evaluates greedily or with the CTC prefix beam search and prints
``WER: <value>``.  Runs on the CUDA device unless ``--device cpu``.
"""
from __future__ import annotations

from argparse import ArgumentParser
from typing import List, Tuple

import numpy as np


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description="Quantized Conformer-CTC evaluation")
    p.add_argument("--restore", type=str, required=True,
                   help=".qasr Conformer-CTC checkpoint (ConformerCTC.save_to)")
    p.add_argument("--dataset", type=str, required=True, help="evaluation manifest (JSON lines)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--normalize_text", default=True,
                   type=lambda v: str(v).lower() not in ("0", "false", "no"))
    p.add_argument("--calib_manifest", type=str, default=None,
                   help="calibrate on real audio from this manifest")
    p.add_argument("--num_calib_batch", type=int, default=4)
    p.add_argument("--synthetic", action="store_true",
                   help="data-free calibration from the encoder's BN statistics")
    p.add_argument("--num_batch", type=int, default=2, help="synthetic batches")
    p.add_argument("--seqlen", "--seq_len", dest="seqlen", type=int, default=128)
    p.add_argument("--train_iter", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--weight_bit", type=int, default=8)
    p.add_argument("--act_bit", type=int, default=8)
    p.add_argument("--percentile", type=float, default=None)
    p.add_argument("--dynamic", action="store_true",
                   help="per-batch dynamic ranges, no calibration data")
    p.add_argument("--no_quant", action="store_true", help="float evaluation")
    p.add_argument("--integer", action="store_true",
                   help="integer glue: int8 attention products, i-softmax, i-LayerNorm, "
                        "i-GLU / i-swish and static attention scales")
    p.add_argument("--freeze", action="store_true",
                   help="freeze to the integer-only executor (implies --integer)")
    p.add_argument("--decoder", choices=["greedy", "beam"], default="greedy")
    p.add_argument("--beam_width", type=int, default=64)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--beta", type=float, default=0.0)
    p.add_argument("--lm_path", type=str, default=None)
    p.add_argument("--eval_early_stop", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA device; 'cpu' to run there)")
    return p


def run(argv=None) -> Tuple[float, List[str], List[str], object]:
    """The workflow; returns (WER, hypotheses, references, the model)."""
    args = build_parser().parse_args(argv)

    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.decode.ctc import word_error_rate
    from qasr_tpu_torch.device import as_device
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC

    dev = as_device(args.device)
    model = ConformerCTC.restore_from(args.restore)
    print(f"Restored Conformer-CTC from {args.restore} (layers={model.ccfg.n_layers}, "
          f"d={model.ccfg.d_model})")
    tok = getattr(model, "tokenizer", None)

    def dataset(manifest):
        if tok is not None:     # a BPE vocabulary: the references are tokenized
            from qasr_tpu_torch.models.ctc_bpe_model import AudioToBPEDataset

            return AudioToBPEDataset(manifest_filepath=manifest, tokenizer=tok,
                                     sample_rate=model.cfg.sample_rate)
        return AudioToCharDataset(manifest_filepath=manifest, labels=list(model.vocabulary),
                                  sample_rate=model.cfg.sample_rate,
                                  normalize_transcripts=args.normalize_text,
                                  parser="en" if args.normalize_text else "base")

    loader = DataLoader(dataset(args.dataset), batch_size=args.batch_size)
    if not args.no_quant:
        integer = args.integer or args.freeze
        qkw = dict(weight_bit=args.weight_bit, act_bit=args.act_bit, percentile=args.percentile,
                   dynamic=args.dynamic, quantize_attention=integer, integer_softmax=integer,
                   integer_layernorm=integer, integer_activations=integer,
                   static_attention=integer)
        if args.synthetic:
            print(f"Zero-shot synthetic calibration (nb={args.num_batch}, "
                  f"iter={args.train_iter})")
            model.quantize_encoder_synthetic(num_batch=args.num_batch, seqlen=args.seqlen,
                                             train_iter=args.train_iter, lr=args.lr,
                                             device=dev, **qkw)
        elif args.calib_manifest is not None:
            batches = []
            for i, (audio, alens, *_rest) in enumerate(
                    DataLoader(dataset(args.calib_manifest), batch_size=args.batch_size)):
                if i >= args.num_calib_batch:
                    break
                batches.append((audio, alens))
            print(f"Calibrating on {len(batches)} real batches")
            model.quantize_encoder(batches, device=dev, **qkw)
        elif args.dynamic:
            model.quantize_encoder([], device=dev, **qkw)
        else:
            raise SystemExit("pick a calibration source: --calib_manifest, --synthetic, "
                             "--dynamic, or --no_quant")
        if args.freeze:
            model.freeze(dev)
            print("Frozen to the integer-only executor")

    lm = None
    if args.decoder == "beam":
        from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM

        lm = BeamSearchDecoderWithLM(model.vocabulary, beam_width=args.beam_width,
                                     alpha=args.alpha, beta=args.beta, lm_path=args.lm_path)
    hyps: List[str] = []
    refs: List[str] = []
    labels = list(model.vocabulary)
    for bi, (audio, alens, tokens, tlens) in enumerate(loader):
        if args.eval_early_stop is not None and bi >= args.eval_early_stop:
            break
        if lm is not None:
            hyps += model.transcribe_beam(audio, alens, lm=lm, device=dev)
        else:
            hyps += model.transcribe_greedy(audio, alens, device=dev)
        for i in range(np.asarray(tokens).shape[0]):
            ids = [int(c) for c in np.asarray(tokens)[i][:int(tlens[i])]]
            refs.append(tok.ids_to_text(ids) if tok is not None
                        else "".join(labels[c] for c in ids))
    wer = word_error_rate(hyps, refs)
    print(f"WER: {wer:.4f}")
    return wer, hyps, refs, model


def main(argv=None) -> float:
    return run(argv)[0]


if __name__ == "__main__":
    main()
