"""VAD post-processing CLI (port of qasr_tpu/cli/vad_post.py; numpy, no
device).

Covers both reference scripts with one entry point:
  * overlap posterior smoothing + segment tables
    (scripts/vad_overlap_posterior.py:176-259 flags)
  * segment tables -> speaker-diarization manifest
    (scripts/vad_to_manifest.py:52-66 flags)

Usage:
  python -m qasr_tpu_torch.cli.vad_post --gen_overlap_seq --gen_seg_table \
      --frame_folder vad_frame --method median --overlap 0.875 --threshold 0.8
  python -m qasr_tpu_torch.cli.vad_post --to_manifest --vad_directory tables \
      --audio_directory wavs --manifest_file diar.json
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser


def build_parser() -> ArgumentParser:
    p = ArgumentParser(description=__doc__)
    p.add_argument("--gen_overlap_seq", action="store_true")
    p.add_argument("--gen_seg_table", action="store_true")
    p.add_argument("--frame_folder", type=str)
    p.add_argument("--method", type=str, default="median",
                   help="mean/median smoothing for overlapped prediction")
    p.add_argument("--overlap_out_dir", type=str)
    p.add_argument("--table_out_dir", type=str)
    p.add_argument("--overlap", type=float, default=0.875)
    p.add_argument("--seg_len", type=float, default=0.63)
    p.add_argument("--shift_len", type=float, default=0.01)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--num_workers", type=int, default=4,
                   help="accepted for flag parity; processing is vectorized")
    # vad_to_manifest.py flags
    p.add_argument("--to_manifest", action="store_true")
    p.add_argument("--vad_directory", type=str)
    p.add_argument("--audio_directory", type=str)
    p.add_argument("--manifest_file", type=str)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from qasr_tpu_torch.decode.vad import process_frame_dir, segments_to_manifest

    table_out_dir = args.table_out_dir
    if args.gen_overlap_seq or args.gen_seg_table:
        if not args.frame_folder:
            raise SystemExit("--frame_folder is required for smoothing/tables")
        overlap_dir, table_out_dir = process_frame_dir(
            args.frame_folder, method=args.method, overlap=args.overlap,
            seg_len=args.seg_len, shift_len=args.shift_len,
            threshold=args.threshold, overlap_out_dir=args.overlap_out_dir,
            table_out_dir=args.table_out_dir,
            gen_overlap_seq=args.gen_overlap_seq,
            gen_seg_table=args.gen_seg_table)
        if args.gen_overlap_seq:
            logging.info(f"smoothed predictions -> {overlap_dir}")
        if args.gen_seg_table:
            logging.info(f"segment tables -> {table_out_dir}")
    if args.to_manifest:
        vad_dir = args.vad_directory or table_out_dir
        if not (vad_dir and args.audio_directory and args.manifest_file):
            raise SystemExit("--vad_directory, --audio_directory and "
                             "--manifest_file are required for --to_manifest")
        segments_to_manifest(vad_dir, args.audio_directory, args.manifest_file)
        logging.info(f"wrote {args.manifest_file} from {vad_dir}")


if __name__ == "__main__":
    main()
