#!/usr/bin/env python3
"""Smoke test of the PyTorch port (qasr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--report PATH] [--only training|rnnt_loss]

Drives the port's serving paths on the card, the frozen W6A6 QuartzNet15x5
in its dyadic modes (static_e and static_e16 on FrozenExecFused,
every requant in a prologue or epilogue of Kernels 1-2; per_channel on
FrozenExecKernels, convs in Kernels 1-2, the requants next to a depthwise
conv in Kernel 1's prologue and epilogue with per-channel exponents, the
rest in Kernel 7), the same at W8A8 (uint8 codes at the +1-bit sites) and
Jasper10x5Dr at W6A6 and W8A8 (its dense convs in Kernel 8), the
grouped and hardtanh QuartzNet15x5 variants and a grouped Jasper-width
block (the grouped forms of Kernels 2 and 8), MatchboxNet VAD, and
the frozen W8A8 Conformer-CTC (16 x 256) and Conformer-Transducer (its
integer decoder in Kernel 9), and QuartzNet15x5's zero-shot
workflow (synthesis, calibration, the dynamic forward, the CLIs) and the
Conformer-CTC's (synthesis, calibration, freeze and serve, dynamic), and
both families through their checkpoints (.nemo, .qasr, from_pretrained)
with the CTC beam search and the vggnet subsampler and the LSTM head, and
training (the three model families' steps, the transducer's loss in
Kernel 10, the training CLIs, train -> quantize -> serve), with
nothing that falls back: no CUDA, a failed kernel build or any failed
phase exits non-zero before the result line.  Phases:

1. the card's name and power limit (nvidia-smi);
2. build every kernel from qasr_tpu_torch/kernels/csrc (one nvcc per
   source, in parallel; timed);
3. each kernel against its plain torch version on the card, bit for bit
   (torch.equal): dw_conv and pw_gemm at every QuartzNet shape and
   epilogue mode, and with the input-requant prologue (int8 and int32
   inputs, producer bias and ReLU on and off, 31- and 16-bit mantissas,
   per-channel or scalar, bits1 6/7/8, ragged input lengths, with every
   epilogue mode; dw_conv also with per-channel exponents e / e1 spread
   over 1-31 plus 0, 62, 63 and 70 in six prologue / epilogue modes),
   pw_gemm at N in {1, 37, 609} (a ragged last row tile),
   Cin 64 (a single K chunk) to 1024 and 24 / 40 (the wrapper zero-pads
   them to a multiple of 16), Cout 29 (one 32-column tile, rows of
   29 or 116 bytes) to 1024 (the prologue's resident A tile reused over 8
   column tiles); the
   requant kernel at C in {64, 256, 512, 1024, 29, 24} with int8 and int32
   inputs, scalar and per-channel mantissas and exponents (1, 31, 62, 63,
   70), identity and mask on and off, every row masked, and a view that
   starts off a 16-byte boundary; the requant device functions
   (qasr_requant, and qasr_rq with its constants hoisted, as Kernels 1, 4
   and 7 use it) over a boundary grid and 2 x 2^20 random triples, z over
   all of int32 in one half, and qasr_rq_f64 (Kernel 3's score requants)
   on the triples in its domain plus 2^20 at |z| <= 2^21; the Conformer's
   integer device functions over their whole domains (i_exp, and i_exp >> 4
   from the table of its quadratic as Kernel 3 reads it; i_sigmoid_grid,
   and Kernel 4's GLU-gate forms, the table lookup and the reciprocal
   division, on [-N_IN-64, N_IN+64] and +-2^26; the invariant-divisor
   division Kernel 3 divides by the row sum with, over every divisor in
   [1, 2^20] against ten numerators each and 2 x 2^20 random pairs below
   2^31; the LN square root, also as the float root Kernel 4 uses, on
   [0, 2^22) and 2^20 random n < 2^30; floor_div; the i-LN row core in
   both forms); int_attention at T in {1, 37, 128, 129, 375, 500} with ragged
   lengths and contexts -1, (8, 0), (4, 2), at d_k in {16, 96, 128}
   besides the flagship's 64, at T in {1300, 1500, 2600} on its
   streaming form, and with score requants outside qasr_rq_f64's domain
   at T 129 and 1300; conv_block at d in {64, 256, 512}, T in {1, 31, 375}
   with ragged lengths; lin_epilogue in its three modes at every (K, D) of
   the Conformer path (K = 4864 is 38 chunks of K), with and without bias,
   at N in {1, 37, 609, 12000}, on the flagship's sites and on seeded sites
   with exponents above 31; ffn_ln
   at d in {64, 256, 512} x T in {1, 31, 375}, tail on and off, its
   per-column requants on the FP64 pipe, and at T = 375 also with every
   site, and with l1 alone, pushed out of qasr_rq_f64's domain (so that
   the host sends them to qasr_rq);
4. the golden checks: full-width QuartzNet15x5 reproduces the JAX static_e
   record exactly on FrozenExecFused, FrozenExecKernels and the plain path,
   and the JAX per_channel record on FrozenExecKernels and the plain path;
   the flagship Conformer-CTC's x8 is within 0.1% of codes at +-1 of the
   JAX record (float32 subsampler) and its integer stack from the golden x8
   reproduces the encodings' hash, ids and lengths exactly under the plans
   ("1", True) (the default), ("conv", True), ("conv", False) and on the
   plain path;
5. serve 4 seeded int16 PCM requests (4.0, 7.3, 11.6, 15.0 s) through
   ASRModel.transcribe in the static_e and per_channel modes (the
   flagship's static_e16 freeze raises, as the JAX package's does) and
   through
   ConformerCTC.transcribe_greedy (the default plan), and the same batch
   once more under ("conv", True), with every launch count set to 0 just
   before each and read just after: each path launches its own kernels as
   kernel_launches predicts for its tables or plan (QuartzNet 77 dw_conv +
   94 pw_gemm, and under per_channel 32 requant: the residual branches'
   and C3's inputs, the joins and the decoder's input; the
   Conformer 16 int_attention + 16 conv_block + 32 ffn_ln + 81
   lin_epilogue, and 16 + 16 + 145 lin_epilogue under ("conv", True)) and
   gives the ids of its plain executor;
6. time the QuartzNet B=64 x 15 s step (static_e and per_channel kernel
   paths, and both plain) and the Conformer B=32 x 15 s step (default
   plan; ("conv", False), the attention and conv-module kernels with plain
   glue; plain), median of 10 after 3 warm-ups, CUDA events, in turns; and
   each kernel against its plain version at its path's shapes (Kernel 1 at
   every depthwise site of the walk in its static_e and its per_channel
   form, the static prologue sites, and the epilogue-off function at C=512
   K=75 and C2 beside cuDNN's float32 depthwise conv; Kernel 7 at every
   kind of site the per_channel path still runs in it; Kernel 2's sites;
   int_attention's streaming form at T=1500; ffn_ln as FFN1 + ln_att, FFN2
   + ln_out and the last layer's FFN2 without a tail), with its bound
   (bytes over 3.35 TB/s or int8 operations over 1,979 TOP/s, from this
   run's inputs) and, where one PyTorch call
   computes the same function, that call's time: each as CUDA events
   around one call (call_ms, the wrapper's host time included) and as
   device time (device_ms: torch.profiler over 10 calls, the named
   kernels' device time per call; where the profiler loses records, CUDA
   events around the 10 calls queued behind a spin kernel);
7. the zero-shot workflow on full-width QuartzNet15x5 at W6A6: (a)
   ``get_synthetic_data`` at the reference recipe (8 x 500 frames, 200
   Adam iterations, lr 0.01; a CUDA graph replay an iteration) for 2
   problems: every loss finite, each problem's last below its first, and
   the first 3 losses of one start point on the card within SYNTH_RTOL of
   the CPU's (eager) at 2 x 200 frames; distill_loss's input gradient at
   8 x 500 frames within GRAD_RTOL (norm-wise) of the CPU's, which the
   same backward under TF32 must exceed; (b) ``calibrate`` on those
   batches, min / max and percentile 99.9 (histogram_quantile at the
   sites above 2^18 elements): 77 dw_conv + 94 pw_gemm launches a forward,
   and the range state equal bit for bit to the plain QuantExec's on the
   card; the calibrating forward (B=8 x 500 frames) timed; (d) the dynamic
   forward's ids equal the plain QuantExec's (77 + 94 launches), and the
   dynamic forward at B=64 x 15 s timed; (e) ``cli.synthesize`` then
   ``cli.inference --weight_bit 6 --act_bit 6 --percentile 99.9`` on a
   manifest of 4 seeded wavs: a finite WER and the hypotheses of the plain
   frozen executor; (c) ``calibrate_on_noise(2, 2, 4 s, seed 0)`` against
   the committed noise ranges (the JAX package's seed-0 recipe): the
   first site (the features alone) within 1e-4 of its range, every site
   within 15% of its range; beside them, how far the CPU's features, or
   the card's times (1 + 1e-5 N(0, 1)), move the port's own ranges, and
   what planted faults of the recipe read (another seed and percentile
   99.9 must read above 15%); how many frozen table entries differ from
   the golden record's tables;
8. the Conformer-CTC's zero-shot workflow at full width (16 x 256, W8A8,
   every integer flag and static attention): (a) synthesis at
   ``quantize_encoder_synthetic``'s recipe (2 problems of 8 x 128 frames,
   200 Adam iterations, lr 0.02; a CUDA graph replay an iteration): every
   loss finite, each problem's last below its first, the first 3 losses of
   one start point within CONF_SYNTH_RTOL of the CPU's (2 x 128 frames),
   conformer_distill_loss's input gradient at 8 x 128 within
   CONF_GRAD_RTOL (norm-wise) of the CPU's, which the same backward under
   TF32 must exceed; (b) ``quantize_encoder`` on those batches: 16 dw_conv
   + 178 pw_gemm launches a forward (pre_out's 4,864-wide contraction in
   two) and the range state equal bit for bit to the plain path's, and
   at momentum 0.9 equal to the plain path's and moved off 0.95's (the
   EMA over the 2 batches); then ``freeze`` and 4 seeded requests through ``transcribe_greedy``: 16 + 16
   + 32 + 81 launches and the plain frozen executor's ids; (c) the
   committed asset's recipe (one batch of 4 x 15 s of seed-0 noise x 0.1)
   against its ranges: pre_out within 1e-4 and every site within
   CONF_RANGE_L of its range, planted faults (another noise seed,
   percentile 99.9) above it, momentum 0.9 printed (one batch never
   applies the EMA), and how many frozen table entries differ from the
   golden record's tables; (d) the dynamic forward at B=32 x 15 s: the
   plain path's log-probs bit for bit (and so its ids), 16 + 179
   launches, and its time; Kernels 1 and 2 against their plain versions
   at its shapes (B=32 T'=375; N=12,000, the K-split included); (e) the calibrating forward at B=4 x 15 s and Kernels 1 and
   2 at its shapes against their plain versions, cuDNN's depthwise conv
   and torch._int_mm.

9. checkpoints and decoding: (a) QuartzNet15x5 seed 0 -> ``save_to(.nemo)``
   -> ``from_pretrained`` by path and by name through
   ``$QASR_PRETRAINED_DIR`` (params bit-equal); folded with the committed
   ranges, its static_e and per_channel tables equal the in-memory
   model's and the golden records hold; ``save_to(.qasr)`` (folded, with
   ranges) -> ``restore_from`` -> B=64 x 15 s on Kernels 1 / 2 (and 7 on
   per_channel) with the planned launches and the unsaved model's ids;
   ``cli.inference --asr_model x.nemo --calib_manifest --decoder beam``
   prints WER: and the beam over the plain frozen executor's log-probs;
   (b) the flagship Conformer-CTC with its committed ranges -> ``.qasr``
   -> ``restore_from`` -> ``freeze``: the golden record, and at B=32 x 15
   s the planned launches and the unsaved model's ids;
   ``cli.conformer_infer --restore --calib_manifest --integer --freeze
   --decoder beam`` prints WER: and the beam over the plain frozen path's
   log-probs; (c) the vggnet Conformer 16 x 256 W8A8 (pre projection
   5,120 -> 256): calibrated on the asset's recipe with kernel ranges equal
   to plain, frozen, at B=32 x 15 s the planned launches and the plain
   path's ids; Kernel 5 at its pre projection against its plain version,
   timed beside torch._int_mm (a second lin_epilogue row of the kernels
   line); (d) the LSTM head (hidden 640, 1 layer) on the flagship's frozen
   encoder: its log-probs on the card within LSTM_ATOL of the CPU's on the
   same encodings, equal greedy ids; phase 9's seconds.

10. W8A8 and Jasper10x5Dr: (a) Kernels 1, 2 and 7 in their uint8 forms
   against their plain versions at phase 3's shapes and modes (a uint8
   input, uint8 prologue codes from int8 / int32 producers with 31- and
   16-bit, one-value and per-channel mantissas and exponents, a uint8
   epilogue, Kernel 1's stride-2 site and one-channel-a-thread staging,
   Kernel 2 at every (Cin, Cout) and N in {609, 1, 37}, Kernel 7 to and from
   uint8), and Kernel 8 at every distinct Jasper10x5Dr site in its serving
   forms and, at (K 13, 256 -> 384) and (K 29, 768 -> 896, d 2), in every
   prologue and epilogue mode with int8 and uint8 inputs at N in {609, 1,
   37} with ragged lengths, and at the edges of its wgmma tiling (Couts no
   tile width divides, B=1 with T_out=1, T_out one past 128 and 256, Cin
   48 / 64 / 144, stride 2 with the prologue, a block walking four Cout
   tiles) in five forms each, exact; (b) full-width QuartzNet15x5 W8A8
   reproduces its static_e and per_channel golden records and Jasper10x5Dr
   its W6A6 and W8A8 ones on the kernel executors and the plain path; (c)
   4 seeded requests through transcribe on QuartzNet W8A8 (static_e,
   per_channel) and Jasper10x5Dr W6A6 / W8A8 (static_e) and W8A8
   per_channel: the launches kernel_launches predicts and the plain
   executor's ids; (d) calibrate (8 x 500 frames of seeded noise features)
   at W8A8 QuartzNet and W6A6 Jasper: the ranges equal the plain
   QuantExec's bit for bit; (e) cli.inference at its default bit widths on
   4 seeded wavs (QuartzNet greedy, Jasper10x5Dr greedy and beam): WER:
   and the plain frozen executor's hypotheses; (f) the frozen steps at
   B=64 x 15 s (QuartzNet W6A6 and W8A8 static_e, W8A8 per_channel; Jasper
   W6A6 and W8A8 static_e), median of 10 in turns, the uint8 forms at
   QuartzNet's shapes and Kernel 8 at each Jasper site (B=64, T'=768)
   against its plain version, its operation bound and float64 conv1d (one
   call, exact here); phase 10's seconds.

11. The rest of the Jasper family and VAD: (a) Kernels 2 and 8 in their
   grouped forms (pw_gemm_grouped.cu, dense_conv_grouped.cu: groups 2 /
   3 / 4 / 6 / 8 at QuartzNet15x5-g4's and Jasper's widths, Cin/g 16 /
   48 / 64 / 80 / 128 / 192, Cout/g ragged against the column tile, N = 1
   and ragged lengths, Kernel 2 past one persistent wave, with and
   without the prologue on int8 and int32 producers, every epilogue mode,
   GroupShuffle in the store or not, int8 and uint8 operands) and
   hardtanh's ceiling (per channel and scalar, prologue and epilogue) in
   Kernels 1, 2, 7 and 8 against their plain versions, exact, and the
   group widths they refuse; (b) QuartzNet15x5-g4 W6A6
   (static_e, per_channel) and QuartzNet15x5 with hardtanh (static_e)
   reproduce their JAX golden records on the kernel executors and the
   plain path, and the Jasper-width grouped block (C 768, K 25, 4 groups,
   residual) calibrates on the card with ranges equal to the plain
   QuantExec's; (c) 4 seeded requests through transcribe on each: the
   planned launches (the grouped forms' as the plan's grouped convs), no
   call of a plain version, the plain executor's ids; (d) QuartzNet15x5-g4 and hardtanh calibration against the plain
   QuantExec; (e) their B=64 x 15 s steps beside QuartzNet15x5 W6A6
   static_e's, and the grouped Kernel 2 (beside torch._int_mm per group)
   and Kernel 8 (beside float64 conv1d(groups=4)) at their serving sites
   with their bounds; (f) cli.vad_infer (MatchboxNet-3x1x64) on the card:
   frames within 1e-4 of a CPU run, windows per second; (g) QuartzNet15x5
   with selu and with swish at W6A6 calibrated and served on the card (the
   planned launches, no plain call, the plain executor's ids); phase 11's
   seconds.
12. Streaming: (a) Kernels 3 and 4 in their cache forms against their plain
   versions at L 70, n in {1, 4, 16}, B in {1, 32}, and (B, n) (1, 25), (32,
   25) (1 s slices), (3, 7) (a tile the utterances do not fill), (300, 4)
   (past one wave of clusters) and (2, 40) (past Kernel 4's cluster tile: its
   staged form), seen in {0, 3, 69, 70, 500} (a stream's first steps and a
   full cache), the new caches included, each Kernel 4 call in the form
   expected of its n; (b) the flagship Conformer-CTC 16 x 256 W8A8 as a
   causal streaming configuration (att_context (70, 0), causal_conv,
   normalization off, the committed ranges) over 15 s of seeded noise:
   frozen_stream_step over the offline forward's subsampled frames, 4 a step,
   every row's encodings and the ids bit-equal to the offline causal frozen
   forward; CacheAwareConformerStream fed the audio in 40 ms, 160 ms and 1 s
   slices, its first-site codes, rows and ids bit-equal to the same at each;
   each step's launches equal to stream_kernel_launches, no plain call in
   any; its latency_report and frozen_stream_step's device / event / host-
   enqueue ms at (B, n) (1, 4), (32, 4) and (32, 16); (c) the windowed
   streamer over 60 s on QuartzNet15x5 W6A6 and W8A8 static_e (normalization
   off): stitched ids equal to the offline ids, transcribe_beam equal to
   offline beam decoding, one planned forward a window, its latency_report;
   (e) QuartzNet15x5 with selu and with swish at W8A8 (signed 9-bit codes as
   two byte planes): calibration equal to the plain QuantExec's with the
   planned launches, 4 requests on FrozenExecFused and FrozenExecKernels with
   the planned launches, no plain call, the plain executor's ids, and every
   plane site of one forward on each against its plain versions (Kernel 7's
   two planes, the joined int32 conv); (f) Kernel 7's byte planes against
   their plain version at B 64 x T 768, partial lengths, C 256 / 512 / 250,
   on its 4-channel and element paths; both cache forms timed at (B, n) (1,
   4), (32, 4) and (32, 16) beside their bounds and latency floors (an empty
   kernel on the same grid and cluster shape, plus Kernel 4's three
   dependent exchanges at cluster_exchange's round); phase 12's seconds.
13. The transducer (the frozen Conformer-Transducer 16 x 256 W8A8, its
   decoder in Kernel 9): (a) rnnt_pred_step and rnnt_joint (the step
   kernels, off the main path) against their plain versions, exactly: the
   pred step at H 64 / 320 / 640, L 1 / 2, B 1 / 7 / 32, tokens with
   blank, c_q at the clip, four emit masks; the joint at De 256, J 320 /
   640, V+1 29 / 1025, B 1 / 32 from strided frames, and with forced ties
   (the lower column wins); rnnt_greedy (the whole greedy decode in one
   launch) against rnnt_greedy_plain, exactly (each row's symbols, joint
   steps and ids, the new carry): H 64 / 320 / 640 x L 1 / 2 (the
   resident and the streamed form) x B 1 / 7 / 32 x a random and a
   blank-biased head, unequal lengths with a zero, caps 10 and 1, a second
   chunk from the first's carry; the three timed beside their bounds
   (rnnt_greedy at a stream chunk, B=1 x 64 frames); (b) the golden
   record: table digests, the decoder fed the record's frames and Kernels
   3-6 -> 9 from its x8 give its frames, enc8 codes and ids exactly; from
   its audio, x8 within 0.1% at +-1 (the enc8 codes and ids that then
   differ counted: the random-weight encoder carries a flip into most
   frames); the main path from the audio with launches equal to
   kernel_launches + one rnnt_greedy (in the form its plan names) + the
   start-of-sequence pred step a layer, no plain call; the main path
   again with the blank's bias raised by 2 (frames ended by a blank): the
   planned launches and the CPU plain decoder's ids; (c) B=32 x 15 s: the
   encoder's time, the exchange floor (a push into every CTA's shared
   memory and one barrier.cluster, a round), and for both heads (the
   golden one, which emits the cap of 10 symbols at every frame, and the
   blank-biased one) the greedy decode by the host clock and by CUDA
   events with its one copy, against the former host loop on the step
   kernels in turns, rnnt_greedy's device time, its longest row's joint
   steps, us a step and the latency floor; (d)
   StreamingTransducer on the causal variant (att_context (70, 0)), the
   decoder frozen on the card: streamed == offline, transcribe_batch ==
   each session offline, its latency_report; (e) .qasr save / restore
   gives the main path's ids; (f) beam / tsd / alsd (beam 3) over the
   record's frames, card == CPU (a float near-tie within 1e-4 printed
   instead); phase 13's seconds.

14. Training (``--only training`` runs the build and this phase alone,
   ``--only rnnt_loss`` the build and 14a, partial runs without the result
   line): (a) Kernel 10 (the RNNT loss, ``kernels/csrc/rnnt_loss.cu``),
   both entries (from the joint's logits, and from the lattice's log-probs)
   forward and backward at (B, T, U) in RNNT_LOSS_SHAPES at V+1 = 29 and
   at RNNT_LOSS_BPE at V+1 = 1,025, ragged lengths, against its plain
   versions in float32 and in float64 (the truth): the NLL within
   RNNT_NLL_RTOL of float64, each gradient no farther from float64 than
   twice the float32 plain version (floor RNNT_GRAD_FLOOR) and at most
   RNNT_GRAD_ATOL; the logits entry timed at RNNT_LOSS_TIMED (each of its
   three kernels) beside the log-softmax chain around the log-probs entry
   (the yardstick), both peak memories, the plain versions, the byte
   bound, the latency floor (the round-floor kernel for T + U rounds on
   the lattice's grid) and the lattice's clock64 stamps a round; (b) the
   golden training records (``qasr_tpu_torch/train/golden.py``: 3 Novograd
   steps of QuartzNet15x5, the Conformer-CTC 16 x 256 and the
   Conformer-Transducer at full width on B=2 x 200 seeded frames, written
   by the JAX package) held at golden.py's bounds, the transducer's steps
   on Kernel 10's logits entry alone (3 launches a step counted from 0;
   the log-probs entry and both plain versions 0); (c) full-width
   training steps on one fixed two-tone batch, median of 5 after 2
   warm-ups by CUDA events: QuartzNet15x5 B=32 x 15 s with the YAML's
   spec-augment, the Conformer-CTC B=32 x 15 s and the Transducer B=16 x
   15 s with dropout 0.1 (150-166 character targets), each with its peak
   memory, the params' write-back, Kernel 10's and F.ctc_loss's device ms
   and the device-busy share of one profiled step; every loss and
   gradient finite; (d) cli.speech_to_text (QuartzNet15x5's YAML) 3 steps
   on 8 wavs, checkpoints, a resume equal to the saved state bit for bit,
   and cli.speech_to_text_rnnt 2 steps; (e) the toy of
   tests/test_e2e_quantization_accuracy.py trained 700 steps on the
   50-utterance corpus, then fp32 WER <= 0.02 and W8A8 dynamic and
   calibrated WER <= 0.08 on the card; phase 14's seconds.

Prints the card line, a {"kernels": [...]} line (each kernel's "ms" and
"library_ms" are device times at the site "shape" names, "call_ms" and
"library_call_ms" the per-call event times), then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the slice's depthwise sites: (C, K, stride, dilation)
DW_SITES = ([(64, 33, 2, 1)]
            + [(c, k, 1, 1) for c in (256, 512) for k in (33, 39, 51, 63, 75)]
            + [(512, 87, 1, 2)])
# 24 and 40: the tiny test preset's widths, below / off a multiple of 16
# (the wrapper zero-pads the contraction)
PW_CIN = (64, 256, 512, 1024, 24, 40)
PW_COUT = (256, 512, 1024, 29)
# the Conformer kernels' check grid
ATT_T = (1, 37, 128, 129, 375, 500)
ATT_CTX = ((-1, -1), (8, 0), (4, 2))
ATT_DK = (16, 96, 128)             # the other head widths the kernel takes (d_k 64 above)
ATT_T_LONG = (1300, 1500, 2600)    # above the resident form's shared memory: streaming
# the requant kernel's channel counts: QuartzNet's widths, the decoder's 29
# and 24 (int8 output on the element path, int32 on 8-channel vectors)
RQ_C = (64, 256, 512, 1024, 29, 24)
# the flagship's dyadic modes; its ranges give static_e16 an exponent above
# 31, so its freeze raises, in the JAX package as here
QUARTZNET_MODES = ("static_e", "per_channel")
CONV_D, CONV_T = (64, 256, 512), (1, 31, 375)
FFN_D, FFN_T = (64, 256, 512), (1, 31, 375)
LIN_N = (1, 37, 609, 12000)
# pw_gemm's (B, T) in phase 3: N = 609, 1 and 37 rows (ragged last row tiles)
PW_BT = ((3, 203), (1, 1), (1, 37))
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12
KERNELS = ("dw_conv", "pw_gemm", "requant", "int_attention", "conv_block", "lin_epilogue",
           "ffn_ln", "dense_conv", "int_attention_cached", "conv_block_cached", "rnnt_pred",
           "rnnt_joint", "rnnt_greedy", "rnnt_loss", "rnnt_loss_from_logits")
# the launches of each rnnt_greedy form (kernels/rnnt_decoder.py: rnnt_greedy.forms)
# and of each conv_block_cached form (kernels/conv_block.py: conv_block_cached.forms)
GREEDY_FORMS = ("rnnt_greedy_resident", "rnnt_greedy_streamed")
CONV_FORMS = ("conv_block_cached_cluster", "conv_block_cached_staged")
# the device kernels each wrapper launches (a substring of their names)
KERNEL_SYMBOLS = {"dw_conv": "dw_conv_kernel",
                  "pw_gemm": ("pw_gemm_kernel", "pw_gemm_grouped_kernel"),
                  "requant": "requant_kernel",
                  "int_attention": ("int_attention_kernel", "int_attention_stream_kernel"),
                  "conv_block": "conv_block_stage", "lin_epilogue": "lin_epilogue_kernel",
                  "ffn_ln": "ffn_ln_kernel",
                  "dense_conv": ("dense_conv_kernel", "dense_conv_grouped_kernel"),
                  "int_attention_cached": "int_attention_cached_kernel",
                  "conv_block_cached": ("conv_block_cached_kernel", "conv_block_cached_stage"),
                  "rnnt_pred": "rnnt_pred_step_kernel", "rnnt_joint": "rnnt_joint_kernel",
                  "rnnt_greedy": "rnnt_greedy_kernel",
                  "rnnt_loss": ("rnnt_diag_kernel", "rnnt_lattice_kernel", "rnnt_occ_kernel"),
                  "rnnt_loss_from_logits": ("rnnt_lse_kernel", "rnnt_lattice_kernel",
                                            "rnnt_grad_kernel")}
# phase 12: the cache-aware stream (NeMo's cache-aware streaming Conformers
# keep 70 frames of left context), its cache forms' check grid, its feed
# sizes (40 ms, 160 ms: the timed one, 1 s) and length, and the windowed
# QuartzNet's length
STREAM_L = 70
STREAM_N, STREAM_B, STREAM_SEEN = (1, 4, 16), (1, 32), (0, 3, 69, 70, 500)
# 12a's further (B, n): 1 s slices, a tile the utterances do not fill, past
# one wave of Kernel 4's clusters, past its 32-row cluster tile (staged);
# the timed (B, n) of the cache forms and of the step
STREAM_MORE = ((1, 25), (32, 25), (3, 7), (300, 4), (2, 40))
STREAM_TIMED = ((1, 4), (32, 4), (32, 16))
# frozen_stream_step's device / host-enqueue ms at STREAM_TIMED on PR 15's
# card runs (PERF.md section 5; B=32 n=4 was not recorded)
STREAM_STEP_PR15 = {(1, 4): (2.547, "7.669-14.339"), (32, 4): None,
                    (32, 16): (3.327, "10.865")}
STREAM_SLICE, STREAM_SLICES = 2560, (640, 2560, 16000)
STREAM_SECONDS, WINDOWED_SECONDS = 15.0, 60.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# device_ms's events fallback: ~50 ms of spinning at the H100's SM clock,
# longer than the host takes to queue ten calls of any timed function
HIDE_HOST_CYCLES = 100_000_000


def cuda_ms(fn, reps: int, warmup: int = 3):
    """Per-call device times (ms) of fn(): CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def device_ms(fn, symbol=None, calls: int = 10):
    """(device time in ms per call of fn(), how it was read): torch.profiler
    (CPU and CUDA activities) over ``calls`` calls, the sum of the CUDA
    kernels' device time (of the kernels whose names hold ``symbol``, or
    one of the substrings of a tuple ``symbol``, or of all) divided by the
    calls.  A trace that holds fewer than ``calls`` of those kernels (the
    profiler drops kernel records now and then) is taken
    again, up to three times; after that CUDA events around the ``calls``
    calls in a row stand in, and the second value says "events".  The
    events' calls are queued behind a spin kernel of HIDE_HOST_CYCLES, so
    they run back to back on the card and a launch-bound kernel's reading
    is its device time, not the host's time to launch it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total_us, kernels = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if symbol is not None and not any(
                    sym in ev.key for sym in ((symbol,) if isinstance(symbol, str) else symbol)):
                continue
            us = getattr(ev, "self_device_time_total", None)
            total_us += ev.self_cuda_time_total if us is None else us
            kernels += ev.count
        if total_us > 0 and kernels >= calls:
            return total_us / 1e3 / calls, "profiler"
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HIDE_HOST_CYCLES)   # the host queues the calls meanwhile
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls, "events"


class Checker:
    """Counts kernel-vs-plain comparisons and their largest |difference|."""

    def __init__(self):
        self.n = 0
        self.max_err = {k: 0 for k in KERNELS + ("requant_fn", "conformer_int")}

    def equal(self, kind: str, what: str, got, want) -> None:
        import torch

        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                                 f"{want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max_err[kind] = max(self.max_err[kind], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel differs from plain (max |d| = {err})")
        self.n += 1


def bound(nbytes: float, int8_ops: float):
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the int8 operations over the tensor-core peak."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, int8_ops / INT8_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def wrappers():
    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_cached
    from qasr_tpu_torch.kernels.dense_conv import dense_conv
    from qasr_tpu_torch.kernels.dw_conv import dw_conv
    from qasr_tpu_torch.kernels.ffn_ln import ffn_ln
    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_cached
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm
    from qasr_tpu_torch.kernels.requant import requant
    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_greedy, rnnt_joint, rnnt_pred_step
    from qasr_tpu_torch.kernels.rnnt_loss import rnnt_loss, rnnt_loss_from_logits

    return {"dw_conv": dw_conv, "pw_gemm": pw_gemm, "requant": requant,
            "int_attention": int_attention, "conv_block": conv_block,
            "lin_epilogue": lin_epilogue, "ffn_ln": ffn_ln, "dense_conv": dense_conv,
            "int_attention_cached": int_attention_cached,
            "conv_block_cached": conv_block_cached, "rnnt_pred": rnnt_pred_step,
            "rnnt_joint": rnnt_joint, "rnnt_greedy": rnnt_greedy, "rnnt_loss": rnnt_loss,
            "rnnt_loss_from_logits": rnnt_loss_from_logits}


def planned(counts):
    """Every kernel's (and rnnt_greedy's and conv_block_cached's forms')
    expected count: 0 unless ``counts`` names it."""
    return {**{k: 0 for k in KERNELS + GREEDY_FORMS + CONV_FORMS}, **counts}


def reset_counts() -> None:
    ws = wrappers()
    for w in ws.values():
        w.launches = 0
    ws["pw_gemm"].grouped_launches = ws["dense_conv"].grouped_launches = 0
    for name in ("rnnt_greedy", "conv_block_cached"):
        for form in ws[name].forms:
            ws[name].forms[form] = 0


def read_counts():
    import torch

    torch.cuda.synchronize()
    ws = wrappers()
    counts = {k: w.launches for k, w in ws.items()}
    for name in ("rnnt_greedy", "conv_block_cached"):
        counts.update({f"{name}_{f}": n for f, n in ws[name].forms.items()})
    return counts


def phase_requant(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant_device
    from qasr_tpu_torch.ops.quant_prims import Dyadic, dyadic_requant

    zs = [0, 1, -1, 2, -2, 3, 2**29 - 1, -(2**29 - 1), 12345678, -98765432, 777,
          2**31 - 1, -2**31, 2**30 + 1, -(2**30 + 3)]
    ms = [1, 2, 3, 2**15, 2**16 - 1, 2**30, 2**31 - 1, 3 << 29]
    es = list(range(1, 71))
    z, m, e = (a.reshape(-1) for a in np.meshgrid(np.asarray(zs), np.asarray(ms),
                                                  np.asarray(es), indexing="ij"))
    rng = np.random.default_rng(0)
    n = 1 << 20
    z = np.concatenate([z, rng.integers(-(2**29) + 1, 2**29, n),
                        rng.integers(-2**31, 2**31, n)]).astype(np.int32)
    m = np.concatenate([m, rng.integers(1, 2**31, 2 * n)]).astype(np.int32)
    e = np.concatenate([e, rng.integers(1, 71, 2 * n)]).astype(np.int32)
    zt, mt, et = (torch.from_numpy(a).to(dev) for a in (z, m, e))
    want = dyadic_requant(zt, Dyadic(mt, et))
    chk.equal("requant_fn", "requant device function (boundary grid + fuzz)",
              requant_device(zt, mt, et), want)
    chk.equal("requant_fn", "hoisted requant qasr_rq (boundary grid + fuzz)",
              requant_device(zt, mt, et, fast=True), want)
    # qasr_rq_f64 on its domain: the triples above inside it, and Kernel 3's
    # score requants (|z| <= d_k 2^14, e from 26)
    za, mm = np.abs(z.astype(np.int64)), m.astype(np.int64)
    lim = np.left_shift(np.int64(1), np.minimum(e.astype(np.int64) + 26, 62))
    ok = (za * mm < lim) & (e <= 62)
    zf = np.concatenate([z[ok], rng.integers(-(2**21), 2**21 + 1, n)]).astype(np.int32)
    mf = np.concatenate([m[ok], rng.integers(1, 2**31, n)]).astype(np.int32)
    ef = np.concatenate([e[ok], rng.integers(26, 63, n)]).astype(np.int32)
    zt, mt, et = (torch.from_numpy(a).to(dev) for a in (zf, mf, ef))
    chk.equal("requant_fn", "qasr_rq_f64 on its domain (grid + fuzz)",
              requant_device(zt, mt, et, f64=True), dyadic_requant(zt, Dyadic(mt, et)))
    log(f"[3] requant device functions (qasr_requant, qasr_rq) == plain on {z.size} "
        f"(z, m, e) triples; qasr_rq_f64 on {zf.size} in its domain")


def _tables(rng, c, m16, dev):
    import torch

    if m16:
        m, e = rng.integers(2**14, 2**16, c), 22
    else:
        m, e = rng.integers(2**29, 2**31 - 1, c), 37
    return torch.from_numpy(m.astype("int32")).to(dev), e


def _vector_tables(rng, c, shift, dev):
    """Per-channel (m, e): exponents 0, 62, 63, 70 and the rest in 1-31 (in
    a random channel order), each mantissa ~2^(e - shift) so that inputs of
    about 2^shift come out near 1 (saturating where e < shift)."""
    import numpy as np
    import torch

    e = rng.permutation(np.concatenate([[0, 62, 63, 70], rng.integers(1, 32, c - 4)]))
    m = np.where(e >= 62, rng.integers(2**29, 2**31, c),
                 np.clip(np.round(2.0 ** (e - shift) * rng.uniform(0.5, 2.0, c)), 1, 2**31 - 1))
    return (torch.from_numpy(m.astype(np.int32)).to(dev),
            torch.from_numpy(e.astype(np.int32)).to(dev))


def _vector_prologue(rng, c, shift, dev):
    m1, e1 = _vector_tables(rng, c, shift, dev)
    return dict(m1=m1, e1=e1)


def phase_dw(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.models.jasper import get_same_padding, out_frames

    rng = np.random.default_rng(1)
    for c, k, s, d in DW_SITES:
        b, t_in = 3, 300 * s + 7
        pad = get_same_padding(k, s, d)
        x = torch.from_numpy(rng.integers(-64, 64, (b, t_in, c)).astype(np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-31, 32, (k, c)).astype(np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-3000, 3000, c).astype(np.int32)).to(dev)
        t_out = out_frames(t_in, k, s, pad, d)
        lens = torch.from_numpy(rng.integers(1, t_out + 1, b).astype(np.int32)).to(dev)
        conv = dict(stride=s, padding=pad, dilation=d)
        modes = {"int32": {}, "int32+bias+relu": dict(bias=bias, relu=True)}
        for m16 in (False, True):
            m, e = _tables(rng, c, m16, dev)
            modes[f"int8 m{16 if m16 else 31}"] = dict(out_len=lens, m=m, e=e, bits=7)
            modes[f"int8 m{16 if m16 else 31}+bias+relu"] = dict(
                bias=bias, relu=True, out_len=lens, m=m, e=e, bits=6)
        for name, kw in modes.items():
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(x, w, **conv, **kw), dw_conv_plain(x, w, **conv, **kw))
        # the input-requant prologue: int8 / int32 inputs, producer bias and
        # ReLU on and off, 31- and 16-bit mantissas, bits1 6/7/8, ragged
        # input lengths, with the epilogue on and off
        in_len = torch.from_numpy(rng.integers(1, t_in + 1, b).astype(np.int32)).to(dev)
        n_pro = 0
        for x32 in (False, True):
            xi = (torch.from_numpy(rng.integers(-2**20, 2**20, (b, t_in, c)).astype(np.int32))
                  .to(dev) if x32 else x)
            for bias_relu in (False, True):
                for m16 in (False, True):
                    bits1 = (6, 7, 8)[n_pro % 3]
                    m1, e1 = _tables(rng, c, m16, dev)
                    if n_pro % 4 == 3:  # one mantissa for all channels, as after a join
                        m1 = np.asarray(m1[0].item(), np.int32)
                    # exponents that spread the requant over the clamp range
                    pro = dict(in_len=in_len, m1=m1, e1=e1 + (6 if x32 else -8), bits1=bits1)
                    if bias_relu:
                        hb = 2**18 if x32 else 64
                        pro.update(in_bias=torch.from_numpy(
                            rng.integers(-hb, hb, c).astype(np.int32)).to(dev), in_relu=True)
                    epi = modes["int8 m31+bias+relu"] if n_pro % 2 else modes["int32"]
                    name = (f"prologue {'int32' if x32 else 'int8'} bias+relu={bias_relu} "
                            f"m{16 if m16 else 31}{' scalar' if m1.ndim == 0 else ''} "
                            f"bits1={bits1} epilogue={bool(n_pro % 2)}")
                    chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                              dw_conv(xi, w, **conv, **pro, **epi),
                              dw_conv_plain(xi, w, **conv, **pro, **epi))
                    n_pro += 1
        # per-channel exponents (the per_channel path's prologue and
        # epilogue): 1-31 with mantissas that keep most results inside
        # the clamp, plus 0 (counts as 1), 62, 63 and 70 (give 0)
        x32 = torch.from_numpy(rng.integers(-2**20, 2**20, (b, t_in, c)).astype(np.int32)).to(dev)
        in_bias = torch.from_numpy(rng.integers(-2**18, 2**18, c).astype(np.int32)).to(dev)
        m_v, e_v = _vector_tables(rng, c, 8, dev)
        epi_v = dict(bias=bias, relu=True, out_len=lens, m=m_v, e=e_v, bits=6)
        vector_modes = {
            "epilogue e[c]": dict(out_len=lens, m=m_v, e=e_v, bits=7),
            "epilogue e[c]+bias+relu": epi_v,
            "prologue int32 e1[c]+bias+relu, epilogue off": dict(
                _vector_prologue(rng, c, 16, dev), in_bias=in_bias, in_relu=True,
                in_len=in_len, bits1=7),
            "prologue int8 e1[c], epilogue e[c]": dict(
                _vector_prologue(rng, c, 2, dev), in_len=in_len, bits1=6, **epi_v),
            "prologue int32 e1[c]+relu, epilogue e[c] (the per_channel form)": dict(
                _vector_prologue(rng, c, 16, dev), in_relu=True, in_len=in_len, bits1=7,
                **epi_v),
            "prologue int32 0-d m1 and e1, epilogue e[c]": dict(
                m1=np.asarray(int(rng.integers(2**14, 2**15)), np.int32),
                e1=np.asarray(31, np.int32), in_relu=True, in_len=in_len, bits1=7, **epi_v),
        }
        for name, kw in vector_modes.items():
            xi = x if name.startswith("prologue int8") or name.startswith("epilogue") else x32
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(xi, w, **conv, **kw), dw_conv_plain(xi, w, **conv, **kw))
    # one channel a thread in the staging: C not a multiple of 4, and x
    # off a 16-byte boundary (a contiguous view)
    for c, x32, view in ((30, False, False), (30, True, False), (256, True, True)):
        b, t_in, k = 2, 203, 33
        n = b * t_in * c
        flat = torch.from_numpy((rng.integers(-2**20, 2**20, n + 1) if x32 else
                                 rng.integers(-64, 64, n + 1)).astype(
                                     np.int32 if x32 else np.int8)).to(dev)
        x = (flat[1:] if view else flat[:n]).view(b, t_in, c)
        w = torch.from_numpy(rng.integers(-31, 32, (k, c)).astype(np.int8)).to(dev)
        m, e = _vector_tables(rng, c, 8, dev)
        kw = dict(padding=16, out_len=torch.tensor([t_in, 150], dtype=torch.int32, device=dev),
                  m=m, e=e, bits=7)
        if x32:
            kw.update(_vector_prologue(rng, c, 16, dev), in_relu=True, bits1=7,
                      in_len=torch.tensor([t_in, 101], dtype=torch.int32, device=dev))
        chk.equal("dw_conv", f"dw_conv C={c} {'int32 prologue' if x32 else 'int8'} "
                  f"{'misaligned view' if view else ''} (one channel a thread)",
                  dw_conv(x, w, **kw), dw_conv_plain(x, w, **kw))
    log(f"[3] dw_conv == plain at {len(DW_SITES)} sites x (6 epilogue modes + 8 prologue "
        f"modes: int8/int32 input, bias+relu on/off, m31/m16, per-channel or one m1, "
        f"bits1 6/7/8, ragged in_len; 6 modes with per-channel exponents e / e1 in 1-31 "
        f"and 0, 62, 63, 70, or a 0-d m1 and e1), and one channel a thread at C=30 and on a "
        f"misaligned view")


def phase_pw(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(2)
    for (b, t), cin, cout in ((bt, ci, co) for bt in PW_BT for ci in PW_CIN for co in PW_COUT):
        x = torch.from_numpy(rng.integers(-64, 64, (b, t, cin)).astype(np.int8)).to(dev)
        wt = torch.from_numpy(rng.integers(-31, 32, (cout, cin)).astype(np.int8)).to(dev)
        bias = torch.from_numpy(rng.integers(-3000, 3000, cout).astype(np.int32)).to(dev)
        lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
        res = torch.from_numpy(
            rng.integers(-2**20, 2**20, (b, t, cout)).astype(np.int32)).to(dev)
        modes = {"none": dict(bias=bias), "none+relu": dict(bias=bias, relu=True)}
        for m16 in (False, True):
            m, e = _tables(rng, cout, m16, dev)
            m_r, e_r = _tables(rng, cout, m16, dev)
            tag = f"m{16 if m16 else 31}"
            modes[f"requant {tag}"] = dict(bias=bias, lens=lens, m=m, e=e, bits=7)
            modes[f"requant+relu {tag}"] = dict(bias=bias, relu=True, lens=lens,
                                                 m=m, e=e, bits=7)
            modes[f"join {tag}"] = dict(bias=bias, m=m, e=e, bits=6, res=res,
                                        m_r=m_r, e_r=e_r + 3)
        for name, kw in modes.items():
            chk.equal("pw_gemm", f"pw_gemm N={b * t} {cin}->{cout} {name}",
                      pw_gemm(x, wt, **kw), pw_gemm_plain(x, wt, **kw))
        # the prologue with every epilogue mode: int8 / int32 inputs,
        # bias and ReLU on and off, 31- and 16-bit mantissas, bits1
        # 6/7/8, ragged in_len or no mask (the decoder's input)
        n_pro = 0
        for x32 in (False, True):
            xi = (torch.from_numpy(rng.integers(-2**20, 2**20, (b, t, cin)).astype(np.int32))
                  .to(dev) if x32 else x)
            for mode in ("none", "requant m31", "join m16"):
                m16 = n_pro % 2 == 1
                bits1 = (6, 7, 8)[n_pro % 3]
                m1, e1 = _tables(rng, cin, m16, dev)
                if n_pro % 4 == 3:  # one mantissa for all channels, as after a join
                    m1 = np.asarray(m1[0].item(), np.int32)
                pro = dict(m1=m1, e1=e1 + (6 if x32 else -8), bits1=bits1,
                           in_len=None if mode == "none" else lens)
                if n_pro % 3 != 2:
                    hb = 2**18 if x32 else 64
                    pro.update(in_bias=torch.from_numpy(
                        rng.integers(-hb, hb, cin).astype(np.int32)).to(dev), in_relu=True)
                name = (f"prologue {'int32' if x32 else 'int8'} {mode} m{16 if m16 else 31}"
                        f"{' scalar' if m1.ndim == 0 else ''} bits1={bits1} "
                        f"bias+relu={'in_bias' in pro} "
                        f"mask={pro['in_len'] is not None}")
                chk.equal("pw_gemm", f"pw_gemm N={b * t} {cin}->{cout} {name}",
                          pw_gemm(xi, wt, **pro, **modes[mode]),
                          pw_gemm_plain(xi, wt, **pro, **modes[mode]))
                n_pro += 1
    log(f"[3] pw_gemm == plain at {len(PW_CIN) * len(PW_COUT)} (Cin, Cout) pairs "
        f"x N in {[b * t for b, t in PW_BT]} x (8 epilogue modes + 6 prologue modes: "
        f"int8/int32 input x none/requant/join, bias+relu on/off, m31/m16, per-channel or "
        f"one m1, bits1 6/7/8, ragged in_len or none)")


def phase_requant_kernel(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant, requant_plain

    rng = np.random.default_rng(12)
    b, t = 3, 203
    lens = torch.from_numpy(rng.integers(1, t + 1, b).astype(np.int32)).to(dev)
    n = 0
    for c in RQ_C:
        def vec(lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

        # per-channel exponents over the boundary values 1, 31, 62, 63 and beyond
        e_vec = torch.from_numpy(np.resize(np.asarray([1, 31, 62, 63, 70, 36, 44], np.int32),
                                           c)[rng.permutation(c)]).to(dev)
        for x32 in (False, True):
            z = torch.from_numpy((rng.integers(-2**28, 2**28, (b, t, c)) if x32 else
                                  rng.integers(-128, 128, (b, t, c)))
                                 .astype(np.int32 if x32 else np.int8)).to(dev)
            for vector in (False, True):
                if vector:
                    m, e = vec(1, 2**31), e_vec
                else:
                    # a 0-d mantissa as the per_channel tables hold one; an
                    # exponent that spreads the result over the clamp range
                    m, e = np.asarray(int(rng.integers(2**29, 2**31)), np.int32), 51 if x32 else 30
                for identity in (False, True):
                    for mask in (False, True):
                        kw = dict(lens=lens if mask else None, relu=bool(n % 2))
                        if identity:
                            kw.update(identity=torch.from_numpy(
                                rng.integers(-2**24, 2**24, (b, t, c)).astype(np.int32)).to(dev),
                                m_r=vec(2**29, 2**31) if vector else 2**30 + 3,
                                e_r=e_vec.flip(0).contiguous() if vector else 63)
                        bits = (6, 7, 8, 9)[n % 4]
                        name = (f"requant C={c} {'int32' if x32 else 'int8'} "
                                f"{'vector' if vector else 'scalar'} m/e identity={identity} "
                                f"mask={mask} relu={kw['relu']} bits={bits}")
                        chk.equal("requant", name, requant(z, m, e, bits, **kw),
                                  requant_plain(z, m, e, bits, **kw))
                        n += 1
            # every row masked: written 0 without being read
            m = vec(1, 2**31)
            kw = dict(lens=torch.zeros(b, dtype=torch.int32, device=dev), identity=z.to(
                torch.int32), m_r=vec(1, 2**31), e_r=e_vec, relu=True)
            for bits in (7, 9):
                chk.equal("requant", f"requant C={c} {'int32' if x32 else 'int8'} all rows "
                          f"masked bits={bits}", requant(z, m, e_vec, bits, **kw),
                          requant_plain(z, m, e_vec, bits, **kw))
                n += 1
    # a contiguous view that starts off a 16-byte boundary (the element path)
    c = 512
    flat = torch.from_numpy(rng.integers(-2**28, 2**28, b * t * c + 1).astype(np.int32)).to(dev)
    z = flat[1:].view(b, t, c)
    m = torch.from_numpy(rng.integers(1, 2**31, c).astype(np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(36, 44, c).astype(np.int32)).to(dev)
    chk.equal("requant", "requant C=512 int32 misaligned view", requant(z, m, e, 7, lens=lens),
              requant_plain(z, m, e, 7, lens=lens))
    n += 1
    log(f"[3] requant == plain at {n} cases: C in {RQ_C}, int8/int32 input, scalar and "
        f"per-channel m/e (exponents 1, 31, 62, 63, 70), identity and mask on/off, "
        f"bits 6-9, every row masked, a misaligned view")


def phase_golden(dev):
    """Full-width QuartzNet15x5 against both JAX golden records: static_e
    on FrozenExecFused, FrozenExecKernels and the plain executor;
    per_channel on FrozenExecKernels and the plain executor."""
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.freeze import (
        FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest, tables_to_device,
    )

    model = golden.quartznet15x5_w6a6()
    feats, lens = golden.golden_features(model.plan.feat_in)
    tables = {}
    for mode, executors in (("static_e", (FrozenExecFused, FrozenExecKernels, FrozenExec)),
                            ("per_channel", (FrozenExecKernels, FrozenExec))):
        host = model.freeze_host(mode)
        want = golden.load_golden(mode)
        digest = tables_digest(host)
        if digest != want["tables_sha256"]:
            raise AssertionError(f"{mode} table digest {digest} != golden "
                                 f"{want['tables_sha256']}")
        tables[mode] = tables_to_device(host, dev)
        for ex in executors:
            bad = golden.compare_golden(
                golden.port_record(model, tables[mode], feats, lens, executor=ex), want)
            if bad:
                raise AssertionError(f"{mode} golden mismatch on {ex.__name__} in {bad}")
        log(f"[4] golden {mode}: tables {digest[:16]}, ids/enc_lens/decoder-input/logits "
            f"hashes equal the JAX record on {[ex.__name__ for ex in executors]} "
            f"(enc_lens {want['enc_lens']})")
    return model, tables


def phase_serve(model, dev):
    """4 requests through transcribe in each dyadic mode, with the launch
    counts read around each; returns {mode: counts}."""
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    utts, secs = seeded_requests(7)
    batch, lens = pad_batch(utts)
    try:
        model.freeze("static_e16", dev)
        raise AssertionError("the flagship's static_e16 freeze was expected to raise")
    except ValueError as err:
        if "static_e16 exponent out of range" not in str(err):
            raise
        log(f"[5] QuartzNet static_e16: freeze raises as in the JAX package ({err})")
    all_counts = {}
    for mode in QUARTZNET_MODES:
        tables = model.freeze(mode, dev)
        model.transcribe(utts[:1], device=dev, dyadic_mode=mode)  # builds and caches
        reset_counts()
        texts = model.transcribe(utts, batch_size=4, device=dev, dyadic_mode=mode)
        counts = read_counts()
        expect = planned(kernel_launches(model.plan, tables))
        if counts != expect:
            raise AssertionError(f"QuartzNet {mode} launch counts {counts} != plan {expect}")
        ids_k, el_k = make_frozen_fn(model, tables, argmax=True)(batch, lens)
        ids_p, el_p = make_frozen_fn(model, tables, argmax=True, fused=False)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"{mode}: kernel path ids differ from the plain executor's")
        if texts != model.ids_to_text(ids_p, el_p):
            raise AssertionError(f"{mode}: transcribe() differs from the plain executor's "
                                 f"transcripts")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError("degenerate ids")
        for s_, txt in zip(secs, texts):
            log(f"[5] QuartzNet {mode} {s_:5.1f} s -> {txt[:80]!r}")
        log(f"[5] QuartzNet {mode} (dyadic16={bool(tables.get('dyadic16'))}) served 4 "
            f"requests; launches {counts} == plan; ids == plain executor")
        all_counts[mode] = counts
    return all_counts


def seeded_requests(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    secs = (4.0, 7.3, 11.6, 15.0)
    return [np.clip(rng.normal(size=int(16000 * s)) * 0.1 * 32767, -32768, 32767)
            .astype(np.int16) for s in secs], secs


def pad_batch(utts):
    import numpy as np

    lens = np.asarray([len(u) for u in utts], np.int32)
    batch = np.zeros((len(utts), lens.max()), np.int16)
    for i, u in enumerate(utts):
        batch[i, :len(u)] = u
    return batch, lens


def timed_pair(chk, kind, label, kern, plain, card, rows, library=None, plain_reps=5):
    """Hold kern() against plain() (exact), then time both (and the
    library call, if any) with CUDA events around each call (median of
    10; the plain version 2 x ``plain_reps`` calls, after 3 warm-ups each
    unless ``plain_reps`` is 1), and the kernel and the library call in
    device time (torch.profiler over 10 calls)."""
    chk.equal(kind, label, kern(), plain())
    warm = 3 if plain_reps > 1 else 0
    pk = statistics.median(cuda_ms(plain, reps=plain_reps, warmup=warm)
                           + cuda_ms(plain, reps=plain_reps, warmup=warm))
    kk = statistics.median(cuda_ms(kern, reps=10))
    kd, kd_by = device_ms(kern, KERNEL_SYMBOLS[kind])
    lib = lib_d = lib_by = None
    if library is not None:
        lib = statistics.median(cuda_ms(library, reps=10))
        lib_d, lib_by = device_ms(library)
    rows.append({"shape": label, "kernel": kind, "call_ms": kk, "device_ms": kd,
                 "device_ms_by": kd_by, "plain_ms": pk, "library_call_ms": lib,
                 "library_device_ms": lib_d, "library_device_ms_by": lib_by})
    log(f"[6] {label}: kernel {kd:.4f} ms device ({kd_by}; {kk:.4f} ms call), plain "
        f"{pk:.4f} ms"
        + (f", library {lib_d:.4f} ms device ({lib_by}; {lib:.4f} ms call)"
           if lib is not None else "")
        + f", equal [{card}]")
    return rows[-1]


def step_times(fns, args, card, tag, batch, seconds, report):
    steps = {}
    for name in list(fns) + list(fns)[::-1]:  # in turns, 2 x 5 each
        steps.setdefault(name, []).extend(cuda_ms(lambda fn=fns[name]: fn(*args), reps=5))
    step = {k: statistics.median(v) for k, v in steps.items()}
    for k in fns:
        log(f"[6] {tag} B={batch} x {seconds:g} s step, {k} path: median {step[k]:.3f} ms "
            f"of {len(steps[k])} ({batch * seconds / step[k] * 1e3:.1f} audio-s/s) [{card}]")
    report[f"{tag.lower()}_step_ms"] = step
    report[f"{tag.lower()}_step_samples_ms"] = steps
    return step


def dw_serving_sites(plan):
    """(C, K, stride, dilation) of every depthwise conv of a QuartzNet plan,
    once each, in walk order."""
    from qasr_tpu_torch.models.jasper import is_depthwise

    sites = []
    for bp in plan.blocks:
        for spec in bp.convs:
            key = (spec.in_ch, spec.kernel, spec.stride, spec.dilation)
            if is_depthwise(spec) and key not in sites:
                sites.append(key)
    return sites


def time_dw_sites(chk, rows, rng, dev, card, sites, batch=64, t_enc=768):
    """Kernel 1 at every depthwise site of the serving path, in the form
    each dyadic mode runs it most: static_e on an int8 input with the
    epilogue (static exponent); per_channel on a pointwise conv's int32
    output through the prologue and the epilogue, per-channel exponents (at
    the stride-2 C1 site the input is the quantized features: int8, the
    epilogue only).  Then the static path's two prologue sites (#8, #9),
    and the epilogue-off function at C=512 K=75 and at C2 beside cuDNN's
    float32 depthwise conv (TF32 off; exact while |acc| < 2^24, which
    torch.equal checks), its yardstick."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.models.jasper import get_same_padding

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    def pair(label, x, w, kw, vec_bytes, library=None):
        r = timed_pair(chk, "dw_conv", label, lambda: dw_conv(x, w, **kw),
                       lambda: dw_conv_plain(x, w, **kw), card, rows, library)
        c, k = x.shape[2], w.shape[0]
        out_bytes = (1 if "m" in kw else 4) * batch * t_enc * c
        r["bound"] = bound(x.numel() * x.element_size() + w.numel() + vec_bytes + out_bytes,
                           2 * k * batch * t_enc * c)
        return r

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    for c, k, s_, d in sites:
        conv = dict(stride=s_, padding=get_same_padding(k, s_, d), dilation=d)
        shape = f"B={batch} T={t_enc * s_} C={c} K={k} s={s_} d={d}"
        w = t8(k, c)
        pair(f"dw_conv {shape} int8", t8(batch, t_enc * s_, c), w,
             dict(conv, out_len=full, m=vec(c, 2**29, 2**31 - 1), e=37, bits=7),
             4 * (c + batch))
        m, e = _vector_tables(rng, c, 8, dev)
        kw = dict(conv, out_len=full, m=m, e=e, bits=6)
        if s_ == 1:
            m1, e1 = _vector_tables(rng, c, 16, dev)
            kw.update(in_relu=True, in_len=full, m1=m1, e1=e1, bits1=7)
            pair(f"dw_conv per_channel {shape} int32 in e1[c], e[c] out", t32(batch, t_enc, c), w,
                 kw, 4 * (4 * c + 2 * batch))
        else:
            pair(f"dw_conv per_channel {shape} int8 in, e[c] out", t8(batch, t_enc * s_, c), w,
                 kw, 4 * (2 * c + batch))
    # the static path's prologue sites: a block's first depthwise conv on a
    # block end's raw int32 accumulator (C1 -> B1.1, the #8 form) and on a
    # join's int8 output (the #9 form), each with its consumer epilogue
    for c, k, x32 in [(256, 33, True), (512, 63, False)]:
        kw = dict(padding=get_same_padding(k, 1, 1), in_len=full, m1=vec(c, 2**29, 2**31 - 1),
                  e1=43 if x32 else 29, bits1=7, in_relu=True, out_len=full,
                  m=vec(c, 2**29, 2**31 - 1), e=37, bits=6)
        if x32:
            kw["in_bias"] = vec(c, -2**18, 2**18)
        pair(f"dw_conv prologue B={batch} T={t_enc} C={c} K={k} "
             f"{'int32+bias' if x32 else 'int8'}+relu in, int8 out",
             t32(batch, t_enc, c) if x32 else t8(batch, t_enc, c), t8(k, c), kw,
             4 * (3 * c + 2 * batch))
    # the epilogue-off function beside cuDNN (used nowhere in the port)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for c, k, d in [(512, 75, 1), (512, 87, 2)]:
            pad = get_same_padding(k, 1, d)
            x, w = t8(batch, t_enc, c), t8(k, c)
            xf = x.permute(0, 2, 1).contiguous().float()
            wf = w.t().contiguous().float()[:, None, :]

            def library(xf=xf, wf=wf, c=c, pad=pad, d=d):
                return F.conv1d(xf, wf, groups=c, padding=pad, dilation=d)

            exact = torch.equal(library().round().to(torch.int32).permute(0, 2, 1),
                                dw_conv(x, w, padding=pad, dilation=d))
            r = pair(f"dw_conv B={batch} T={t_enc} C={c} K={k} s=1 d={d} epilogue off (cuDNN "
                     f"{'exact' if exact else 'inexact'})", x, w, dict(padding=pad, dilation=d),
                     0, library if exact else None)
            r["library_exact"] = exact
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def time_requant_sites(chk, rows, rng, dev, card, batch=64, t_enc=768):
    """Kernel 7 at the sites the per_channel path still runs in it: a
    residual branch's input (int8 after a join, int32 after a block end),
    C3's input (int32, ReLU), the residual joins and the decoder's input
    (unmasked)."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import requant, requant_plain

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    e_pc = torch.from_numpy(rng.integers(36, 44, 1024).astype(np.int32)).to(dev)
    for c, what, x32 in [(256, "input", False), (512, "input", False), (256, "input", True),
                         (512, "input", True), (256, "join", True), (512, "join", True),
                         (1024, "decoder", True)]:
        z = t32(batch, t_enc, c) if x32 else t8(batch, t_enc, c)
        kw = dict(lens=full if what == "input" else None,
                  relu=what == "decoder" or (what == "input" and x32))
        if what == "join":
            kw.update(identity=t32(batch, t_enc, c), m_r=vec(c, 2**29, 2**31 - 1),
                      e_r=e_pc[:c].flip(0).contiguous())
        args = (z, vec(c, 2**29, 2**31 - 1), e_pc[:c].contiguous(), 6)
        r = timed_pair(chk, "requant", f"requant N={batch * t_enc} C={c} "
                       f"{'int32' if x32 else 'int8'} per-channel {what}",
                       lambda a=args, kw=kw: requant(*a, **kw),
                       lambda a=args, kw=kw: requant_plain(*a, **kw), card, rows)
        r["bound"] = bound(z.numel() * (z.element_size() + 1 + 4 * (what == "join"))
                           + 4 * c * (2 + 2 * (what == "join"))
                           + (4 * batch if what == "input" else 0), 0)


def phase_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    batch, seconds = 64, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.normal(size=(batch, n)).astype(np.float32) * 0.1).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    st, pc = tables["static_e"], tables["per_channel"]
    fns = {"kernel": make_frozen_fn(model, st, argmax=True),
           "kernel_per_channel": make_frozen_fn(model, pc, argmax=True),
           "plain": make_frozen_fn(model, st, argmax=True, fused=False),
           "plain_per_channel": make_frozen_fn(model, pc, argmax=True, fused=False)}
    step = step_times(fns, (audio, lens), card, "QuartzNet", batch, seconds, report)

    # each kernel against its plain version at the main path's shapes
    t_enc = 768  # 15 s -> 1501 frames -> padded 1536 -> stride 2
    rows = []

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    time_dw_sites(chk, rows, rng, dev, card, dw_serving_sites(model.plan), batch, t_enc)
    for cin, cout, mode in [(64, 256, "requant"), (256, 256, "requant"), (512, 512, "requant"),
                            (512, 512, "join"), (512, 1024, "none"), (1024, 29, "none")]:
        x = t8(batch, t_enc, cin)
        wt = t8(cout, cin)
        kw = dict(bias=vec(cout, -3000, 3000))
        if mode != "none":
            kw.update(m=vec(cout, 2**29, 2**31 - 1), e=37, bits=6)
        if mode == "requant":
            kw.update(relu=True, lens=full)
        if mode == "join":
            kw.update(res=torch.from_numpy(rng.integers(-2**20, 2**20, (batch, t_enc, cout))
                                           .astype(np.int32)).to(dev),
                      m_r=vec(cout, 2**29, 2**31 - 1), e_r=40)
        x2, wt_t = x.reshape(-1, cin), wt.t()
        lib = (lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t)) if cout % 8 == 0 else None
        r = timed_pair(chk, "pw_gemm", f"pw_gemm N={batch * t_enc} {cin}->{cout} {mode}",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows, lib)
        out_bytes = (4 if mode == "none" else 1) * batch * t_enc * cout
        res_bytes = 4 * batch * t_enc * cout if mode == "join" else 0
        vec_bytes = 4 * cout * (1 + (mode != "none") + (mode == "join")) \
            + (4 * batch if mode == "requant" else 0)
        r["bound"] = bound(x.numel() + wt.numel() + vec_bytes + out_bytes + res_bytes,
                           2 * batch * t_enc * cin * cout)

    def t32(*shape):
        return torch.from_numpy(rng.integers(-2**20, 2**20, shape).astype(np.int32)).to(dev)

    # the prologue sites of Kernel 2: a residual pointwise conv on a join's
    # int8 output, C3 and the decoder on a raw int32 accumulator (the
    # decoder's input is not masked)
    for cin, cout, x32, mask in [(256, 256, False, True), (512, 1024, True, True),
                                 (1024, 29, True, False)]:
        x = t32(batch, t_enc, cin) if x32 else t8(batch, t_enc, cin)
        wt = t8(cout, cin)
        kw = dict(bias=vec(cout, -3000, 3000), m1=vec(cin, 2**29, 2**31 - 1),
                  e1=43 if x32 else 29, bits1=7 if mask else 6, in_relu=True,
                  in_len=full if mask else None)
        if x32:
            kw["in_bias"] = vec(cin, -2**18, 2**18)
        x8 = t8(batch * t_enc, cin)
        wt_t = wt.t()
        lib = (lambda x8=x8, wt_t=wt_t: torch._int_mm(x8, wt_t)) if cout % 8 == 0 else None
        r = timed_pair(chk, "pw_gemm", f"pw_gemm prologue N={batch * t_enc} {cin}->{cout} "
                       f"{'int32+bias' if x32 else 'int8'}+relu in, none",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows, lib)
        r["bound"] = bound(x.numel() * x.element_size() + wt.numel() + 4 * (3 * cin + cout)
                           + (4 * batch if mask else 0) + 4 * batch * t_enc * cout,
                           2 * batch * t_enc * cin * cout)
    time_requant_sites(chk, rows, rng, dev, card, batch, t_enc)
    report["quartznet_per_kernel"] = rows
    return step, rows


# ---------------------------------------------------------------------------
# the Conformer-CTC path
# ---------------------------------------------------------------------------


def phase_int_fns(chk, dev):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.requant import int_fn_device, ln_core_device
    from qasr_tpu_torch.ops import integer_layernorm as iln
    from qasr_tpu_torch.ops import integer_sigmoid as isg
    from qasr_tpu_torch.ops import integer_softmax as ism

    q = torch.arange(-ism.N_IN, 1, dtype=torch.int32, device=dev)
    chk.equal("conformer_int", "i_exp on [-N_IN, 0]", int_fn_device("i_exp", q), ism.i_exp(q))
    chk.equal("conformer_int", "i_exp >> 4 from the quadratic's table on [-N_IN, 0]",
              int_fn_device("i_exp_tab", q), ism.i_exp(q) >> 4)
    q = torch.arange(-ism.N_IN - 64, ism.N_IN + 65, dtype=torch.int32, device=dev)
    chk.equal("conformer_int", "i_sigmoid_grid on [-N_IN-64, N_IN+64]",
              int_fn_device("i_sigmoid_grid", q), isg.i_sigmoid_grid(q))
    # Kernel 4's GLU gate: the table lookup, over the whole domain and the
    # requant's extremes
    from qasr_tpu_torch.kernels.conv_block import sigmoid_table

    qx = torch.cat([q, torch.tensor([-(1 << 26), -(1 << 26) + 1, (1 << 26) - 1, 1 << 26],
                                    dtype=torch.int32, device=dev)])
    chk.equal("conformer_int", "i_sigmoid_tab on [-N_IN-64, N_IN+64] and +-2^26",
              int_fn_device("i_sigmoid_tab", qx, sigmoid_table(dev)), isg.i_sigmoid_grid(qx))
    # Kernel 3's division by the row sum: every divisor in [1, 2^20] against
    # a grid of numerators, then random pairs up to the numerator bound 2^31
    dd = torch.arange(1, (1 << 20) + 1, dtype=torch.int64, device=dev)
    top = (1 << 31) - 1
    mult = top - top % dd
    n_div = 0
    for num in (torch.zeros_like(dd), torch.ones_like(dd), dd - 1, dd, dd + 1, 2 * dd - 1,
                mult, mult - 1, torch.full_like(dd, top), 116_970 * 127 + dd // 2):
        chk.equal("conformer_int", "div over den in [1, 2^20]",
                  int_fn_device("div", num.to(torch.int32), dd.to(torch.int32)),
                  torch.div(num, dd, rounding_mode="floor").to(torch.int32))
        n_div += dd.numel()
    drng = np.random.default_rng(4)
    for dmax in (300_000_000, top):
        num = torch.from_numpy(drng.integers(0, 1 << 31, 1 << 20)).to(dev)
        den = torch.from_numpy(drng.integers(1, dmax + 1, 1 << 20)).to(dev)
        chk.equal("conformer_int", f"div on random pairs, den up to {dmax}",
                  int_fn_device("div", num.to(torch.int32), den.to(torch.int32)),
                  torch.div(num, den, rounding_mode="floor").to(torch.int32))
        n_div += num.numel()
    v = torch.arange(0, 2**16 + 1, dtype=torch.int32, device=dev) << 12
    chk.equal("conformer_int", "isqrt on var << 12, var in [0, 2^16]",
              int_fn_device("isqrt", v), iln.i_sqrt(v))
    v = torch.cat([v, torch.arange(0, 1 << 22, dtype=torch.int32, device=dev),
                   torch.randint(0, 1 << 30, (1 << 20,), dtype=torch.int32, device=dev)])
    chk.equal("conformer_int", "isqrt_f on var << 12, [0, 2^22) and random n < 2^30",
              int_fn_device("isqrt_f", v), iln.i_sqrt(v))
    rng = np.random.default_rng(3)
    n = np.arange(-70_000, 70_001, dtype=np.int32)
    a = np.concatenate([n, n, n, rng.integers(-2**30, 2**30, 1 << 20)]).astype(np.int32)
    b = np.concatenate([np.full(n.size, ism.Q_LN2), np.full(n.size, 568), np.full(n.size, 7),
                        rng.integers(1, 2**20, 1 << 20) * rng.choice([-1, 1], 1 << 20)])
    at, bt = (torch.from_numpy(x.astype(np.int32)).to(dev) for x in (a, b))
    chk.equal("conformer_int", "floor_div on signed grids", int_fn_device("floor_div", at, bt),
              torch.div(at, bt, rounding_mode="floor"))
    for d in (64, 256, 512):
        x = rng.integers(-128, 128, (4096, d)).astype(np.int8)
        x[0], x[1], x[2, : d // 2] = 0, -3, 5
        xt = torch.from_numpy(x).to(dev)
        want = iln.i_layernorm_core(xt)
        chk.equal("conformer_int", f"i-LN row core d={d}", ln_core_device(xt), want)
        chk.equal("conformer_int", f"i-LN row core, divide form, d={d}",
                  ln_core_device(xt, div=True), want)
    log(f"[3] Conformer integer device functions == plain over their domains "
        f"(i_exp {ism.N_IN + 1}, i_sigmoid_grid {2 * ism.N_IN + 129}, i_sigmoid_tab "
        f"{qx.numel()}, i_exp from its table {ism.N_IN + 1}, div {n_div}, isqrt 65537, "
        f"isqrt_f {v.numel()}, floor_div {a.size}, i-LN 3 x 4096 rows in both forms)")


def small_conformer(dev, d_model):
    """A one-layer Conformer table built without jax: seed-0 weights,
    seeded ranges (the conv_block check at widths other than 256)."""
    import numpy as np

    from qasr_tpu_torch.golden import conformer_flagship_configs
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC
    from qasr_tpu_torch.quantize.conformer_ptq import ConformerQuantConfig, init_conformer_qstate

    cfg, ccfg = conformer_flagship_configs(layers=1, d_model=d_model)
    m = ConformerCTC.from_config(cfg, ccfg, seed=0)
    m.enc_qcfg = ConformerQuantConfig(quantize_attention=True, integer_softmax=True,
                                      integer_layernorm=True, integer_activations=True,
                                      static_attention=True)
    qs = init_conformer_qstate(ccfg, m.enc_qcfg)
    qs["dec_in"] = {"x_min": np.float32(0), "x_max": np.float32(0)}
    rng = np.random.default_rng(11)
    for site in [qs["pre_out"], qs["dec_in"]] + [x for layer in qs["layers"]
                                                 for x in layer.values()]:
        site["x_min"], site["x_max"] = np.float32(-rng.uniform(0.5, 8)), np.float32(rng.uniform(0.5, 8))
    m.enc_qstate = qs
    return m.freeze(dev)["encoder"]["layers"][0]


def phase_int_attention(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain

    tbl = tables["encoder"]["layers"][0]
    rng = np.random.default_rng(5)
    h, d_k, n = 4, 64, 0
    for t in ATT_T:
        b = 4 if t >= 375 else 3
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.from_numpy(np.concatenate([[t], rng.integers(1, t + 1, b - 1)])
                                .astype(np.int32)).to(dev)
        for left, right in ATT_CTX:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention B={b} T={t} ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    t, b = 129, 2
    for d_k in ATT_DK:
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, 77], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention d_k={d_k} T={t} ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    # the streaming form (no score rows in shared memory): long inputs
    from qasr_tpu_torch.kernels.int_attention import resident

    for t in ATT_T_LONG:
        b = 2
        if resident(t, d_k):
            raise AssertionError(f"T={t} was meant to take the streaming form")
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (b, t, h, d_k)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, d_k)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, int(rng.integers(1, t))], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention streaming B={b} T={t} "
                      f"ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    # score requants outside qasr_rq_f64's domain take qasr_rq, both forms
    for t in (129, ATT_T_LONG[0]):
        qu, qv, k, v = (torch.from_numpy(rng.integers(-128, 128, (2, t, h, 64)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-128, 128, (2 * t - 1, h, 64)).astype(np.int8)).to(dev)
        lens = torch.tensor([t, t // 2], dtype=torch.int32, device=dev)
        kw = dict(ac=(2**30 + 5, 22), bd=(2**29 + 3, 21), ctx_rq=tbl["ctx_rq"], left=-1,
                  right=-1, nbits=8)
        chk.equal("int_attention", f"int_attention T={t} with score requants on qasr_rq",
                  int_attention(qu, qv, k, v, p, lens, **kw),
                  int_attention_plain(qu, qv, k, v, p, lens, **kw))
        n += 1
    # lengths past T count as T (the plain version's arange(T) < lens), both
    # forms, with T off the 64-key chunk so the padded keys [T, Tp) exist
    for t in (37, 375, ATT_T_LONG[0]):
        qu, qv, k, v = (torch.from_numpy(rng.integers(-127, 127, (2, t, h, 64)).astype(np.int8))
                        .to(dev) for _ in range(4))
        p = torch.from_numpy(rng.integers(-127, 127, (2 * t - 1, h, 64)).astype(np.int8)).to(dev)
        lens = torch.tensor([t + 1, t + 100], dtype=torch.int32, device=dev)
        for left, right in ATT_CTX[::2]:
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=left,
                      right=right, nbits=8)
            chk.equal("int_attention", f"int_attention T={t} lens={lens.tolist()} "
                      f"ctx=({left}, {right})",
                      int_attention(qu, qv, k, v, p, lens, **kw),
                      int_attention_plain(qu, qv, k, v, p, lens, **kw))
            n += 1
    log(f"[3] int_attention == plain at {n} (T, d_k, context, requant) cases, ragged "
        f"lengths and lengths past T, T in {ATT_T_LONG} on the streaming form")


def phase_conv_block(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import _packed, conv_block, conv_block_plain

    rng = np.random.default_rng(6)
    layers = {64: small_conformer(dev, 64), 256: tables["encoder"]["layers"][3],
              512: small_conformer(dev, 512)}
    for d in CONV_D:
        for t in CONV_T:
            b = (32 if d == 256 else 4) if t == 375 else 3
            c8, x8 = (torch.from_numpy(rng.integers(-127, 127, (b, t, d)).astype(np.int8)).to(dev)
                      for _ in range(2))
            lens = torch.from_numpy(np.concatenate([[t], rng.integers(1, t + 1, b - 1)])
                                    .astype(np.int32)).to(dev)
            want = conv_block_plain(c8, x8, lens, layers[d], (15, 15), nbits=8)
            chk.equal("conv_block", f"conv_block d={d} B={b} T={t}",
                      conv_block(c8, x8, lens, layers[d], (15, 15), nbits=8), want)
            if d == 256 and t == 375:
                # the same layer with every requant on qasr_rq (the form for
                # tables outside qasr_rq_f64's domain)
                rq_only = dict(layers[d], _conv_block={**_packed(layers[d]), "f64": False})
                chk.equal("conv_block", f"conv_block d={d} B={b} T={t}, requants on qasr_rq",
                          conv_block(c8, x8, lens, rq_only, (15, 15), nbits=8), want)
    log(f"[3] conv_block == plain at d in {CONV_D} x T in {CONV_T}, ragged lengths, and "
        f"with every requant on qasr_rq at d=256 T=375")


def _lin_sites(tables):
    """The Conformer path's Kernel 5 sites on the flagship's layer 0:
    (label, mode, site, epilogue kwargs, K)."""
    from qasr_tpu_torch.quantize.conformer_freeze import _pos_tables

    enc = tables["encoder"]
    tbl = enc["layers"][0]
    pos = _pos_tables(enc, 375)[1][0]
    sites = [("q_u", "rq", tbl["att_q_u"], {}), ("pre", "rq", enc["pre"], {}),
             ("pos", "rq", pos, {}),
             ("ff1 l1", "swish", tbl["ff1_l1"], dict(swish=(tbl["ff1_grid"], tbl["ff1_prod"]))),
             ("ff1 l2", "join", tbl["ff1_l2"], dict(stream_rq=tbl["j1_stream"]))]
    return [(f"{name} {s['wt'].shape[1]}->{s['wt'].shape[0]}" + ("" if "b" in s else " no bias"),
             mode, s, kw) for name, mode, s, kw in sites]


def phase_lin_epilogue(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain

    rng = np.random.default_rng(9)
    sites = _lin_sites(tables)
    # seeded sites with exponents above 31 in every requant of each mode
    for mode, (k, d) in (("rq", (256, 256)), ("swish", (256, 1024)), ("join", (1024, 256))):
        site = {"wt": torch.from_numpy(rng.integers(-127, 127, (d, k)).astype(np.int8)).to(dev),
                "b": torch.from_numpy(rng.integers(-2**15, 2**15, d).astype(np.int32)).to(dev),
                "m": torch.from_numpy(rng.integers(2**29, 2**31 - 1, d).astype(np.int32)).to(dev),
                "e": 37}
        kw = {"rq": {}, "swish": dict(swish=((2**30 + 7, 36), (1234567, 40))),
              "join": dict(stream_rq=(2**31 - 1, 33))}[mode]
        sites.append((f"seeded {k}->{d} e>31", mode, site, kw))
    n_cases = 0
    for label, mode, site, kw in sites:
        d, k = site["wt"].shape
        for bias in (True, False):
            s_ = site if bias else {n: v for n, v in site.items() if n != "b"}
            for n in LIN_N:
                x = torch.from_numpy(rng.integers(-127, 127, (n, k)).astype(np.int8)).to(dev)
                args = dict(kw, nbits=8)
                if mode == "join":
                    args["stream8"] = torch.from_numpy(
                        rng.integers(-127, 127, (n, d)).astype(np.int8)).to(dev)
                chk.equal("lin_epilogue", f"lin_epilogue {label} {mode} bias={bias} N={n}",
                          lin_epilogue(x, s_, **args), lin_epilogue_plain(x, s_, **args))
                n_cases += 1
    log(f"[3] lin_epilogue == plain at {n_cases} cases: every path (K, D) in rq / swish / "
        f"join, with and without bias, N in {LIN_N}, and seeded e > 31")


def out_of_f64(site):
    """A copy of a requant site pushed out of qasr_rq_f64's domain: its
    mantissas rescaled to e = 20 (about the same function) and column 0's
    made 2^30, so that some |z| m reaches 2^(e + 26) and the kernel has to
    requant the site with qasr_rq (saturating column 0)."""
    e = int(site["e"])
    if e < 20:
        raise AssertionError(f"out_of_f64 needs e >= 20, got {e}")
    m = (site["m"] >> (e - 20)).clone()
    m[0] = 2 ** 30
    return {**{k: v for k, v in site.items() if not k.startswith("_")}, "m": m, "e": 20}


def ffn_forms(layers):
    """Kernel 6's three forms on the Conformer path: (label, layer table,
    half, stream requant, tail): FFN1 with the ln_att tail, FFN2 with the
    ln_out tail (the next layer's stream), the last layer's FFN2 without."""
    first, last = layers[0], layers[-1]
    return [("ff1 + ln_att", first, "ff1", "j1_stream", first["ln_att"]),
            ("ff2 + ln_out", first, "ff2", "j4_stream", first["ln_out"]),
            ("ff2 no tail", last, "ff2", "j4_stream", None)]


def phase_ffn_ln(chk, dev, tables):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.ffn_ln import _packed, ffn_ln, ffn_ln_plain

    rng = np.random.default_rng(10)
    layers = {64: small_conformer(dev, 64), 256: tables["encoder"]["layers"][0],
              512: small_conformer(dev, 512)}
    n = 0
    for d in FFN_D:
        tbl = layers[d]
        sites = {"ln": tbl["ln_ff1"], "l1": tbl["ff1_l1"], "l2": tbl["ff1_l2"],
                 "tail": tbl["ln_att"]}
        # the layer as it is (the flagship's sites all on the FP64 pipe);
        # then all four sites, and l1 alone, pushed onto qasr_rq
        variants = [("as frozen", sites),
                    ("qasr_rq", {k: out_of_f64(v) for k, v in sites.items()}),
                    ("l1 on qasr_rq", {**sites, "l1": out_of_f64(sites["l1"])})]
        for label, st in variants:
            on_f64 = {k: _packed(v)["mf"] is not None for k, v in st.items()}
            if any(on_f64[k] for k, v in st.items() if v is not sites[k]) or \
                    (d == 256 and label == "as frozen" and not all(on_f64.values())):
                raise AssertionError(f"d={d} {label}: the host's requant choice {on_f64}")
            if label == "as frozen":
                log(f"[3] ffn_ln d={d}: sites on the FP64 pipe {on_f64}")
            for t in FFN_T:
                if label != "as frozen" and t != FFN_T[-1]:
                    continue
                b = (32 if d == 256 else 4) if t == 375 else 3
                x = torch.from_numpy(rng.integers(-127, 127, (b, t, d)).astype(np.int8)).to(dev)
                for tail in (st["tail"], None):
                    args = (x, st["ln"], st["l1"], tbl["ff1_grid"], tbl["ff1_prod"], st["l2"],
                            tbl["j1_stream"], tail)
                    (got, got_t), (want, want_t) = (ffn_ln(*args, nbits=8),
                                                    ffn_ln_plain(*args, nbits=8))
                    what = f"ffn_ln d={d} B={b} T={t} tail={tail is not None} {label}"
                    chk.equal("ffn_ln", what, got, want)
                    if tail is not None:
                        chk.equal("ffn_ln", what + " (tail)", got_t, want_t)
                    elif got_t is not None:
                        raise AssertionError(f"{what}: a tail without a tail table")
                    n += 1
    log(f"[3] ffn_ln == plain at {n} cases: d in {FFN_D} x T in {FFN_T} (N ragged against "
        f"32-row tiles), tail on and off, the layers as frozen; at "
        f"T={FFN_T[-1]} also every site, and l1 alone, pushed onto qasr_rq")


def conformer_plans():
    from qasr_tpu_torch.quantize.conformer_freeze import DEFAULT_PLAN, ConformerPlan

    return DEFAULT_PLAN, ConformerPlan("conv", True), ConformerPlan("conv", False)


def phase_conformer_golden(dev):
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.conformer_freeze import conformer_tables_digest

    model = golden.conformer16x256_w8a8()
    tables = model.freeze(dev)
    plans = conformer_plans()
    runs = [(True, plan) for plan in plans] + [(False, plans[0])]
    for kernels, plan in runs:
        res = golden.check_conformer_golden(model, tables, kernels=kernels, plan=plan)
        if res["bad"]:
            raise AssertionError(f"Conformer golden mismatch ({plan if kernels else 'plain'} "
                                 f"path) in {res['bad']}: {res}")
    log(f"[4] Conformer golden: tables {conformer_tables_digest(tables['encoder'])[:16]}; x8 "
        f"{res['x8_flips']} of {res['x8_size']} codes flipped (max |d| {res['x8_max_diff']}, "
        f"limit 0.1% at 1); from the golden x8 the encodings' hash, ids and enc_lens "
        f"{res['enc_lens']} equal the JAX record under the plans "
        f"{[(p.mod, p.fused) for p in plans]} and on the plain path, log-probs "
        f"within {res['log_prob_max_err']:.2e}")
    return model, tables, res


def phase_conformer_serve(model, tables, dev):
    import torch

    from qasr_tpu_torch.decode.ctc import ctc_collapse
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches

    utts, secs = seeded_requests(8)
    batch, lens = pad_batch(utts)
    ids_p, el_p = make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)(batch, lens)
    plain_texts = ctc_collapse(ids_p.cpu().numpy(), model.blank_id, model.vocabulary,
                               el_p.cpu().numpy())
    default, conv_fused, _ = conformer_plans()
    main_counts = None
    for plan in (default, conv_fused):
        model.transcribe_greedy(batch[:1, :len(utts[0])], lens[:1], device=dev,
                                plan=plan)  # build + cache
        reset_counts()
        texts = model.transcribe_greedy(batch, lens, device=dev, plan=plan)
        counts = read_counts()
        expect = planned(kernel_launches(model.ccfg, plan))
        if counts != expect:
            raise AssertionError(f"Conformer launch counts under {plan}: {counts} != {expect}")
        main_counts = main_counts or counts
        ids_k, el_k = make_conformer_frozen_fn(model, tables, argmax=True, plan=plan)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"Conformer ids under {plan} differ from the plain executor's")
        if texts != plain_texts:
            raise AssertionError(f"transcribe_greedy under {plan} differs from the plain "
                                 f"executor's transcripts")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError("degenerate Conformer ids")
        log(f"[5] Conformer served 4 requests under ({plan.mod!r}, {plan.fused}) (enc_lens "
            f"{el_k.tolist()}); launches {counts} == plan; ids == plain executor")
    for s_, txt in zip(secs, plain_texts):
        log(f"[5] Conformer {s_:5.1f} s -> {txt[:100]!r}")
    return main_counts


def phase_conformer_time(chk, model, tables, dev, card, report):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.conv_block import conv_block, conv_block_plain
    from qasr_tpu_torch.kernels.ffn_ln import ffn_ln, ffn_ln_plain
    from qasr_tpu_torch.kernels.int_attention import int_attention, int_attention_plain
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
    from qasr_tpu_torch.models.conformer_ctc import make_conformer_frozen_fn

    batch, seconds = 32, 15.0
    n = int(16000 * seconds)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.normal(size=(batch, n)) * 0.1).astype(np.float32)).to(dev)
    lens = torch.full((batch,), n, dtype=torch.int32, device=dev)
    default, _, conv_only = conformer_plans()
    fns = {"kernel": make_conformer_frozen_fn(model, tables, argmax=True, plan=default),
           "kernel_conv_only": make_conformer_frozen_fn(model, tables, argmax=True,
                                                        plan=conv_only),
           "plain": make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)}
    step = step_times(fns, (audio, lens), card, "Conformer", batch, seconds, report)

    # each kernel at the serving shapes (15 s -> T = 375, 374 valid frames)
    t = valid = 1 + n // 160                           # frames, then padded to 16
    t = -(-t // 16) * 16
    for _ in range(2):                                  # two stride-2 k=3 convs
        t, valid = (t - 3) // 2 + 1, (valid - 3) // 2 + 1
    h, d = model.ccfg.n_heads, model.ccfg.d_model
    d_k = d // h
    tbl = tables["encoder"]["layers"][0]
    full = torch.full((batch,), valid, dtype=torch.int32, device=dev)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-64, 64, shape).astype(np.int8)).to(dev)

    rows = []
    qu, qv, k, v = (t8(batch, t, h, d_k) for _ in range(4))
    p = t8(2 * t - 1, h, d_k)
    kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], left=-1, right=-1,
              nbits=8)
    r = timed_pair(chk, "int_attention", f"int_attention B={batch} T={t} h={h} d_k={d_k}",
                   lambda: int_attention(qu, qv, k, v, p, full, **kw),
                   lambda: int_attention_plain(qu, qv, k, v, p, full, **kw), card, rows)
    # q/k/v/pos in, context out; ac, the bd diagonal and a8.v as int8 products
    r["bound"] = bound(4 * qu.numel() + p.numel() + 4 * batch + batch * t * d,
                       3 * 2 * batch * h * t * t * d_k)
    # the streaming form at a 60 s input (T = 1500 after subsampling), B=4
    tl, bl = 1500, 4
    qul, qvl, kl, vl = (t8(bl, tl, h, d_k) for _ in range(4))
    pl_ = t8(2 * tl - 1, h, d_k)
    fl = torch.full((bl,), tl, dtype=torch.int32, device=dev)
    r = timed_pair(chk, "int_attention", f"int_attention streaming B={bl} T={tl} h={h} d_k={d_k}",
                   lambda: int_attention(qul, qvl, kl, vl, pl_, fl, **kw),
                   lambda: int_attention_plain(qul, qvl, kl, vl, pl_, fl, **kw), card, rows)
    r["bound"] = bound(4 * qul.numel() + pl_.numel() + 4 * bl + bl * tl * d,
                       3 * 2 * bl * h * tl * tl * d_k)
    c8, x8 = t8(batch, t, d), t8(batch, t, d)
    k_size = tbl["dw_w"].shape[0]
    pad = model.ccfg.dw_padding
    r = timed_pair(chk, "conv_block", f"conv_block B={batch} T={t} d={d} K={k_size}",
                   lambda: conv_block(c8, x8, full, tbl, pad, nbits=8),
                   lambda: conv_block_plain(c8, x8, full, tbl, pad, nbits=8), card, rows)
    weights = 4 * d * d + k_size * d + 14 * 4 * d + 16 * 4
    r["bound"] = bound(3 * batch * t * d + weights + 4 * batch,
                       2 * batch * t * d * (4 * d + k_size))
    # Kernel 5 at each of its path's sites (the pos projection has 2T-1 rows)
    for label, mode, site, kw in _lin_sites(tables):
        dout, kin = site["wt"].shape
        rows_ = 2 * t - 1 if label.startswith("pos") else batch * t
        x = t8(rows_, kin)
        args = dict(kw, nbits=8)
        if mode == "join":
            args["stream8"] = t8(rows_, dout)
        wt_t = site["wt"].t()
        r = timed_pair(chk, "lin_epilogue", f"lin_epilogue N={rows_} {label} {mode}",
                       lambda x=x, s_=site, a=args: lin_epilogue(x, s_, **a),
                       lambda x=x, s_=site, a=args: lin_epilogue_plain(x, s_, **a), card, rows,
                       lambda x=x, w=wt_t: torch._int_mm(x, w))
        vec_bytes = 4 * dout * (1 + ("b" in site))
        r["bound"] = bound(x.numel() + site["wt"].numel() + vec_bytes
                           + rows_ * dout * (1 + (mode == "join")), 2 * rows_ * kin * dout)
    # Kernel 6 in its three forms; the first is the kernels line's
    layers = tables["encoder"]["layers"]
    for form, lt, half, stream, tail in ffn_forms(layers):
        f = lt[f"{half}_l1"]["wt"].shape[0]
        args = (x8, lt[f"ln_{half}"], lt[f"{half}_l1"], lt[f"{half}_grid"], lt[f"{half}_prod"],
                lt[f"{half}_l2"], lt[stream], tail)
        pick = 0 if tail is None else 1
        r = timed_pair(chk, "ffn_ln", f"ffn_ln B={batch} T={t} d={d} f={f} {form}",
                       lambda a=args, i=pick: ffn_ln(*a, nbits=8)[i],
                       lambda a=args, i=pick: ffn_ln_plain(*a, nbits=8)[i], card, rows)
        if tail is not None:
            chk.equal("ffn_ln", f"ffn_ln {form} at the serving shape (joined stream)",
                      ffn_ln(*args, nbits=8)[0], ffn_ln_plain(*args, nbits=8)[0])
        # x in, stream (and tail) out; both weights; the (3, d) / (2, f) / (2, d) rows
        outs = 1 if tail is None else 2
        r["bound"] = bound((1 + outs) * batch * t * d + 2 * d * f
                           + 4 * (3 * d + 2 * f + 2 * d + (0 if tail is None else 3 * d)),
                           2 * 2 * batch * t * d * f)
    report["conformer_per_kernel"] = rows
    return step, rows


# ---------------------------------------------------------------------------
# phase 7: the zero-shot workflow (synthesis, calibration, dynamic, CLIs)
# ---------------------------------------------------------------------------

# card vs CPU, the first 3 losses from one start point (~3 float32 ulps at
# their 4.2e7)
SYNTH_RTOL = 3e-7
# card vs CPU, distill_loss's input gradient at the recipe's shape (norm-wise);
# the same backward with TF32 on must read above it
GRAD_RTOL = 2e-5
# noise ranges vs the committed ones (the JAX package's seed-0 recipe): of
# each site's range (above what the port reads from features perturbed at
# the committed ranges' own first-site offset, below what another noise
# seed or percentile 99.9 reads), and at the first site, which sees the
# features alone
NOISE_RANGE_TOL = 0.15
FIRST_SITE_TOL = 1e-4
FRONT_PERTURBATION = 1e-5
PERTURBATION_SEEDS = (1, 2, 3)


def qstate_sites(qstate, path=""):
    """[(site, x_min, x_max)] of every activation site, in one fixed order."""
    if isinstance(qstate, dict) and "x_min" in qstate:
        return [(path, float(qstate["x_min"]), float(qstate["x_max"]))]
    if isinstance(qstate, dict):
        return [s for k in sorted(qstate) for s in qstate_sites(qstate[k], f"{path}.{k}")]
    return [s for i, q in enumerate(qstate) for s in qstate_sites(q, f"{path}[{i}]")]


def table_entries_differing(a, b) -> int:
    """Elements (array entries, or static scalars) that differ between two
    host table trees of the same structure."""
    import numpy as np

    if isinstance(a, dict):
        return sum(table_entries_differing(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(table_entries_differing(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        return int(np.sum(a != b)) if a.shape == b.shape else int(max(a.size, b.size))
    return int(a != b)


def write_manifest(root, rng, sr=16000):
    """4 seeded wavs (tone + noise) and their JSON-lines manifest."""
    import numpy as np

    from qasr_tpu_torch.data.audio import write_wav

    texts = ("hello world", "the quick brown fox", "zero shot quantization",
             "integer only speech recognition")
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        for i, text in enumerate(texts):
            n = int(sr * (1.5 + 0.5 * i))
            t = np.arange(n) / sr
            x = (0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t)
                 + 0.05 * rng.normal(size=n)).astype(np.float32)
            wav = os.path.join(root, f"utt{i}.wav")
            write_wav(wav, x, sr)
            f.write(json.dumps({"audio_filepath": wav, "duration": n / sr, "text": text}) + "\n")
    return path


def phase_workflow(chk, dev, card, report, name="QuartzNet15x5Base-En"):
    import math
    import tempfile

    import numpy as np
    import torch

    from qasr_tpu_torch.cli import inference as cli_inference
    from qasr_tpu_torch.cli import synthesize as cli_synthesize
    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.models.ctc_model import ASRModel, make_frozen_fn
    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.ranges import qstate_to_device
    from qasr_tpu_torch.quantize.freeze import kernel_launches
    from qasr_tpu_torch.quantize.synth import get_synthetic_data, start_points

    out = report.setdefault("workflow", {})
    model = ASRModel.from_pretrained(name, allow_random_weights=True)
    per_fwd = kernel_launches(model.plan)
    dim = model.plan.feat_in

    # (a) synthesis at the reference recipe's shapes, 2 problems
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, losses = get_synthetic_data(model.plan, model.params["encoder"], batch_size=8,
                                      dim=dim, seqlen=500, train_iter=200, num_batch=2,
                                      lr=0.01, seed=0, device=dev, verbose=False,
                                      return_losses=True)
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / 400
    for i, ls in enumerate(losses):
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"synthesis problem {i}: losses {ls[0]} -> {ls[-1]} "
                                 f"(finite={all(math.isfinite(v) for v in ls)})")
    x0 = start_points(1, 2, 200, dim, seed=1)
    kw = dict(batch_size=2, dim=dim, seqlen=200, train_iter=3, lr=0.01, x0=x0, verbose=False,
              return_losses=True)
    l_card = get_synthetic_data(model.plan, model.params["encoder"], device=dev, **kw)[1][0]
    l_cpu = get_synthetic_data(model.plan, model.params["encoder"], device="cpu", **kw)[1][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if rel > SYNTH_RTOL:
        raise AssertionError(f"synthesis losses card {l_card} vs CPU {l_cpu}: rel {rel}")
    log(f"[7a] synthesis 2 x (8 x 500 x {dim}), 200 iterations: losses {losses[0][0]:.2f} -> "
        f"{losses[0][-1]:.2f}, {losses[1][0]:.2f} -> {losses[1][-1]:.2f}, all finite; "
        f"{s_iter * 1e3:.2f} ms an iteration [{card}]; first 3 losses at 2 x 200 card "
        f"{l_card} vs CPU {l_cpu}, max rel {rel:.2e} <= {SYNTH_RTOL}")
    t0 = time.perf_counter()
    g_rel, g_rel_tf32 = synthesis_grad_rel(model.plan, model.params["encoder"], dev, dim)
    if g_rel > GRAD_RTOL or not g_rel_tf32 > GRAD_RTOL:
        raise AssertionError(f"distill_loss gradient card vs CPU: rel {g_rel:.3e} (TF32 on: "
                             f"{g_rel_tf32:.3e}), tolerance {GRAD_RTOL:g}")
    log(f"[7a] distill_loss gradient at 8 x 500 x {dim}, card vs CPU: norm-wise rel "
        f"{g_rel:.3e} <= {GRAD_RTOL:g}; the backward with TF32 on reads {g_rel_tf32:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    out.update(synth_ms_per_iter=s_iter * 1e3, synth_losses=[[ls[0], ls[-1]] for ls in losses],
               synth_cpu_rel=rel, synth_grad_rel=g_rel, synth_grad_rel_tf32=g_rel_tf32)

    # (b) calibration on the synthetic batches, kernels against plain
    model.set_quant_bit(6, "all")
    model.bn_folding()
    for pct in (None, 99.9):
        model.set_percentile(pct)
        model.qstate = init_qstate(model.plan)
        reset_counts()
        model.calibrate(data, device=dev)
        counts = read_counts()
        expect = planned({k: 2 * v for k, v in per_fwd.items()})
        if counts != expect:
            raise AssertionError(f"calibration launches {counts} != {expect} (2 forwards)")
        q_kernel = model.qstate
        model.qstate = init_qstate(model.plan)
        model.calibrate(data, device=dev, kernels=False)
        a, b = qstate_sites(q_kernel), qstate_sites(model.qstate)
        bad = sum(x != y for x, y in zip(a, b))
        if bad or len(a) != len(b):
            raise AssertionError(f"calibration (percentile {pct}): {bad} of {len(a)} sites' "
                                 f"ranges differ from the plain QuantExec's")
        log(f"[7b] calibrate on 2 synthetic batches, percentile {pct}: the {len(a)} sites' "
            f"ranges equal the plain QuantExec's bit for bit; launches {counts} (a forward: "
            f"{per_fwd})")
    feats = data[0]
    lens = torch.full((8,), 500, dtype=torch.int32, device=dev)
    qs = qstate_to_device(model.qstate, dev)
    calib = {}
    for pct in (None, 99.9):
        model.set_percentile(pct)
        # the plain path once (it ran in the comparison above), the kernels' median of 3
        for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
            calib[f"{path} percentile={pct}"] = statistics.median(cuda_ms(
                lambda kern=kern: model.encode_decode_quant(feats, lens, qs, update_ranges=True,
                                                            kernels=kern), reps=reps, warmup=0))
    log(f"[7b] calibrating forward B=8 x 500 frames, ms (kernels: median of 3; plain: one call): "
        f"{ {k: round(v, 3) for k, v in calib.items()} } [{card}]")
    out["calibrate_forward_ms"] = calib

    time_workflow_sites(chk, report.setdefault("workflow_per_kernel", []), dev, card)

    # (d) the dynamic forward, kernels against plain
    model.set_percentile(None)
    model.set_dynamic(True)
    utts, _ = seeded_requests(7)
    batch, blens = pad_batch(utts)
    reset_counts()
    _, el_k, ids_k = model.forward(batch, blens, device=dev)
    counts = read_counts()
    _, el_p, ids_p = model.forward(batch, blens, device=dev, kernels=False)
    if counts != planned(per_fwd):
        raise AssertionError(f"dynamic forward launches {counts} != {per_fwd}")
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
        raise AssertionError("dynamic forward: kernel ids differ from the plain QuantExec's")
    log(f"[7d] dynamic forward of 4 requests: ids == plain QuantExec, launches {counts}")
    b64, n64 = 64, 16000 * 15
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(b64, n64))
                             .astype(np.float32) * 0.1).to(dev)
    alens = torch.full((b64,), n64, dtype=torch.int32, device=dev)
    dyn = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        dyn[path] = statistics.median(cuda_ms(
            lambda kern=kern: model.forward(audio, alens, device=dev, kernels=kern), reps=reps,
            warmup=1))
    log(f"[7d] dynamic forward B=64 x 15 s: kernel {dyn['kernel']:.3f} ms (median of 3), plain "
        f"{dyn['plain']:.3f} ms (one call after one) [{card}]")
    out["dynamic_forward_ms"] = dyn
    del audio

    # (e) the CLIs on a manifest of 4 seeded wavs
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_manifest(tmp, np.random.default_rng(5))
        pkl = cli_synthesize.main(["--asr_model", name, "--num_batch", "1",
                                   "--batch_size", "4", "--seqlen", "300", "--train_iter",
                                   "50", "--dump_path", tmp, "--allow_random_weights", "--device", str(dev)])
        wer, hyps, refs, cal = cli_inference.run(
            ["--asr_model", name, "--dataset", manifest, "--load", pkl,
             "--weight_bit", "6", "--act_bit", "6", "--percentile", "99.9",
             "--allow_random_weights", "--batch_size", "4", "--device", str(dev)])
        if not math.isfinite(wer):
            raise AssertionError(f"cli.inference WER {wer}")
        ds = AudioToCharDataset(manifest, labels=list(cal.vocabulary))
        plain_fn = make_frozen_fn(cal, cal.freeze("static_e", dev), argmax=True, fused=False)
        want = []
        for audio_b, alens_b, _, _ in DataLoader(ds, batch_size=4):
            want += cal.ids_to_text(*plain_fn(audio_b, alens_b))
        if hyps != want:
            raise AssertionError(f"cli.inference hypotheses {hyps} != plain frozen {want}")
    log(f"[7e] cli.synthesize -> cli.inference W6A6 percentile 99.9: WER {wer:.4f}; "
        f"hypotheses == plain frozen executor's: {[h[:40] for h in hyps]}")
    out.update(cli_wer=wer, cli_hypotheses=hyps)

    # (c) the noise recipe of the committed ranges; how far a float front's
    # rounding alone moves them; and what faults of the recipe read
    phase_noise_ranges(model, dev, out)


def phase_noise_ranges(model, dev, out):
    """calibrate_on_noise(2, 2, 4 s, seed 0), the recipe of the committed
    ranges, against them at a fixed tolerance.  Witnesses of how far the
    float front's rounding moves a random stack's deep ranges: the same
    recipe from the features computed on the CPU, and from the card's
    features times (1 + 1e-5 N(0, 1)) for a few seeds.  Planted faults of
    the recipe (another seed, one batch, percentile 99.9, momentum 0.9,
    exact calibration requants) and what each reads against the
    committed ranges; another seed's and percentile 99.9's must read
    above the tolerance.  Prints how many frozen table entries differ
    from the golden record's tables."""
    import dataclasses

    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.jasper import init_qstate

    model.set_dynamic(False)
    model.set_percentile(None)
    base_qcfg = model.qcfg
    ref_model = golden.quartznet15x5_w6a6()
    ref = ref_model.qstate

    def calibrated(feats=None, seed=0, batches=2, **qcfg):
        model.qcfg = dataclasses.replace(base_qcfg, **qcfg)
        model.qstate = init_qstate(model.plan)
        if feats is None:
            model.calibrate_on_noise(batches=batches, batch_size=2, seconds=4.0, seed=seed,
                                     device=dev)
        else:
            model.calibrate(feats, device=dev)
        model.qcfg = base_qcfg
        return model.qstate

    def worst(q, against=ref):
        return site_deviations(q, against)[0][0]

    port_q = calibrated()
    devs = site_deviations(port_q, ref)
    first = next(d for d in devs if d[1] == ".blocks[0].convs[0]")[0]
    # the recipe's audio, as calibrate_on_noise draws it
    rng = np.random.default_rng(0)
    n = 16000 * 4
    audio = [torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32) * 0.1)
             for _ in range(2)]
    lens = torch.full((2,), n, dtype=torch.int32)
    card_feats = [model.frontend(a.to(dev), lens.to(dev), dither=0.0) for a in audio]
    cpu_feats = [tuple(v.to(dev) for v in model.frontend(a, lens, dither=0.0)) for a in audio]
    witness = {"cpu front": site_deviations(calibrated(cpu_feats), port_q)}
    for seed in PERTURBATION_SEEDS:
        gen = torch.Generator(device=dev).manual_seed(seed)
        feats = [(f * (1 + FRONT_PERTURBATION * torch.randn(f.shape, generator=gen, device=dev)),
                  fl) for f, fl in card_feats]
        witness[f"perturbed seed {seed}"] = site_deviations(calibrated(feats), port_q)
    moves = {}
    for devs_w in witness.values():
        for d in devs_w:
            moves[d[1]] = max(moves.get(d[1], 0.0), d[0])
    faults = {"seed 1": calibrated(seed=1), "one batch": calibrated(batches=1),
              "percentile 99.9": calibrated(percentile=99.9),
              "act_momentum 0.9": calibrated(act_momentum=0.9),
              "calib_exact": calibrated(calib_exact=True)}
    fault_worst = {k: worst(q) for k, q in faults.items()}
    model.qstate = port_q
    differ = table_entries_differing(model.freeze_host("static_e"),
                                     ref_model.freeze_host("static_e"))
    med = statistics.median(d[0] for d in devs)
    out.update(noise_range_worst=devs[0][0], noise_range_median=med, noise_first_site=first,
               noise_witness_worst={k: v[0][0] for k, v in witness.items()},
               noise_fault_worst=fault_worst, noise_table_entries_differing=differ,
               noise_site_deviation=[list(d) + [moves[d[1]]] for d in devs])
    for d in devs[:8]:
        log(f"[7c]   {d[1]}: ({d[2]:.6g}, {d[3]:.6g}) vs committed ({d[4]:.6g}, {d[5]:.6g}): "
            f"{d[0]:.3%} of its range; the witnesses move it up to {moves[d[1]]:.3%}")
    log(f"[7c] calibrate_on_noise(2, 2, 4 s, seed 0): {len(devs)} sites against the committed "
        f"ranges: worst {devs[0][0]:.3%}, median {med:.3%} of a site's range (tolerance "
        f"{NOISE_RANGE_TOL:.0%}), the first site (features only) {first:.2e} (tolerance "
        f"{FIRST_SITE_TOL:g}); the port's own ranges move, worst site: "
        f"{ {k: f'{v[0][0]:.3%}' for k, v in witness.items()} }; planted faults read "
        f"{ {k: f'{v:.3%}' for k, v in fault_worst.items()} }; {differ} frozen table entries "
        f"differ from the golden record's tables")
    if devs[0][0] > NOISE_RANGE_TOL or first > FIRST_SITE_TOL:
        raise AssertionError(f"noise ranges off the committed ones: worst site {devs[0][0]:.3%} "
                             f"(tolerance {NOISE_RANGE_TOL:.0%}), first site {first:.2e} "
                             f"(tolerance {FIRST_SITE_TOL:g})")
    blind = [k for k in ("seed 1", "percentile 99.9") if not fault_worst[k] > NOISE_RANGE_TOL]
    if blind:
        raise AssertionError(f"the noise-range tolerance cannot see the planted faults {blind}")


def synthesis_grad_rel(plan, enc_params, dev, dim):
    """Norm-wise relative difference of distill_loss's input gradient on the
    card from the CPU's, at the recipe's shape (8 x 500) from one start
    point: through ``loss_and_backward``, as synthesis steps, and with the
    backward under TF32 (PyTorch's cuDNN default), the fault the gate must
    see."""
    import torch

    from qasr_tpu_torch.quantize.ranges import params_to_device
    from qasr_tpu_torch.quantize.synth import (bn_targets, distill_loss, loss_and_backward,
                                               start_points)

    x0 = start_points(1, 8, 500, dim, seed=2)[0]

    def grad(device, tf32=False):
        params = params_to_device(enc_params, device)
        targets = bn_targets(plan, params)
        x = x0.to(device, copy=True).requires_grad_(True)
        lens = torch.full((8,), 500, dtype=torch.int32, device=device)
        if not tf32:
            loss_and_backward(plan, params, x, lens, targets)
            return x.grad.double().cpu()
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            distill_loss(plan, params, x, lens, targets).backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return x.grad.double().cpu()

    g_cpu = grad("cpu")

    def rel(g):
        return float(torch.linalg.vector_norm(g - g_cpu) / torch.linalg.vector_norm(g_cpu))

    return rel(grad(dev)), rel(grad(dev, tf32=True))


def time_workflow_sites(chk, rows, dev, card):
    """Kernels 1 and 2 in the forms QuantExec runs them (int8 in, int32 out,
    no epilogue) at the calibrating forward's shapes (B=8, T=250 after the
    stride-2 site) and the dynamic forward's (B=64 x 15 s: T=751), against
    their plain versions; beside cuDNN's float32 depthwise conv (TF32 off,
    exact here) and torch._int_mm."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(9)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-32, 32, shape).astype(np.int8)).to(dev)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for b, t in ((8, 250), (64, 751)):
            c, k = 512, 75
            x, w = t8(b, t, c), t8(k, c)
            xf = x.permute(0, 2, 1).contiguous().float()
            wf = w.t().contiguous().float()[:, None, :]
            r = timed_pair(chk, "dw_conv", f"dw_conv QuantExec B={b} T={t} C={c} K={k} int8 in, "
                           f"int32 out", lambda x=x, w=w: dw_conv(x, w, padding=k // 2),
                           lambda x=x, w=w: dw_conv_plain(x, w, padding=k // 2), card, rows,
                           lambda xf=xf, wf=wf: F.conv1d(xf, wf, groups=c, padding=k // 2))
            r["bound"] = bound(x.numel() + w.numel() + 4 * b * t * c, 2 * k * b * t * c)
            x, wt = t8(b, t, c), t8(c, c)
            bias = torch.from_numpy(rng.integers(-3000, 3000, c).astype(np.int32)).to(dev)
            x2, wt_t = x.reshape(-1, c), wt.t()
            r = timed_pair(chk, "pw_gemm", f"pw_gemm QuantExec N={b * t} {c}->{c} int8 in, "
                           f"int32 + bias out", lambda x=x, wt=wt: pw_gemm(x, wt, bias=bias),
                           lambda x=x, wt=wt: pw_gemm_plain(x, wt, bias=bias), card, rows,
                           lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t))
            r["bound"] = bound(x.numel() + wt.numel() + 4 * c + 4 * b * t * c, 2 * b * t * c * c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# ---------------------------------------------------------------------------
# phase 8: the Conformer's zero-shot workflow (synthesis, calibration,
# freeze and serve, the asset's recipe, dynamic)
# ---------------------------------------------------------------------------

CONF_FLAGS = dict(quantize_attention=True, integer_softmax=True, integer_layernorm=True,
                  integer_activations=True, static_attention=True)
# quantize_encoder_synthetic's recipe (the JAX package's defaults)
CONF_SYNTH = dict(num_batch=2, batch_size=8, seqlen=128, train_iter=200, lr=0.02, seed=0)
CONF_SECONDS = 15.0
# card vs CPU, the first 3 synthesis losses of one start point (2 x 128 frames)
CONF_SYNTH_RTOL = 1e-5
# card vs CPU, conformer_distill_loss's input gradient at 8 x 128 (norm-wise);
# the same backward with TF32 on must read above it
CONF_GRAD_RTOL = 1e-4
# the committed asset's recipe (one batch of 4 x 15 s of seed-0 noise x 0.1)
# against its ranges, as a share of each site's range: every site within
# CONF_RANGE_L, pre_out within CONF_PRE_OUT_TOL.  L sits above what the
# port reads on the CPU against the asset (5.9%) and how far a 1e-5
# perturbation of the features moves the port's own ranges (up to 9.7%),
# below the planted faults (another noise seed 27.8%, percentile 99.9
# 52.3%): experiments/torch_conformer_asset_ranges.py --device cpu
CONF_RANGE_L = 0.15
CONF_PRE_OUT_TOL = 1e-4


def conformer_synth_grad_rel(model, dev):
    """Norm-wise relative difference of conformer_distill_loss's input
    gradient on the card from the CPU's at the recipe's 8 x 128 frames from
    one start point: through ``backward_no_tf32``, as synthesis steps, and
    with the backward under TF32 (the fault the gate must see)."""
    import torch

    from qasr_tpu_torch.models.conformer import encoder_params_to_device
    from qasr_tpu_torch.quantize.conformer_synth import (conformer_bn_targets,
                                                         conformer_distill_loss)
    from qasr_tpu_torch.quantize.synth import backward_no_tf32, start_points

    b, t = CONF_SYNTH["batch_size"], CONF_SYNTH["seqlen"]
    x0 = start_points(1, b, t, model.ccfg.feat_in, seed=2)[0]

    def grad(device, tf32=False):
        params = encoder_params_to_device(model.params["encoder"], device)
        targets = conformer_bn_targets(params)
        x = x0.to(device, copy=True).requires_grad_(True)
        lens = torch.full((b,), t, dtype=torch.int32, device=device)

        def loss(v):
            return conformer_distill_loss(params, model.ccfg, v, lens, targets)
        if not tf32:
            backward_no_tf32(loss, x)
            return x.grad.double().cpu()
        flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            loss(x).backward()
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return x.grad.double().cpu()

    g_cpu = grad("cpu")

    def rel(g):
        return float(torch.linalg.vector_norm(g - g_cpu) / torch.linalg.vector_norm(g_cpu))

    return rel(grad(dev)), rel(grad(dev, tf32=True))


def recipe_noise(seed, batch=4, seconds=CONF_SECONDS):
    """The asset's recipe audio: default_rng(seed).normal((32, n)) x 0.1,
    the first ``batch`` rows (experiments/torch_conformer_golden.py)."""
    import numpy as np

    n = int(16000 * seconds)
    audio = (np.random.default_rng(seed).normal(size=(32, n)) * 0.1).astype(np.float32)
    return audio[:batch], np.full((batch,), n, np.int32)


def phase_conformer_workflow(chk, dev, card, report):
    """Phase 8: the flagship Conformer-CTC's zero-shot workflow."""
    import torch

    from qasr_tpu_torch.golden import conformer_flagship_configs
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC, make_conformer_frozen_fn
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches
    from qasr_tpu_torch.quantize.conformer_ptq import ptq_kernel_launches
    from qasr_tpu_torch.quantize.conformer_synth import get_synthetic_conformer_data
    from qasr_tpu_torch.quantize.synth import start_points

    t_phase = time.perf_counter()
    out = report.setdefault("conformer_workflow", {})
    model = ConformerCTC.from_config(*conformer_flagship_configs(), seed=0)
    ccfg = model.ccfg
    enc = model.params["encoder"]

    # (a) synthesis at quantize_encoder_synthetic's recipe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data, losses = get_synthetic_conformer_data(enc, ccfg, device=dev, **CONF_SYNTH)
    torch.cuda.synchronize()
    s_iter = (time.perf_counter() - t0) / (CONF_SYNTH["num_batch"] * CONF_SYNTH["train_iter"])
    for i, ls in enumerate(losses):
        if not all(math.isfinite(v) for v in ls) or not ls[-1] < ls[0]:
            raise AssertionError(f"Conformer synthesis problem {i}: losses {ls[0]} -> {ls[-1]}")
    x0 = start_points(1, 2, CONF_SYNTH["seqlen"], ccfg.feat_in, seed=1)
    kw = dict(batch_size=2, seqlen=CONF_SYNTH["seqlen"], train_iter=3, lr=CONF_SYNTH["lr"],
              x0=x0)
    l_card = get_synthetic_conformer_data(enc, ccfg, device=dev, **kw)[1][0]
    l_cpu = get_synthetic_conformer_data(enc, ccfg, device="cpu", **kw)[1][0]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if rel > CONF_SYNTH_RTOL:
        raise AssertionError(f"Conformer synthesis losses card {l_card} vs CPU {l_cpu}: rel {rel}")
    g_rel, g_rel_tf32 = conformer_synth_grad_rel(model, dev)
    if g_rel > CONF_GRAD_RTOL or not g_rel_tf32 > CONF_GRAD_RTOL:
        raise AssertionError(f"conformer_distill_loss gradient card vs CPU: rel {g_rel:.3e} "
                             f"(TF32 on: {g_rel_tf32:.3e}), tolerance {CONF_GRAD_RTOL:g}")
    log(f"[8a] Conformer synthesis {CONF_SYNTH['num_batch']} x ({CONF_SYNTH['batch_size']} x "
        f"{CONF_SYNTH['seqlen']} x {ccfg.feat_in}), "
        f"{CONF_SYNTH['train_iter']} iterations: losses "
        f"{[(round(ls[0], 3), round(ls[-1], 3)) for ls in losses]}, all finite; "
        f"{s_iter * 1e3:.2f} ms an iteration [{card}]; first 3 losses at 2 x 128 card {l_card} "
        f"vs CPU {l_cpu}, max rel {rel:.2e} <= {CONF_SYNTH_RTOL:g}; input gradient at the recipe's "
        f"norm-wise rel {g_rel:.3e} <= {CONF_GRAD_RTOL:g}, with a TF32 backward {g_rel_tf32:.3e}")
    out.update(synth_ms_per_iter=s_iter * 1e3, synth_losses=[[ls[0], ls[-1]] for ls in losses],
               synth_cpu_rel=rel, synth_grad_rel=g_rel, synth_grad_rel_tf32=g_rel_tf32)

    # (b) calibration on the synthetic batches, kernels against plain; then
    # freeze and serve from the port's own ranges
    per_fwd = ptq_kernel_launches(ccfg)
    reset_counts()
    model.quantize_encoder(data, features=True, device=dev, **CONF_FLAGS)
    calib_counts = read_counts()
    expect = planned({k: len(data) * v for k, v in per_fwd.items()})
    if calib_counts != expect:
        raise AssertionError(f"Conformer calibration launches {calib_counts} != {expect}")
    q_kernel = model.enc_qstate
    model.quantize_encoder(data, features=True, device=dev, kernels=False, **CONF_FLAGS)
    a, b = qstate_sites(q_kernel), qstate_sites(model.enc_qstate)
    bad = sum(x != y for x, y in zip(a, b))
    if bad or len(a) != len(b):
        raise AssertionError(f"Conformer calibration: {bad} of {len(a)} sites' ranges differ "
                             f"from the plain path's")
    log(f"[8b] Conformer calibration on the {len(data)} synthetic batches, every integer flag "
        f"and static attention: the {len(a)} sites' ranges equal the plain path's bit for bit; "
        f"launches {calib_counts} (a forward: {per_fwd})")
    tables = model.freeze(dev)
    utts, secs = seeded_requests(10)
    batch, lens = pad_batch(utts)
    ids_p, el_p = make_conformer_frozen_fn(model, tables, argmax=True, kernels=False)(batch, lens)
    plain_texts = model.ids_to_text(ids_p, el_p)
    model.transcribe_greedy(batch[:1, :len(utts[0])], lens[:1], device=dev)  # build + cache
    reset_counts()
    texts = model.transcribe_greedy(batch, lens, device=dev)
    counts = read_counts()
    if counts != planned(kernel_launches(ccfg)):
        raise AssertionError(f"frozen Conformer from the port's ranges: launches {counts}")
    ids_k, el_k = make_conformer_frozen_fn(model, tables, argmax=True)(batch, lens)
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)) or texts != plain_texts:
        raise AssertionError("frozen Conformer from the port's ranges: kernel ids differ from "
                             "the plain executor's")
    log(f"[8b] froze on those ranges and served 4 requests ({secs} s): launches {counts}; ids "
        f"== plain executor; {[t_[:40] for t_ in texts]}")
    out.update(calib_launches=calib_counts, served_launches=counts, served_texts=texts)

    # the EMA: over these 2 batches momentum 0.9 must move the ranges off
    # 0.95's, kernels and plain alike (the asset's one-batch recipe in (c)
    # never applies the EMA)
    m90 = {}
    for kern in (True, False):
        model.quantize_encoder(data, features=True, device=dev, kernels=kern, momentum=0.9,
                               **CONF_FLAGS)
        m90[kern] = qstate_sites(model.enc_qstate)
    if m90[True] != m90[False]:
        raise AssertionError("Conformer calibration at momentum 0.9: kernel ranges differ from "
                             "the plain path's")
    moved = sum(x != y for x, y in zip(m90[True], a))
    if not moved:
        raise AssertionError("Conformer calibration: momentum 0.9 gave momentum 0.95's ranges")
    log(f"[8b] at momentum 0.9 the ranges equal the plain path's and {moved} of {len(a)} sites "
        f"moved off momentum 0.95's")
    out["calib_momentum_sites_moved"] = moved

    # (c) the committed asset's recipe, and planted faults of it
    conformer_asset_ranges(model, dev, out)

    # (d) the dynamic forward at B=32 x 15 s, kernels against plain
    a4, l4 = recipe_noise(0)
    model.quantize_encoder([(a4, l4)], dynamic=True, device=dev, **CONF_FLAGS)
    audio32, lens32 = recipe_noise(0, batch=32)
    audio32 = torch.from_numpy(audio32).to(dev)
    lens32 = torch.from_numpy(lens32).to(dev)
    model.forward(audio32[:2], lens32[:2], device=dev)
    reset_counts()
    lp_k, el_k = model.forward(audio32, lens32, device=dev)
    counts = read_counts()
    lp_p, el_p = model.forward(audio32, lens32, device=dev, kernels=False)
    if counts != planned(ptq_kernel_launches(ccfg, head=True)):
        raise AssertionError(f"dynamic Conformer forward launches {counts}")
    # the same int32 products, then the same float ops: the log-probs agree
    # bit for bit
    if not (torch.equal(lp_k, lp_p) and torch.equal(lp_k.argmax(-1), lp_p.argmax(-1))
            and torch.equal(el_k, el_p)):
        raise AssertionError(f"dynamic Conformer forward: kernel log-probs differ from the plain "
                             f"path's (max |d| {float((lp_k - lp_p).abs().max()):.3e})")
    check_dynamic_shapes(chk, dev, ccfg, lp_k.shape[0], lp_k.shape[1])
    dyn = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        dyn[path] = statistics.median(cuda_ms(
            lambda kern=kern: model.forward(audio32, lens32, device=dev, kernels=kern),
            reps=reps, warmup=1))
    log(f"[8d] dynamic Conformer forward B=32 x 15 s: log-probs == plain path bit for bit, "
        f"launches {counts}; "
        f"kernel {dyn['kernel']:.3f} ms (median of 3), plain {dyn['plain']:.3f} ms (one call "
        f"after one) [{card}]")
    out["dynamic_forward_ms"] = dyn
    del audio32, lp_k, lp_p

    # (e) the calibrating forward at B=4 x 15 s and Kernels 1 and 2 at its shapes
    time_conformer_calibration(chk, model, dev, card, report)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[8] phase 8 took {out['seconds']:.1f} s")


def check_dynamic_shapes(chk, dev, ccfg, b, t):
    """Kernels 1 and 2 against their plain versions on seeded int8 at the
    dynamic forward's shapes: the depthwise at B=b, T=t, and the linears
    and pre_out's K-split at N = b * t."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.quantize.conformer_ptq import pre_out_width

    rng = np.random.default_rng(13)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    c, k, d_ff = ccfg.d_model, ccfg.conv_kernel_size, ccfg.d_ff
    x, w = t8(b, t, c), t8(k, c)
    chk.equal("dw_conv", f"dw_conv dynamic Conformer B={b} T={t} C={c} K={k}",
              dw_conv(x, w, padding=k // 2), dw_conv_plain(x, w, padding=k // 2))
    n = b * t
    for cin, cout in ((c, c), (c, d_ff), (d_ff, c), (c, 2 * c), (pre_out_width(ccfg), c)):
        x3, wt = t8(1, n, cin), t8(cout, cin)
        chk.equal("pw_gemm", f"pw_gemm dynamic Conformer N={n} {cin}->{cout}",
                  pw_gemm(x3, wt), pw_gemm_plain(x3, wt))
    log(f"[8d] Kernels 1 and 2 at the dynamic forward's shapes (B={b} T={t}; N={n}, pre_out's "
        f"K-split {pre_out_width(ccfg)}->{c} included) equal their plain versions")


def conformer_asset_ranges(model, dev, out):
    """quantize_encoder on the committed asset's recipe (one batch of 4 x
    15 s of seed-0 noise x 0.1, every integer flag, static attention)
    against its ranges: pre_out within CONF_PRE_OUT_TOL of its range, every
    site within CONF_RANGE_L.  Planted faults of the recipe (another noise
    seed, percentile 99.9: must read above L; momentum 0.9: one batch
    initializes every range, so it reads as the recipe does) and what each
    reads; how many frozen table entries differ from the golden record's
    tables."""
    from qasr_tpu_torch import golden

    ref = golden.conformer16x256_w8a8()

    def calibrated(seed=0, **kw):
        model.quantize_encoder([recipe_noise(seed)], device=dev, **dict(CONF_FLAGS, **kw))
        return model.enc_qstate

    port_q = calibrated()
    devs = site_deviations(port_q, ref.enc_qstate)
    pre = next(d for d in devs if d[1] == ".pre_out")[0]
    faults = {"seed 1": calibrated(seed=1), "percentile 99.9": calibrated(percentile=99.9),
              "momentum 0.9": calibrated(momentum=0.9)}
    fault_worst = {k: site_deviations(q, ref.enc_qstate)[0][0] for k, q in faults.items()}
    model.enc_qstate = port_q
    differ = table_entries_differing(model.freeze_host(), ref.freeze_host())
    med = statistics.median(d[0] for d in devs)
    out.update(asset_range_worst=devs[0][0], asset_range_median=med, asset_pre_out=pre,
               asset_fault_worst=fault_worst, asset_table_entries_differing=differ,
               asset_site_deviation=[list(d) for d in devs])
    for d in devs[:6]:
        log(f"[8c]   {d[1]}: ({d[2]:.6g}, {d[3]:.6g}) vs committed ({d[4]:.6g}, {d[5]:.6g}): "
            f"{d[0]:.4%} of its range")
    log(f"[8c] the asset's recipe: {len(devs)} sites against the committed ranges: worst "
        f"{devs[0][0]:.4%}, median {med:.4%} of a site's range (L = {CONF_RANGE_L:.0%}), pre_out "
        f"{pre:.2e} (tolerance {CONF_PRE_OUT_TOL:g}); planted faults read "
        f"{ {k: f'{v:.3%}' for k, v in fault_worst.items()} }; {differ} frozen table entries "
        f"differ from the golden record's tables")
    if devs[0][0] > CONF_RANGE_L or pre > CONF_PRE_OUT_TOL:
        raise AssertionError(f"the asset's recipe off its ranges: worst site {devs[0][0]:.4%} "
                             f"(L {CONF_RANGE_L:.0%}), pre_out {pre:.2e}")
    blind = [k for k in ("seed 1", "percentile 99.9") if not fault_worst[k] > CONF_RANGE_L]
    if blind:
        raise AssertionError(f"L cannot see the planted faults {blind}")


def time_conformer_calibration(chk, model, dev, card, report):
    """The calibrating forward (every flag, static attention) at B=4 x 15 s,
    kernels and plain, and Kernels 1 and 2 at its shapes (Kernel 1: C 256,
    K 31, T 375; Kernel 2 at N = 1,500: 256->256, 256->1024, 1024->256,
    256->512 and pre_out's K-split 4,864->256), each against its plain
    version, cuDNN's float32 depthwise conv (TF32 off, exact here) or
    torch._int_mm."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.models.ctc_model import _pcm_f32
    from qasr_tpu_torch.quantize.ranges import qstate_to_device
    from qasr_tpu_torch.quantize.conformer_ptq import (conformer_encoder_apply_ptq,
                                                       quantize_conformer_weights)

    out = report["conformer_workflow"]
    model.quantize_encoder([recipe_noise(0)], device=dev, **CONF_FLAGS)
    a4, l4 = (torch.from_numpy(v).to(dev) for v in recipe_noise(0))
    feats, fl = model.frontend(_pcm_f32(a4), l4, dither=0.0)
    qp = quantize_conformer_weights(model.params["encoder"], model.ccfg,
                                    model.enc_qcfg.weight_bit, dev)
    qs = qstate_to_device(model.enc_qstate, dev)
    calib = {}
    for path, kern, reps in (("kernel", True, 3), ("plain", False, 1)):
        calib[path] = statistics.median(cuda_ms(
            lambda kern=kern: conformer_encoder_apply_ptq(qp, model.ccfg, model.enc_qcfg, qs,
                                                          feats, fl, update=True, kernels=kern),
            reps=reps, warmup=1))
    log(f"[8e] calibrating Conformer forward B=4 x 15 s (T'=375): kernel {calib['kernel']:.3f} "
        f"ms (median of 3), plain {calib['plain']:.3f} ms (one call after one) [{card}]")
    out["calibrate_forward_ms"] = calib

    rows = report.setdefault("conformer_workflow_per_kernel", [])
    rng = np.random.default_rng(12)

    def t8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)

    b, t, c, k = 4, 375, model.ccfg.d_model, model.ccfg.conv_kernel_size
    x, w = t8(b, t, c), t8(k, c)
    xf = x.permute(0, 2, 1).contiguous().float()
    wf = w.t().contiguous().float()[:, None, :]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = timed_pair(chk, "dw_conv", f"dw_conv Conformer calibration B={b} T={t} C={c} K={k} "
                       f"int8 in, int32 out", lambda: dw_conv(x, w, padding=k // 2),
                       lambda: dw_conv_plain(x, w, padding=k // 2), card, rows,
                       lambda: F.conv1d(xf, wf, groups=c, padding=k // 2))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    r["bound"] = bound(x.numel() + w.numel() + 4 * b * t * c, 2 * k * b * t * c)
    n = b * t
    for cin, cout in ((256, 256), (256, 1024), (1024, 256), (256, 512), (4864, 256)):
        x3, wt = t8(1, n, cin), t8(cout, cin)
        x2, wt_t = x3[0], wt.t()
        r = timed_pair(chk, "pw_gemm", f"pw_gemm Conformer calibration N={n} {cin}->{cout} "
                       f"int8 in, int32 out" + (" (K-split)" if cin > 2944 else ""),
                       lambda x3=x3, wt=wt: pw_gemm(x3, wt),
                       lambda x3=x3, wt=wt: pw_gemm_plain(x3, wt), card, rows,
                       lambda x2=x2, wt_t=wt_t: torch._int_mm(x2, wt_t))
        r["bound"] = bound(x3.numel() + wt.numel() + 4 * n * cout, 2 * n * cin * cout)


def site_deviations(q, ref):
    """[(deviation / the reference site's range, site, lo, hi, ref lo, ref hi)]
    of every activation site, largest first."""
    devs = []
    for (site, lo, hi), (_, rlo, rhi) in zip(qstate_sites(q), qstate_sites(ref)):
        mag = max(abs(rlo), abs(rhi))
        d = max(abs(lo - rlo), abs(hi - rhi))
        devs.append((d / mag if mag else (0.0 if d == 0 else math.inf), site, lo, hi, rlo, rhi))
    return sorted(devs, reverse=True)


# ---------------------------------------------------------------------------
# phase 9: checkpoints and decoding (.nemo / .qasr, from_pretrained, the
# vggnet subsampler, the LSTM head, the beam-search CLIs)
# ---------------------------------------------------------------------------

# the serving batches phase 9 holds restored models to: QuartzNet B x 15 s,
# the Conformer B x 15 s (phase 6's)
CKPT_QN_BATCH, CKPT_CONF_BATCH, CKPT_SECONDS = 64, 32, 15.0
# the LSTM head on the card against the CPU on the same encodings
LSTM_ATOL = 1e-4


def trees_equal(a, b) -> bool:
    """Two params / range trees hold the same arrays, dtypes and keys."""
    import numpy as np

    from qasr_tpu_torch.utils.checkpoint import flatten_tree

    fa, fb = flatten_tree(a), flatten_tree(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


def noise_batch(batch, seconds, dev):
    """Phase 6's seeded noise audio (B, n) float32 and its lengths, on dev."""
    import numpy as np
    import torch

    n = int(16000 * seconds)
    audio = np.random.default_rng(0).normal(size=(batch, n)).astype(np.float32) * 0.1
    return (torch.from_numpy(audio).to(dev),
            torch.full((batch,), n, dtype=torch.int32, device=dev))


def run_cli(main, argv):
    """Run a CLI's main() with its standard output captured; the output
    must hold a "WER:" line, which is echoed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    line = next((ln for ln in buf.getvalue().splitlines() if ln.startswith("WER:")), None)
    if line is None:
        raise AssertionError(f"the CLI printed no WER: line: {buf.getvalue()[-2000:]}")
    return result, line


def phase_checkpoints(chk, dev, card, report, qn_model, qn_tables, conf_model, conf_tables):
    """Phase 9 (checkpoints and decoding); returns the vggnet pre row of the
    kernels line."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.cli import conformer_infer as cli_conformer
    from qasr_tpu_torch.cli import inference as cli_inference
    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
    from qasr_tpu_torch.models.config import quartznet15x5
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC, make_conformer_frozen_fn
    from qasr_tpu_torch.models.ctc_model import ASRModel, frozen_executor, make_frozen_fn
    from qasr_tpu_torch.models.lstm_decoder import lstm_decoder_forward
    from qasr_tpu_torch.quantize import conformer_freeze as cf
    from qasr_tpu_torch.quantize.freeze import kernel_launches, tables_digest, tables_to_device
    from qasr_tpu_torch.quantize.ranges import params_to_device

    t_phase = time.perf_counter()
    out = report.setdefault("checkpoints", {})
    tmp = tempfile.mkdtemp(prefix="qasr_smoke_ckpt_")
    saved_env = os.environ.get("QASR_PRETRAINED_DIR")
    try:
        manifest = write_manifest(tmp, np.random.default_rng(5))
        ds = AudioToCharDataset(manifest, labels=list(golden.CONF_LABELS))

        # (a) QuartzNet15x5: .nemo by path and by name, fold + committed
        # ranges -> the golden tables, .qasr -> serving on Kernels 1 / 2 / 7
        name = "QuartzNet15x5Base-En"
        fresh = ASRModel.from_config(quartznet15x5(), seed=0)
        nemo = os.path.join(tmp, "x.nemo")
        t0 = time.perf_counter()
        fresh.save_to(nemo)
        t_save = time.perf_counter() - t0
        by_path = ASRModel.from_pretrained(nemo)
        cache = os.path.join(tmp, "pretrained")
        os.makedirs(cache)
        shutil.copy(nemo, os.path.join(cache, name + ".nemo"))
        os.environ["QASR_PRETRAINED_DIR"] = cache
        by_name = ASRModel.from_pretrained(name)
        for how, m in (("path", by_path), ("name", by_name)):
            if not trees_equal(m.params, fresh.params) or m.cfg != fresh.cfg:
                raise AssertionError(f"QuartzNet .nemo by {how}: params or config differ")
        log(f"[9a] QuartzNet15x5 seed 0 -> .nemo ({os.path.getsize(nemo) / 2**20:.1f} MiB, "
            f"{t_save:.1f} s) -> from_pretrained by path and by name ($QASR_PRETRAINED_DIR): "
            f"params bit-equal")
        m = by_name
        m.set_quant_bit(6, "weight")
        m.set_quant_bit(6, "act")
        m.bn_folding()
        with open(golden.QSTATE_PATH) as f:
            m.qstate_from_json(f.read())
        feats, flens = golden.golden_features(m.plan.feat_in)
        for mode in QUARTZNET_MODES:
            host = m.freeze_host(mode)
            digest = tables_digest(host)
            if digest != tables_digest(qn_model.freeze_host(mode)):
                raise AssertionError(f"restored QuartzNet {mode} tables differ from the "
                                     f"in-memory model's")
            tables = tables_to_device(host, dev)
            bad = golden.compare_golden(golden.port_record(
                m, tables, feats, flens, executor=frozen_executor(tables)),
                golden.load_golden(mode))
            if bad:
                raise AssertionError(f"restored QuartzNet {mode}: golden mismatch in {bad}")
        log(f"[9a] folded + committed ranges: static_e and per_channel tables equal the "
            f"in-memory model's, golden records hold")
        qasr = os.path.join(tmp, "y.qasr")
        m.save_to(qasr)
        r = ASRModel.restore_from(qasr)
        if not (r.folded and trees_equal(r.params, m.params) and trees_equal(r.qstate, m.qstate)
                and r.qcfg == m.qcfg):
            raise AssertionError("QuartzNet .qasr: folded state, params, ranges or knobs differ")
        audio, lens = noise_batch(CKPT_QN_BATCH, CKPT_SECONDS, dev)
        for mode in QUARTZNET_MODES:
            tables_r = r.freeze(mode, dev)
            fn_r = make_frozen_fn(r, tables_r, argmax=True)
            reset_counts()
            ids_r, el_r = fn_r(audio, lens)
            counts = read_counts()
            if counts != planned(kernel_launches(r.plan, tables_r)):
                raise AssertionError(f"restored QuartzNet {mode} launches {counts}")
            ids_u, el_u = make_frozen_fn(qn_model, qn_tables[mode], argmax=True)(audio, lens)
            if not (torch.equal(ids_r, ids_u) and torch.equal(el_r, el_u)):
                raise AssertionError(f"restored QuartzNet {mode}: ids differ from the "
                                     f"unsaved model's")
            log(f"[9a] .qasr (folded, ranges) -> restore_from -> {mode} B={CKPT_QN_BATCH} x "
                f"{CKPT_SECONDS:g} s: ids == unsaved model's; launches {counts}")
        del audio
        (wer, hyps, _, cal), line = run_cli(cli_inference.run, [
            "--asr_model", nemo, "--dataset", manifest, "--calib_manifest", manifest,
            "--weight_bit", "6", "--act_bit", "6", "--decoder", "beam", "--beam_width", "16",
            "--batch_size", "4", "--device", str(dev)])
        beam = BeamSearchDecoderWithLM(list(cal.vocabulary), beam_width=16)
        plain_fn = make_frozen_fn(cal, cal.freeze("static_e", dev), fused=False)
        want = []
        for audio_b, alens_b, _, _ in DataLoader(ds, batch_size=4):
            want += [c[0][1] if c else "" for c in beam(*plain_fn(audio_b, alens_b))]
        if hyps != want or not math.isfinite(wer):
            raise AssertionError(f"cli.inference --decoder beam: {hyps} != {want} (WER {wer})")
        log(f"[9a] cli.inference --asr_model x.nemo --calib_manifest --decoder beam: {line}; "
            f"hypotheses == the beam over the plain frozen executor's log-probs")
        out.update(quartznet_cli_wer=wer, quartznet_cli_hypotheses=hyps)

        # (b) the Conformer-CTC 16 x 256 W8A8 through .qasr
        cq = os.path.join(tmp, "conf.qasr")
        conf_model.save_to(cq)
        rc = ConformerCTC.restore_from(cq)
        if rc.mode() != "ptq" or not (trees_equal(rc.params, conf_model.params)
                                      and trees_equal(rc.enc_qstate, conf_model.enc_qstate)):
            raise AssertionError("Conformer .qasr: params or ranges differ")
        tables_rc = rc.freeze(dev)
        res = golden.check_conformer_golden(rc, tables_rc)
        if res["bad"]:
            raise AssertionError(f"restored Conformer: golden mismatch in {res['bad']}")
        audio, lens = noise_batch(CKPT_CONF_BATCH, CKPT_SECONDS, dev)
        reset_counts()
        ids_r, el_r = make_conformer_frozen_fn(rc, tables_rc, argmax=True)(audio, lens)
        counts = read_counts()
        if counts != planned(cf.kernel_launches(rc.ccfg)):
            raise AssertionError(f"restored Conformer launches {counts}")
        ids_u, el_u = make_conformer_frozen_fn(conf_model, conf_tables, argmax=True)(audio, lens)
        if not (torch.equal(ids_r, ids_u) and torch.equal(el_r, el_u)):
            raise AssertionError("restored Conformer: ids differ from the unsaved model's")
        log(f"[9b] Conformer-CTC 16 x 256 .qasr ({os.path.getsize(cq) / 2**20:.1f} MiB) -> "
            f"restore_from -> freeze: golden record holds; B={CKPT_CONF_BATCH} x "
            f"{CKPT_SECONDS:g} s ids == unsaved model's; launches {counts}")
        (wer, hyps, _, cm), line = run_cli(cli_conformer.run, [
            "--restore", cq, "--dataset", manifest, "--calib_manifest", manifest,
            "--integer", "--freeze", "--decoder", "beam", "--beam_width", "16",
            "--batch_size", "4", "--device", str(dev)])
        want = []
        for audio_b, alens_b, _, _ in DataLoader(ds, batch_size=4):
            want += cm.transcribe_beam(audio_b, alens_b, beam_width=16, device=dev,
                                       kernels=False)
        if cm.mode() != "frozen" or hyps != want or not math.isfinite(wer):
            raise AssertionError(f"cli.conformer_infer: {hyps} != {want} (WER {wer}, "
                                 f"mode {cm.mode()})")
        log(f"[9b] cli.conformer_infer --restore --calib_manifest --integer --freeze --decoder "
            f"beam: {line}; hypotheses == the beam over the plain frozen path's log-probs")
        out.update(conformer_cli_wer=wer, conformer_cli_hypotheses=hyps)

        # (c) the vggnet Conformer 16 x 256 W8A8: calibrate on the asset's
        # recipe, freeze, kernels against plain; Kernel 5 at pre 5,120 -> 256
        cfg, ccfg = golden.conformer_flagship_configs()
        vm = ConformerCTC.from_config(cfg, dataclasses.replace(ccfg, subsampling="vggnet"),
                                      seed=0)
        noise = recipe_noise(0)
        vm.quantize_encoder([noise], device=dev, **CONF_FLAGS)
        q_kernel = vm.enc_qstate
        vm.quantize_encoder([noise], device=dev, kernels=False, **CONF_FLAGS)
        a, b = qstate_sites(q_kernel), qstate_sites(vm.enc_qstate)
        if a != b:
            raise AssertionError("vggnet calibration: kernel ranges differ from plain")
        tables_v = vm.freeze(dev)
        reset_counts()
        ids_k, el_k = make_conformer_frozen_fn(vm, tables_v, argmax=True)(audio, lens)
        counts_v = read_counts()
        if counts_v != planned(cf.kernel_launches(vm.ccfg)):
            raise AssertionError(f"vggnet Conformer launches {counts_v}")
        ids_p, el_p = make_conformer_frozen_fn(vm, tables_v, argmax=True, kernels=False)(audio,
                                                                                      lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError("vggnet Conformer: kernel ids differ from the plain path's")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError("degenerate vggnet ids")
        with torch.no_grad():
            f, fl = vm.frontend(audio, lens, dither=0.0)
            x8, _ = cf.conformer_x8(tables_v["encoder"], vm.ccfg, f, fl)
        site = tables_v["encoder"]["pre"]
        dout, kin = site["wt"].shape
        x2 = x8.reshape(-1, kin).contiguous()
        rows = []
        r_pre = timed_pair(chk, "lin_epilogue", f"lin_epilogue N={x2.shape[0]} pre {kin}->{dout} "
                           f"rq (vggnet)", lambda: lin_epilogue(x2, site, nbits=8),
                           lambda: lin_epilogue_plain(x2, site, nbits=8), card, rows,
                           lambda w=site["wt"].t(): torch._int_mm(x2, w))
        r_pre["bound"] = bound(x2.numel() + site["wt"].numel() + 4 * dout * (1 + ("b" in site))
                               + x2.shape[0] * dout, 2 * x2.shape[0] * kin * dout)
        r_pre["launches"] = counts_v["lin_epilogue"]
        log(f"[9c] vggnet Conformer 16 x 256 (pre {kin} -> {dout}): calibrated on the asset's "
            f"recipe, kernel ranges == plain; frozen B={CKPT_CONF_BATCH} x {CKPT_SECONDS:g} s "
            f"ids == plain path's; launches {counts_v}")
        del audio, f, x8, x2

        # (d) the LSTM head (hidden 640, 1 layer) on the flagship's frozen encoder
        lm = ConformerCTC.from_config(cfg, ccfg, seed=0, decoder_kind="lstm", lstm_hidden=640)
        lm.params = {"encoder": conf_model.params["encoder"], "decoder": lm.params["decoder"]}
        lm.enc_qcfg, lm.enc_qstate = conf_model.enc_qcfg, conf_model.enc_qstate
        tables_l = lm.freeze(dev)
        utts, _ = seeded_requests(9)
        batch, blens = pad_batch(utts)
        lp_card, el_card = lm.forward(batch, blens, device=dev)
        with torch.no_grad():
            fb, fbl = lm.frontend(torch.from_numpy(batch).to(dev).to(torch.float32) * 2.0 ** -15,
                                  torch.from_numpy(blens).to(dev), dither=0.0)
            x8, sl = cf.conformer_x8(tables_l["encoder"], lm.ccfg, fb, fbl)
            enc, el = cf.conformer_encode(tables_l["encoder"], lm.ccfg, x8, sl)
            lp_head = lm.head(tables_l, enc)
            lp_cpu = lstm_decoder_forward(params_to_device(lm.params["decoder"], "cpu"),
                                          enc.cpu())
        if not (torch.equal(lp_head, lp_card) and torch.equal(el, el_card)):
            raise AssertionError("LSTM head: forward differs from the head on its encodings")
        err = float((lp_head.cpu() - lp_cpu).abs().max())
        if err > LSTM_ATOL or not torch.equal(lp_head.argmax(-1).cpu(), lp_cpu.argmax(-1)):
            raise AssertionError(f"LSTM head card vs CPU: max |d| {err} (tolerance "
                                 f"{LSTM_ATOL}) or ids differ")
        log(f"[9d] LSTM head (640, 1 layer) on the frozen encoder, 4 requests: card log-probs "
            f"within {err:.2e} of the CPU's (tolerance {LSTM_ATOL:g}), greedy ids equal")
        out.update(lstm_max_abs_err=err)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved_env is None:
            os.environ.pop("QASR_PRETRAINED_DIR", None)
        else:
            os.environ["QASR_PRETRAINED_DIR"] = saved_env
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[9] phase 9 took {out['seconds']:.1f} s")
    return r_pre


# ---------------------------------------------------------------------------
# phase 10: W8A8 and Jasper10x5Dr (uint8 codes in Kernels 1, 2 and 7; Kernel
# 8, the dense int8 conv)
# ---------------------------------------------------------------------------

# the (model, bits, dyadic mode) paths phase 10 serves: every new golden
# record's, and Jasper's per_channel path (Kernel 8 beside Kernel 7)
W8A8_SERVED = (("quartznet15x5", 8, "static_e"), ("quartznet15x5", 8, "per_channel"),
               ("jasper10x5dr", 6, "static_e"), ("jasper10x5dr", 8, "static_e"),
               ("jasper10x5dr", 8, "per_channel"))
# Kernel 8's mode checks: (K, Cin, Cout, stride, dilation), at N = B * T in
# {609, 1, 37} (PW_BT)
DENSE_MODE_SITES = ((13, 256, 384, 1, 1), (29, 768, 896, 1, 2))
# Kernel 8 at the edges of its wgmma tiling: (K, Cin, Cout, stride,
# dilation, B, T_out) -- Couts that no tile width divides (203 not even 8),
# one frame of one utterance, T_out one past a multiple of its 128-frame
# tile, Cin 64 / 48 / 144 (the weight map's zero fill past Cin inside a
# 128-byte box), stride 2 (with the prologue too), the widest site's ring,
# and a block that walks four Cout tiles (B=33: no grid-z split)
DENSE_EDGE_CASES = ((11, 256, 200, 1, 1, 2, 150), (13, 384, 203, 1, 1, 2, 129),
                    (11, 64, 200, 2, 1, 1, 1), (29, 768, 896, 1, 2, 1, 1),
                    (25, 768, 768, 1, 1, 3, 257), (11, 48, 40, 1, 1, 2, 77),
                    (7, 144, 384, 2, 1, 2, 129), (11, 256, 256, 2, 1, 2, 129),
                    (5, 128, 640, 1, 1, 33, 512))
# phase 10f's serving batch (B x 15 s)
W8A8_STEP_BATCH = 64


def dense_serving_sites(plan):
    """(K, Cin, Cout, stride, dilation) of every dense conv of a plan, once
    each, in walk order."""
    from qasr_tpu_torch.models.jasper import is_dense

    sites = []
    for bp in plan.blocks:
        for spec in bp.convs:
            key = (spec.kernel, spec.in_ch, spec.out_ch, spec.stride, spec.dilation)
            if is_dense(spec) and key not in sites:
                sites.append(key)
    return sites


def spread_e(n_terms, x_rms, w_rms, target=48.0):
    """An exponent that maps a sum of n_terms products of x_rms x w_rms onto
    about +-target with a mantissa near 2^30 (values for the checks that
    spread over the clamp instead of saturating it)."""
    return 30 + int(round(math.log2(math.sqrt(n_terms) * x_rms * w_rms / target)))


def phase_u8_kernels(chk, dev):
    """10a: Kernels 1, 2 and 7 in their uint8 forms at phase 3's shapes and
    modes, and Kernel 8 at every Jasper10x5Dr site and in every mode."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.kernels.requant import requant, requant_plain
    from qasr_tpu_torch.models.config import jasper10x5dr
    from qasr_tpu_torch.models.jasper import build_encoder_plan, get_same_padding, out_frames

    rng = np.random.default_rng(10)
    n0 = chk.n

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    def vec(c, lo, hi):
        return t(lo, hi, c, np.int32)

    # Kernel 1: a uint8 input, uint8 prologue codes (in_relu, bits1 9), a
    # uint8 epilogue (relu, bits 9), per-channel exponents, every site
    for c, k, s, d in DW_SITES:
        b, t_in = 3, 300 * s + 7
        pad = get_same_padding(k, s, d)
        xu = t(0, 256, (b, t_in, c), np.uint8)
        w = t(-31, 32, (k, c), np.int8)
        bias = vec(c, -3000, 3000)
        t_out = out_frames(t_in, k, s, pad, d)
        lens = vec(b, 1, t_out + 1)
        in_len = vec(b, 1, t_in + 1)
        conv = dict(stride=s, padding=pad, dilation=d)
        m, e = _tables(rng, c, False, dev)
        m_v, e_v = _vector_tables(rng, c, 10, dev)
        modes = {
            "u8 in, int32": ({}, xu),
            "u8 in, int32+bias+relu": (dict(bias=bias, relu=True), xu),
            "u8 in, int8 out": (dict(out_len=lens, m=m, e=e + 2, bits=8), xu),
            "u8 in, u8 out (relu, bits 9)": (
                dict(bias=bias, relu=True, out_len=lens, m=m, e=e + 1, bits=9), xu),
            "u8 in, int8 out e[c]+bias+relu": (
                dict(bias=bias, relu=True, out_len=lens, m=m_v, e=e_v, bits=8), xu),
        }
        n_pro = 0
        for x32 in (False, True):
            xi = t(-2**20, 2**20, (b, t_in, c), np.int32) if x32 else t(-64, 64, (b, t_in, c),
                                                                         np.int8)
            hb = 2**18 if x32 else 64
            for m16 in (False, True):
                m1, e1 = _tables(rng, c, m16, dev)
                if n_pro % 2:
                    m1 = np.asarray(m1[0].item(), np.int32)
                pro = dict(in_len=in_len, m1=m1, e1=e1 + (6 if x32 else -8), bits1=9,
                           in_relu=True, in_bias=vec(c, -hb, hb))
                epi = dict(bias=bias, relu=True, out_len=lens, m=m, e=e + 2, bits=8) \
                    if n_pro % 2 else {}
                modes[f"prologue {'int32' if x32 else 'int8'} -> u8 m{16 if m16 else 31}"
                      f"{' scalar' if n_pro % 2 else ''}, epilogue={bool(epi)}"] = (
                    dict(pro, **epi), xi)
                n_pro += 1
            modes[f"prologue {'int32' if x32 else 'int8'} e1[c] -> u8, epilogue e[c] "
                  f"(the per_channel form)"] = (dict(
                      _vector_prologue(rng, c, 16 if x32 else 0, dev), in_relu=True,
                      in_len=in_len, bits1=9, bias=bias, relu=True, out_len=lens, m=m_v,
                      e=e_v, bits=8), xi)
        for name, (kw, xi) in modes.items():
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(xi, w, **conv, **kw), dw_conv_plain(xi, w, **conv, **kw))
    for c, x32, view in ((30, False, False), (30, True, False), (256, False, True)):
        b, t_in, k = 2, 203, 33
        n = b * t_in * c
        flat = (t(-2**20, 2**20, n + 1, np.int32) if x32 else t(0, 256, n + 1, np.uint8))
        x = (flat[1:] if view else flat[:n]).view(b, t_in, c)
        w = t(-31, 32, (k, c), np.int8)
        m, e = _vector_tables(rng, c, 10, dev)
        kw = dict(padding=16, out_len=torch.tensor([t_in, 150], dtype=torch.int32, device=dev),
                  m=m, e=e, bits=8)
        if x32:
            kw.update(_vector_prologue(rng, c, 16, dev), in_relu=True, bits1=9,
                      in_len=torch.tensor([t_in, 101], dtype=torch.int32, device=dev))
        chk.equal("dw_conv", f"dw_conv C={c} {'int32 prologue -> u8' if x32 else 'u8 in'} "
                  f"{'misaligned view' if view else ''} (one channel a thread)",
                  dw_conv(x, w, **kw), dw_conv_plain(x, w, **kw))
    n_dw = chk.n - n0

    # Kernel 2: a uint8 A (from memory or the prologue), a uint8 output
    n1 = chk.n
    for (b, tt), cin, cout in ((bt, ci, co) for bt in PW_BT for ci in PW_CIN for co in PW_COUT):
        xu = t(0, 256, (b, tt, cin), np.uint8)
        wt = t(-31, 32, (cout, cin), np.int8)
        bias = vec(cout, -3000, 3000)
        lens = vec(b, 1, tt + 1)
        res = t(-2**20, 2**20, (b, tt, cout), np.int32)
        m, e = _tables(rng, cout, False, dev)
        m_r, e_r = _tables(rng, cout, True, dev)
        modes = {"none": dict(bias=bias), "none+relu": dict(bias=bias, relu=True),
                 "requant int8": dict(bias=bias, lens=lens, m=m, e=e + 2, bits=8),
                 "requant+relu u8": dict(bias=bias, relu=True, lens=lens, m=m, e=e + 2, bits=9),
                 "join": dict(bias=bias, m=m, e=e + 2, bits=8, res=res, m_r=m_r, e_r=e_r + 3)}
        for name, kw in modes.items():
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} u8 in, {name}",
                      pw_gemm(xu, wt, **kw), pw_gemm_plain(xu, wt, **kw))
        for i, (x32, mode) in enumerate(((False, "none"), (True, "requant+relu u8"),
                                         (True, "join"))):
            xi = t(-2**20, 2**20, (b, tt, cin), np.int32) if x32 else t(-64, 64, (b, tt, cin),
                                                                         np.int8)
            m1, e1 = _tables(rng, cin, i == 1, dev)
            if i == 2:
                m1 = np.asarray(m1[0].item(), np.int32)
            hb = 2**18 if x32 else 64
            pro = dict(m1=m1, e1=e1 + (6 if x32 else -8), bits1=9, in_relu=True,
                       in_bias=vec(cin, -hb, hb), in_len=None if mode == "none" else lens)
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} prologue "
                      f"{'int32' if x32 else 'int8'} -> u8, {mode}",
                      pw_gemm(xi, wt, **pro, **modes[mode]),
                      pw_gemm_plain(xi, wt, **pro, **modes[mode]))
    n_pw = chk.n - n1

    # Kernel 7: a uint8 output (ReLU, bits 9) from int8 / int32 / uint8
    # inputs, and a uint8 input into int8 and int32 outputs
    n2 = chk.n
    b, tt = 3, 203
    lens = vec(b, 1, tt + 1)
    for c in RQ_C:
        e_vec = torch.from_numpy(np.resize(np.asarray([1, 31, 62, 63, 70, 36, 44], np.int32),
                                           c)[rng.permutation(c)]).to(dev)
        for xt in ("int8", "int32", "uint8"):
            z = {"int8": lambda: t(-128, 128, (b, tt, c), np.int8),
                 "int32": lambda: t(-2**28, 2**28, (b, tt, c), np.int32),
                 "uint8": lambda: t(0, 256, (b, tt, c), np.uint8)}[xt]()
            for vector in (False, True):
                if vector:
                    m, e = vec(c, 1, 2**31), e_vec
                else:
                    m, e = np.asarray(int(rng.integers(2**29, 2**31)), np.int32), \
                        51 if xt == "int32" else 30
                for mask in (False, True):
                    kw = dict(lens=lens if mask else None, relu=True)
                    chk.equal("requant", f"requant C={c} {xt} in, u8 out "
                              f"{'vector' if vector else 'scalar'} m/e mask={mask}",
                              requant(z, m, e, 9, **kw), requant_plain(z, m, e, 9, **kw))
            if xt == "uint8":
                for bits, kw in ((8, dict(identity=t(-2**24, 2**24, (b, tt, c), np.int32),
                                          m_r=2**30 + 3, e_r=40)), (10, {})):
                    chk.equal("requant", f"requant C={c} u8 in bits={bits}",
                              requant(z, m, e, bits, **kw), requant_plain(z, m, e, bits, **kw))
    n_rq = chk.n - n2

    # Kernel 8 at every Jasper10x5Dr site, in its serving forms
    n3 = chk.n
    sites = dense_serving_sites(build_encoder_plan(jasper10x5dr().encoder))
    for k, cin, cout, s, d in sites:
        b, t_in = 2, 150 * s + 11
        pad = get_same_padding(k, s, d)
        t_out = out_frames(t_in, k, s, pad, d)
        first = cin == 64   # the quantized features: int8
        x = t(-64, 64, (b, t_in, cin), np.int8) if first else t(0, 256, (b, t_in, cin),
                                                                 np.uint8)
        w = t(-127, 128, (cout, k, cin), np.int8)
        bias = vec(cout, -3000, 3000)
        lens = vec(b, 1, t_out + 1)
        m = vec(cout, 2**29, 2**31)
        e = spread_e(k * cin, 40 if first else 147, 73)
        conv = dict(stride=s, padding=pad, dilation=d)
        forms = {"none+relu (QuantExec, per_channel)": dict(bias=bias, relu=True),
                 "requant+relu u8 (W8A8 in-block)": dict(bias=bias, relu=True, lens=lens, m=m,
                                                         e=e, bits=9),
                 "requant+relu int8 (W6A6 in-block)": dict(bias=bias, relu=True, lens=lens,
                                                           m=m, e=e + 2, bits=7)}
        if not first:
            forms["join"] = dict(bias=bias, m=m, e=e + 1, bits=8,
                                 res=t(-2**20, 2**20, (b, t_out, cout), np.int32),
                                 m_r=vec(cout, 2**29, 2**31), e_r=45)
        for name, kw in forms.items():
            chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} s={s} d={d} "
                      f"{'int8' if first else 'u8'} in, {name}",
                      dense_conv(x, w, **conv, **kw), dense_conv_plain(x, w, **conv, **kw))
        if not first:
            # a block's first conv: the prologue on a block end's int32
            # accumulator (+bias, ReLU) -> uint8 codes, ragged in_len
            x32 = t(-2**20, 2**20, (b, t_in, cin), np.int32)
            pro = dict(in_bias=vec(cin, -2**18, 2**18), in_relu=True,
                       in_len=vec(b, 1, t_in + 1), m1=vec(cin, 2**29, 2**31), e1=42, bits1=9)
            kw = dict(pro, **forms["requant+relu u8 (W8A8 in-block)"])
            chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} s={s} d={d} prologue "
                      f"int32 -> u8, requant u8", dense_conv(x32, w, **conv, **kw),
                      dense_conv_plain(x32, w, **conv, **kw))
    # ... and in every prologue and epilogue mode at N in {609, 1, 37}
    for k, cin, cout, s, d in DENSE_MODE_SITES:
        pad = get_same_padding(k, s, d)
        for b, tt in PW_BT:
            w = t(-127, 128, (cout, k, cin), np.int8)
            bias = vec(cout, -3000, 3000)
            lens = vec(b, 1, tt + 1)
            m, m_r = vec(cout, 2**29, 2**31), vec(cout, 2**29, 2**31)
            conv = dict(stride=s, padding=pad, dilation=d)
            res = t(-2**20, 2**20, (b, tt, cout), np.int32)
            for xt in ("int8", "uint8"):
                x = t(-128, 128, (b, tt, cin), np.int8) if xt == "int8" else \
                    t(0, 256, (b, tt, cin), np.uint8)
                e = spread_e(k * cin, 74 if xt == "int8" else 147, 73)
                modes = {"none": dict(bias=bias), "none+relu": dict(bias=bias, relu=True),
                         "requant int8": dict(bias=bias, lens=lens, m=m, e=e + 1, bits=7),
                         "requant+relu u8": dict(bias=bias, relu=True, lens=lens, m=m, e=e,
                                                 bits=9),
                         "join": dict(bias=bias, m=m, e=e + 1, bits=8, res=res, m_r=m_r,
                                      e_r=45)}
                for name, kw in modes.items():
                    chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} d={d} N={b * tt} "
                              f"{xt} in, {name}", dense_conv(x, w, **conv, **kw),
                              dense_conv_plain(x, w, **conv, **kw))
            for i, (x32, bits1, mode) in enumerate(((False, 7, "none"), (True, 9, "requant+relu u8"),
                                                    (True, 9, "join"), (False, 9, "requant int8"))):
                xi = t(-2**20, 2**20, (b, tt, cin), np.int32) if x32 else \
                    t(-128, 128, (b, tt, cin), np.int8)
                m1 = vec(cin, 2**29, 2**31) if i != 2 else np.asarray(2**30 + 5, np.int32)
                pro = dict(m1=m1, e1=42 if x32 else (30 if bits1 == 9 else 33), bits1=bits1,
                           in_relu=bits1 == 9, in_bias=vec(cin, -500, 500),
                           in_len=None if i == 0 else vec(b, 1, tt + 1))
                e = spread_e(k * cin, 147 if bits1 == 9 else 40, 73)
                epi = {"none": dict(bias=bias, relu=True),
                       "requant+relu u8": dict(bias=bias, relu=True, lens=lens, m=m, e=e, bits=9),
                       "join": dict(bias=bias, m=m, e=e + 1, bits=8, res=res, m_r=m_r, e_r=45),
                       "requant int8": dict(bias=bias, lens=lens, m=m, e=e + 1, bits=7)}[mode]
                chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} d={d} N={b * tt} "
                          f"prologue {'int32' if x32 else 'int8'} -> bits1 {bits1}"
                          f"{' scalar m1' if i == 2 else ''}, {mode}",
                          dense_conv(xi, w, **conv, **pro, **epi),
                          dense_conv_plain(xi, w, **conv, **pro, **epi))
    # ... and at the edges of its tiling, each in five forms: u8 in with no
    # epilogue and with the u8 requant, int8 in with the join, the
    # prologue from int32 to u8 codes with the int8 requant, and from int8
    # to 7-bit codes with no epilogue
    n_edge = chk.n
    for k, cin, cout, s, d, b, t_want in DENSE_EDGE_CASES:
        pad = get_same_padding(k, s, d)
        t_in = next(ti for ti in range(1, 2 * s * t_want + 2 * k * d)
                    if out_frames(ti, k, s, pad, d) == t_want)
        conv = dict(stride=s, padding=pad, dilation=d)
        w = t(-127, 128, (cout, k, cin), np.int8)
        bias = vec(cout, -3000, 3000)
        lens = vec(b, 1, t_want + 1)
        m, m_r = vec(cout, 2**29, 2**31), vec(cout, 2**29, 2**31)
        res = t(-2**20, 2**20, (b, t_want, cout), np.int32)
        xu = t(0, 256, (b, t_in, cin), np.uint8)
        x8 = t(-128, 128, (b, t_in, cin), np.int8)
        x32 = t(-2**20, 2**20, (b, t_in, cin), np.int32)
        e_u, e_8 = spread_e(k * cin, 147, 73), spread_e(k * cin, 74, 73)
        pro9 = dict(in_bias=vec(cin, -2**18, 2**18), in_relu=True, in_len=vec(b, 1, t_in + 1),
                    m1=vec(cin, 2**29, 2**31), e1=42, bits1=9)
        pro7 = dict(in_bias=vec(cin, -500, 500), in_len=vec(b, 1, t_in + 1),
                    m1=np.asarray(2**30 + 5, np.int32), e1=33, bits1=7)
        forms = {"u8 in, none+relu": (xu, dict(bias=bias, relu=True)),
                 "u8 in, requant+relu u8": (xu, dict(bias=bias, relu=True, lens=lens, m=m,
                                                     e=e_u, bits=9)),
                 "int8 in, join": (x8, dict(bias=bias, m=m, e=e_8 + 1, bits=8, res=res,
                                            m_r=m_r, e_r=45)),
                 "prologue int32 -> u8, requant int8": (
                     x32, dict(pro9, bias=bias, lens=lens, m=m, e=e_u + 1, bits=7)),
                 "prologue int8 -> 7-bit codes (scalar m1), none": (x8, dict(pro7, bias=bias))}
        for name, (xi, kw) in forms.items():
            chk.equal("dense_conv", f"dense_conv edge K={k} {cin}->{cout} s={s} d={d} B={b} "
                      f"T_out={t_want}: {name}", dense_conv(xi, w, **conv, **kw),
                      dense_conv_plain(xi, w, **conv, **kw))
    n_edge = chk.n - n_edge
    n_dense = chk.n - n3
    log(f"[10a] uint8 forms == plain: dw_conv {n_dw} cases ({len(DW_SITES)} sites x u8 input, "
        f"u8 prologue codes from int8 / int32 with m31 / m16 / one m1, per-channel e1 / e, "
        f"u8 epilogue; one channel a thread); pw_gemm {n_pw} (the {len(PW_CIN) * len(PW_COUT)} "
        f"(Cin, Cout) pairs x N in {[b * tt for b, tt in PW_BT]} x u8 A in 5 epilogue modes + "
        f"3 prologue -> u8 modes); requant {n_rq} (u8 out from int8 / int32 / u8, u8 in); "
        f"dense_conv {n_dense} ({len(sites)} Jasper10x5Dr sites {sites} in their serving "
        f"forms; {DENSE_MODE_SITES} x N in {[b * tt for b, tt in PW_BT]} x int8 / u8 input x "
        f"5 epilogue modes + 4 prologue modes; {n_edge} at the tiling's edges "
        f"{DENSE_EDGE_CASES}); exact")


def phase_w8a8_golden(dev):
    """10b: the W8A8 QuartzNet and the Jasper10x5Dr golden records on the
    kernel executors and the plain path; returns ({(name, bits): model},
    {(name, bits, mode): device tables})."""
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.freeze import (
        FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest, tables_to_device,
    )

    models, tables = {}, {}
    for key in sorted(golden.RECORDS):
        name, bits, mode = key
        if (name, bits) == ("quartznet15x5", 6) or name not in ("quartznet15x5", "jasper10x5dr"):
            continue   # phase 4's, and phase 11's
        model = models.setdefault((name, bits), golden.flagship(name, bits))
        feats, lens = golden.golden_features(model.plan.feat_in, name)
        host = model.freeze_host(mode)
        want = golden.load_golden(mode, name, bits)
        digest = tables_digest(host)
        if digest != want["tables_sha256"]:
            raise AssertionError(f"{key}: table digest {digest} != golden "
                                 f"{want['tables_sha256']}")
        tables[key] = tables_to_device(host, dev)
        executors = ((FrozenExecFused, FrozenExecKernels, FrozenExec) if mode != "per_channel"
                     else (FrozenExecKernels, FrozenExec))
        for ex in executors:
            bad = golden.compare_golden(
                golden.port_record(model, tables[key], feats, lens, executor=ex), want)
            if bad:
                raise AssertionError(f"{key} golden mismatch on {ex.__name__} in {bad}")
        log(f"[10b] golden {name} W{bits}A{bits} {mode}: tables {digest[:16]}, "
            f"ids/enc_lens/decoder-input/logits hashes equal the JAX record on "
            f"{[ex.__name__ for ex in executors]} (enc_lens {want['enc_lens']})")
    for (name, bits), model in models.items():
        if name == "jasper10x5dr":
            tables[name, bits, "per_channel"] = model.freeze("per_channel", dev)
    return models, tables


def phase_w8a8_serve(models, tables, dev):
    """10c: 4 seeded requests through transcribe on each path of
    W8A8_SERVED; returns {"name WbAb mode": counts}."""
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    utts, secs = seeded_requests(7)
    batch, lens = pad_batch(utts)
    out = {}
    for name, bits, mode in W8A8_SERVED:
        model, tab = models[name, bits], tables[name, bits, mode]
        model.transcribe(utts[:1], device=dev, dyadic_mode=mode)  # builds and caches
        reset_counts()
        texts = model.transcribe(utts, batch_size=4, device=dev, dyadic_mode=mode)
        counts = read_counts()
        expect = planned(kernel_launches(model.plan, tab))
        tag = f"{name} W{bits}A{bits} {mode}"
        if counts != expect:
            raise AssertionError(f"{tag}: launch counts {counts} != plan {expect}")
        ids_k, el_k = make_frozen_fn(model, tab, argmax=True)(batch, lens)
        ids_p, el_p = make_frozen_fn(model, tab, argmax=True, fused=False)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"{tag}: kernel path ids differ from the plain executor's")
        if texts != model.ids_to_text(ids_p, el_p):
            raise AssertionError(f"{tag}: transcribe() differs from the plain executor's")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError(f"{tag}: degenerate ids")
        log(f"[10c] {tag} served 4 requests {[f'{s_:g} s' for s_ in secs]} -> "
            f"{[txt[:24] for txt in texts]}; launches {counts} == plan; ids == plain executor")
        out[tag] = counts
    return out


def phase_w8a8_calibrate(chk, dev):
    """10d: calibrate (kernels) against the plain QuantExec, bit for bit:
    W8A8 QuartzNet15x5 and W6A6 Jasper10x5Dr on B=8 x 500 frames of seeded
    noise features."""
    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    for name, bits in (("quartznet15x5", 8), ("jasper10x5dr", 6)):
        model = golden.flagship(name, bits, ranges=False)
        feats = torch.from_numpy(np.random.default_rng(3).normal(
            size=(8, 500, model.plan.feat_in)).astype(np.float32)).to(dev)
        per_fwd = {k: v for k, v in kernel_launches(model.plan).items() if k != "requant"}
        model.qstate = init_qstate(model.plan)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.calibrate([feats], device=dev)
        counts = read_counts()
        t_k = time.perf_counter() - t0
        if counts != planned(per_fwd):
            raise AssertionError(f"{name} W{bits}A{bits} calibration launches {counts} != "
                                 f"{per_fwd}")
        q_kernel = model.qstate
        model.qstate = init_qstate(model.plan)
        model.calibrate([feats], device=dev, kernels=False)
        a, b = qstate_sites(q_kernel), qstate_sites(model.qstate)
        bad = sum(x != y for x, y in zip(a, b))
        if bad or len(a) != len(b) or sum(v[2] != 0 for v in a) < len(a) // 2:
            raise AssertionError(f"{name} W{bits}A{bits} calibration: {bad} of {len(a)} sites' "
                                 f"ranges differ from the plain QuantExec's (or are empty)")
        log(f"[10d] calibrate {name} W{bits}A{bits} on 8 x 500 frames: the {len(a)} sites' "
            f"ranges equal the plain QuantExec's bit for bit; launches {counts} "
            f"({t_k:.2f} s with the kernels, first call)")


def phase_w8a8_cli(dev, report):
    """10e: cli.inference at its default bit widths (W8A8) on 4 seeded
    wavs: QuartzNet15x5 greedy, Jasper10x5Dr greedy and beam; each prints
    WER: and the plain frozen executor's hypotheses."""
    import tempfile

    import numpy as np

    from qasr_tpu_torch.cli import inference as cli_inference
    from qasr_tpu_torch.data.dataset import AudioToCharDataset, DataLoader
    from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    out = report.setdefault("w8a8_cli", {})
    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_manifest(tmp, np.random.default_rng(5))
        for name, decoder in (("QuartzNet15x5Base-En", "greedy"), ("Jasper10x5Dr", "greedy"),
                              ("Jasper10x5Dr", "beam")):
            (wer, hyps, _, cal), line = run_cli(cli_inference.run, [
                "--asr_model", name, "--dataset", manifest, "--calib_manifest", manifest,
                "--allow_random_weights", "--decoder", decoder, "--beam_width", "16",
                "--batch_size", "4", "--device", str(dev)])
            if (cal.qcfg.weight_bit, cal.qcfg.act_bit) != (8, 8) or not math.isfinite(wer):
                raise AssertionError(f"cli.inference {name}: bits {cal.qcfg}, WER {wer}")
            ds = AudioToCharDataset(manifest, labels=list(cal.vocabulary))
            plain_fn = make_frozen_fn(cal, cal.freeze("static_e", dev), fused=False)
            beam = BeamSearchDecoderWithLM(list(cal.vocabulary), beam_width=16)
            want = []
            for audio_b, alens_b, _, _ in DataLoader(ds, batch_size=4):
                lp, el = plain_fn(audio_b, alens_b)
                want += (cal.ids_to_text(lp.argmax(-1), el) if decoder == "greedy"
                         else [c[0][1] if c else "" for c in beam(lp, el)])
            if hyps != want:
                raise AssertionError(f"cli.inference {name} --decoder {decoder}: {hyps} != "
                                     f"plain frozen {want}")
            log(f"[10e] cli.inference --asr_model {name} (default W8A8) --decoder {decoder}: "
                f"{line}; hypotheses == the plain frozen executor's: {[h[:24] for h in hyps]}")
            out[f"{name} {decoder}"] = {"wer": wer, "hypotheses": hyps}


def phase_w8a8_time(chk, models, tables, qn6, dev, card, report):
    """10f: the frozen steps at B x 15 s and each kernel's uint8 form and
    Kernel 8's sites against their plain versions, bounds and yardsticks;
    returns the kernels line's rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.kernels.requant import requant, requant_plain
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.models.jasper import get_same_padding, out_frames

    batch, seconds = W8A8_STEP_BATCH, 15.0
    audio, lens = noise_batch(batch, seconds, dev)
    qn8 = models["quartznet15x5", 8]
    fns = {"QuartzNet W6A6 static_e": make_frozen_fn(qn6[0], qn6[1], argmax=True),
           "QuartzNet W8A8 static_e": make_frozen_fn(
               qn8, tables["quartznet15x5", 8, "static_e"], argmax=True),
           "QuartzNet W8A8 per_channel": make_frozen_fn(
               qn8, tables["quartznet15x5", 8, "per_channel"], argmax=True)}
    for bits in (6, 8):
        fns[f"Jasper10x5Dr W{bits}A{bits} static_e"] = make_frozen_fn(
            models["jasper10x5dr", bits], tables["jasper10x5dr", bits, "static_e"], argmax=True)
    step = step_times(fns, (audio, lens), card, "W8A8", batch, seconds, report)
    del audio

    rng = np.random.default_rng(11)
    rows = []
    t_enc = 768

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    def vec(c, lo, hi):
        return t(lo, hi, c, np.int32)

    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)
    # Kernel 1: a uint8 input (W8A8's in-block depthwise conv) and the
    # uint8 prologue on a block end's int32 accumulator
    c, k = 512, 75
    xu = t(0, 256, (batch, t_enc, c), np.uint8)
    w = t(-31, 32, (k, c), np.int8)
    m, e = _tables(rng, c, False, dev)
    kw = dict(padding=37, bias=vec(c, -3000, 3000), relu=True, out_len=full, m=m, e=e + 2,
              bits=8)
    r = timed_pair(chk, "dw_conv", f"dw_conv B={batch} T={t_enc} C={c} K={k} u8 in, int8 out",
                   lambda: dw_conv(xu, w, **kw), lambda: dw_conv_plain(xu, w, **kw), card, rows)
    r["bound"] = bound(xu.numel() + w.numel() + 12 * c + 4 * batch + xu.numel(),
                       2 * xu.numel() * k)
    x32 = t(-2**20, 2**20, (batch, t_enc, c), np.int32)
    kwp = dict(kw, in_bias=vec(c, -2**18, 2**18), in_relu=True, in_len=full,
               m1=vec(c, 2**29, 2**31), e1=43, bits1=9)
    r = timed_pair(chk, "dw_conv", f"dw_conv prologue B={batch} T={t_enc} C={c} K={k} "
                   f"int32+bias+relu in -> u8 codes, int8 out", lambda: dw_conv(x32, w, **kwp),
                   lambda: dw_conv_plain(x32, w, **kwp), card, rows)
    r["bound"] = bound(4 * x32.numel() + w.numel() + 24 * c + 8 * batch + xu.numel(),
                       2 * xu.numel() * k)
    # Kernel 2: a uint8 A, and a uint8 output (the next depthwise input)
    n_rows = batch * t_enc
    for cin, cout, mode in ((512, 512, "u8 in, requant int8"), (512, 512, "requant u8 out")):
        x = t(0, 256, (batch, t_enc, cin), np.uint8) if "u8 in" in mode else \
            t(-64, 64, (batch, t_enc, cin), np.int8)
        wt = t(-31, 32, (cout, cin), np.int8)
        kw = dict(bias=vec(cout, -3000, 3000), relu=True, lens=full,
                  m=vec(cout, 2**29, 2**31 - 1), e=39, bits=8 if "int8" in mode else 9)
        xf, wf = x.reshape(-1, cin).to(torch.float64), wt.t().to(torch.float64)
        x8 = x.reshape(-1, cin) if x.dtype == torch.int8 else None
        lib = ((lambda x8=x8, w_=wt.t(): torch._int_mm(x8, w_)) if x8 is not None else
               (lambda xf=xf, wf=wf: xf @ wf))
        r = timed_pair(chk, "pw_gemm", f"pw_gemm N={n_rows} {cin}->{cout} {mode}"
                       f"{' (library: float64 matmul)' if x8 is None else ''}",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows, lib)
        r["bound"] = bound(x.numel() + wt.numel() + 8 * cout + 4 * batch + n_rows * cout,
                           2 * n_rows * cin * cout)
        del xf, wf
    # Kernel 7: a block end's int32 accumulator -> uint8 codes (per_channel)
    for c in (256, 512):
        z = t(-2**28, 2**28, (batch, t_enc, c), np.int32)
        m, ev = vec(c, 2**29, 2**31), vec(c, 36, 44)
        r = timed_pair(chk, "requant", f"requant N={n_rows} C={c} int32 per-channel -> u8",
                       lambda z=z, m=m, ev=ev: requant(z, m, ev, 9, relu=True, lens=full),
                       lambda z=z, m=m, ev=ev: requant_plain(z, m, ev, 9, relu=True, lens=full),
                       card, rows)
        r["bound"] = bound(5 * z.numel() + 8 * c + 4 * batch, 0)

    # Kernel 8 at each Jasper10x5Dr site, the W8A8 in-block form (uint8 in,
    # requant + ReLU -> uint8 out), beside float64 conv1d (exact here)
    jas = models["jasper10x5dr", 8]
    for k, cin, cout, s, d in dense_serving_sites(jas.plan):
        pad = get_same_padding(k, s, d)
        t_in = t_enc * s
        t_out = out_frames(t_in, k, s, pad, d)
        first = cin == jas.plan.feat_in
        x = t(-64, 64, (batch, t_in, cin), np.int8) if first else \
            t(0, 256, (batch, t_in, cin), np.uint8)
        w = t(-127, 128, (cout, k, cin), np.int8)
        kw = dict(stride=s, padding=pad, dilation=d, bias=vec(cout, -3000, 3000), relu=True,
                  lens=full, m=vec(cout, 2**29, 2**31),
                  e=spread_e(k * cin, 40 if first else 147, 73), bits=9)
        xf = x.to(torch.float64).transpose(1, 2).contiguous()
        wf = w.to(torch.float64).permute(0, 2, 1).contiguous()
        label = (f"dense_conv B={batch} T={t_out} K={k} {cin}->{cout} s={s} d={d} "
                 f"{'int8' if first else 'u8'} in, requant+relu u8 out")
        chk.equal("dense_conv", label, dense_conv(x, w, **kw), dense_conv_plain(x, w, **kw))
        pk = statistics.median(cuda_ms(lambda: dense_conv_plain(x, w, **kw), reps=2, warmup=1))
        kk = statistics.median(cuda_ms(lambda: dense_conv(x, w, **kw), reps=10))
        kd, kd_by = device_ms(lambda: dense_conv(x, w, **kw), KERNEL_SYMBOLS["dense_conv"])
        lib = statistics.median(cuda_ms(lambda: F.conv1d(xf, wf, None, s, pad, d), reps=1,
                                        warmup=1))
        rows.append({"shape": label, "kernel": "dense_conv", "call_ms": kk, "device_ms": kd,
                     "device_ms_by": kd_by, "plain_ms": pk, "library_call_ms": lib,
                     "library_device_ms": lib, "library_device_ms_by": "events"})
        rows[-1]["bound"] = bound(x.numel() + w.numel() + 4 * 2 * cout + 4 * batch
                                  + batch * t_out * cout, 2 * batch * t_out * k * cin * cout)
        log(f"[10f] {label}: kernel {kd:.4f} ms device ({kd_by}; {kk:.4f} ms call), plain "
            f"{pk:.3f} ms, float64 conv1d {lib:.3f} ms (events, one call), bound "
            f"{rows[-1]['bound'][0]:.4f} ms ({rows[-1]['bound'][1]}), equal [{card}]")
        del x, w, xf, wf
    report["w8a8_per_kernel"] = rows
    dense = [r for r in rows if r["kernel"] == "dense_conv"]
    log(f"[10f] Kernel 8 over Jasper10x5Dr's distinct sites: {sum(r['device_ms'] for r in dense):.3f} "
        f"ms device against {sum(r['bound'][0] for r in dense):.3f} ms of bound, one call each "
        f"[{card}]")
    return step, rows


def phase_w8a8(chk, dev, card, report, qn6):
    """Phase 10; returns (kernels line rows, {path: launch counts})."""
    t_phase = time.perf_counter()
    phase_u8_kernels(chk, dev)
    models, tables = phase_w8a8_golden(dev)
    counts = phase_w8a8_serve(models, tables, dev)
    phase_w8a8_calibrate(chk, dev)
    phase_w8a8_cli(dev, report)
    _, rows = phase_w8a8_time(chk, models, tables, qn6, dev, card, report)
    report["w8a8_launches"] = counts
    report["w8a8_seconds"] = time.perf_counter() - t_phase
    log(f"[10] phase 10 took {report['w8a8_seconds']:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 11: grouped convs with GroupShuffle (the grouped forms of Kernels 2
# and 8), hardtanh's ceiling in Kernels 1, 2, 7 and 8, and the rest of the
# Jasper family and MatchboxNet VAD on the card
# ---------------------------------------------------------------------------

# Kernel 2's grouped checks (pw_gemm_grouped.cu): (Cin, Cout, groups) at N =
# B * T in {609, 1, 37} (PW_BT): QuartzNet15x5-g4's 256 / 512 sites, groups
# 2 and 8, Cin/g 16 (the narrowest the kernel takes), 48, 80 (the thread-
# filled A with a zero pad a group) and 192, Cout/g not a multiple of the
# column tile's (40, 48, 50), 3 and 6 groups (a tile of 1 or 2 of them)
GROUPED_PW = ((256, 256, 2), (256, 256, 4), (512, 512, 4), (256, 512, 4), (512, 512, 8),
              (128, 256, 8), (1024, 512, 8), (192, 160, 4), (160, 96, 2), (768, 768, 4),
              (240, 150, 3), (384, 192, 6))
# Kernel 2 grouped past one persistent wave (row tiles > 2 x 132 blocks):
# (B, T) and the shapes
GROUPED_PW_WAVE, GROUPED_PW_WAVE_SHAPES = (8, 6007), ((512, 512, 4), (256, 256, 4), (256, 256, 8))
# Kernel 8's grouped checks (dense_conv_grouped.cu): (K, Cin, Cout, stride,
# dilation, groups) -- the Jasper-width block's site (768, K 25, 4 groups:
# Cout/g 192), Cout/g 64 at 4 and 8 groups, 2 groups at Cout/g 192, stride 2,
# dilation 2, Cin/g 48 / 80 / 16 (K steps past the group: zero weights),
# 3 and 6 groups
GROUPED_DENSE = ((25, 768, 768, 1, 1, 4), (5, 256, 256, 1, 1, 4), (11, 512, 512, 1, 1, 8),
                 (13, 256, 384, 1, 1, 2), (7, 128, 256, 2, 1, 2), (9, 512, 512, 1, 2, 2),
                 (5, 192, 160, 1, 1, 4), (7, 160, 96, 1, 1, 2), (5, 128, 128, 1, 1, 8),
                 (3, 384, 240, 1, 1, 3), (5, 384, 192, 1, 1, 6))


def phase_grouped_kernels(chk, dev):
    """11a: Kernels 2 and 8 grouped (groups 2 / 4 / 8, with and without the
    prologue, every epilogue mode, GroupShuffle on store or not, int8 and
    uint8 operands) and hardtanh's ceiling (per channel and scalar, in the
    prologue and the epilogue) in Kernels 1, 2, 7 and 8, each against its
    plain version, exact; and the group widths the grouped kernels refuse."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
    from qasr_tpu_torch.kernels.dw_conv import dw_conv, dw_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain
    from qasr_tpu_torch.kernels.requant import requant, requant_plain
    from qasr_tpu_torch.models.jasper import get_same_padding, out_frames

    rng = np.random.default_rng(11)
    n0 = chk.n

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    def vec(c, lo, hi):
        return t(lo, hi, c, np.int32)

    def modes_for(cout, b, tt, acc_rms, groups):
        """The epilogue modes of Kernels 2 and 8 at this output: none,
        ReLU, hardtanh (vector and scalar ceilings), requant (int8, and
        uint8 with a ReLU or hardtanh at 9 bits) and join, with and
        without GroupShuffle."""
        bias = vec(cout, -3000, 3000)
        lens = vec(b, 1, tt + 1)
        res = t(-2**20, 2**20, (b, tt, cout), np.int32)
        e = spread_e(1, acc_rms, 1.0)
        m = vec(cout, 2**29, 2**31 - 1)
        m_r = vec(cout, 2**29, 2**31 - 1)
        cap = vec(cout, 0, int(acc_rms) + 1)
        cap_s = int(acc_rms // 2)
        sh = groups > 1
        return {
            "none": dict(bias=bias),
            "none+relu shuffle": dict(bias=bias, relu=True, shuffle=sh),
            "none+hardtanh[c] shuffle": dict(bias=bias, relu=True, hcap=cap, shuffle=sh),
            "none+hardtanh scalar": dict(bias=bias, relu=True, hcap=cap_s),
            "requant shuffle": dict(bias=bias, lens=lens, m=m, e=e, bits=7, shuffle=sh),
            "requant+hardtanh[c] u8 shuffle": dict(bias=bias, relu=True, hcap=cap, lens=lens,
                                                   m=m, e=e - 1, bits=9, shuffle=sh),
            "requant+relu": dict(bias=bias, relu=True, lens=lens, m=m, e=e, bits=6),
            "join shuffle": dict(bias=bias, m=m, e=e, bits=6, res=res, m_r=m_r, e_r=e + 14,
                                 shuffle=sh),
            "join": dict(bias=bias, m=m, e=e, bits=8, res=res, m_r=m_r, e_r=e + 14),
        }

    def prologues(cin, b, t_in):
        """Prologue forms: int8 and int32 producers, a vector or a scalar
        ceiling (hardtanh), ragged lengths, uint8 codes at 9 bits."""
        in_len = vec(b, 1, t_in + 1)
        out = {}
        for x32 in (False, True):
            hb = 2**18 if x32 else 64
            x = t(-2**20, 2**20, (b, t_in, cin), np.int32) if x32 else \
                t(-64, 64, (b, t_in, cin), np.int8)
            m1, e1 = _tables(rng, cin, False, dev)
            e1 = e1 + (7 if x32 else -6)   # codes of about +-64
            tag = "int32" if x32 else "int8"
            out[f"prologue {tag} hardtanh[c]"] = (x, dict(
                m1=m1, e1=e1, bits1=7, in_bias=vec(cin, -hb, hb), in_relu=True,
                in_hcap=vec(cin, 0, hb), in_len=in_len))
            out[f"prologue {tag} hardtanh scalar -> u8"] = (x, dict(
                m1=np.asarray(int(m1[0].item()), np.int32), e1=e1 - 1, bits1=9,
                in_relu=True, in_hcap=hb // 2, in_len=in_len))
            out[f"prologue {tag} relu"] = (x, dict(m1=m1, e1=e1, bits1=8, in_relu=True))
        return out

    # Kernel 2, grouped
    for (b, tt), (cin, cout, g) in ((bt, s) for bt in PW_BT for s in GROUPED_PW):
        wt = t(-31, 32, (cout, cin // g), np.int8)
        acc_rms = math.sqrt(cin // g) * 40 * 18
        modes = modes_for(cout, b, tt, acc_rms, g)
        inputs = {"int8 in": t(-64, 64, (b, tt, cin), np.int8),
                  "u8 in": t(0, 256, (b, tt, cin), np.uint8)}
        for (iname, x), (name, kw) in ((i, md) for i in inputs.items() for md in modes.items()):
            if iname == "u8 in" and "join" in name:
                continue
            what = f"pw_gemm N={b * tt} {cin}->{cout} g={g} {iname}, {name}"
            chk.equal("pw_gemm", what, pw_gemm(x, wt, groups=g, **kw),
                      pw_gemm_plain(x, wt, groups=g, **kw))
        for i, (pname, (x, pro)) in enumerate(prologues(cin, b, tt).items()):
            mode = ("requant+hardtanh[c] u8 shuffle", "join shuffle", "none+relu shuffle")[i % 3]
            kw = dict(pro, **modes[mode])
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} g={g} {pname}, {mode}",
                      pw_gemm(x, wt, groups=g, **kw), pw_gemm_plain(x, wt, groups=g, **kw))
    # past one persistent wave: every block walks several row tiles, each A
    # stage refilled (by TMA, and by the warpgroup with the prologue on)
    b, tt = GROUPED_PW_WAVE
    for cin, cout, g in GROUPED_PW_WAVE_SHAPES:
        wt = t(-31, 32, (cout, cin // g), np.int8)
        modes = modes_for(cout, b, tt, math.sqrt(cin // g) * 40 * 18, g)
        x = t(-64, 64, (b, tt, cin), np.int8)
        for name in ("requant shuffle", "join shuffle", "none"):
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} g={g} int8 in, {name}",
                      pw_gemm(x, wt, groups=g, **modes[name]),
                      pw_gemm_plain(x, wt, groups=g, **modes[name]))
        pname, (xp, pro) = next(iter(prologues(cin, b, tt).items()))
        kw = dict(pro, **modes["requant+hardtanh[c] u8 shuffle"])
        chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} g={g} {pname}",
                  pw_gemm(xp, wt, groups=g, **kw), pw_gemm_plain(xp, wt, groups=g, **kw))
        del x, xp
    n_pw = chk.n - n0

    # Kernel 8, grouped
    n1 = chk.n
    for k, cin, cout, s, d, g in GROUPED_DENSE:
        for b, t_out in ((2, 300), (1, 1), (3, 129)):
            pad = get_same_padding(k, s, d)
            t_in = t_out * s
            conv = dict(stride=s, padding=pad, dilation=d, groups=g)
            w = t(-31, 32, (cout, k, cin // g), np.int8)
            t_o = out_frames(t_in, k, s, pad, d)
            modes = modes_for(cout, b, t_o, math.sqrt(k * cin // g) * 40 * 18, g)
            x = t(-64, 64, (b, t_in, cin), np.int8)
            xu = t(0, 256, (b, t_in, cin), np.uint8)
            for name, kw in modes.items():
                chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} s={s} d={d} g={g} "
                          f"B={b} T'={t_o} int8 in, {name}", dense_conv(x, w, **conv, **kw),
                          dense_conv_plain(x, w, **conv, **kw))
            for name in ("requant+hardtanh[c] u8 shuffle", "none+relu shuffle"):
                kw = modes[name]
                chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} s={s} d={d} g={g} "
                          f"B={b} u8 in, {name}", dense_conv(xu, w, **conv, **kw),
                          dense_conv_plain(xu, w, **conv, **kw))
            for i, (pname, (xp, pro)) in enumerate(prologues(cin, b, t_in).items()):
                mode = ("requant+hardtanh[c] u8 shuffle", "join shuffle",
                        "none+hardtanh[c] shuffle")[i % 3]
                kw = dict(pro, **modes[mode])
                chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} g={g} B={b} {pname}, "
                          f"{mode}", dense_conv(xp, w, **conv, **kw),
                          dense_conv_plain(xp, w, **conv, **kw))
    n_dense = chk.n - n1

    # hardtanh's ceiling ungrouped: Kernel 2 and 8 at QuartzNet / Jasper
    # widths, Kernel 1 in its epilogue and prologue at every depthwise site,
    # Kernel 7 per channel and scalar
    n2 = chk.n
    for (b, tt), (cin, cout) in ((bt, s) for bt in PW_BT for s in ((512, 512), (40, 256))):
        wt = t(-31, 32, (cout, cin), np.int8)
        modes = modes_for(cout, b, tt, math.sqrt(cin) * 40 * 18, 1)
        x = t(-64, 64, (b, tt, cin), np.int8)
        for name in ("none+hardtanh[c] shuffle", "none+hardtanh scalar",
                     "requant+hardtanh[c] u8 shuffle"):
            kw = modes[name]
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} {name} (ungrouped)",
                      pw_gemm(x, wt, **kw), pw_gemm_plain(x, wt, **kw))
        for pname, (xp, pro) in prologues(cin, b, tt).items():
            kw = dict(pro, **modes["requant+relu"])
            chk.equal("pw_gemm", f"pw_gemm N={b * tt} {cin}->{cout} {pname} (ungrouped)",
                      pw_gemm(xp, wt, **kw), pw_gemm_plain(xp, wt, **kw))
    for k, cin, cout in ((13, 256, 384), (25, 768, 768)):
        b, t_in = 2, 300
        w = t(-31, 32, (cout, k, cin), np.int8)
        conv = dict(padding=k // 2)
        modes = modes_for(cout, b, t_in, math.sqrt(k * cin) * 40 * 18, 1)
        x = t(-64, 64, (b, t_in, cin), np.int8)
        for name in ("none+hardtanh[c] shuffle", "requant+hardtanh[c] u8 shuffle"):
            chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} {name} (ungrouped)",
                      dense_conv(x, w, **conv, **modes[name]),
                      dense_conv_plain(x, w, **conv, **modes[name]))
        for pname, (xp, pro) in prologues(cin, b, t_in).items():
            kw = dict(pro, **modes["requant+relu"])
            chk.equal("dense_conv", f"dense_conv K={k} {cin}->{cout} {pname} (ungrouped)",
                      dense_conv(xp, w, **conv, **kw), dense_conv_plain(xp, w, **conv, **kw))
    n_cap28 = chk.n - n2
    n3 = chk.n
    for c, k, s, d in DW_SITES + [(30, 33, 1, 1)]:
        b, t_in = 3, 200 * s + 7
        pad = get_same_padding(k, s, d)
        w = t(-31, 32, (k, c), np.int8)
        t_o = out_frames(t_in, k, s, pad, d)
        acc_rms = math.sqrt(k) * 40 * 18
        bias = vec(c, -3000, 3000)
        lens = vec(b, 1, t_o + 1)
        m, _ = _tables(rng, c, False, dev)
        e = 30 + int(round(math.log2(acc_rms / 24)))   # codes of about +-24
        conv = dict(stride=s, padding=pad, dilation=d)
        x = t(-64, 64, (b, t_in, c), np.int8)
        cases = {
            "int32 out hardtanh[c]": (x, dict(bias=bias, relu=True, hcap=vec(c, 0, int(acc_rms)))),
            "int32 out hardtanh scalar": (x, dict(bias=bias, relu=True, hcap=int(acc_rms) // 3)),
            "int8 out hardtanh[c]": (x, dict(bias=bias, relu=True, hcap=vec(c, 0, int(acc_rms)),
                                             out_len=lens, m=m, e=e, bits=8)),
            "u8 out hardtanh scalar": (x, dict(bias=bias, relu=True, hcap=int(acc_rms) // 2,
                                               out_len=lens, m=m, e=e - 1, bits=9)),
        }
        for pname, (xp, pro) in prologues(c, b, t_in).items():
            cases[pname + ", int8 out hardtanh[c]"] = (xp, dict(
                pro, bias=bias, relu=True, hcap=vec(c, 0, int(acc_rms)), out_len=lens, m=m,
                e=e, bits=8))
        for name, (xi, kw) in cases.items():
            chk.equal("dw_conv", f"dw_conv C={c} K={k} s={s} d={d} {name}",
                      dw_conv(xi, w, **conv, **kw), dw_conv_plain(xi, w, **conv, **kw))
    n_cap1 = chk.n - n3
    n4 = chk.n
    for c in RQ_C:
        b, tt = 3, 203
        lens = vec(b, 1, tt + 1)
        for x32 in (False, True):
            z = t(-2**20, 2**20, (b, tt, c), np.int32) if x32 else t(-128, 128, (b, tt, c),
                                                                     np.int8)
            hb = 2**19 if x32 else 100
            m = vec(c, 2**29, 2**31 - 1)
            e = 51 if x32 else 37
            for cname, cap in (("[c]", vec(c, 0, hb)), (" scalar", hb // 3)):
                for bits in (7, 9):
                    kw = dict(relu=True, hcap=cap, lens=lens)
                    chk.equal("requant", f"requant C={c} {'int32' if x32 else 'int8'} "
                              f"hardtanh{cname} bits={bits}", requant(z, m, e - (bits == 9), bits,
                                                                      **kw),
                              requant_plain(z, m, e - (bits == 9), bits, **kw))
    n_cap7 = chk.n - n4
    # the group widths the grouped kernels refuse on CUDA
    refused = 0
    if dev.type == "cuda":
        for fn, args in ((pw_gemm, (t(-8, 8, (1, 5, 64), np.int8), t(-8, 8, (64, 8), np.int8))),
                         (dense_conv, (t(-8, 8, (1, 5, 64), np.int8),
                                       t(-8, 8, (64, 3, 8), np.int8)))):
            try:
                fn(*args, groups=8)
            except NotImplementedError:
                refused += 1
            else:
                raise AssertionError(f"{fn.__name__}: 8 input channels a group was taken")
    log(f"[11a] exact: pw_gemm grouped {n_pw} (groups 2/3/4/6/8 at {len(GROUPED_PW)} shapes x N "
        f"in {[b * t for b, t in PW_BT]} and {len(GROUPED_PW_WAVE_SHAPES)} at N = "
        f"{GROUPED_PW_WAVE[0] * GROUPED_PW_WAVE[1]}, 9 epilogue modes incl. GroupShuffle and "
        f"hardtanh, int8 / uint8 A, 6 prologue forms), dense_conv grouped {n_dense} "
        f"({len(GROUPED_DENSE)} sites x 3 shapes), hardtanh ceilings in Kernels 2 + 8 "
        f"{n_cap28}, Kernel 1 {n_cap1}, Kernel 7 {n_cap7}; {refused} narrow groups refused "
        f"(NotImplementedError)")
    return {"pw_grouped": n_pw, "dense_grouped": n_dense, "cap_2_8": n_cap28,
            "cap_1": n_cap1, "cap_7": n_cap7, "refused": refused}


# the full-width paths phase 11 serves: (golden record name or the Jasper-width
# grouped block, bits, dyadic mode)
GROUPED_SERVED = (("quartznet15x5_g4", 6, "static_e"), ("quartznet15x5_g4", 6, "per_channel"),
                  ("quartznet15x5_hardtanh", 6, "static_e"),
                  ("jasper_grouped_block", 6, "static_e"))
# the wavs phase 11f's vad_infer reads: seconds each (0.63 s windows, 0.01 s apart)
VAD_SECONDS = (4.0, 6.5, 3.2)


class PlainCalls:
    """Counts the calls of every kernel's plain version (the ``*_plain``
    functions of the kernel modules and the frozen executors' module)
    while it is active: a kernel path on CUDA makes none."""

    def __init__(self):
        self.n = 0
        self.saved = []

    def __enter__(self):
        from qasr_tpu_torch.kernels import (
            conv_block, dense_conv, dw_conv, ffn_ln, int_attention, lin_epilogue, pw_gemm,
            requant, rnnt_decoder,
        )
        from qasr_tpu_torch.quantize import conformer_freeze, freeze

        def counting(fn):
            def wrapper(*a, **kw):
                self.n += 1
                return fn(*a, **kw)
            return wrapper
        for mod in (dense_conv, dw_conv, pw_gemm, requant, freeze, conv_block, ffn_ln,
                    int_attention, lin_epilogue, conformer_freeze, rnnt_decoder):
            for name in dir(mod):
                if name.endswith("_plain") and callable(getattr(mod, name)):
                    self.saved.append((mod, name, getattr(mod, name)))
                    setattr(mod, name, counting(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def grouped_block_model(dev):
    """The Jasper-width grouped block (config.jasper_grouped_block) at W6A6,
    BN-folded, calibrated on the card (kernels) on the log-mel features of
    2 x 4 x 4 s of seeded noise (0.1 sigma, seed 0); its ranges also from
    the plain QuantExec, which must be equal."""
    import numpy as np
    import torch

    from qasr_tpu_torch.models.config import jasper_grouped_block
    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.models.jasper import init_qstate

    model = ASRModel.from_config(jasper_grouped_block(), seed=0)
    model.set_quant_bit(6, "all")
    model.bn_folding()
    rng = np.random.default_rng(0)
    n = int(16000 * 4.0)
    batches = []
    for _ in range(2):
        audio = torch.from_numpy(rng.normal(size=(4, n)).astype(np.float32) * 0.1).to(dev)
        batches.append(model.frontend(audio, torch.full((4,), n, dtype=torch.int32,
                                                        device=dev), dither=0.0))
    model.calibrate(batches, device=dev, kernels=False)
    plain = model.qstate
    model.qstate = init_qstate(model.plan)
    model.calibrate(batches, device=dev)
    a, b = qstate_sites(model.qstate), qstate_sites(plain)
    bad = sum(x != y for x, y in zip(a, b))
    if bad or len(a) != len(b) or sum(v[2] != 0 for v in a) < len(a) // 2:
        raise AssertionError(f"jasper_grouped_block calibration: {bad} of {len(a)} sites' "
                             f"ranges differ from the plain QuantExec's (or are empty)")
    log(f"[11b] jasper_grouped_block W6A6 calibrated on the card on its noise recipe "
        f"(Kernels 2 and 8 grouped, no epilogue): the {len(a)} sites' ranges equal the plain "
        f"QuantExec's bit for bit")
    return model


def phase_grouped_golden(dev):
    """11b: QuartzNet15x5-g4 (static_e, per_channel) and QuartzNet15x5 with
    hardtanh (static_e) against their JAX golden records on the kernel
    executors and the plain one, and the Jasper-width grouped block
    calibrated and frozen; returns ({name: model}, {(name, bits, mode):
    device tables})."""
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.quantize.freeze import (
        FrozenExec, FrozenExecFused, FrozenExecKernels, tables_digest, tables_to_device,
    )

    models, tables = {}, {}
    for name, bits, mode in GROUPED_SERVED[:3]:
        model = models.setdefault(name, golden.flagship(name, bits))
        feats, lens = golden.golden_features(model.plan.feat_in, name)
        host = model.freeze_host(mode)
        want = golden.load_golden(mode, name, bits)
        digest = tables_digest(host)
        if digest != want["tables_sha256"]:
            raise AssertionError(f"{name} {mode}: table digest {digest} != golden "
                                 f"{want['tables_sha256']}")
        tables[name, bits, mode] = tables_to_device(host, dev)
        executors = ((FrozenExecFused, FrozenExecKernels, FrozenExec) if mode != "per_channel"
                     else (FrozenExecKernels, FrozenExec))
        for ex in executors:
            bad = golden.compare_golden(golden.port_record(
                model, tables[name, bits, mode], feats, lens, executor=ex), want)
            if bad:
                raise AssertionError(f"{name} {mode} golden mismatch on {ex.__name__} in {bad}")
        log(f"[11b] golden {name} W{bits}A{bits} {mode}: tables {digest[:16]}, "
            f"ids/enc_lens/decoder-input/logits hashes equal the JAX record on "
            f"{[ex.__name__ for ex in executors]} (enc_lens {want['enc_lens']})")
    jb = models["jasper_grouped_block"] = grouped_block_model(dev)
    tables["jasper_grouped_block", 6, "static_e"] = jb.freeze("static_e", dev)
    return models, tables


def grouped_sites(plan):
    """The launches of the grouped forms of Kernels 2 and 8 in one frozen
    forward: its grouped pointwise and grouped dense convs (a depthwise
    conv's groups are its channels: Kernel 1)."""
    from qasr_tpu_torch.models.jasper import is_depthwise, is_pointwise

    specs = [s for bp in plan.blocks for s in bp.convs + bp.res
             if s.groups > 1 and not is_depthwise(s)]
    pw = sum(map(is_pointwise, specs))
    return {"pw_gemm_grouped": pw, "dense_conv_grouped": len(specs) - pw}


def grouped_counts():
    from qasr_tpu_torch.kernels.dense_conv import dense_conv
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm

    return {"pw_gemm_grouped": pw_gemm.grouped_launches,
            "dense_conv_grouped": dense_conv.grouped_launches}


def phase_grouped_serve(models, tables, dev):
    """11c: 4 seeded requests through transcribe on each path of
    GROUPED_SERVED: the launches kernel_launches plans (of them, the
    grouped forms' as the plan's grouped convs), no call of a plain
    version, and the plain executor's ids; returns {path: counts}."""
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    utts, secs = seeded_requests(7)
    batch, lens = pad_batch(utts)
    out = {}
    for name, bits, mode in GROUPED_SERVED:
        model, tab = models[name], tables[name, bits, mode]
        model.transcribe(utts[:1], device=dev, dyadic_mode=mode)  # builds and caches
        reset_counts()
        with PlainCalls() as plain:
            texts = model.transcribe(utts, batch_size=4, device=dev, dyadic_mode=mode)
            counts = read_counts()
            grouped = grouped_counts()
        expect = planned(kernel_launches(model.plan, tab))
        tag = f"{name} W{bits}A{bits} {mode}"
        if counts != expect or plain.n or grouped != grouped_sites(model.plan):
            raise AssertionError(f"{tag}: launch counts {counts} (plan {expect}), grouped forms "
                                 f"{grouped} (plan {grouped_sites(model.plan)}), {plain.n} "
                                 f"plain-version calls")
        counts.update(grouped)
        ids_k, el_k = make_frozen_fn(model, tab, argmax=True)(batch, lens)
        ids_p, el_p = make_frozen_fn(model, tab, argmax=True, fused=False)(batch, lens)
        if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)):
            raise AssertionError(f"{tag}: kernel path ids differ from the plain executor's")
        if texts != model.ids_to_text(ids_p, el_p):
            raise AssertionError(f"{tag}: transcribe() differs from the plain executor's")
        if len(torch.unique(ids_k)) < 2:
            raise AssertionError(f"{tag}: degenerate ids")
        log(f"[11c] {tag} served 4 requests {[f'{s_:g} s' for s_ in secs]} -> "
            f"{[txt[:24] for txt in texts]}; launches {counts} == plan, 0 plain-version "
            f"calls; ids == plain executor")
        out[tag] = counts
    return out


def phase_grouped_calibrate(models, dev):
    """11d: QuartzNet15x5-g4 and hardtanh calibrating (kernels: the grouped
    Kernel 2 without epilogue, GroupShuffle and hardtanh in float glue)
    against the plain QuantExec, bit for bit, on 8 x 500 frames of seeded
    noise features, with the planned launches and no plain-version call."""
    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    for name in ("quartznet15x5_g4", "quartznet15x5_hardtanh"):
        model = golden.flagship(name, 6, ranges=False)
        feats = torch.from_numpy(np.random.default_rng(3).normal(
            size=(8, 500, model.plan.feat_in)).astype(np.float32)).to(dev)
        per_fwd = {k: v for k, v in kernel_launches(model.plan).items() if k != "requant"}
        model.qstate = init_qstate(model.plan)
        reset_counts()
        with PlainCalls() as plain:
            model.calibrate([feats], device=dev)
            counts = read_counts()
        if counts != planned(per_fwd) or plain.n:
            raise AssertionError(f"{name} calibration launches {counts} != {per_fwd}, "
                                 f"{plain.n} plain-version calls")
        q_kernel = model.qstate
        model.qstate = init_qstate(model.plan)
        model.calibrate([feats], device=dev, kernels=False)
        a, b = qstate_sites(q_kernel), qstate_sites(model.qstate)
        bad = sum(x != y for x, y in zip(a, b))
        if bad or len(a) != len(b) or sum(v[2] != 0 for v in a) < len(a) // 2:
            raise AssertionError(f"{name} calibration: {bad} of {len(a)} sites' ranges differ "
                                 f"from the plain QuantExec's (or are empty)")
        log(f"[11d] calibrate {name} W6A6 on 8 x 500 frames: the {len(a)} sites' ranges equal "
            f"the plain QuantExec's bit for bit; launches {counts}, 0 plain-version calls")


def time_grouped_sites(chk, dev, card, batch=64, t_enc=768):
    """11e: Kernel 2 grouped at QuartzNet15x5-g4's grouped pointwise sites
    (B=64 x 15 s: the in-block form, int8 from the depthwise conv's
    epilogue, requant + ReLU + GroupShuffle -> int8) beside torch._int_mm
    per group, and Kernel 8 grouped at the Jasper-width block's K 25 site
    (int8 in, requant + ReLU + GroupShuffle -> int8) beside float64
    conv1d(groups=4); each against its plain version (exact) and its
    bound.  Returns the rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from qasr_tpu_torch.kernels.dense_conv import dense_conv, dense_conv_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    rng = np.random.default_rng(14)
    rows = []
    g = 4
    full = torch.full((batch,), t_enc, dtype=torch.int32, device=dev)

    def t(lo, hi, shape, dtype):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)

    n_rows = batch * t_enc
    for cin, cout in ((256, 256), (256, 512), (512, 512)):
        x = t(-32, 32, (batch, t_enc, cin), np.int8)
        wt = t(-31, 32, (cout, cin // g), np.int8)
        kw = dict(bias=t(-3000, 3000, cout, np.int32), relu=True, lens=full,
                  m=t(2**29, 2**31 - 1, cout, np.int32), e=spread_e(cin // g, 18, 18),
                  bits=6, groups=g, shuffle=True)
        x2 = x.reshape(-1, cin)
        parts = [(x2[:, i * (cin // g):(i + 1) * (cin // g)].contiguous(),
                  wt[i * (cout // g):(i + 1) * (cout // g)].t()) for i in range(g)]
        r = timed_pair(chk, "pw_gemm", f"pw_gemm grouped g={g} N={n_rows} {cin}->{cout} "
                       f"requant+relu+shuffle (library: torch._int_mm per group)",
                       lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw),
                       lambda x=x, wt=wt, kw=kw: pw_gemm_plain(x, wt, **kw), card, rows,
                       lambda parts=parts: [torch._int_mm(a, b) for a, b in parts])
        r["bound"] = bound(x.numel() + wt.numel() + 8 * cout + 4 * batch + n_rows * cout,
                           2 * n_rows * (cin // g) * cout)
        log(f"[11e]   bound {r['bound'][0]:.4f} ms ({r['bound'][1]}) [{card}]")
        del x, parts
    k, c = 25, 768
    x = t(-32, 32, (batch, t_enc, c), np.int8)
    w = t(-31, 32, (c, k, c // g), np.int8)
    kw = dict(padding=k // 2, bias=t(-3000, 3000, c, np.int32), relu=True, lens=full,
              m=t(2**29, 2**31 - 1, c, np.int32), e=spread_e(k * c // g, 18, 18), bits=6,
              groups=g, shuffle=True)
    label = f"dense_conv grouped g={g} B={batch} T={t_enc} K={k} {c}->{c} requant+relu+shuffle"
    chk.equal("dense_conv", label, dense_conv(x, w, **kw), dense_conv_plain(x, w, **kw))
    xf = x.to(torch.float64).transpose(1, 2).contiguous()
    wf = w.to(torch.float64).permute(0, 2, 1).contiguous()
    pk = statistics.median(cuda_ms(lambda: dense_conv_plain(x, w, **kw), reps=2, warmup=1))
    kk = statistics.median(cuda_ms(lambda: dense_conv(x, w, **kw), reps=10))
    kd, kd_by = device_ms(lambda: dense_conv(x, w, **kw), KERNEL_SYMBOLS["dense_conv"])
    lib = statistics.median(cuda_ms(lambda: F.conv1d(xf, wf, None, 1, k // 2, 1, g), reps=1,
                                    warmup=1))
    rows.append({"shape": label, "kernel": "dense_conv", "call_ms": kk, "device_ms": kd,
                 "device_ms_by": kd_by, "plain_ms": pk, "library_call_ms": lib,
                 "library_device_ms": lib, "library_device_ms_by": "events"})
    rows[-1]["bound"] = bound(x.numel() + w.numel() + 4 * 2 * c + 4 * batch + x.numel(),
                              2 * batch * t_enc * k * (c // g) * c)
    log(f"[11e] {label}: kernel {kd:.4f} ms device ({kd_by}; {kk:.4f} ms call), plain "
        f"{pk:.3f} ms, float64 conv1d(groups={g}) {lib:.3f} ms (events, one call), bound "
        f"{rows[-1]['bound'][0]:.4f} ms ({rows[-1]['bound'][1]}), equal [{card}]")
    return rows


def phase_grouped_steps(models, tables, qn6, dev, card, report):
    """11e: the frozen steps at B=64 x 15 s of the grouped and hardtanh
    paths beside plain QuartzNet15x5's (W6A6 static_e), in turns."""
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn

    audio, lens = noise_batch(W8A8_STEP_BATCH, 15.0, dev)
    fns = {"QuartzNet15x5 W6A6 static_e": make_frozen_fn(qn6[0], qn6[1], argmax=True)}
    for name, bits, mode in GROUPED_SERVED:
        fns[f"{name} W{bits}A{bits} {mode}"] = make_frozen_fn(
            models[name], tables[name, bits, mode], argmax=True)
    return step_times(fns, (audio, lens), card, "grouped", W8A8_STEP_BATCH, 15.0, report)


def write_vad_manifest(root):
    """Seeded wavs of VAD_SECONDS (a louder stretch in each) and their label
    manifest with dummy labels."""
    import numpy as np

    from qasr_tpu_torch.data.audio import write_wav

    rng = np.random.default_rng(21)
    rows = []
    for i, seconds in enumerate(VAD_SECONDS):
        n = int(16000 * seconds)
        x = rng.normal(size=n) * 0.05
        x[n // 4: n // 2] *= 6.0
        path = os.path.join(root, f"vad{i}.wav")
        write_wav(path, x.astype(np.float32))
        rows.append({"audio_filepath": path, "duration": seconds, "label": "infer"})
    manifest = os.path.join(root, "vad_manifest.json")
    with open(manifest, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return manifest


def phase_vad(dev, card, report):
    """11f: cli.vad_infer (MatchboxNet-3x1x64, random weights from seed 0,
    64 windows a batch) on the card and on the CPU over the same seeded
    wavs: frame files within 1e-4, and the card's windows per second
    (a second run, the first having built and warmed up)."""
    import tempfile

    import numpy as np
    import torch

    from qasr_tpu_torch.cli import vad_infer

    with tempfile.TemporaryDirectory() as tmp:
        manifest = write_vad_manifest(tmp)
        cpu = vad_infer.main(["--dataset", manifest, "--out_dir", os.path.join(tmp, "cpu"),
                              "--device", "cpu"])
        vad_infer.main(["--dataset", manifest, "--out_dir", os.path.join(tmp, "warm"),
                        "--device", str(dev)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu = vad_infer.main(["--dataset", manifest, "--out_dir", os.path.join(tmp, "gpu"),
                              "--device", str(dev)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        worst, windows = 0.0, 0
        for a, b in zip(gpu, cpu):
            fa, fb = np.loadtxt(a, ndmin=2), np.loadtxt(b, ndmin=2)
            if fa.shape != fb.shape or fa.shape[1] != 2:
                raise AssertionError(f"vad_infer frames {fa.shape} vs CPU {fb.shape}")
            worst = max(worst, float(np.abs(fa - fb).max()))
            windows += fa.shape[0]
        if worst > 1e-4 + 1e-9 or len(gpu) != len(VAD_SECONDS):
            raise AssertionError(f"vad_infer on the card: frames {worst} from the CPU's")
    out = {"windows": windows, "seconds": secs, "windows_per_s": windows / secs,
           "max_abs_diff_vs_cpu": worst}
    report["vad"] = out
    log(f"[11f] cli.vad_infer --device {dev}: {windows} windows of 0.63 s over "
        f"{len(VAD_SECONDS)} wavs ({sum(VAD_SECONDS):g} s) in {secs:.3f} s = "
        f"{out['windows_per_s']:.1f} windows/s (host clock, whole CLI: wav reads, windows, "
        f"frontend, MatchboxNet, files); frames within {worst:.1e} of the CPU run's [{card}]")
    return out


def selu_swish_model(act, bits):
    """QuartzNet15x5 with ``act`` (selu or swish) at W<bits>A<bits>,
    BN-folded, seed 0, no ranges."""
    import dataclasses

    from qasr_tpu_torch.models.config import quartznet15x5
    from qasr_tpu_torch.models.ctc_model import ASRModel

    cfg = quartznet15x5()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, activation=act))
    model = ASRModel.from_config(cfg, seed=0)
    model.set_quant_bit(bits, "all")
    model.bn_folding()
    return model


def serve_checked(model, tables, batch, lens, tag):
    """4 requests through the kernel path with the planned launches and no
    plain-version call, ids equal to the plain executor's; returns the
    launch counts."""
    import torch

    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    fn = make_frozen_fn(model, tables, argmax=True)
    fn(batch, lens)   # builds and warms
    reset_counts()
    with PlainCalls() as plain:
        ids_k, el_k = fn(batch, lens)
        counts = read_counts()
    expect = planned(kernel_launches(model.plan, tables))
    if counts != expect or plain.n:
        raise AssertionError(f"{tag}: launch counts {counts} (plan {expect}), {plain.n} "
                             f"plain-version calls")
    ids_p, el_p = make_frozen_fn(model, tables, argmax=True, fused=False)(batch, lens)
    if not (torch.equal(ids_k, ids_p) and torch.equal(el_k, el_p)) or \
            len(torch.unique(ids_k)) < 2:
        raise AssertionError(f"{tag}: kernel path ids differ from the plain executor's "
                             f"(or are degenerate)")
    return counts


def phase_selu_swish(dev):
    """11g: QuartzNet15x5 with selu and with swish at W6A6: calibrated on
    the card on 8 x 500 frames of seeded noise features, frozen
    (static_e), 4 seeded requests on the kernel path (selu / swish as float
    glue on each flushed accumulator) with the planned launches, no plain
    call and the plain executor's ids.  (Their W8A8 is phase 12e.)"""
    import numpy as np
    import torch

    utts, _ = seeded_requests(7)
    batch, lens = pad_batch(utts)
    feats = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 500, 64)).astype(
        np.float32)).to(dev)
    out = {}
    for act in ("selu", "swish"):
        model = selu_swish_model(act, 6)
        model.calibrate([feats], device=dev)
        counts = serve_checked(model, model.freeze("static_e", dev), batch, lens,
                               f"{act} W6A6")
        log(f"[11g] QuartzNet15x5 {act} W6A6 static_e calibrated and served on the card: "
            f"launches {counts} == plan, 0 plain-version calls, ids == plain executor")
        out[act] = counts
    return out


def phase_grouped(chk, dev, card, report, qn6):
    """Phase 11; returns (kernels line rows, {path: launch counts})."""
    t_phase = time.perf_counter()
    report["grouped_kernel_checks"] = phase_grouped_kernels(chk, dev)
    models, tables = phase_grouped_golden(dev)
    counts = phase_grouped_serve(models, tables, dev)
    phase_grouped_calibrate(models, dev)
    phase_grouped_steps(models, tables, qn6, dev, card, report)
    rows = time_grouped_sites(chk, dev, card)
    report["grouped_per_kernel"] = rows
    phase_vad(dev, card, report)
    counts.update(phase_selu_swish(dev))
    report["grouped_launches"] = counts
    report["grouped_seconds"] = time.perf_counter() - t_phase
    log(f"[11] phase 11 took {report['grouped_seconds']:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 12: streaming (the cache-aware Conformer stream, the windowed
# streamer) and W8A8 selu / swish on the card
# ---------------------------------------------------------------------------


def causal_flagship(dev):
    """The flagship Conformer-CTC 16 x 256 W8A8 as a cache-aware streaming
    configuration: att_context_size (STREAM_L, 0), causal_conv, the
    frontend's normalization off, the committed seed-0 noise ranges (their
    sites do not depend on the attention context or the conv's padding),
    frozen on the card; (model, tables)."""
    import dataclasses

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.conformer_ctc import ConformerCTC

    cfg, ccfg = golden.conformer_flagship_configs()
    cfg = dataclasses.replace(cfg, preprocessor={**cfg.preprocessor, "normalize": False})
    ccfg = dataclasses.replace(ccfg, att_context_size=(STREAM_L, 0), causal_conv=True)
    model = ConformerCTC.from_config(cfg, ccfg, seed=0)
    with open(golden.CONF_QSTATE_PATH) as f:
        model.qstate_from_json(f.read())
    return model, model.freeze(dev)


def stream_inputs(rng, dev, b, n, h, d_k, d, k_size):
    import numpy as np
    import torch

    def t8(*shape):
        return torch.from_numpy(rng.integers(-127, 127, shape).astype(np.int8)).to(dev)
    return ([t8(b, n, h, d_k) for _ in range(4)], t8(b, STREAM_L, h, d_k),
            t8(b, STREAM_L, h, d_k), t8(b, n, d), t8(b, n, d), t8(b, k_size - 1, d))


def stream_cases():
    """12a's (B, n): STREAM_B x STREAM_N, then STREAM_MORE."""
    return [(b, n) for b in STREAM_B for n in STREAM_N] + list(STREAM_MORE)


def conv_form(n):
    """The form Kernel 4's cache form is expected to run at n new frames:
    one cluster launch while an utterance's rows fit its 32-row tile."""
    return "cluster" if n <= 32 else "staged"


def phase_stream_kernels(chk, model, tables, dev):
    """12a: Kernels 3 and 4 in their cache forms against their plain
    versions at L = 70, the (B, n) of ``stream_cases``, every layer's
    tables in turn, and seen in STREAM_SEEN (a stream's first steps, seen
    < L, and a full cache): the context and the new caches, each Kernel 4
    call in the form ``conv_form`` expects."""
    import numpy as np

    from qasr_tpu_torch.kernels.conv_block import conv_block_cached, conv_block_cached_plain
    from qasr_tpu_torch.kernels.int_attention import (
        int_attention_cached, int_attention_cached_plain,
    )
    from qasr_tpu_torch.quantize.conformer_freeze import _stream_p8

    enc = tables["encoder"]
    ccfg = model.ccfg
    h, d = ccfg.n_heads, ccfg.d_model
    k_size = ccfg.conv_kernel_size
    p8s = _stream_p8(enc, ccfg)
    rng = np.random.default_rng(12)
    n0 = chk.n
    forms = {}
    for b, n in stream_cases():
        for li, seen in enumerate(STREAM_SEEN):
            li = (li + 3 * n + b) % len(enc["layers"])
            tbl = enc["layers"][li]
            (qu, qv, k, v), kc, vc, c8, x8, gc = stream_inputs(rng, dev, b, n, h, d // h,
                                                               d, k_size)
            kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], nbits=8)
            tag = f"B={b} n={n} L={STREAM_L} seen={seen} layer {li}"
            got = int_attention_cached(qu, qv, k, v, kc, vc, p8s[li], seen, **kw)
            want = int_attention_cached_plain(qu, qv, k, v, kc, vc, p8s[li], seen, **kw)
            for what, g, w in zip(("context", "k cache", "v cache"), got, want):
                chk.equal("int_attention_cached", f"int_attention_cached {tag} {what}", g, w)
            got = conv_block_cached(c8, x8, gc, tbl, nbits=8)
            cfg = conv_block_cached.last_config
            if cfg["form"] != conv_form(n):
                raise AssertionError(f"conv_block_cached {tag}: ran the {cfg['form']} form, "
                                     f"expected {conv_form(n)} ({cfg})")
            forms[(b, n)] = cfg
            want = conv_block_cached_plain(c8, x8, gc, tbl, nbits=8)
            for what, g, w in zip(("stream", "GLU cache"), got, want):
                chk.equal("conv_block_cached", f"conv_block_cached {tag} {what}", g, w)
    log(f"[12a] int_attention_cached and conv_block_cached == their plain versions in "
        f"{chk.n - n0} exact comparisons: (B, n) in {stream_cases()}, L {STREAM_L}, "
        f"seen in {STREAM_SEEN}, the new caches included")
    log("[12a] conv_block_cached's plans (form, utterances a tile, clusters, shared memory "
        "a CTA): " + "; ".join(f"B={b} n={n}: {c['form']} {c['utterances']} {c['clusters']} "
                               f"{c['smem']}" for (b, n), c in forms.items()))
    return forms


def phase_stream(model, tables, dev, card, report):
    """12b: the cache-aware stream at full width over 15 s of seeded noise.
    (i) frozen_stream_step over the offline forward's subsampled frames, 4
    a step (a 160 ms slice): every step's launches equal to
    ``stream_kernel_launches``, no plain-version call, the encodings of
    every valid row and the greedy ids bit-equal to the offline causal
    frozen forward's.  (ii) CacheAwareConformerStream fed the audio in 40
    ms, 160 ms and 1 s slices (the frontend and subsampler re-run on each
    slice's window): the same per-step launches and no plain call, its
    first-site codes, every row's encodings and the ids bit-equal to the
    offline forward's at each slice size.  Then its latency_report (160 ms
    slices) and frozen_stream_step's device and host ms at (B, n) (1, 4),
    (32, 4) and (32, 16).  Returns (ii)'s launch counts at 160 ms."""
    import numpy as np
    import torch

    from qasr_tpu_torch.decode.streaming import CacheAwareConformerStream
    from qasr_tpu_torch.models import conformer as mc
    from qasr_tpu_torch.quantize import conformer_freeze as cf

    enc_t, ccfg = tables["encoder"], model.ccfg
    n_samp = int(16000 * STREAM_SECONDS)
    audio = (np.random.default_rng(15).normal(size=n_samp) * 0.1).astype(np.float32)
    with torch.no_grad():
        a = torch.from_numpy(audio)[None].to(dev)
        feats, fl = model.frontend(a, torch.tensor([n_samp], dtype=torch.int32, device=dev),
                                   dither=0.0)
        x_sub, sl = mc.subsample_convs(enc_t["subsampler"], ccfg, feats, fl)
        x8 = cf.clip8(torch.round(cf.f32_div(x_sub, enc_t["S_pre"])), enc_t["act_bit"])
        enc_off, el = cf.conformer_encode(enc_t, ccfg, x8, sl)
        el = int(el[0])
        enc_off = enc_off[0, :el]
        ids_off = model.head(tables, enc_off[None]).argmax(-1)[0]
    per_step = planned({**cf.stream_kernel_launches(ccfg),
                        "conv_block_cached_cluster": ccfg.n_layers})
    step_fn = cf.frozen_stream_step
    steps, xs, bad_steps = [], [], []

    def recording(*a, **kw):
        before = read_counts()
        out, state = step_fn(*a, **kw)
        after = read_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != per_step:
            bad_steps.append(delta)
        xs.append(a[2])
        steps.append(out)
        return out, state

    def checked(tag, plain, n_steps, counts):
        if bad_steps or plain.n:
            raise AssertionError(f"{tag}: {len(bad_steps)} steps launched other than "
                                 f"{per_step} (first {bad_steps[:1]}), {plain.n} plain calls")
        if counts != planned({k: v * n_steps for k, v in per_step.items() if v}):
            raise AssertionError(f"{tag}: launches {counts} != {n_steps} x {per_step}")

    # (i) the offline frames, 4 a step
    state = cf.frozen_stream_init(enc_t, ccfg, 1, dev)
    cf.frozen_stream_step = recording
    try:
        reset_counts()
        with PlainCalls() as plain:
            for i in range(0, el, 4):
                _, state = cf.frozen_stream_step(enc_t, ccfg, x_sub[:, i:min(i + 4, el)], state)
            counts = read_counts()
        checked("stream (offline frames)", plain, len(steps), counts)
        enc_i = torch.cat(steps, dim=1)[0]
        ids_i = model.head(tables, enc_i[None]).argmax(-1)[0]
        if not torch.equal(enc_i, enc_off) or not torch.equal(ids_i, ids_off) or \
                len(torch.unique(ids_off)) < 2:
            raise AssertionError("stream (offline frames): rows or ids differ from the offline "
                                 "causal frozen forward's (or the ids are degenerate)")
        log(f"[12b] frozen_stream_step, Conformer 16x256 W8A8 causal (L {STREAM_L}, K "
            f"{ccfg.conv_kernel_size}), the offline forward's {el} subsampled frames of "
            f"{STREAM_SECONDS:g} s, 4 a step: {len(steps)} steps, every row's encodings and "
            f"the ids ({len(torch.unique(ids_off))} distinct) bit-equal to the offline causal "
            f"frozen forward's; launches {counts} = {len(steps)} x stream_kernel_launches, 0 "
            f"plain-version calls")
        # (ii) the audio, in slices of each size
        for size in STREAM_SLICES:
            tag = f"stream (audio, {size / 16:g} ms slices)"
            st = CacheAwareConformerStream(model, device=dev)
            steps.clear()
            xs.clear()
            ids = []
            reset_counts()
            with PlainCalls() as plain:
                for s0 in range(0, n_samp, size):
                    ids.extend(st.feed(audio[s0:s0 + size]).tolist())
                ids.extend(st.flush().tolist())
                n_counts = read_counts()
            checked(tag, plain, len(steps), n_counts)
            enc_s = torch.cat(steps, dim=1)[0]
            x8_s = cf.clip8(torch.round(cf.f32_div(torch.cat(xs, dim=1), enc_t["S_pre"])), 8)[0]
            if enc_s.shape[0] != el or len(ids) != el:
                raise AssertionError(f"{tag}: {enc_s.shape[0]} rows, {len(ids)} ids, offline "
                                     f"{el}")
            flips = int((x8_s != x8[0, :el]).sum())
            if flips or not torch.equal(enc_s, enc_off) or ids != ids_off.tolist():
                raise AssertionError(f"{tag}: {flips} first-site codes, the rows or the ids "
                                     f"differ from the offline causal frozen forward's")
            log(f"[12b] CacheAwareConformerStream, the same audio in {size / 16:g} ms slices: "
                f"{len(steps)} steps, first-site codes, every row's encodings and the ids "
                f"bit-equal to the offline causal frozen forward's; launches {n_counts} = "
                f"{len(steps)} x stream_kernel_launches, 0 plain-version calls")
            if size == STREAM_SLICE:
                counts, n_steps = n_counts, len(steps)
    finally:
        cf.frozen_stream_step = step_fn
    rep = CacheAwareConformerStream(model, device=dev).latency_report(audio, STREAM_SLICE)
    log(f"[12b] cache-aware latency_report ({STREAM_SLICE / 16:g} ms slices, B=1): first "
        f"{rep['first_chunk_latency_ms']:.3f} ms, mean {rep['mean_chunk_latency_ms']:.3f}, p95 "
        f"{rep['p95_chunk_latency_ms']:.3f}, steady {rep['steady_chunk_latency_ms']:.3f} ms; "
        f"streaming RTFx {rep['streaming_rtfx']:.1f} [{card}]")
    out = {"latency_report": rep, "steps": n_steps, "step": stream_step_times(model, tables,
                                                                             dev, card)}
    report["stream"] = out
    return counts


def stream_step_times(model, tables, dev, card):
    """frozen_stream_step alone at each (B, n) of STREAM_TIMED, a stream
    past L frames (every cache slot valid): device ms (torch.profiler,
    every kernel of the step), per-step event ms, and host ms to enqueue a
    step; logged beside PR 15's readings."""
    import numpy as np
    import torch

    from qasr_tpu_torch.quantize import conformer_freeze as cf

    enc_t, ccfg = tables["encoder"], model.ccfg
    f_sub = enc_t["pre"]["wt"].shape[1]   # the subsampled frame's features (K of pre)
    out = {}
    rng = np.random.default_rng(16)
    for b, n in STREAM_TIMED:
        state = cf.frozen_stream_init(enc_t, ccfg, b, dev)
        x = torch.from_numpy(rng.normal(size=(b, n, f_sub)).astype(np.float32)).to(dev)
        for _ in range(20):   # a stream past L frames: every cache slot valid
            _, state = cf.frozen_stream_step(enc_t, ccfg, x, state)
        fn = lambda s=state: cf.frozen_stream_step(enc_t, ccfg, x, s)   # noqa: E731
        dev_ms, by = device_ms(fn)
        ev_ms = statistics.median(cuda_ms(fn, reps=20))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        calls = sum(cf.stream_kernel_launches(ccfg).values())
        out[f"B={b} n={n}"] = {"device_ms": dev_ms, "device_ms_by": by, "event_ms": ev_ms,
                               "host_enqueue_ms": host_ms, "kernel_calls": calls}
        was = STREAM_STEP_PR15[(b, n)]
        log(f"[12b] frozen_stream_step B={b} n={n} ({calls} kernel calls): device {dev_ms:.4f} "
            f"ms ({by}), {ev_ms:.4f} ms a step by events, host enqueue {host_ms:.4f} ms "
            + (f"(PR 15: device {was[0]} ms, host {was[1]} ms) " if was else
               "(PR 15: not recorded) ") + f"[{card}]")
    return out


def unnormalized(model):
    """``model`` with its frontend's normalization off (a window's features
    must not depend on the window)."""
    import dataclasses

    from qasr_tpu_torch.ops.features import MelFrontend

    model.frontend = MelFrontend(dataclasses.replace(model.frontend.cfg, normalize=None))
    return model


def phase_windowed(dev, card, report):
    """12c: the windowed streamer over 60 s of seeded noise on QuartzNet15x5
    W6A6 and W8A8 (static_e, frontend normalization off): stitched greedy
    ids equal to the offline forward's, transcribe_beam equal to offline
    beam decoding, one kernel forward a window; its latency_report.
    Returns W6A6's launch counts."""
    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.decode.beam_search import BeamSearchDecoderWithLM
    from qasr_tpu_torch.decode.streaming import StreamingTranscriber
    from qasr_tpu_torch.quantize.freeze import kernel_launches

    n_samp = int(16000 * WINDOWED_SECONDS)
    audio = (np.random.default_rng(60).normal(size=n_samp) * 0.1).astype(np.float32)
    first = None
    for bits in (6, 8):
        model = unnormalized(golden.flagship("quartznet15x5", bits))
        tab = model.freeze("static_e", dev)
        lp, el, ids = model.forward(audio[None], np.asarray([n_samp], np.int32), device=dev)
        el = int(el[0])
        st = StreamingTranscriber(model, device=dev)
        windows = sum(1 for _ in st._windows(n_samp))
        reset_counts()
        with PlainCalls() as plain:
            got = st.predictions(audio)
            counts = read_counts()
        expect = planned({k: v * windows for k, v in kernel_launches(model.plan, tab).items()})
        if counts != expect or plain.n:
            raise AssertionError(f"windowed W{bits}A{bits}: launches {counts} != {windows} "
                                 f"windows x plan, {plain.n} plain calls")
        want = ids[0, :el].cpu().numpy()
        if len(got) < el or not np.array_equal(got[:el], want) or len(np.unique(want)) < 2:
            raise AssertionError(f"windowed W{bits}A{bits}: stitched ids differ from offline "
                                 f"(or are degenerate)")
        beam = st.transcribe_beam(audio, beam_width=16)
        off = BeamSearchDecoderWithLM(model.vocabulary, beam_width=16)(lp, torch.tensor([el]))
        if beam != off[0][0][1]:
            raise AssertionError(f"windowed W{bits}A{bits}: transcribe_beam differs from "
                                 f"offline beam decoding")
        rep = st.latency_report(audio)
        log(f"[12c] windowed QuartzNet15x5 W{bits}A{bits} static_e over {WINDOWED_SECONDS:g} s "
            f"(chunk {st.chunk_frames}, context {st.context_left}/{st.context_right} frames, "
            f"{windows} windows): {el} stitched ids == offline, transcribe_beam == offline "
            f"beam ({len(beam)} chars); launches {counts} = {windows} x plan, 0 plain calls; "
            f"latency_report first {rep['first_chunk_latency_ms']:.2f} ms, mean "
            f"{rep['mean_chunk_latency_ms']:.2f}, p95 {rep['p95_chunk_latency_ms']:.2f}, steady "
            f"{rep['steady_chunk_latency_ms']:.2f} ms, RTFx {rep['streaming_rtfx']:.1f} [{card}]")
        report.setdefault("windowed", {})[f"W{bits}A{bits}"] = rep
        first = first or counts
    return first


def check_plane_sites(chk, model, tables, batch, lens, tag):
    """One forward of the kernel path (``make_frozen_fn``) with every
    byte-plane site held against its plain versions at the main path's
    shapes, exact: Kernel 7's two planes of the site's input against
    split_planes of requant_plain, and the site's joined int32 conv (acc_u
    - 256 acc_s, two launches of Kernel 1, 2 or 8) against the plain
    FrozenExec's int32 conv at that site.  Returns the sites checked."""
    from qasr_tpu_torch.kernels.checks import split_planes
    from qasr_tpu_torch.kernels.requant import requant, requant_plain
    from qasr_tpu_torch.models.ctc_model import make_frozen_fn
    from qasr_tpu_torch.ops.quant_prims import QTensor
    from qasr_tpu_torch.quantize import freeze as fz

    orig = fz._StagedExec._planes_conv
    sites = []

    def checked(self, entry, spec, x, lens_):
        if isinstance(x, fz._PendingConv):   # flushed as _planes_conv does
            x = fz._Held(self._flush_act(x), x.out_scale())
        out = orig(self, entry, spec, x, lens_)
        site = next((bi, kind, i) for bi, tb in enumerate(self.t["blocks"])
                    for kind in ("convs", "res") for i, e in enumerate(tb[kind]) if e is entry)
        c = spec.in_ch
        m, e = fz._per_channel(entry, "act_m", c), fz._per_channel(entry, "act_e", c)
        got = requant(x.values, m, e, 9, lens=lens_, planes=True)
        want = split_planes(requant_plain(x.values, m, e, 9, lens=lens_))
        for plane, g, w in zip("us", got, want):
            chk.equal("requant", f"{tag} site {site} {tuple(g.shape)} plane {plane}", g, w)
        y, _ = fz.FrozenExec(self.t, self.qcfg, activation=self.activation_kind).masked_conv(
            site, spec, QTensor(x.values, x.scale), lens_)
        if out.shuffled:   # GroupShuffle in the planes' stores, after the plain conv
            y = fz.group_shuffle_q(y, out.shuffled)
        chk.equal(fz._conv_kernel(spec), f"{tag} site {site} joined int32 conv", out.values,
                  y.values)
        sites.append(site)
        return out

    fz._StagedExec._planes_conv = checked
    try:
        make_frozen_fn(model, tables, argmax=True)(batch, lens)
    finally:
        fz._StagedExec._planes_conv = orig
    return len(sites)


def phase_requant_planes(chk, dev):
    """12f: Kernel 7's byte planes (``requant(planes=True)``, the storage
    of a signed 9-bit code) against split_planes of its plain version,
    exact, at B=64 x T=768 with partial lengths: C 256 and 512 on the
    4-channel path and on the element path (an int32 input that starts 4
    bytes off a 16-byte boundary), C 250 (the element path), each with
    per-channel and with static exponents, codes clamped on both sides."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.checks import join_planes, split_planes
    from qasr_tpu_torch.kernels.requant import plan, requant, requant_plain

    rng = np.random.default_rng(18)
    b, t = 64, 768
    lens = torch.from_numpy(rng.integers(t // 4, t + 1, b).astype(np.int32)).to(dev)
    lens[0] = t
    n0, paths = chk.n, set()
    for c in (256, 512, 250):
        z = torch.from_numpy(rng.integers(-2 ** 20, 2 ** 20, (b, t, c)).astype(np.int32)).to(dev)
        views = [("aligned", z)]
        if c % 4 == 0:
            buf = torch.empty(z.numel() + 1, dtype=torch.int32, device=dev)
            off = buf[1:].view(b, t, c)
            off.copy_(z)
            views.append(("offset", off))
        m = torch.from_numpy(rng.integers(1 << 29, 1 << 30, c).astype(np.int32)).to(dev)
        e_c = torch.from_numpy(rng.integers(39, 44, c).astype(np.int32)).to(dev)
        for exps, e in (("per-channel", e_c), ("static", 41)):
            for how, zz in views:
                v = plan(b, t, c, aligned=zz.data_ptr() % 16 == 0)["v"]
                paths.add(v)
                q = requant_plain(zz, m, e, 9, lens=lens)
                got = requant(zz, m, e, 9, lens=lens, planes=True)
                label = f"requant planes B={b} T={t} C={c} {exps} e, {how} (V={v})"
                for plane, g, w in zip("us", got, split_planes(q)):
                    chk.equal("requant", f"{label} plane {plane}", g, w)
                if not torch.equal(join_planes(got[0].to(torch.int32), got[1].to(torch.int32)),
                                   q) or int(q.min()) != -256 or int(q.max()) != 255:
                    raise AssertionError(f"{label}: u - 256 s != the int32 requant, or the "
                                         f"codes miss a clamp")
    if paths != {1, 4}:
        raise AssertionError(f"requant planes: paths {paths}, not both V=1 and V=4")
    log(f"[12f] Kernel 7's byte planes == split_planes(requant_plain) in {chk.n - n0} exact "
        f"comparisons: B={b} x T={t}, partial lengths, C 256 / 512 / 250, per-channel and "
        f"static exponents, the 4-channel (V=4) and element (V=1) paths; u - 256 s == the "
        f"int32 requant, clamped at -256 and 255")


def phase_w8a8_selu_swish(chk, dev):
    """12e: QuartzNet15x5 with selu and with swish at W8A8 on the card, its
    asymmetric sites' signed 9-bit codes as two byte planes: calibration
    (kernels, two launches a plane site) equal to the plain QuantExec's,
    then 4 requests on each kernel executor (static_e: FrozenExecFused;
    per_channel: FrozenExecKernels) with the planned launches, no plain
    call and the plain executor's ids, and one more forward with every
    plane site held against its plain versions (``check_plane_sites``).
    Returns static_e's counts."""
    import numpy as np
    import torch

    from qasr_tpu_torch.models.jasper import init_qstate
    from qasr_tpu_torch.quantize.freeze import quant_kernel_launches

    utts, _ = seeded_requests(7)
    batch, lens = pad_batch(utts)
    feats = torch.from_numpy(np.random.default_rng(3).normal(size=(8, 500, 64)).astype(
        np.float32)).to(dev)
    out = {}
    for act in ("selu", "swish"):
        model = selu_swish_model(act, 8)
        reset_counts()
        model.calibrate([feats], device=dev)
        counts = read_counts()
        expect = planned(quant_kernel_launches(model.plan, 8))
        if counts != expect:
            raise AssertionError(f"{act} W8A8 calibration launches {counts} != {expect}")
        q_kernel = model.qstate
        model.qstate = init_qstate(model.plan)
        model.calibrate([feats], device=dev, kernels=False)
        a, b = qstate_sites(q_kernel), qstate_sites(model.qstate)
        if a != b:
            raise AssertionError(f"{act} W8A8 calibration: ranges differ from the plain "
                                 f"QuantExec's")
        served, n_sites, n0 = {}, {}, chk.n
        for mode in ("static_e", "per_channel"):
            tab = model.freeze(mode, dev)
            served[mode] = serve_checked(model, tab, batch, lens, f"{act} W8A8 {mode}")
            n_sites[mode] = check_plane_sites(chk, model, tab, batch, lens,
                                              f"{act} W8A8 {mode}")
        log(f"[12e] QuartzNet15x5 {act} W8A8 on the card: calibration launches {counts} "
            f"(byte planes: two a signed 9-bit site), ranges == plain QuantExec; served "
            f"static_e {served['static_e']} and per_channel {served['per_channel']} == plan, "
            f"0 plain calls, ids == plain executor; plane sites {n_sites} each held against "
            f"its plain versions (Kernel 7's planes, the joined int32 conv) in {chk.n - n0} "
            f"exact comparisons")
        out[f"{act} W8A8"] = served["static_e"]
    return out


def stream_floor_ms(grid, threads, cluster, smem, dev):
    """The device ms of an empty kernel on this launch shape (10 calls,
    torch.profiler; ``device_ms``)."""
    from qasr_tpu_torch.kernels.floor import empty_launch

    ms, _ = device_ms(lambda: empty_launch(grid, threads, cluster, smem, device=dev),
                      "empty_kernel")
    return ms


def time_stream_kernels(chk, model, tables, dev, card, report, floors=True):
    """Each cache form at the (B, n) of STREAM_TIMED, a full cache (seen
    500), layer 0's tables: held against its plain version, then timed
    (``timed_pair``) beside its bound and, with ``floors``, its latency
    floor: an empty kernel on the kernel's own grid, block, cluster and
    shared memory (``stream_floor_ms``), plus for Kernel 4's cluster form
    its three dependent exchanges (x1, the i-LN's rows, mid8) each at the
    round ``exchange_floor`` measures in this run (one push into every CTA
    and barrier.cluster, clusters of 8; the kernel's st.async exchanges
    need no barrier, so this part may sit above their true cost).
    ``floors`` off times a tree whose wrappers lack the plan's report (a
    parent checkout).  Returns the rows."""
    import numpy as np

    from qasr_tpu_torch.kernels.conv_block import conv_block_cached, conv_block_cached_plain
    from qasr_tpu_torch.kernels.int_attention import (
        int_attention_cached, int_attention_cached_plain,
    )
    from qasr_tpu_torch.quantize.conformer_freeze import _stream_p8

    enc, ccfg = tables["encoder"], model.ccfg
    h, d, k_size = ccfg.n_heads, ccfg.d_model, ccfg.conv_kernel_size
    d_k = d // h
    tbl, p8 = enc["layers"][0], _stream_p8(enc, ccfg)[0]
    kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], nbits=8)
    round_us = exchange_floor(dev, card, 1, "12")["exchange_us"] if floors else None
    rows = []
    for b, n in STREAM_TIMED:
        (qu, qv, k, v), kc, vc, c8, x8, gc = stream_inputs(np.random.default_rng(17), dev, b, n,
                                                           h, d_k, d, k_size)
        r = timed_pair(chk, "int_attention_cached",
                       f"int_attention_cached B={b} n={n} L={STREAM_L} h={h} d_k={d_k}",
                       lambda: int_attention_cached(qu, qv, k, v, kc, vc, p8, 500, **kw)[0],
                       lambda: int_attention_cached_plain(qu, qv, k, v, kc, vc, p8, 500,
                                                          **kw)[0], card, rows)
        # q/k/v and both caches and p8 in, the context and both caches out; each
        # query's L + 1 scores (ac, bd) and its context as int8 products
        qkv = b * n * d
        r["bound"] = bound(4 * qkv + 2 * 2 * b * STREAM_L * d + p8.numel() + qkv,
                           3 * 2 * b * h * n * (STREAM_L + 1) * d_k)
        if floors:
            from qasr_tpu_torch.kernels.int_attention import TQ_CACHE, cached_smem_bytes

            warps = min(n, TQ_CACHE)
            r["floor_ms"] = stream_floor_ms((-(-n // TQ_CACHE), h, b), 32 * warps, 1,
                                            cached_smem_bytes(STREAM_L, d_k, warps), dev)
        r = timed_pair(chk, "conv_block_cached", f"conv_block_cached B={b} n={n} d={d} "
                       f"K={k_size}", lambda: conv_block_cached(c8, x8, gc, tbl, nbits=8)[0],
                       lambda: conv_block_cached_plain(c8, x8, gc, tbl, nbits=8)[0], card, rows)
        weights = 4 * d * d + k_size * d + 14 * 4 * d + 16 * 4
        r["bound"] = bound(3 * b * n * d + 2 * b * (k_size - 1) * d + weights,
                           2 * b * n * d * (4 * d + k_size))
        if floors:
            from qasr_tpu_torch.kernels.conv_block import CTA_COLS

            cfg = conv_block_cached.last_config
            r["plan"] = cfg
            c = d // CTA_COLS
            r["floor_ms"] = stream_floor_ms((cfg["clusters"] * c, 1, 1), 128, c, cfg["smem"], dev)
            r["floor_ms"] += 3 * round_us / 1e3 if cfg["form"] == "cluster" else 0.0
        for row in rows[-2:]:
            if "floor_ms" in row:
                log(f"[12] {row['shape']}: bound {row['bound'][0]:.5f} ms ({row['bound'][1]}, "
                    f"{row['bound'][0] / row['device_ms']:.1%}), latency floor "
                    f"{row['floor_ms']:.5f} ms ({row['floor_ms'] / row['device_ms']:.1%}) "
                    f"[{card}]")
    report["stream_round_us"] = round_us
    return rows


def phase_streaming(chk, dev, card, report):
    """Phase 12; returns (kernels line rows, {path: launch counts})."""
    t_phase = time.perf_counter()
    model, tables = causal_flagship(dev)
    phase_stream_kernels(chk, model, tables, dev)
    counts = {"stream": phase_stream(model, tables, dev, card, report)}
    counts["windowed W6A6"] = phase_windowed(dev, card, report)
    counts.update(phase_w8a8_selu_swish(chk, dev))
    phase_requant_planes(chk, dev)
    rows = time_stream_kernels(chk, model, tables, dev, card, report)
    report["stream_per_kernel"] = rows
    report["stream_launches"] = counts
    report["stream_seconds"] = time.perf_counter() - t_phase
    log(f"[12] phase 12 took {report['stream_seconds']:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 13: the transducer (the frozen Conformer-Transducer: Kernels 3-6 in
# the encoder, Kernel 9 in the decoder)
# ---------------------------------------------------------------------------

# Kernel 9's check grid: the pred step at (H, L, B), the joint at (J, V+1,
# B) with De 256; NeMo's Conformer-Transducer small (320) and medium (640)
# head widths, 29 characters and a 1,024-piece BPE vocabulary plus blank
RNNT_H, RNNT_L, RNNT_B = (64, 320, 640), (1, 2), (1, 7, 32)
RNNT_J, RNNT_V, RNNT_JB = (320, 640), (29, 1025), (1, 32)
# the timed batch (B x 15 s), the streamed utterance and its chunk (mel
# frames), the beam searches' per-frame expansion cap and their float
# near-tie margin
RNNT_BATCH, RNNT_SECONDS = 32, 15.0
RNNT_STREAM_SECONDS, RNNT_STREAM_CHUNK, RNNT_STREAM_LENS = 6.0, 256, (96000, 70000, 81000)
RNNT_BEAM, RNNT_TSD_EXP, BEAM_MARGIN = 3, 4, 1e-4
# the blank logit's bias raise of the second head on the main path: the
# golden head emits the cap of 10 symbols at every frame, this one ends
# most frames with a blank (golden.nudged_out_bias)
RNNT_BLANK_BIAS = 2.0
# rnnt_greedy's checks: the frames a check decodes at each batch, the
# second chunk's first frame, the two heads of the random decoders (blank
# bias 0 and +2), and its timed shape (B=1 x 64 frames: a chunk of 13d's
# stream, 256 mel frames)
RNNT_GREEDY_T = {1: 6, 7: 5, 32: 2}
RNNT_GREEDY_SPLIT = 3
RNNT_GREEDY_BIAS = (0.0, RNNT_BLANK_BIAS)
# the check grid's shapes whose weights the plan keeps in shared memory
RNNT_GREEDY_RESIDENT = ((64, 1), (64, 2), (320, 1))
# a batch that no wave of clusters covers (at most 8 rows x 33 clusters),
# so that clusters take a second group of rows, and its cap
RNNT_GREEDY_MANY, RNNT_GREEDY_MANY_CAP = 300, 3
RNNT_CHUNK_FRAMES = 64
# the exchange micro-benchmark: dependent rounds a launch (n and 2n timed)
EXCHANGE_ROUNDS = 20000


def rnnt_decoder_tables(dev, hidden, layers, joint, vocab, seed, blank_bias=0.0):
    """(RNNTConfig, device tables) of a random-weight decoder frozen at
    ranges 4.0 (encoder) and 6.0 (joint), the blank's out bias raised by
    ``blank_bias``."""
    from qasr_tpu_torch.models.rnnt import RNNTConfig, init_rnnt_params
    from qasr_tpu_torch.quantize.rnnt_freeze import freeze_rnnt_decoder, rnnt_tables_to_device

    cfg = RNNTConfig(num_classes=vocab - 1, enc_hidden=256, pred_hidden=hidden,
                     pred_rnn_layers=layers, joint_hidden=joint)
    params = init_rnnt_params(seed, cfg)
    params["joint"]["out"]["b"][cfg.blank_id] += blank_bias
    host = freeze_rnnt_decoder(params, cfg, enc_range=4.0, joint_range=6.0)
    return cfg, rnnt_tables_to_device(host, dev)


def rnnt_pred_inputs(rng, dev, cfg, b):
    """token (a blank first), h8, and c_q with entries at and next to the
    cell state's +-2^23 clip."""
    import numpy as np
    import torch

    n_l, h = cfg.pred_rnn_layers, cfg.pred_hidden
    tok = rng.integers(0, cfg.num_classes + 1, b).astype(np.int32)
    tok[0] = cfg.blank_id
    h8 = rng.integers(-127, 128, (n_l, b, h)).astype(np.int8)
    c = rng.integers(-(1 << 23), (1 << 23) + 1, (n_l, b, h)).astype(np.int32)
    c[..., 0], c[..., 1], c[..., 2] = 1 << 23, -(1 << 23), (1 << 23) - 1
    return tuple(torch.from_numpy(a).to(dev) for a in (tok, h8, c))


def emit_masks(rng, dev, b):
    import numpy as np
    import torch

    mixed = rng.random(b) < 0.5
    if b > 1:
        mixed[0], mixed[1] = True, False
    return [None] + [torch.from_numpy(m).to(dev) for m in
                     (np.ones(b, bool), mixed, np.zeros(b, bool))]


def tied_joint(tables, lo, hi):
    """``tables`` with out columns lo < hi made identical and far above the
    rest: every row's logits tie at lo and hi, and its id must be lo."""
    jt = dict(tables["joint"])
    for k in ("wt_out", "m_o", "b_out_logit"):
        jt[k] = jt[k].clone()
        jt[k][hi] = jt[k][lo]
    jt["b_out_logit"][lo] = jt["b_out_logit"][hi] = 1 << 24
    return {**tables, "joint": jt}


def phase_rnnt_kernels(chk, dev):
    """13a: Kernel 9 against its plain versions on the card, exactly: the
    pred step (the new h8 and c_q stacks and the top h8) at every (H, L, B)
    of the grid with tokens including blank, c_q at and next to the clip,
    and the emit masks none / all / mixed / no row; the joint (logits and
    ids) at every (J, V+1, B) from strided encoder frames, and with two
    columns forced to tie (in one warp and across warps): the lower index
    wins."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.rnnt_decoder import (
        rnnt_joint, rnnt_joint_plain, rnnt_pred_step, rnnt_pred_step_plain,
    )

    rng = np.random.default_rng(13)
    n0 = chk.n
    for h in RNNT_H:
        for n_l in RNNT_L:
            cfg, tables = rnnt_decoder_tables(dev, h, n_l, 320, 29, seed=h + n_l)
            for b in RNNT_B:
                tok, h8, c = rnnt_pred_inputs(rng, dev, cfg, b)
                for emit in emit_masks(rng, dev, b):
                    tag = (f"rnnt_pred H={h} L={n_l} B={b} emit "
                           f"{'none' if emit is None else emit.int().tolist()[:8]}")
                    got = rnnt_pred_step(tables, tok, h8, c, emit)
                    want = rnnt_pred_step_plain(tables, tok, h8, c, emit)
                    for what, g, w in zip(("top h8", "h8", "c_q"), got, want):
                        chk.equal("rnnt_pred", f"{tag} {what}", g, w)
    for j in RNNT_J:
        for v in RNNT_V:
            cfg, tables = rnnt_decoder_tables(dev, 320, 1, j, v, seed=j + v)
            ties = (((3, 19), (7, 20)) if v == 29 else ((700, 1000), (37, 53)))
            for b in RNNT_JB:
                frames = torch.from_numpy(rng.normal(size=(b, 3, 256)).astype(np.float32)
                                          * 2).to(dev)
                e = frames[:, 1]   # a strided view, as the greedy loop's enc[:, t]
                h8 = torch.from_numpy(rng.integers(-127, 128, (b, 320)).astype(np.int8)).to(dev)
                for tab, lo in [(tables, None)] + [(tied_joint(tables, lo, hi), lo)
                                                   for lo, hi in ties]:
                    tag = f"rnnt_joint De=256 J={j} V+1={v} B={b}" + (
                        "" if lo is None else f" tie at {lo}")
                    got, want = rnnt_joint(tab, e, h8), rnnt_joint_plain(tab, e, h8)
                    chk.equal("rnnt_joint", f"{tag} logits", got[0], want[0])
                    chk.equal("rnnt_joint", f"{tag} ids", got[1], want[1])
                    if lo is not None and not bool((got[1] == lo).all()):
                        raise AssertionError(f"{tag}: a tie did not go to the lower column")
    log(f"[13a] rnnt_pred_step and rnnt_joint == their plain versions in {chk.n - n0} exact "
        f"comparisons: pred H {RNNT_H} x L {RNNT_L} x B {RNNT_B} x 4 emit masks (tokens with "
        f"blank, c_q at the clip); joint De 256, J {RNNT_J} x V+1 {RNNT_V} x B {RNNT_JB}, "
        f"strided frames, forced ties in one warp and across warps to the lower column")


def greedy_inputs(rng, dev, cfg, b, t):
    """(B, t, 256) float32 frames, unequal lengths (the first row all t
    frames, the second none, the rest at random) and a random carry (h8,
    c_q at and next to the cell state's clip, g8 the top layer's h8)."""
    import numpy as np
    import torch

    n_l, h = cfg.pred_rnn_layers, cfg.pred_hidden
    enc = torch.from_numpy(rng.normal(size=(b, t, 256)).astype(np.float32) * 2).to(dev)
    lens = rng.integers(0, t + 1, b).astype(np.int32)
    lens[0] = t
    if b > 1:
        lens[1] = 0
    h8 = rng.integers(-127, 128, (n_l, b, h)).astype(np.int8)
    c = rng.integers(-(1 << 23), (1 << 23) + 1, (n_l, b, h)).astype(np.int32)
    c[..., 0], c[..., 1] = 1 << 23, -(1 << 23)
    h8, c = (torch.from_numpy(a).to(dev) for a in (h8, c))
    return enc, torch.from_numpy(lens).to(dev), (h8[-1].clone(), h8, c)


def greedy_equal(chk, tag, got, want):
    """rnnt_greedy's result (symbols, joint steps, ids; g8, h8, c_q) held
    to its plain version's, exactly."""
    chk.equal("rnnt_greedy", f"{tag} symbols, steps, ids", got[0], want[0])
    for what, g, w in zip(("g8", "h8", "c_q"), got[1], want[1]):
        chk.equal("rnnt_greedy", f"{tag} {what}", g, w)


def phase_rnnt_greedy(chk, dev):
    """13a: rnnt_greedy against rnnt_greedy_plain, exactly (each row's
    symbols, joint steps and ids, the new carry): H 64 / 320 / 640 x L 1 /
    2 (each in the form that its shared-memory plan picks: resident for
    the serving shape and H 64, streamed from L2 for two layers of H 320
    and for H 640) x B 1 / 7 / 32 x both heads, unequal lengths with a
    zero, max_symbols_per_step 10 (and 1 at B=7), a carry fed back into a
    second chunk of strided frames at B=7.  Then, in each form, a batch of
    RNNT_GREEDY_MANY rows, more than a wave of clusters takes, so that
    clusters decode a second group of rows.  Returns the launches by
    form."""
    import numpy as np

    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_greedy, rnnt_greedy_plain

    rng = np.random.default_rng(17)
    n0, forms = chk.n, {"resident": 0, "streamed": 0}
    capped = blanked = 0

    def launch(tag, want_form, *a):
        got = rnnt_greedy(*a)
        ran = rnnt_greedy.last_config["form"]
        if ran != want_form:
            raise AssertionError(f"{tag}: rnnt_greedy ran {ran}, the shape plans {want_form}")
        forms[ran] += 1
        return got

    for h in RNNT_H:
        for n_l in RNNT_L:
            form = "resident" if (h, n_l) in RNNT_GREEDY_RESIDENT else "streamed"
            for bias in RNNT_GREEDY_BIAS:
                cfg, tables = rnnt_decoder_tables(dev, h, n_l, 320, 29, seed=h + n_l,
                                                  blank_bias=bias)
                blank = cfg.blank_id
                for b in RNNT_B:
                    t = RNNT_GREEDY_T[b]
                    enc, lens, carry = greedy_inputs(rng, dev, cfg, b, t)
                    tag = f"rnnt_greedy {form} H={h} L={n_l} B={b} T={t} bias {bias:g}"
                    for cap in ((10, 1) if b == 7 and bias == 0 else (10,)):
                        got = launch(tag, form, tables, enc, lens, carry, cap, blank)
                        want = rnnt_greedy_plain(tables, enc, lens, carry, cap, blank)
                        greedy_equal(chk, f"{tag} cap {cap}", got, want)
                        # joint steps = symbols + frames - the frames that reach the cap
                        res, n = want[0].cpu().numpy(), lens.cpu().numpy()
                        capped += int((res[:, 0] + n > res[:, 1]).any())
                        blanked += int((res[:, 1] > res[:, 0]).any())
                    if b != 7:
                        continue
                    s = RNNT_GREEDY_SPLIT   # a second chunk, from the first's carry
                    l1, l2 = lens.clamp(max=s), (lens - s).clamp(min=0)
                    g1 = launch(tag, form, tables, enc[:, :s], l1, carry, 10, blank)
                    w1 = rnnt_greedy_plain(tables, enc[:, :s], l1, carry, 10, blank)
                    g2 = launch(tag, form, tables, enc[:, s:], l2, g1[1], 10, blank)
                    w2 = rnnt_greedy_plain(tables, enc[:, s:], l2, w1[1], 10, blank)
                    greedy_equal(chk, f"{tag} chunk 1", g1, w1)
                    greedy_equal(chk, f"{tag} chunk 2 from chunk 1's carry", g2, w2)
    if not capped or not blanked or not all(forms.values()):
        raise AssertionError(f"rnnt_greedy checks: {capped} cases reached the cap, {blanked} "
                             f"ended frames with a blank, launches by form {forms}")
    n1, b, t, cap = chk.n, RNNT_GREEDY_MANY, 2, RNNT_GREEDY_MANY_CAP
    waves = []
    for h, form in ((320, "resident"), (640, "streamed")):
        for bias in RNNT_GREEDY_BIAS:
            cfg, tables = rnnt_decoder_tables(dev, h, 1, 320, 29, seed=h + 1, blank_bias=bias)
            enc, lens, carry = greedy_inputs(rng, dev, cfg, b, t)
            tag = f"rnnt_greedy {form} H={h} L=1 B={b} T={t} bias {bias:g} cap {cap}"
            got = launch(tag, form, tables, enc, lens, carry, cap, cfg.blank_id)
            plan = dict(rnnt_greedy.last_config)
            if plan["rows"] * plan["clusters"] >= b:
                raise AssertionError(f"{tag}: {plan} covers the batch in one group a cluster")
            waves.append(plan)
            greedy_equal(chk, tag, got,
                         rnnt_greedy_plain(tables, enc, lens, carry, cap, cfg.blank_id))
    log(f"[13a] rnnt_greedy == rnnt_greedy_plain in {chk.n - n0} exact comparisons (symbols, "
        f"joint steps, ids; g8, h8, c_q): H {RNNT_H} x L {RNNT_L} x B {RNNT_B} x blank bias "
        f"{RNNT_GREEDY_BIAS}, lengths with a zero, caps 10 and 1, a second chunk from the "
        f"first's carry; {capped} cases reach the cap, {blanked} end frames with a blank; "
        f"{chk.n - n1} of them at B={b} x T={t}, cap {cap}, past one wave of clusters "
        f"({waves}); launches by form {forms}")
    return forms


def greedy_work(tables, batch, frames, symbols, steps, out_ints):
    """(bytes, int8 operations) of one rnnt_greedy decode of ``batch`` rows
    that walked ``frames`` frames in all, emitted ``symbols`` and took
    ``steps`` joint steps: the frames read once, the blob's weights once,
    the carry in and out, the (B, 2 + T cap) result written; the products
    this decode needed (a joint step's out product over J x V+1, a frame's
    f_j over De x J, an emission's gates over 2 H x 4 H a layer and its g_j
    over H x J)."""
    jt = tables["joint"]
    j, de = jt["wt_enc"].shape
    v, hid, n_l = jt["wt_out"].shape[0], tables["embed"].shape[1], len(tables["layers"])
    weights = sum(t.numel() * t.element_size() for t in
                  [tables["embed"]] + [lt[k] for lt in tables["layers"] for k in
                                       ("wt_i", "wt_h", "mi", "mh", "b_grid")]
                  + [jt[k] for k in ("wt_enc", "wt_pred", "wt_out", "m_f", "m_g", "b_j", "m_o",
                                     "b_out_logit")])
    weights += n_l * 3 * hid * 4   # mi2, mh2, b2_grid over the g gate's columns
    nbytes = (frames * de * 4 + weights + 2 * batch * (hid + n_l * hid * 5) + 4 * batch
              + 4 * out_ints)
    ops = 2 * (steps * j * v + frames * de * j + symbols * (n_l * 8 * hid * hid + hid * j))
    return nbytes, ops


def time_rnnt_kernels(chk, dev, card, rows):
    """13a: the step entries at the serving shapes (H = J = 320, one layer,
    29 outputs; B 32, the timed batch, and B 1, a stream) beside their
    bounds: each input read once, each output written once, over HBM;
    the int8 multiply-adds over the tensor-core peak.  Then rnnt_greedy at
    a chunk of the stream (B=1 x RNNT_CHUNK_FRAMES frames, the serving
    decoder at blank bias 0 and +2) beside its bound from the decode's own
    work (``greedy_work``)."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.rnnt_decoder import (
        rnnt_greedy, rnnt_greedy_plain, rnnt_joint, rnnt_joint_plain, rnnt_pred_step,
        rnnt_pred_step_plain,
    )

    rng = np.random.default_rng(131)
    cfg, tables = rnnt_decoder_tables(dev, 320, 1, 320, 29, seed=0)
    h, j, v, de = 320, 320, 29, 256
    for b in (RNNT_BATCH, 1):
        tok, h8, c = rnnt_pred_inputs(rng, dev, cfg, b)
        emit = emit_masks(rng, dev, b)[2].to(torch.int32)   # as the greedy loop passes it
        pred = lambda: rnnt_pred_step(tables, tok, h8, c, emit)[2]   # noqa: E731
        r = timed_pair(chk, "rnnt_pred", f"rnnt_pred H={h} L=1 B={b}", pred,
                       lambda: rnnt_pred_step_plain(tables, tok, h8, c, emit)[2], card, rows)
        # token, embedding row, h8, c and the int32 emit flag in; both
        # weight matrices; mi, mh, b_grid over the 4H gate columns and mi2,
        # mh2, b2_grid over the g gate's H (all int32); h8 and c out
        r["bound"] = bound(b * (4 + h + h + 4 * h + 4) + 8 * h * h + (3 * 4 * h + 3 * h) * 4
                           + b * (h + 4 * h), 2 * b * 4 * h * 2 * h)
        frames = torch.from_numpy(rng.normal(size=(b, 3, de)).astype(np.float32) * 2).to(dev)
        e = frames[:, 1]
        g8 = torch.from_numpy(rng.integers(-127, 128, (b, h)).astype(np.int8)).to(dev)
        jnt = lambda: rnnt_joint(tables, e, g8)[0]   # noqa: E731
        r = timed_pair(chk, "rnnt_joint", f"rnnt_joint De={de} J={j} V+1={v} B={b}", jnt,
                       lambda: rnnt_joint_plain(tables, e, g8)[0], card, rows)
        r["bound"] = bound(b * (4 * de + h) + de * j + h * j + j * v + 4 * (3 * j + 2 * v)
                           + b * (4 * v + 4), 2 * b * (de * j + h * j + j * v))
    for bias in RNNT_GREEDY_BIAS:
        cfg, tables = rnnt_decoder_tables(dev, 320, 1, 320, 29, seed=0, blank_bias=bias)
        t = RNNT_CHUNK_FRAMES
        enc, _, carry = greedy_inputs(rng, dev, cfg, 1, t)
        lens = torch.full((1,), t, dtype=torch.int32, device=dev)
        fn = lambda: rnnt_greedy(tables, enc, lens, carry, 10, cfg.blank_id)[0]   # noqa: E731
        # the plain per-row loop takes seconds here: two timed calls
        r = timed_pair(chk, "rnnt_greedy", f"rnnt_greedy H=320 L=1 B=1 T={t} bias {bias:g}", fn,
                       lambda: rnnt_greedy_plain(tables, enc, lens, carry, 10,
                                                 cfg.blank_id)[0], card, rows, plain_reps=1)
        res = fn().cpu().numpy()
        r["bound"] = bound(*greedy_work(tables, 1, t, int(res[0, 0]), int(res[0, 1]), res.size))
        r["joint_steps"], r["symbols"] = int(res[0, 1]), int(res[0, 0])


def phase_rnnt_golden(dev, card):
    """13b: the golden record on the card (``golden.check_rnnt_golden``:
    the decoder from the record's frames, Kernels 3-6 and 9 from its x8,
    exact; the float front from its audio within the x8 tolerance), then
    the main path from the record's audio with every count at 0 before it:
    frontend, the frozen encoder (Kernels 3-6, their planned launches),
    Kernel 9 (one rnnt_greedy, in the resident form that the serving
    head's plan picks, one pred step a layer at the start), no plain-version call, the same ids as the
    check's audio run.  Then the main path again with the head whose
    blank bias is raised by RNNT_BLANK_BIAS: its frames end with a blank
    (each row takes more joint steps than it emits symbols), the launches
    are planned, and the ids equal the plain decoder's on the CPU from the
    same frames.  Returns (model,
    the blank-biased model, the golden main path's counts, its ids)."""
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_greedy
    from qasr_tpu_torch.quantize.conformer_freeze import kernel_launches
    from qasr_tpu_torch.quantize.rnnt_freeze import decoder_launches, greedy_decode_frozen

    model = golden.rnnt_conformer16x256_w8a8()
    res = golden.check_rnnt_golden(model, dev)
    if res["bad"]:
        raise AssertionError(f"transducer golden record: {res['bad']} "
                             f"({ {k: v for k, v in res.items() if k != 'ids_audio'} })")
    log(f"[13b] transducer golden record holds: table digests; the integer decoder fed the "
        f"record's frames, and Kernels 3-6 -> Kernel 9 from its x8, give its frames, enc8 "
        f"codes and ids ({res['symbols']} symbols) exactly; from its audio, x8 flips "
        f"{res['x8_flips']} of {res['x8_size']} (<= 0.1%, +-1), enc8 codes differing "
        f"{res['enc8_differing_from_audio']} of {res['enc8_size']}, ids equal to the record's: "
        f"{res['audio_ids_equal']} (first difference per utterance "
        f"{res['audio_ids_first_difference']}) [{card}]")
    audio, alens = golden.rnnt_golden_audio()
    stats = {}
    reset_counts()
    with PlainCalls() as plain:
        enc, enc_lens = model.encode(audio, alens, device=dev)
        ids = model._greedy_hyps(enc, enc_lens, stats=stats)
        counts = read_counts()
    expect = planned({**kernel_launches(model.ccfg),
                      **decoder_launches(model.decoder_tables(dev), stats),
                      "rnnt_greedy_resident": stats["calls"]})
    if counts != expect or plain.n or ids != res["ids_audio"] or stats["calls"] != 1:
        raise AssertionError(f"transducer main path: launches {counts} vs plan {expect}, "
                             f"{plain.n} plain calls, ids equal to the check's audio run: "
                             f"{ids == res['ids_audio']}")
    log(f"[13b] main path (frontend -> Kernels 3-6 -> Kernel 9, B=2 x 4 / 3.5 s): launches "
        f"{ {k: v for k, v in counts.items() if v} } == plan (one rnnt_greedy, "
        f"{rnnt_greedy.last_config}; joint steps a row {stats['joint_steps']}, "
        f"{stats['symbols']} symbols), 0 plain calls, ids == the check's audio run")
    mixed = golden.rnnt_conformer16x256_w8a8(blank_bias=RNNT_BLANK_BIAS)
    m_stats = {}
    reset_counts()
    with PlainCalls() as plain:
        enc, enc_lens = mixed.encode(audio, alens, device=dev)
        m_ids = mixed._greedy_hyps(enc, enc_lens, stats=m_stats)
        m_counts = read_counts()
    m_expect = planned({**kernel_launches(mixed.ccfg),
                        **decoder_launches(mixed.decoder_tables(dev), m_stats),
                        "rnnt_greedy_resident": m_stats["calls"]})
    cpu = torch.device("cpu")
    want = greedy_decode_frozen(mixed.decoder_tables(cpu), mixed.rnnt_cfg, enc.to(cpu),
                                enc_lens.to(cpu))
    # frames end with a blank (more joint steps than symbols in each row)
    blank_ended = all(n > len(i) for n, i in zip(m_stats["joint_steps"], m_ids))
    if (m_counts != m_expect or plain.n or m_ids != want or not all(m_ids)
            or not blank_ended):
        raise AssertionError(f"transducer main path, blank bias +{RNNT_BLANK_BIAS:g}: launches "
                             f"{m_counts} vs plan {m_expect}, {plain.n} plain calls, stats "
                             f"{m_stats}, ids equal to the CPU's plain decoder: {m_ids == want}, "
                             f"symbols {[len(i) for i in m_ids]}")
    log(f"[13b] main path, blank bias +{RNNT_BLANK_BIAS:g}: launches "
        f"{ {k: v for k, v in m_counts.items() if v} } == plan (joint steps a row "
        f"{m_stats['joint_steps']}, symbols {[len(i) for i in m_ids]}), 0 plain calls, ids == "
        f"the CPU's plain decoder from the same frames")
    return model, mixed, counts, ids


def host_loop_decode(tables, cfg, enc, enc_lens, carry, max_symbols_per_step=10, stats=None):
    """The former greedy loop on Kernel 9's step kernels, rnnt_greedy's
    "was" in 13c's turns: a symbol step is one rnnt_joint launch, one copy of the
    B ids to the host, one host-to-card copy of tokens and emit flags and,
    where a row emits, one rnnt_pred_step launch a layer that keeps the
    old state in the rows that do not.  ``stats`` counts "steps" (joint
    launches) and "emit_steps"."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_joint, rnnt_pred_step

    g8, (h8, c_q), hyps = carry
    dev = tables["device"]
    enc_lens = enc_lens.cpu().numpy() if isinstance(enc_lens, torch.Tensor) \
        else np.asarray(enc_lens)
    st = stats if stats is not None else {}
    for t in range(enc.shape[1]):
        active = enc_lens > t
        if not active.any():
            break
        e_t = enc[:, t]
        for _ in range(max_symbols_per_step):
            sym = rnnt_joint(tables, e_t, g8)[1].cpu().numpy()
            st["steps"] = st.get("steps", 0) + 1
            emit = (sym != cfg.blank_id) & active
            if not emit.any():
                break
            tok_emit = torch.from_numpy(np.stack([np.where(emit, sym, cfg.blank_id),
                                                  emit]).astype(np.int32)).to(dev)
            g8, h8, c_q = rnnt_pred_step(tables, tok_emit[0], h8, c_q, emit=tok_emit[1])
            for i in np.nonzero(emit)[0]:
                hyps[i].append(int(sym[i]))
            st["emit_steps"] = st.get("emit_steps", 0) + 1
    return g8, (h8, c_q), hyps


def exchange_floor(dev, card, clusters, tag="13c"):
    """The latency floor of a rnnt_greedy step's exchange: us a round of
    ``cluster_exchange`` (every CTA pushes a word into every CTA's shared
    memory, then one barrier.cluster, then reads what arrived; dependent
    rounds) on ``clusters`` clusters of 8 CTAs, and of the barrier alone:
    CUDA events around n and 2n rounds a launch, the difference over n,
    median of 3."""
    from qasr_tpu_torch.kernels.rnnt_decoder import cluster_exchange

    out = {"clusters": clusters}
    for exchange in (True, False):
        per = []
        for _ in range(3):
            ms = {n: statistics.median(cuda_ms(
                lambda n=n: cluster_exchange(n, clusters, exchange, device=dev), reps=3,
                warmup=1)) for n in (EXCHANGE_ROUNDS, 2 * EXCHANGE_ROUNDS)}
            per.append((ms[2 * EXCHANGE_ROUNDS] - ms[EXCHANGE_ROUNDS]) / EXCHANGE_ROUNDS * 1e3)
        out["exchange_us" if exchange else "barrier_us"] = statistics.median(per)
        out["exchange_us_samples" if exchange else "barrier_us_samples"] = per
    log(f"[{tag}] cluster exchange floor ({clusters} clusters of 8 CTAs): a push into every "
        f"CTA + barrier.cluster {out['exchange_us']:.4f} us a round, the barrier alone "
        f"{out['barrier_us']:.4f} us [{card}]")
    return out


def phase_rnnt_time(models, dev, card, report):
    """13c: B=32 x 15 s of seeded noise: the encoder's step (CUDA events,
    median of 10), then for each head of ``models`` (name -> model, one
    encoder) the greedy decode on the main path (``_greedy_hyps``: the
    start-of-sequence step, one rnnt_greedy launch, one copy of ids and
    counts) and the former host loop (``host_loop_decode``) in turns (was,
    now, now, was; two decodes each), each by the host clock and by CUDA
    events around the whole decode with its final copy; both give the same
    ids.  For the main path also: rnnt_greedy's device time (profiler),
    its joint steps (the most a row takes, ``max_row_steps``), us a step,
    and the latency floor: the critical row's chain of exchanges (a step
    each, and one a layer each emission) times the measured round."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_greedy
    from qasr_tpu_torch.quantize.rnnt_freeze import frozen_decoder_init

    n = int(16000 * RNNT_SECONDS)
    audio = torch.from_numpy((np.random.default_rng(32).normal(size=(RNNT_BATCH, n)) * 0.1)
                             .astype(np.float32)).to(dev)
    lens = torch.full((RNNT_BATCH,), n, dtype=torch.int32, device=dev)
    model = next(iter(models.values()))
    enc_ms = statistics.median(cuda_ms(lambda: model.encode(audio, lens, device=dev), reps=10))
    enc, el = model.encode(audio, lens, device=dev)
    report["transducer_step"] = {"batch": RNNT_BATCH, "seconds": RNNT_SECONDS,
                                 "encoder_ms": enc_ms, "frames": int(enc.shape[1])}
    log(f"[13c] Conformer-Transducer B={RNNT_BATCH} x {RNNT_SECONDS:g} s: encoder "
        f"{enc_ms:.3f} ms (events) over {int(enc.shape[1])} frames [{card}]")
    model._greedy_hyps(enc, el)
    floor = exchange_floor(dev, card, rnnt_greedy.last_config["clusters"])
    report["transducer_step"]["exchange_floor"] = floor
    for name, m in models.items():
        tables, cfg = m.decoder_tables(dev), m.rnnt_cfg

        def now():
            st = {}
            return m._greedy_hyps(enc, el, stats=st), st

        def was():
            st = {}
            carry = frozen_decoder_init(tables, cfg, RNNT_BATCH)
            return host_loop_decode(tables, cfg, enc, el, carry, 10, st)[2], st
        fns = {"was": was, "now": now}
        ids = {k: fn()[0] for k, fn in fns.items()}   # warm-up, and the same ids
        if ids["was"] != ids["now"]:
            raise AssertionError(f"{name} head: rnnt_greedy's ids differ from the host loop's")
        host, events, stats = {k: [] for k in fns}, {k: [] for k in fns}, {}
        for k in ("was", "now", "now", "was"):
            for _ in range(2):
                torch.cuda.synchronize()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                a.record()
                _, stats[k] = fns[k]()
                b.record()
                b.synchronize()
                host[k].append((time.perf_counter() - t0) * 1e3)
                events[k].append(a.elapsed_time(b))
        dev_ms, by = device_ms(lambda: m._greedy_hyps(enc, el), KERNEL_SYMBOLS["rnnt_greedy"],
                               calls=1)
        st = stats["now"]
        steps = st["joint_steps"]
        frames = int(el.clamp(max=enc.shape[1]).sum())
        work = greedy_work(tables, RNNT_BATCH, frames, st["symbols"], int(sum(steps)),
                           RNNT_BATCH * (2 + enc.shape[1] * 10))
        crit = int(np.argmax(steps))
        chain = steps[crit] + cfg.pred_rnn_layers * len(ids["now"][crit])
        out = {"decode_ms": statistics.median(host["now"]), "decode_ms_samples": host["now"],
               "decode_event_ms": statistics.median(events["now"]),
               "decode_event_ms_samples": events["now"],
               "was_decode_ms": statistics.median(host["was"]), "was_decode_ms_samples": host["was"],
               "was_decode_event_ms": statistics.median(events["was"]),
               "was_symbol_steps": stats["was"]["steps"],
               "was_emitting_steps": stats["was"]["emit_steps"],
               "symbols": st["symbols"], "max_row_steps": st["max_row_steps"],
               "row_steps_total": int(sum(steps)), "greedy_config": rnnt_greedy.last_config,
               "greedy_device_ms": dev_ms, "greedy_device_ms_by": by,
               "us_per_step": dev_ms * 1e3 / st["max_row_steps"],
               "floor_chain": chain, "floor_ms": chain * floor["exchange_us"] / 1e3,
               "bound": bound(*work)}
        report["transducer_step"][name] = out
        log(f"[13c] {name} head: greedy decode {out['decode_ms']:.3f} ms host clock, "
            f"{out['decode_event_ms']:.3f} ms events (was {out['was_decode_ms']:.3f} / "
            f"{out['was_decode_event_ms']:.3f} ms: {stats['was']['steps']} batched symbol "
            f"steps); rnnt_greedy {dev_ms:.4f} ms device ({by}), {st['max_row_steps']} joint "
            f"steps in the longest row ({out['us_per_step']:.3f} us a step), {st['symbols']} "
            f"symbols; floor {out['floor_ms']:.4f} ms ({chain} exchanges x "
            f"{floor['exchange_us']:.4f} us), bound {out['bound'][0]:.5f} ms "
            f"({out['bound'][1]}); {rnnt_greedy.last_config} [{card}]")


def phase_rnnt_stream(dev, card, report):
    """13d: StreamingTransducer on the local-attention variant (the phase
    12b encoder config: att_context_size (70, 0), causal_conv,
    normalization off; the transducer's ranges; the decoder frozen by
    ``freeze_decoder`` on the card): the streamed transcript (its
    partials prefixes of it) equals offline ``transcribe_greedy``,
    ``transcribe_batch`` equals each session's offline transcript, and
    its latency_report."""
    import numpy as np

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.decode.streaming import StreamingTransducer

    model = unnormalized(golden.rnnt_conformer16x256_w8a8(
        frozen=False, att_context_size=(STREAM_L, 0), causal_conv=True))
    model.freeze_encoder()
    rng = np.random.default_rng(61)
    calib = (rng.normal(size=(2, 64000)) * 0.1).astype(np.float32)
    model.freeze_decoder([(calib, np.asarray([64000, 48000], np.int32))], device=dev)
    s_n = len(RNNT_STREAM_LENS)
    audio = np.zeros((s_n, max(RNNT_STREAM_LENS)), np.float32)
    for i, k in enumerate(RNNT_STREAM_LENS):
        audio[i, :k] = (rng.normal(size=k) * 0.1).astype(np.float32)
    offline = [model.transcribe_greedy(audio[i:i + 1, :k], np.asarray([k], np.int32),
                                       device=dev)[0]
               for i, k in enumerate(RNNT_STREAM_LENS)]
    st = StreamingTransducer(model, chunk_frames=RNNT_STREAM_CHUNK, device=dev)
    partials = []
    streamed = st.transcribe(audio[0, :RNNT_STREAM_LENS[0]], partials=partials)
    if streamed != offline[0] or not offline[0] or not all(streamed.startswith(p)
                                                           for p in partials):
        raise AssertionError(f"streamed transducer {streamed!r} != offline {offline[0]!r} "
                             f"(or empty, or a partial is no prefix)")
    batch = st.transcribe_batch(audio, np.asarray(RNNT_STREAM_LENS, np.int32))
    if batch != offline:
        raise AssertionError("StreamingTransducer.transcribe_batch differs from offline")
    rep = st.latency_report(audio[0, :RNNT_STREAM_LENS[0]])
    windows = sum(1 for _ in st._windows(RNNT_STREAM_LENS[0]))
    log(f"[13d] StreamingTransducer, causal Conformer-Transducer (att_context (70, 0)): "
        f"{RNNT_STREAM_SECONDS:g} s in {windows} windows (chunk {st.chunk_frames}, context "
        f"{st.context_left}/{st.context_right} frames) == offline transcribe_greedy "
        f"({len(streamed)} chars, {len(partials)} partials, each a prefix); transcribe_batch "
        f"of {s_n} sessions == each offline; latency_report first "
        f"{rep['first_chunk_latency_ms']:.2f} ms, mean {rep['mean_chunk_latency_ms']:.2f}, "
        f"p95 {rep['p95_chunk_latency_ms']:.2f}, steady {rep['steady_chunk_latency_ms']:.2f} "
        f"ms, RTFx {rep['streaming_rtfx']:.1f} [{card}]")
    report["transducer_stream"] = rep


def phase_rnnt_roundtrip(model, dev, ids):
    """13e: ``save_to`` / ``restore_from`` through a .qasr on the card: the
    restored model, frozen again (the decoder from the record's ranges),
    has the record's decoder tables and gives the main path's ids from the
    record's audio."""
    import shutil
    import tempfile

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.rnnt_model import RNNTModel
    from qasr_tpu_torch.quantize.rnnt_freeze import decoder_tables_digest, freeze_rnnt_decoder

    rec = golden.load_rnnt_golden()[0]
    tmp = tempfile.mkdtemp(prefix="qasr_smoke_rnnt_")
    try:
        path = f"{tmp}/transducer.qasr"
        model.save_to(path)
        m2 = RNNTModel.restore_from(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    m2.freeze_encoder()
    m2.dec_frozen = freeze_rnnt_decoder(m2.params["rnnt"], m2.rnnt_cfg, enc_range=rec["ranges"][0],
                                        joint_range=rec["ranges"][1])
    audio, alens = golden.rnnt_golden_audio()
    enc, el = m2.encode(audio, alens, device=dev)
    if m2._greedy_hyps(enc, el) != ids or \
            decoder_tables_digest(m2.dec_frozen) != rec["decoder_tables_sha256"]:
        raise AssertionError("the restored transducer's ids or decoder tables differ")
    log("[13e] .qasr save_to / restore_from on the card: the restored transducer's decoder "
        "tables equal the record's, its ids the main path's")


def phase_rnnt_beam(model, dev, card):
    """13f: beam / tsd / alsd over the record's two utterances' frames (B=2
    x 4 / 3.5 s) on the card and on the CPU: the best ids equal, or, where
    the CPU's two best sort keys lie within BEAM_MARGIN (a float near-tie),
    the margin is printed."""
    import numpy as np
    import torch

    from qasr_tpu_torch import golden
    from qasr_tpu_torch.models.rnnt import beam_search

    rec, frames, _, _ = golden.load_rnnt_golden()
    cfg = model.rnnt_cfg
    on = {"card": model.float_decoder(dev), "cpu": model.float_decoder(torch.device("cpu"))}
    t0 = time.perf_counter()
    for st in ("beam", "tsd", "alsd"):
        for i, n in enumerate(rec["enc_lens"]):
            hyps = {k: beam_search(p, cfg, torch.from_numpy(frames[i, :n]), beam_size=RNNT_BEAM,
                                   search_type=st, tsd_max_sym_exp=RNNT_TSD_EXP)
                    for k, p in on.items()}
            best = {k: [t for t in h[0].y_sequence if t != cfg.blank_id] for k, h in hyps.items()}
            if best["card"] == best["cpu"]:
                continue
            cpu = hyps["cpu"]
            margin = (cpu[0].score / len(cpu[0].y_sequence) - cpu[1].score
                      / len(cpu[1].y_sequence)) if len(cpu) > 1 else float("inf")
            if not margin < BEAM_MARGIN:
                raise AssertionError(f"{st} utterance {i}: card ids differ from the CPU's "
                                     f"(margin {margin:.3g})")
            log(f"[13f] {st} utterance {i}: card and CPU best differ at a float near-tie "
                f"(CPU margin {margin:.3g} < {BEAM_MARGIN:g})")
    log(f"[13f] beam / tsd (max {RNNT_TSD_EXP} expansions a frame) / alsd, beam {RNNT_BEAM}, "
        f"over the "
        f"record's 2 utterances: the card's best ids == the CPU's "
        f"({time.perf_counter() - t0:.1f} s) [{card}]")


def phase_transducer(chk, dev, card, report):
    """Phase 13; returns (kernels line rows, the main path's counts)."""
    t_phase = time.perf_counter()
    rows, parts = [], {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        parts[name] = time.perf_counter() - t0
        return out
    part("13a checks", phase_rnnt_kernels, chk, dev)
    part("13a rnnt_greedy checks", phase_rnnt_greedy, chk, dev)
    model, mixed, counts, ids = part("13b golden and main path", phase_rnnt_golden, dev, card)
    part("13a timing", time_rnnt_kernels, chk, dev, card, rows)
    part("13c step", phase_rnnt_time,
         {"cap-bound (golden)": model, f"blank bias +{RNNT_BLANK_BIAS:g}": mixed}, dev, card,
         report)
    del mixed
    part("13d stream", phase_rnnt_stream, dev, card, report)
    part("13e round trip", phase_rnnt_roundtrip, model, dev, ids)
    part("13f beam", phase_rnnt_beam, model, dev, card)
    log("[13] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    report["transducer_part_seconds"] = parts
    report["transducer_per_kernel"] = rows
    report["transducer_launches"] = counts
    report["transducer_seconds"] = time.perf_counter() - t_phase
    log(f"[13] phase 13 took {report['transducer_seconds']:.1f} s")
    return rows, counts


# ---------------------------------------------------------------------------
# phase 14: training
# ---------------------------------------------------------------------------

# 14a: Kernel 10's check grid (B, T, U) at V+1 = 29 characters and its
# BPE-width shape (B, T, U) at V+1 = 1,025 (a 1,024-piece vocabulary; 48
# pieces for a 15 s utterance); the timed shapes (a B=16 x 15 s transducer
# batch with 166-character targets, a longer lattice, the BPE width)
RNNT_LOSS_SHAPES = ((1, 1, 0), (1, 1, 5), (4, 37, 0), (4, 37, 12), (16, 375, 166), (3, 500, 300))
RNNT_LOSS_V = 28                   # the character labels; blank is V
RNNT_LOSS_BPE, RNNT_BPE_V = (16, 375, 48), 1024
RNNT_LOSS_TIMED = ((16, 375, 166, RNNT_LOSS_V), (3, 500, 300, RNNT_LOSS_V),
                   (16, 375, 48, RNNT_BPE_V))
# the NLL relative to the float64 plain version, and each gradient's largest
# |difference| from it: no farther than 2x the float32 plain version's own,
# with a floor, and at most RNNT_GRAD_ATOL (both bounds set from the card's
# worst, NLL 4.7e-8 and gradients 6e-8, NVIDIA H100 700 W, with room; the
# NLL's was 1e-5 at first)
RNNT_NLL_RTOL, RNNT_GRAD_FLOOR, RNNT_GRAD_ATOL = 1e-6, 1e-5, 1e-6
# the kernels of each entry (symbols in the profiler's names)
RNNT_LOGITS_KERNELS = ("rnnt_lse_kernel", "rnnt_lattice_kernel", "rnnt_grad_kernel")
RNNT_LP_KERNELS = ("rnnt_diag_kernel", "rnnt_lattice_kernel", "rnnt_occ_kernel")
# NeMo's examples/asr/conf/quartznet_15x5.yaml: SpecCutout 5 x (120 frames x
# 50 mels); its blocks' dropout is 0.0
QN_SPEC_AUGMENT = {"rect_masks": 5, "rect_time": 120, "rect_freq": 50}
TRAIN_SECONDS, CONF_TRAIN_DROPOUT = 15.0, 0.1
TRAIN_BATCH = {"quartznet15x5": 32, "conformer16x256": 32, "rnnt_conformer16x256": 16}
TRAIN_CHARS = (150, 166)           # 166 characters of 0.09 s: 14.94 s
# 14e: tests/corpus_utils.py::train_ctc_model's recipe on the toy of
# tests/test_e2e_quantization_accuracy.py, and the WER bounds that test
# holds the JAX package to
TOY_STEPS, TOY_BATCH, TOY_LR, TOY_CLIP = 700, 10, 0.02, 1.0
TOY_FP32_WER, TOY_W8A8_WER = 0.02, 0.08
CHAR_SEC, SAMPLE_RATE = 0.09, 16000
WORDS = ["cat", "dog", "bird", "fish", "tree", "rock", "wind", "rain", "moon", "star", "sand",
         "wave", "leaf", "frog", "bear", "wolf", "ant", "bee", "owl", "fox"]


def char_tone(c):
    """The two-tone code of a character (tests/corpus_utils.py's recipe)."""
    if c == " ":
        return (0.0, 0.0)
    i = ord(c) - ord("a")
    return (320.0 + 42.0 * i, 1250.0 + 67.0 * i)


def synth_utterance(text, rng, noise=0.02):
    import numpy as np

    n_char = int(CHAR_SEC * SAMPLE_RATE)
    t = np.arange(n_char) / SAMPLE_RATE
    env = np.ones(n_char)
    edge = n_char // 8
    ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(edge) / edge)
    env[:edge] *= ramp
    env[-edge:] *= ramp[::-1]
    out = []
    for c in text:
        f1, f2 = char_tone(c)
        out.append(np.zeros(n_char) if f1 == 0.0 else
                   env * (0.18 * np.sin(2 * np.pi * f1 * t) + 0.12 * np.sin(2 * np.pi * f2 * t)))
    sig = np.concatenate(out) if out else np.zeros(n_char)
    return (sig + rng.normal(size=sig.shape) * noise).astype(np.float32)


def make_corpus(n_utts, seed=0, min_words=2, max_words=3, noise=0.02):
    import numpy as np

    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_utts):
        k = int(rng.integers(min_words, max_words + 1))
        texts.append(" ".join(rng.choice(WORDS) for _ in range(k)))
    clips = [synth_utterance(s, rng, noise) for s in texts]
    audio = np.zeros((n_utts, max(len(c) for c in clips)), np.float32)
    lens = np.zeros((n_utts,), np.int32)
    for i, c in enumerate(clips):
        audio[i, :len(c)] = c
        lens[i] = len(c)
    return texts, audio, lens


def tokenize(texts, labels):
    import numpy as np

    lab = {c: i for i, c in enumerate(labels)}
    tlens = np.asarray([len(s) for s in texts], np.int32)
    toks = np.zeros((len(texts), int(tlens.max())), np.int32)
    for i, s in enumerate(texts):
        toks[i, :len(s)] = [lab[c] for c in s]
    return toks, tlens


def long_texts(rng, n):
    """n texts of words, each TRAIN_CHARS[0]..TRAIN_CHARS[1] characters long."""
    chars = TRAIN_CHARS
    out = []
    while len(out) < n:
        s = ""
        while len(s) < chars[0]:
            s = (s + " " + str(rng.choice(WORDS))).strip()
        if len(s) <= chars[1]:
            out.append(s)
    return out


def train_batch(b, labels, seed, dev):
    """(audio (B, 15 s) float32, lengths, tokens, token lengths) on ``dev``:
    two-tone utterances of 150-166 characters, padded to 15 s."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    texts = long_texts(rng, b)
    n = int(TRAIN_SECONDS * SAMPLE_RATE)
    audio = np.zeros((b, n), np.float32)
    lens = np.zeros((b,), np.int32)
    for i, s in enumerate(texts):
        sig = synth_utterance(s, rng)[:n]
        audio[i, :len(sig)] = sig
        lens[i] = len(sig)
    toks, tl = tokenize(texts, labels)
    return tuple(torch.from_numpy(a).to(dev) for a in (audio, lens, toks, tl))


def rnnt_loss_inputs(rng, b, t, u, v, dev):
    """(logits (B, T, U+1, V+1) float32, targets (B, U), lengths int32) on
    ``dev``: random joint logits, ragged lengths (row 0 at the full T and
    U)."""
    import numpy as np
    import torch

    logits = torch.from_numpy(rng.normal(size=(b, t, u + 1, v + 1)).astype(np.float32)).to(dev)
    tg = torch.from_numpy(rng.integers(0, v, size=(b, u))).to(dev)
    il = rng.integers(max(1, t // 2), t + 1, size=b)
    tl = rng.integers(0, u + 1, size=b)
    il[0], tl[0] = t, u
    return (logits, tg, torch.from_numpy(il.astype(np.int32)).to(dev),
            torch.from_numpy(tl.astype(np.int32)).to(dev))


def rnnt_loss_grads(fn, xs, rest, w):
    """(nll, d(w . nll)/d x for each x of ``xs``) of fn(*xs, *rest)."""
    import torch

    xs = [x.detach().clone().requires_grad_() for x in xs]
    nll = fn(*xs, *rest)
    return (nll.detach(), *torch.autograd.grad((nll * w).sum(), xs))


def rnnt_loss_bound(b, t, u, v1, il, tl):
    """(bound_ms, bound_by): the bytes Kernel 10's function of the logits
    must move (the logits of the lattice cells these lengths use, read
    once; their gradient written whole; targets, lengths, the NLL) over
    HBM; its operations (~8 float32 a logit) are far below their peak."""
    cells = int((il.long() * (tl.long() + 1)).sum())
    nbytes = 4 * cells * v1 + 4 * b * t * (u + 1) * v1 + 4 * b * u + 12 * b
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def rnnt_lp_bound(b, t, u, il, tl):
    """(bound_ms, bound_by) of the log-probs entry: the lattice cells'
    blank and emit log-probs these lengths use, read once; both gradients
    written whole; lengths and the NLL."""
    cells = int((il.long() * (tl.long() + 1)).sum() + (il.long() * tl.long()).sum())
    nbytes = 4 * cells + 4 * b * t * (2 * u + 1) + 12 * b
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def kernels_ms(fn, symbols):
    """(device ms a call of fn() summed over ``symbols``, how it was read,
    each symbol's ms or None): each kernel read on its own (device_ms
    counts one record a call, and a trace that dropped one kernel's records
    would pass for all); if any fell back to events, one events reading of
    whole calls."""
    parts = {sym: device_ms(fn, sym) for sym in symbols}
    if all(by == "profiler" for _, by in parts.values()):
        return sum(ms for ms, _ in parts.values()), "profiler", {k: v[0] for k, v in
                                                                 parts.items()}
    ms = next(ms for ms, by in parts.values() if by == "events")
    return ms, "events", {k: (v[0] if v[1] == "profiler" else None) for k, v in parts.items()}


def peak_gib(fn):
    """Peak device memory (GiB) above what was allocated, over one fn()."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def lattice_stamps(K10, logits, tg, il, tl, blank):
    """The lattice kernel's clock64 stamps on these inputs (two-sided):
    median cycles a round of row 0's alpha and beta blocks (its full T and
    U) spends waiting for its staged row, at the barrier, issuing the next
    row's copies, on thread 0's cell, on the stores, and in all (one
    round's first stamp to the next's), over the rounds where thread 0's
    cell (u = 0) is inside the diagonal."""
    import statistics as st

    import torch

    b, t, u1, _ = logits.shape
    lx, tg32, il32, tl32 = K10.logits_inputs(logits, tg, il, tl)
    _, bd, ed = K10.cell_pass(lx, tg32, il32, tl32, blank)
    stamps = torch.zeros((2 * b, t + u1 - 1, K10.STAMPS), dtype=torch.int64, device=lx.device)
    K10.lattice(bd, ed, il32, tl32, t, True, stamps=stamps)
    torch.cuda.synchronize()
    tb, ub = int(il32[0].clamp(1, t)), int(tl32[0].clamp(0, u1 - 1))
    out = {}
    # alpha's round d - 1 holds diagonal d, beta's round i diagonal tb - 1 + ub - i
    for side, blk, rounds in (("alpha", 0, range(0, tb - 1)), ("beta", 1, range(ub, tb + ub))):
        s = stamps[blk].double().cpu()
        parts = {name: st.median((s[rounds.start:rounds.stop, k + 1]
                                  - s[rounds.start:rounds.stop, k]).tolist())
                 for k, name in enumerate(("wait", "barrier", "issue", "cell", "stores"))}
        parts["round"] = st.median((s[rounds.start + 1:rounds.stop, 0]
                                    - s[rounds.start:rounds.stop - 1, 0]).tolist())
        out[side] = dict(parts, rounds=len(rounds))
    return out


def phase_rnnt_loss(chk, dev, card, rows):
    """14a: both entries of Kernel 10 against their plain versions (float32)
    and the plain versions in float64 (the truth) on the card; the timed
    shapes beside the log-softmax chain, the bound and the latency floor."""
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels import rnnt_loss as K10

    rng = np.random.default_rng(14)
    worst = {"nll_rel": 0.0, "grad_ratio": 0.0}
    shapes = [s + (RNNT_LOSS_V,) for s in RNNT_LOSS_SHAPES] + [RNNT_LOSS_BPE + (RNNT_BPE_V,)]
    for b, t, u, v in shapes:
        x, tg, il, tl = rnnt_loss_inputs(rng, b, t, u, v, dev)
        w = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(dev)
        with torch.no_grad():
            bl, em = K10.lattice_log_probs(torch.log_softmax(x.double(), dim=-1), tg, v)
        entries = (
            ("rnnt_loss_from_logits", K10.rnnt_loss_from_logits,
             K10.rnnt_loss_from_logits_plain, [x], (tg, il, tl, v), ("d logits",)),
            ("rnnt_loss", K10.rnnt_loss, K10.rnnt_loss_plain, [bl.float(), em.float()],
             (il, tl), ("d blank", "d emit")))
        for kind, kern, plain_fn, xs, rest, names in entries:
            got = rnnt_loss_grads(kern, xs, rest, w)
            plain = rnnt_loss_grads(plain_fn, xs, rest, w)
            truth = rnnt_loss_grads(plain_fn, [z.double() for z in xs], rest, w.double())
            torch.cuda.synchronize()
            nll_rel = float(((got[0].double() - truth[0]).abs() / truth[0].abs()).max())
            worst["nll_rel"] = max(worst["nll_rel"], nll_rel)
            what_shape = f"{kind} B={b} T={t} U={u} V+1={v + 1}"
            if not nll_rel <= RNNT_NLL_RTOL:
                raise AssertionError(f"14a {what_shape}: NLL {nll_rel:.3g} relative from "
                                     f"float64, above {RNNT_NLL_RTOL}")
            errs = []
            for i, what in enumerate(names, start=1):
                if got[i].numel() == 0:
                    continue
                ek = float((got[i].double() - truth[i]).abs().max())
                ep = float((plain[i].double() - truth[i]).abs().max())
                allowed = min(max(2 * ep, RNNT_GRAD_FLOOR), RNNT_GRAD_ATOL)
                if not ek <= allowed:
                    raise AssertionError(f"14a {what_shape} {what}: {ek:.3g} from float64, "
                                         f"the plain float32 version {ep:.3g}")
                errs.append((what, ek, ep))
                worst["grad_ratio"] = max(worst["grad_ratio"], ek / allowed)
                chk.max_err[kind] = max(chk.max_err[kind], ek)
            chk.max_err[kind] = max(chk.max_err[kind],
                                    float((got[0].double() - truth[0]).abs().max()))
            chk.n += 1
            log(f"[14a] {what_shape}: NLL {nll_rel:.2e} relative from float64; "
                + "; ".join(f"{what} {ek:.2e} (plain float32 {ep:.2e})" for what, ek, ep in errs))
            del got, plain, truth
        del bl, em
        if (b, t, u, v) in RNNT_LOSS_TIMED:
            rows.append(rnnt_loss_timed(K10, x, tg, il, tl, v, card))
        del x
        torch.cuda.empty_cache()
    log(f"[14a] worst: NLL {worst['nll_rel']:.2e} relative (bound {RNNT_NLL_RTOL}), gradient "
        f"error / allowed {worst['grad_ratio']:.3f}")
    return worst


def rnnt_loss_timed(K10, x, tg, il, tl, v, card):
    """14a's timed row at one shape: Kernel 10 from the logits forward +
    backward (device ms of its three kernels, the call, the forward), the
    log-softmax chain around its log-probs entry (torch.log_softmax, the
    gather, Kernel 10, autograd's scatter and log-softmax backward: the
    structure the loss had before the logits entry) as the yardstick, peak
    memory of both, the plain version, the byte bound, the latency floor
    (the round-floor kernel on the lattice's grid for T + U rounds) and
    the lattice's clock64 stamps."""
    import statistics

    import torch

    b, t, u1, v1 = x.shape
    u = u1 - 1
    xg = x.detach().clone().requires_grad_()

    def kern():
        return torch.autograd.grad(K10.rnnt_loss_from_logits(xg, tg, il, tl, v).sum(), xg)

    def chain():
        bl, em = K10.lattice_log_probs(torch.log_softmax(xg, dim=-1), tg, v)
        return torch.autograd.grad(K10.rnnt_loss(bl, em, il, tl).sum(), xg)

    def plain_fn():
        return torch.autograd.grad(
            K10.rnnt_loss_from_logits_plain(xg, tg, il, tl, v).sum(), xg)

    with torch.no_grad():
        lps = [z.contiguous().requires_grad_() for z in
               K10.lattice_log_probs(torch.log_softmax(x, dim=-1), tg, v)]

    def lp_kern():
        return torch.autograd.grad(K10.rnnt_loss(*lps, il, tl).sum(), lps)

    def lp_plain():
        return torch.autograd.grad(K10.rnnt_loss_plain(*lps, il, tl).sum(), lps)

    call = statistics.median(cuda_ms(kern, reps=10))
    dev_ms, by, parts = kernels_ms(kern, RNNT_LOGITS_KERNELS)
    fwd = None if None in (parts["rnnt_lse_kernel"], parts["rnnt_lattice_kernel"]) else \
        parts["rnnt_lse_kernel"] + parts["rnnt_lattice_kernel"]
    chain_call = statistics.median(cuda_ms(chain, reps=10))
    chain_ms, chain_by = device_ms(chain)
    chain_k10, chain_k10_by, _ = kernels_ms(chain, RNNT_LP_KERNELS)
    mem, chain_mem = peak_gib(kern), peak_gib(chain)
    pk = statistics.median(cuda_ms(plain_fn, reps=2, warmup=1))
    lp_call = statistics.median(cuda_ms(lp_kern, reps=10))
    lp_ms, lp_by, _ = kernels_ms(lp_kern, RNNT_LP_KERNELS)
    lp_pk = statistics.median(cuda_ms(lp_plain, reps=2, warmup=1))
    bnd = rnnt_loss_bound(b, t, u, v1, il, tl)
    lp_bnd = rnnt_lp_bound(b, t, u, il, tl)
    threads = K10.lattice_threads(u)
    floor_ms, floor_by = device_ms(lambda: K10.round_floor(2 * b, threads, t + u),
                                   "rnnt_round_floor_kernel")
    stamps = lattice_stamps(K10, x, tg, il, tl, v)
    shape = f"rnnt_loss_from_logits B={b} T={t} U={u} V+1={v1}"
    row = {"shape": shape, "kernel": "rnnt_loss_from_logits", "call_ms": call,
           "device_ms": dev_ms, "device_ms_by": by, "kernel_ms": parts, "forward_device_ms": fwd,
           "plain_ms": pk, "bound": bnd, "rounds": t + u, "floor_ms": floor_ms,
           "floor_by": floor_by, "lattice_threads": threads, "stamps_cycles": stamps,
           "peak_gib": mem, "chain_device_ms": chain_ms, "chain_device_ms_by": chain_by,
           "chain_kernel10_ms": chain_k10, "chain_kernel10_ms_by": chain_k10_by,
           "chain_call_ms": chain_call, "chain_peak_gib": chain_mem,
           "lp_device_ms": lp_ms, "lp_device_ms_by": lp_by, "lp_call_ms": lp_call,
           "lp_plain_ms": lp_pk, "lp_bound": lp_bnd,
           "library_call_ms": None, "library_device_ms": None, "library_device_ms_by": None}
    fmt = lambda z: "not read" if z is None else f"{z:.4f}"  # noqa: E731
    log(f"[14a] {shape} forward + backward: {dev_ms:.4f} ms device ({by}; cell pass "
        f"{fmt(parts['rnnt_lse_kernel'])}, lattice {fmt(parts['rnnt_lattice_kernel'])}, "
        f"gradient {fmt(parts['rnnt_grad_kernel'])}; {call:.4f} ms call), peak {mem:.3f} GiB; "
        f"yardstick (log-softmax chain around the log-probs entry) {chain_ms:.4f} ms device "
        f"({chain_by}; its Kernel 10 {chain_k10:.4f}; {chain_call:.4f} ms call), peak "
        f"{chain_mem:.3f} GiB; plain {pk:.3f} ms; bound {bnd[0]:.5f} ms ({bnd[1]}), latency "
        f"floor {floor_ms:.4f} ms ({t + u} rounds of {threads} threads, {floor_by}); library: "
        f"none [{card}]")
    log(f"[14a] rnnt_loss (the log-probs entry) B={b} T={t} U={u} forward + backward: "
        f"{lp_ms:.4f} ms device ({lp_by}; {lp_call:.4f} ms call), plain {lp_pk:.3f} ms, bound "
        f"{lp_bnd[0]:.5f} ms ({lp_bnd[1]})")
    log(f"[14a] {shape} lattice stamps (median cycles a round: wait, barrier, issue, cell, "
        f"stores, round): " + "; ".join(
            f"{side} {d['wait']:.0f}, {d['barrier']:.0f}, {d['issue']:.0f}, {d['cell']:.0f}, "
            f"{d['stores']:.0f}, {d['round']:.0f} ({d['rounds']} rounds)"
            for side, d in stamps.items()))
    return row


def phase_train_golden(dev, report):
    """14b: the three golden training records on the card; Kernel 10's
    launches on the transducer's (the main path's counts)."""
    import torch

    from qasr_tpu_torch.kernels import rnnt_loss as K10
    from qasr_tpu_torch.train import golden as G

    out, counts = {}, None
    for name in G.MODELS:
        model = G.train_model(name)
        start = G.start_norms(model)
        tr = G.make_trainer(name, model, dev)
        plains = (K10.rnnt_loss_plain, K10.rnnt_loss_from_logits_plain)
        if name == "rnnt_conformer16x256":
            reset_counts()
            for w in plains:
                w.launches = 0
        rec = G.train_record(name, dev, tr)
        if name == "rnnt_conformer16x256":
            counts = read_counts()
            counts["rnnt_loss_plain"] = sum(w.launches for w in plains)
            # a step: the cell pass and the lattice forward, the gradient
            # pass backward; the log-probs entry not at all
            want = planned({"rnnt_loss_from_logits": 3 * G.STEPS})
            got = {k: counts.get(k, 0) for k in want}
            if got != want or counts["rnnt_loss_plain"]:
                raise AssertionError(f"14b transducer steps launched {counts}, planned {want} "
                                     f"and no plain version")
        cmp = G.compare_train_record(rec, G.load_record(name), start)
        out[name] = {"record": rec, "compare": cmp}
        log(f"[14b] {name}: losses {rec['losses']}; step-1 loss {cmp['loss1']:.2e} relative "
            f"(bound {G.LOSS_RTOL}), later steps {cmp['later_losses']:.2e}; worst step-1 "
            f"gradient norm {cmp['grad'][0]:.2e} ({cmp['grad'][1]}; bound {G.GRAD_RTOL}), "
            f"step-3 param norm {cmp['param'][0]:.2e} ({cmp['param'][1]}; bound "
            f"{G.PARAM_RTOL}); {cmp['weak']} weak leaves: gradient norms at "
            f"{cmp['weak_grad'][0]:.3f} of their bound, moves at {cmp['weak_param'][0]:.3f} "
            f"of Novograd's reach")
        if cmp["failures"]:
            raise AssertionError(f"14b {name}: {cmp['failures'][:5]}")
        del tr, model
        torch.cuda.empty_cache()
    log(f"[14b] transducer golden steps: rnnt_loss_from_logits "
        f"{counts['rnnt_loss_from_logits']} launches, rnnt_loss {counts['rnnt_loss']}, the plain "
        f"versions {counts['rnnt_loss_plain']}")
    report["train_golden"] = {k: v["compare"] for k, v in out.items()}
    return counts


def profile_step(fn):
    """(device kernel ms by group, all kernels' device ms, the call's ms by
    CUDA events) of one fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    groups = {"rnnt_loss": 0.0, "ctc_loss": 0.0}
    total, by_kernel = 0.0, []
    for ev in prof.key_averages():
        # a record_function range (torch.optim's "Optimizer.step#..." around
        # the optimizer's step) spans kernels that are counted themselves
        if ev.device_type != torch.autograd.DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False) or ev.key.startswith("Optimizer."):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        total += us
        by_kernel.append((us / 1e3, ev.count, ev.key[:90]))
        if any(sym in ev.key for sym in KERNEL_SYMBOLS["rnnt_loss_from_logits"]
               + KERNEL_SYMBOLS["rnnt_loss"]):
            groups["rnnt_loss"] += us
        elif "ctc_loss" in ev.key:
            groups["ctc_loss"] += us
    groups = {k: v / 1e3 for k, v in groups.items()}
    groups["top"] = sorted(by_kernel, reverse=True)[:6]
    return groups, total / 1e3, a.elapsed_time(b)


def phase_train_steps(dev, card, report):
    """14c: full-width training steps timed (median of 5 after 2 warm-ups,
    CUDA events around train_step), peak memory, the params' write-back,
    Kernel 10's and F.ctc_loss's device ms a step, the device-busy share
    (one profiled step's kernel time over the median step: the profiler
    slows the host, not the kernels) and the step's top kernels; every loss
    and gradient finite."""
    import dataclasses

    import torch

    from qasr_tpu_torch.kernels import rnnt_loss as K10
    from qasr_tpu_torch.ops.spec_augment import SpecAugmentConfig
    from qasr_tpu_torch.train import golden as G

    steps = {}
    for name in G.MODELS:
        model = G.train_model(name)
        spec = None
        if name == "quartznet15x5":
            spec = SpecAugmentConfig.from_dict(QN_SPEC_AUGMENT)
        else:
            ccfg = dataclasses.replace(model.plan if name.startswith("rnnt") else model.ccfg,
                                       dropout=CONF_TRAIN_DROPOUT)
            if name.startswith("rnnt"):
                model.plan = ccfg
            else:
                model.ccfg = ccfg
        tr = G.make_trainer(name, model, dev)
        tr.spec_aug = spec
        b = TRAIN_BATCH[name]
        batch = train_batch(b, list(model.cfg.labels), seed=40 + b, dev=dev)
        loss = tr.backward(batch)
        grads = [p.grad for p in tr.opt.params if p.grad is not None]
        finite = bool(torch.isfinite(loss)) and bool(
            torch.isfinite(torch.stack(torch._foreach_norm(grads))).all())
        if not finite:
            raise AssertionError(f"14c {name}: loss {float(loss)} or a gradient not finite")
        tr.apply()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n0 = K10.rnnt_loss_from_logits.launches
        times = cuda_ms(lambda: tr.train_step(batch), reps=5, warmup=2)
        launches = (K10.rnnt_loss_from_logits.launches - n0) / 7
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = statistics.median(times)
        wb_ms = statistics.median(cuda_ms(tr.sync_model, reps=5, warmup=1))
        groups, busy, prof_ms = profile_step(lambda: tr.train_step(batch))
        last = tr.train_step(batch)
        if not math.isfinite(last):
            raise AssertionError(f"14c {name}: loss {last} after the timed steps")
        steps[name] = {"batch": b, "seconds": TRAIN_SECONDS, "step_ms": step_ms,
                       "samples_ms": times, "peak_gib": peak, "write_back_ms": wb_ms,
                       "rnnt_loss_device_ms": groups["rnnt_loss"],
                       "rnnt_loss_launches_per_step": launches,
                       "ctc_loss_device_ms": groups["ctc_loss"], "kernels_device_ms": busy,
                       "profiled_step_ms": prof_ms, "busy_share": busy / step_ms,
                       "top_kernels": groups["top"], "loss": last}
        log(f"[14c] {name} B={b} x {TRAIN_SECONDS:g} s train step: median {step_ms:.2f} ms of "
            f"{len(times)} ({b * TRAIN_SECONDS / step_ms * 1e3:.1f} audio-s/s), peak "
            f"{peak:.2f} GiB, params write-back {wb_ms:.2f} ms, Kernel 10 "
            f"{groups['rnnt_loss']:.3f} ms device and {launches:g} launches a step, F.ctc_loss "
            f"{groups['ctc_loss']:.3f} ms device, kernels {busy:.1f} ms device in a profiled "
            f"step of {prof_ms:.1f} ms (busy share, over the median step: {busy / step_ms:.3f}), "
            f"loss {last:.3f} [{card}]")
        log(f"[14c] {name} top kernels (device ms, calls): " + "; ".join(
            f"{ms:.1f} ({n}) {key}" for ms, n, key in groups["top"]))
        del tr, model, batch
        torch.cuda.empty_cache()
    report["train_steps"] = steps
    return steps


def write_train_manifest(root, n=8, seed=8):
    """n two-tone wavs of 2-3 words and their manifest."""
    import numpy as np

    from qasr_tpu_torch.data.audio import write_wav

    texts, audio, lens = make_corpus(n, seed=seed)
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        for i, s in enumerate(texts):
            wav = os.path.join(root, f"t{i}.wav")
            write_wav(wav, audio[i, :lens[i]], SAMPLE_RATE)
            f.write(json.dumps({"audio_filepath": wav, "duration": int(lens[i]) / SAMPLE_RATE,
                                "text": s}) + "\n")
    return path


def npz_arrays(path):
    import numpy as np

    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def phase_train_cli(dev, report):
    """14d: cli.speech_to_text (QuartzNet15x5's YAML at full width) 3 steps,
    checkpoints, a resume whose params and optimizer state equal the saved
    ones bit for bit; cli.speech_to_text_rnnt 2 steps."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from qasr_tpu_torch.cli import speech_to_text, speech_to_text_rnnt
    from qasr_tpu_torch.models.config import config_to_dict, quartznet15x5
    from qasr_tpu_torch.utils.yaml_io import safe_dump

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        manifest = write_train_manifest(td)
        model = dict(config_to_dict(quartznet15x5()), spec_augment=QN_SPEC_AUGMENT,
                     train_ds={"manifest_filepath": manifest, "batch_size": 4, "shuffle": True},
                     optim={"name": "novograd", "lr": 0.01, "betas": [0.8, 0.5],
                            "weight_decay": 0.001,
                            "sched": {"name": "CosineAnnealing", "warmup_steps": 0}})
        cfg = os.path.join(td, "quartznet_15x5.yaml")
        with open(cfg, "w") as f:
            safe_dump({"model": model, "trainer": {"max_steps": 3},
                       "exp_manager": {"exp_dir": os.path.join(td, "exp"), "name": "qn",
                                       "checkpoint_every_n_steps": 1, "resume_if_exists": True,
                                       "resume_ignore_no_checkpoint": True}}, f)
        quiet = contextlib.redirect_stderr(io.StringIO())
        with quiet:
            tr = speech_to_text.main(["--config-path", cfg])
        ck = os.path.join(td, "exp", "qn", "version_0", "checkpoints")
        names = sorted(os.listdir(ck))
        if tr.step != 3 or not {"last.npz", "step_2.npz", "step_3.npz"} <= set(names):
            raise AssertionError(f"14d speech_to_text: step {tr.step}, checkpoints {names}")
        saved = npz_arrays(os.path.join(ck, "last.npz"))
        with contextlib.redirect_stderr(io.StringIO()):
            tr2 = speech_to_text.main(["--config-path", cfg])     # resumes at step 3
        again = npz_arrays(os.path.join(ck, "last.npz"))
        same = sorted(again) == sorted(saved) and all(
            np.array_equal(again[k], saved[k]) for k in saved)
        if tr2.step != 3 or not same:
            raise AssertionError(f"14d resume: step {tr2.step}, bit-equal {same}")
        n_opt = sum(1 for k in saved if k.startswith("opt/"))
        log(f"[14d] cli.speech_to_text QuartzNet15x5 (full width, spec-augment) 3 steps: "
            f"{names}; resumed from last.npz, its params and {n_opt} optimizer leaves equal "
            f"the saved ones bit for bit")
        rcfg = os.path.join(td, "rnnt.yaml")
        with open(rcfg, "w") as f:
            safe_dump({"model": config_to_dict(quartznet15x5())}, f)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            out = speech_to_text_rnnt.main(["--config", rcfg, "--train_manifest", manifest,
                                            "--batch_size", "4", "--max_steps", "2"])
        if out["steps"] != 2 or not math.isfinite(out["final_loss"]):
            raise AssertionError(f"14d speech_to_text_rnnt: {out}")
        log(f"[14d] cli.speech_to_text_rnnt 2 steps: {buf.getvalue().strip()}")
    report["train_cli_seconds"] = time.perf_counter() - t0


def toy_config():
    """tests/test_e2e_quantization_accuracy.py::_cfg: 16 mels, four tiny
    blocks (24, 24 x 2, 32 x 2, 40), 28 labels, no dither."""
    from qasr_tpu_torch.models.config import BlockConfig, DecoderConfig, EncoderConfig, ModelConfig

    blocks = (BlockConfig(filters=24, repeat=1, kernel=(7,), stride=(2,), residual=False,
                          separable=True),
              BlockConfig(filters=24, repeat=2, kernel=(5,), residual=True, separable=True),
              BlockConfig(filters=32, repeat=2, kernel=(5,), residual=True, separable=True),
              BlockConfig(filters=40, repeat=1, kernel=(1,), residual=False, separable=False))
    return ModelConfig(encoder=EncoderConfig(feat_in=16, blocks=blocks, activation="relu"),
                       decoder=DecoderConfig(feat_in=40, num_classes=28),
                       preprocessor={"features": 16, "dither": 0.0})


def corpus_wer(model, texts, audio, lens, dev, mode=None, batch_size=10):
    from qasr_tpu_torch.decode.ctc import WER

    wer = WER(model.vocabulary)
    toks, tlens = tokenize(texts, model.vocabulary)
    for i in range(0, len(texts), batch_size):
        sl = slice(i, i + batch_size)
        _, el, preds = model.forward(audio[sl], lens[sl], mode=mode, device=dev)
        wer.update(preds.cpu().numpy(), toks[sl], tlens[sl], el.cpu().numpy())
    return wer.compute()


def phase_train_quantize(dev, card, report):
    """14e: train the toy on the 50-utterance corpus (seed 1) as
    train_ctc_model does, then zero-shot quantize it and serve on the
    card: fp32 WER <= 0.02, W8A8 dynamic and calibrated WER <= 0.08."""
    import copy

    import numpy as np
    import torch

    from qasr_tpu_torch.models.ctc_model import ASRModel
    from qasr_tpu_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    texts, audio, lens = make_corpus(50, seed=1)
    model = ASRModel.from_config(toy_config(), seed=0)
    toks, tlens = tokenize(texts, model.vocabulary)
    tr = Trainer(model, TrainConfig(lr=TOY_LR, warmup_steps=0, max_steps=TOY_STEPS,
                                    log_every=10 ** 9, grad_clip=TOY_CLIP), device=dev)
    rng = np.random.default_rng(0)
    loss = math.inf
    for _ in range(TOY_STEPS):
        idx = rng.choice(len(texts), size=TOY_BATCH, replace=False)
        loss = tr.train_step((audio[idx], lens[idx], toks[idx], tlens[idx]))
    t_train = time.perf_counter() - t0
    params = copy.deepcopy(model.params)
    wer = {"fp32": corpus_wer(model, texts, audio, lens, dev, mode="fp32")}
    for name in ("w8a8_dyn", "w8a8"):
        m = ASRModel.from_config(toy_config(), seed=0)
        m.params = copy.deepcopy(params)
        m.set_quant_bit(8)
        if name == "w8a8_dyn":
            m.set_dynamic(True)
        m.bn_folding()
        if name == "w8a8":
            with torch.no_grad():
                cal = [m.frontend(torch.from_numpy(audio[i:i + 4]).to(dev),
                                  torch.from_numpy(lens[i:i + 4]).to(dev), dither=0.0)
                       for i in range(0, 20, 4)]
            m.calibrate(cal, device=dev)
        wer[name] = corpus_wer(m, texts, audio, lens, dev)
    report["train_quantize"] = {"loss": loss, "wer": wer, "train_s": t_train,
                                "seconds": time.perf_counter() - t0}
    log(f"[14e] toy trained {TOY_STEPS} steps B={TOY_BATCH} on the card in {t_train:.1f} s "
        f"(final loss {loss:.4f}); corpus WER fp32 {wer['fp32']:.4f} (bound {TOY_FP32_WER}), "
        f"W8A8 dynamic {wer['w8a8_dyn']:.4f}, W8A8 calibrated {wer['w8a8']:.4f} (bound "
        f"{TOY_W8A8_WER}) [{card}]")
    if not (wer["fp32"] <= TOY_FP32_WER and wer["w8a8_dyn"] <= TOY_W8A8_WER
            and wer["w8a8"] <= TOY_W8A8_WER):
        raise AssertionError(f"14e WER above its bounds: {wer}")


def phase_training(chk, dev, card, report):
    """Phase 14; returns (kernels line rows, the main path's counts)."""
    t_phase = time.perf_counter()
    rows, parts = [], {}

    def part(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        parts[name] = time.perf_counter() - t0
        return out
    part("14a rnnt_loss", phase_rnnt_loss, chk, dev, card, rows)
    counts = part("14b golden records", phase_train_golden, dev, report)
    part("14c steps", phase_train_steps, dev, card, report)
    part("14d CLIs", phase_train_cli, dev, report)
    part("14e train, quantize, serve", phase_train_quantize, dev, card, report)
    log("[14] seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    report["training_part_seconds"] = parts
    report["training_per_kernel"] = rows
    report["training_seconds"] = time.perf_counter() - t_phase
    log(f"[14] phase 14 took {report['training_seconds']:.1f} s")
    return rows, counts


def rnnt_loss_rows(chk, rows, counts):
    """Kernel 10's entries of the kernels line at the B=16 x 15 s lattice:
    from the logits (the training path's) and from the log-probs (off the
    main path since training takes the logits)."""
    r = next(r for r in rows if r["shape"] == "rnnt_loss_from_logits B=16 T=375 U=166 V+1=29")
    src = "qasr_tpu_torch/kernels/csrc/rnnt_loss.cu"
    scan = ("the lax.scan over anti-diagonals differentiated by autodiff, "
            "qasr_tpu/models/rnnt.py:156-216 (rnnt_loss_wavefront)")
    common = {"route": "cuda", "source": src, "library_ms": None, "library_call_ms": None,
              "floor_ms": r["floor_ms"], "rounds": r["rounds"]}
    return [
        {"name": "rnnt_loss_from_logits", "shape": r["shape"],
         "replaces": "none: rnnt_loss(log_softmax(logits)), "
                     f"qasr_tpu/models/rnnt_model.py:227-228, {scan}",
         "launches": counts["rnnt_loss_from_logits"],
         "max_abs_err": chk.max_err["rnnt_loss_from_logits"], "ms": r["device_ms"],
         "call_ms": r["call_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "forward_ms": r["forward_device_ms"],
         "yardstick_ms": r["chain_device_ms"], **common},
        {"name": "rnnt_loss", "shape": r["shape"].replace("rnnt_loss_from_logits", "rnnt_loss"),
         "replaces": f"none: {scan}", "launches": counts["rnnt_loss"],
         "max_abs_err": chk.max_err["rnnt_loss"], "ms": r["lp_device_ms"],
         "call_ms": r["lp_call_ms"], "plain_ms": r["lp_plain_ms"],
         "bound_ms": r["lp_bound"][0], "bound_by": r["lp_bound"][1], **common}]


def main() -> int:
    ap = argparse.ArgumentParser(description="PyTorch port smoke test on one GPU")
    ap.add_argument("--report", help="also write a JSON report of every number here")
    ap.add_argument("--only", choices=("training", "rnnt_loss"),
                    help="run the build and phase 14 (training) or 14a (rnnt_loss) alone (a "
                         "partial run: it prints no result line)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on a GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build

    t_start = time.perf_counter()
    dev = require_cuda(0)
    card = card_line()
    log(f"[1] {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    log(card)
    report = {"card": card, "device": torch.cuda.get_device_name(0)}

    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    info = _build.BuildInfo
    log(f"[2] kernels built from csrc in {build_s:.2f} s (nvcc {info.seconds:.2f} s, "
        f"compiled={info.compiled}) -> {os.path.relpath(info.path, ROOT)}")
    if info.per_source:
        log("[2] nvcc seconds a source, slowest first: " + ", ".join(
            f"{name} {sec:.1f}" for name, sec in info.per_source.items()))
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"    ptxas: {line.strip()}")
    report.update(build_s=build_s, nvcc_s=info.seconds, nvcc_per_source=info.per_source,
                  ptxas=info.log)

    chk = Checker()
    if args.only:
        if args.only == "training":
            rows, counts = phase_training(chk, dev, card, report)
            report["kernels"] = rnnt_loss_rows(chk, rows, counts)
        else:
            rows = []
            phase_rnnt_loss(chk, dev, card, rows)
            report["kernels"] = []
            report["training_per_kernel"] = rows
        report["seconds"] = time.perf_counter() - t_start
        if args.report:
            os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
            with open(args.report, "w") as f:
                json.dump(report, f, indent=1)
        log(card)
        print(json.dumps({"kernels": report["kernels"]}), flush=True)
        log(f"partial run (--only {args.only}) passed in {report['seconds']:.1f} s")
        return 0
    phase_requant(chk, dev)
    phase_dw(chk, dev)
    phase_pw(chk, dev)
    phase_requant_kernel(chk, dev)
    phase_int_fns(chk, dev)
    conf_model, conf_tables, conf_golden = phase_conformer_golden(dev)
    phase_int_attention(chk, dev, conf_tables)
    phase_conv_block(chk, dev, conf_tables)
    phase_lin_epilogue(chk, dev, conf_tables)
    phase_ffn_ln(chk, dev, conf_tables)
    log(f"[3] {chk.n} kernel-vs-plain comparisons pass at tolerance exact "
        f"(torch.equal); max |d| {chk.max_err}")
    report["conformer_golden"] = conf_golden

    model, tables = phase_golden(dev)
    q_counts = phase_serve(model, dev)
    conf_counts = phase_conformer_serve(conf_model, conf_tables, dev)
    # launches on each kernel's own main path: Kernels 1-2 on the static
    # QuartzNet path, Kernel 7 on the per_channel one, the rest on the
    # Conformer's default plan
    counts = {"dw_conv": q_counts["static_e"]["dw_conv"],
              "pw_gemm": q_counts["static_e"]["pw_gemm"],
              "requant": q_counts["per_channel"]["requant"]}
    counts.update({k: conf_counts[k] for k in
                   ("int_attention", "conv_block", "lin_epilogue", "ffn_ln")})
    report["launches"] = {"quartznet": q_counts, "conformer": conf_counts}
    phase_time(chk, model, tables, dev, card, report)
    phase_conformer_time(chk, conf_model, conf_tables, dev, card, report)
    log(f"[6] {chk.n} kernel-vs-plain comparisons in all, the main paths' shapes included, "
        f"exact; max |d| {chk.max_err}")
    phase_workflow(chk, dev, card, report)
    phase_conformer_workflow(chk, dev, card, report)
    vgg_pre = phase_checkpoints(chk, dev, card, report, model, tables, conf_model, conf_tables)
    w8a8_rows, w8a8_counts = phase_w8a8(chk, dev, card, report, (model, tables["static_e"]))
    g_rows, g_counts = phase_grouped(chk, dev, card, report, (model, tables["static_e"]))
    s_rows, s_counts = phase_streaming(chk, dev, card, report)
    t_rows, t_counts = phase_transducer(chk, dev, card, report)
    tr_rows, tr_counts = phase_training(chk, dev, card, report)

    rows = report["quartznet_per_kernel"] + report["conformer_per_kernel"]
    kernels = []

    def kernel_row(kind, replaces, r, launches):
        return {"name": kind, "route": "cuda", "shape": r["shape"],
                "source": f"qasr_tpu_torch/kernels/csrc/{kind}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": chk.max_err[kind], "ms": r["device_ms"],
                "call_ms": r["call_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
                "library_ms": r["library_device_ms"],
                "library_call_ms": r["library_call_ms"]}
    for kind, replaces, label in [
            ("dw_conv", "qasr_tpu/kernels/cm_fused.py:248 (#1); qasr_tpu/kernels/depthwise.py:104 "
             "(#2); qasr_tpu/kernels/depthwise.py:409 (#3); qasr_tpu/kernels/cm_fused.py:575 "
             "(#6); qasr_tpu/kernels/cm_fused.py:486 (#7); qasr_tpu/kernels/cm_fused.py:374 "
             "(#8); qasr_tpu/kernels/depthwise.py:284 (#9)", "C=512 K=75 s=1 d=1 epilogue off"),
            ("pw_gemm", "qasr_tpu/kernels/cm_fused.py:131 (#4); qasr_tpu/kernels/cm_fused.py:704 "
             "(#5); qasr_tpu/kernels/pw_matmul.py:51 (#11)", "512->512 requant"),
            ("requant", "qasr_tpu/kernels/requant.py:65,74 (#10)", "C=512 int32 per-channel input"),
            ("int_attention", "qasr_tpu/kernels/int_attention.py:170", "int_attention B="),
            ("conv_block", "qasr_tpu/kernels/conf_module.py:341", "conv_block B="),
            ("lin_epilogue", "qasr_tpu/kernels/gemm_fused.py:159", "q_u 256->256"),
            ("ffn_ln", "qasr_tpu/kernels/conf_module.py:206", "ff1 + ln_att")]:
        r = next(r for r in rows if label in r["shape"])
        kernels.append(kernel_row(kind, replaces, r, counts[kind]))
    # Kernel 5 at the vggnet subsampler's pre projection (launches: phase 9c's path)
    kernels.append(kernel_row("lin_epilogue", "qasr_tpu/kernels/gemm_fused.py:159", vgg_pre,
                              vgg_pre["launches"]))
    # phase 10: the uint8 forms of Kernels 1, 2 and 7 (launches: W8A8
    # QuartzNet's static_e and per_channel paths) and Kernel 8 at Jasper's
    # widest site (launches: W8A8 Jasper10x5Dr's static_e path)
    qn8 = w8a8_counts["quartznet15x5 W8A8 static_e"]
    for kind, replaces, label, launches in [
            ("dw_conv", "qasr_tpu/kernels/cm_fused.py:248 (#1), with uint8 codes",
             "C=512 K=75 u8 in", qn8["dw_conv"]),
            ("pw_gemm", "qasr_tpu/kernels/cm_fused.py:131 (#4), with uint8 codes",
             "512->512 requant u8 out", qn8["pw_gemm"]),
            ("requant", "qasr_tpu/kernels/requant.py:65,74 (#10), with uint8 codes",
             "C=512 int32 per-channel -> u8",
             w8a8_counts["quartznet15x5 W8A8 per_channel"]["requant"]),
            ("dense_conv", "none: XLA's integer conv, qasr_tpu/models/jasper.py:332 (conv_nwc)",
             "K=29 768->896", w8a8_counts["jasper10x5dr W8A8 static_e"]["dense_conv"])]:
        r = next(r for r in w8a8_rows if label in r["shape"])
        kernels.append(kernel_row(kind, replaces, r, launches))
    # phase 11: the grouped forms of Kernels 2 and 8 (launches: QuartzNet15x5-g4's
    # static_e path; the Jasper-width grouped block's)
    for kind, replaces, label, launches in [
            ("pw_gemm", "none: XLA's grouped_conv1d, qasr_tpu/ops/grouped_conv.py:45 (from "
             "qasr_tpu/models/jasper.py:390-392), and group_shuffle, jasper.py:415",
             "pw_gemm grouped g=4 N=49152 512->512",
             g_counts["quartznet15x5_g4 W6A6 static_e"]["pw_gemm_grouped"]),
            ("dense_conv", "none: XLA's grouped integer conv, qasr_tpu/ops/grouped_conv.py "
             "(conv_nwc, qasr_tpu/models/jasper.py:332), with GroupShuffle",
             "dense_conv grouped g=4",
             g_counts["jasper_grouped_block W6A6 static_e"]["dense_conv_grouped"])]:
        r = next(r for r in g_rows if label in r["shape"])
        row = kernel_row(kind, replaces, r, launches)
        row["source"] = f"qasr_tpu_torch/kernels/csrc/{kind}_grouped.cu"
        kernels.append(row)
    # phase 12: the cache forms of Kernels 3 and 4 (launches: the cache-aware
    # stream of phase 12b)
    for kind, replaces, label in [
            ("int_attention_cached", "qasr_tpu/kernels/int_attention.py:170 (#12), cache form: "
             "the stream step's XLA composition, qasr_tpu/quantize/conformer_freeze.py:803-824",
             "int_attention_cached B=32 n=4 "),
            ("conv_block_cached", "qasr_tpu/kernels/conf_module.py:341 (#13), cache form: the "
             "stream step's XLA composition, qasr_tpu/quantize/conformer_freeze.py:825-835",
             "conv_block_cached B=32 n=4 ")]:
        r = next(r for r in s_rows if label in r["shape"])
        row = kernel_row(kind, replaces, r, s_counts["stream"][kind])
        row["source"] = ("qasr_tpu_torch/kernels/csrc/int_attention.cu"
                         if kind == "int_attention_cached" else
                         "qasr_tpu_torch/kernels/csrc/conv_block_cached.cu")
        row["floor_ms"] = r["floor_ms"]
        kernels.append(row)
    # phase 13: Kernel 9 (launches: the frozen Conformer-Transducer's main path
    # of phase 13b: one rnnt_greedy a decode, the start-of-sequence pred step;
    # rnnt_joint is off the main path since rnnt_greedy took the loop)
    for kind, replaces, label in [
            ("rnnt_pred", "none: XLA ops, qasr_tpu/quantize/rnnt_freeze.py:157-196 "
             "(pred_step_frozen); on the main path the start-of-sequence step",
             f"rnnt_pred H=320 L=1 B={RNNT_BATCH}"),
            ("rnnt_joint", "none: XLA ops, qasr_tpu/quantize/rnnt_freeze.py:199-217 "
             "(joint_logits_frozen) and the host argmax, :266; off the main path (the host "
             "loop that 13c times as rnnt_greedy's was)",
             f"rnnt_joint De=256 J=320 V+1=29 B={RNNT_BATCH}"),
            ("rnnt_greedy", "none: the greedy loop of XLA ops driven from the host, "
             "qasr_tpu/quantize/rnnt_freeze.py:251-278 (pred_step_frozen :157-196, "
             "joint_logits_frozen :199-217)", "rnnt_greedy H=320 L=1 B=1 T="
             f"{RNNT_CHUNK_FRAMES} bias 0")]:
        r = next(r for r in t_rows if r["shape"] == label)
        row = kernel_row(kind, replaces, r, t_counts[kind])
        row["source"] = "qasr_tpu_torch/kernels/csrc/rnnt_decoder.cu"
        kernels.append(row)
    # phase 14: Kernel 10's two entries (launches: the transducer's golden
    # training steps of 14b, on the logits entry)
    kernels.extend(rnnt_loss_rows(chk, tr_rows, tr_counts))
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    log(f"[6] whole smoke run {report['seconds']:.1f} s")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
