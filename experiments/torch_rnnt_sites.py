"""Kernel 9 (the transducer decoder: rnnt_greedy, the whole greedy decode in
one launch, and the step kernels rnnt_pred_step and rnnt_joint) and the
frozen Conformer-Transducer on a GPU.

    python3 experiments/torch_rnnt_sites.py [--checks] [--greedy] [--time] [--exchange] \
        [--turns] [--phase13] [--profile] [--fallback] [--out PATH]

Every run builds the kernels and prints ptxas's lines for Kernel 9.
--checks runs chip_smoke.py's phase 13a checks of the step kernels (both
entries against their plain versions over the grid, exact); --greedy its
rnnt_greedy checks (``phase_rnnt_greedy``: against rnnt_greedy_plain,
exact, each shape in the form that its shared-memory plan picks, and past
one wave of clusters in both forms).  --time times the three entries at
their timed shapes beside their bounds and plain versions (chip_smoke.py's
``time_rnnt_kernels``).  --exchange measures the latency floor of a
rnnt_greedy step's exchange (``exchange_floor``: a push into every CTA's
shared memory and one barrier.cluster a round, and the barrier alone) at 1
and 16 clusters of 8 CTAs.  --turns builds the frozen flagship transducer
and its blank-biased head and times the B=32 x 15 s greedy decode on
rnnt_greedy against the former host loop on the step kernels, in turns
(chip_smoke.py's ``phase_rnnt_time``).  --phase13 runs the whole of
chip_smoke.py's phase 13 (the checks, the golden record and the main
path's launches, the B=32 x 15 s encoder / decoder split, the streamer,
the .qasr round trip, the beam searches against the CPU).  --profile runs
the flagship's frozen greedy decode over B=32 and B=1 x 15 s of seeded
noise under cProfile and prints the host functions that take its time.
--fallback reads both entries at the serving shapes (B 32 and 1) twice
each through ``device_ms``'s profiler and through its events fallback
(forced by a kernel name that matches nothing), beside CUDA events around
single calls.  The helpers are this checkout's chip_smoke.py.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_decode(cs, dev, card):
    """The frozen greedy decode's host time by function (cProfile), B=32
    and B=1 x 15 s, after one warm-up decode each."""
    import cProfile
    import pstats
    import time

    import numpy as np
    import torch

    from qasr_tpu_torch import golden

    model = golden.rnnt_conformer16x256_w8a8()
    n = int(16000 * cs.RNNT_SECONDS)
    for b in (cs.RNNT_BATCH, 1):
        audio = (np.random.default_rng(32).normal(size=(b, n)) * 0.1).astype(np.float32)
        enc, el = model.encode(audio, np.full((b,), n, np.int32), device=dev)
        model._greedy_hyps(enc, el)
        stats = {}
        prof = cProfile.Profile()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prof.enable()
        model._greedy_hyps(enc, el, stats=stats)
        torch.cuda.synchronize()
        prof.disable()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"decode B={b}: {ms:.1f} ms under cProfile, {stats['max_row_steps']} joint steps "
              f"in the longest row ({ms / stats['max_row_steps']:.4f} ms a step) [{card}]",
              flush=True)
        pstats.Stats(prof).sort_stats("tottime").print_stats(18)


def fallback_readings(cs, dev, card):
    """Kernel 9's device ms by the profiler and by device_ms's events
    fallback, and the per-call event ms, at the serving shapes."""
    import statistics

    import numpy as np
    import torch

    from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_joint, rnnt_pred_step

    rng = np.random.default_rng(131)
    cfg, tables = cs.rnnt_decoder_tables(dev, 320, 1, 320, 29, seed=0)
    out = []
    for b in (cs.RNNT_BATCH, 1):
        tok, h8, c = cs.rnnt_pred_inputs(rng, dev, cfg, b)
        emit = cs.emit_masks(rng, dev, b)[2].to(torch.int32)
        e = torch.from_numpy(rng.normal(size=(b, 3, 256)).astype(np.float32)).to(dev)[:, 1]
        g8 = torch.from_numpy(rng.integers(-127, 128, (b, 320)).astype(np.int8)).to(dev)
        for name, fn in (("rnnt_pred", lambda: rnnt_pred_step(tables, tok, h8, c, emit)),
                         ("rnnt_joint", lambda: rnnt_joint(tables, e, g8))):
            for rep in range(2):
                prof = cs.device_ms(fn, cs.KERNEL_SYMBOLS[name])
                ev = cs.device_ms(fn, "no_such_kernel")
                call = statistics.median(cs.cuda_ms(fn, reps=10))
                out.append({"kernel": name, "batch": b, "profiler_ms": prof[0],
                            "profiler_by": prof[1], "fallback_ms": ev[0],
                            "fallback_by": ev[1], "call_ms": call})
                print(f"{name} B={b} rep {rep}: {prof[0]:.5f} ms ({prof[1]}), fallback "
                      f"{ev[0]:.5f} ms ({ev[1]}), a call by events {call:.5f} ms [{card}]",
                      flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checks", action="store_true")
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--exchange", action="store_true")
    ap.add_argument("--turns", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--phase13", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--fallback", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_rnnt_sites: needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from qasr_tpu_torch.kernels import _build

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    _build.library()
    ours = False   # the lines of Kernel 9's entries, from each "Compiling entry" on
    for line in _build.BuildInfo.log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            ours = "rnnt" in line or "cluster_exchange" in line
        if ours and any(k in line for k in ("registers", "spill", "Compiling entry", "smem")):
            print("ptxas:", line.strip())
    chk, report, rows = cs.Checker(), {"card": card}, []
    if args.checks:
        cs.phase_rnnt_kernels(chk, dev)
    if args.greedy:
        report["greedy_forms"] = cs.phase_rnnt_greedy(chk, dev)
    if args.time:
        cs.time_rnnt_kernels(chk, dev, card, rows)
        for r in rows:
            print(json.dumps(r), flush=True)
        report["rows"] = rows
    if args.exchange:
        report["exchange"] = [cs.exchange_floor(dev, card, n) for n in (1, 16)]
    if args.turns:
        from qasr_tpu_torch import golden

        models = {"cap-bound (golden)": golden.rnnt_conformer16x256_w8a8(),
                  f"blank bias +{cs.RNNT_BLANK_BIAS:g}": golden.rnnt_conformer16x256_w8a8(
                      blank_bias=cs.RNNT_BLANK_BIAS)}
        cs.phase_rnnt_time(models, dev, card, report)
    if args.phase13:
        report["phase13"] = cs.phase_transducer(chk, dev, card, report)[0]
    if args.profile:
        profile_decode(cs, dev, card)
    if args.fallback:
        report["fallback"] = fallback_readings(cs, dev, card)
    print(f"{chk.n} exact comparisons; max |d| {chk.max_err}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
