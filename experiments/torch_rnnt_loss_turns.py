"""Kernel 10 against an earlier tree of the port, in turns, on one GPU.

    python3 experiments/torch_rnnt_loss_turns.py --parent DIR [--step] [--out PATH]

DIR is an unpacked earlier commit of the repository (``git archive``
into a directory that .gitignore lists).  Each turn is a process of its
own that imports ``qasr_tpu_torch`` from one tree (its kernels built
there); the turns run parent, change, change, parent.

- loss: at (B, T, U, V+1) = (16, 375, 166, 29), (3, 500, 300, 29) and
  (16, 375, 48, 1,025), one seeded set of logits (ragged lengths, row 0 at
  the full T and U): the transducer loss of the logits, forward and
  backward, as each tree's training path computes it.  The parent's:
  torch.log_softmax, the lattice's gather, Kernel 10 on the log-probs,
  autograd's scatter and log-softmax backward.  A tree with
  ``rnnt_loss_from_logits``: that entry (and the chain around its
  log-probs entry too).  Device ms of every kernel the call launches
  (torch.profiler over 10 calls), Kernel 10's own kernels' ms, the call by
  CUDA events (median of 10), peak memory above the inputs.
- step (--step): chip_smoke.py phase 14c's Conformer-Transducer B=16 x 15 s
  training step from each tree (dropout 0.1, median of 5 after 2 warm-ups
  by CUDA events) and Kernel 10's device ms in one profiled step.

Prints one JSON line a turn and writes them all to --out, if given.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((16, 375, 166, 28), (3, 500, 300, 28), (16, 375, 48, 1024))
SEED = 21


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def events_ms(fn, reps=10, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def profiled_ms(fn, symbols, calls=10):
    """(device ms a call of every CUDA kernel, of the kernels named by
    ``symbols``, kernel records seen) over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = mine = 0.0
    seen = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        total += us
        if any(s in ev.key for s in symbols):
            mine += us
            seen += ev.count
    return total / 1e3 / calls, mine / 1e3 / calls, seen


def peak_gib(fn):
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def turn_loss(root):
    import numpy as np
    import torch

    from qasr_tpu_torch.kernels import rnnt_loss as K10
    from qasr_tpu_torch.models.rnnt import lattice_log_probs

    dev = torch.device("cuda", 0)
    new = hasattr(K10, "rnnt_loss_from_logits")
    k10 = ("rnnt_lse", "rnnt_lattice", "rnnt_grad", "rnnt_diag", "rnnt_occ", "rnnt_alpha",
           "rnnt_beta")
    out = []
    for b, t, u, v in SHAPES:
        rng = np.random.default_rng(SEED)
        x = torch.from_numpy(rng.normal(size=(b, t, u + 1, v + 1)).astype(np.float32)).to(dev)
        tg = torch.from_numpy(rng.integers(0, v, size=(b, u))).to(dev)
        il = rng.integers(max(1, t // 2), t + 1, size=b)
        tl = rng.integers(0, u + 1, size=b)
        il[0], tl[0] = t, u
        il = torch.from_numpy(il.astype(np.int32)).to(dev)
        tl = torch.from_numpy(tl.astype(np.int32)).to(dev)
        x.requires_grad_()

        def chain():
            bl, em = lattice_log_probs(torch.log_softmax(x, dim=-1), tg, v)
            return torch.autograd.grad(K10.rnnt_loss(bl, em, il, tl).sum(), x)

        paths = {"chain": chain}
        if new:
            paths["logits"] = lambda: torch.autograd.grad(
                K10.rnnt_loss_from_logits(x, tg, il, tl, v).sum(), x)
        row = {"shape": [b, t, u, v + 1]}
        for name, fn in paths.items():
            g = fn()[0]
            torch.cuda.synchronize()
            nll_fn = (K10.rnnt_loss_from_logits(x.detach(), tg, il, tl, v) if name == "logits"
                      else K10.rnnt_loss(*lattice_log_probs(torch.log_softmax(x.detach(), -1),
                                                            tg, v), il, tl))
            total, mine, seen = profiled_ms(fn, k10)
            row[name] = {"device_ms": total, "kernel10_ms": mine, "kernel10_records": seen,
                         "call_ms": events_ms(fn), "peak_gib": peak_gib(fn),
                         "nll_sum": float(nll_fn.double().sum()),
                         "grad_abs_sum": float(g.double().abs().sum())}
            del g
        out.append(row)
        del x
        torch.cuda.empty_cache()
    return {"loss": out}


def turn_step(root):
    import dataclasses

    import torch

    import chip_smoke as C
    from qasr_tpu_torch.train import golden as G

    dev = torch.device("cuda", 0)
    name = "rnnt_conformer16x256"
    model = G.train_model(name)
    model.plan = dataclasses.replace(model.plan, dropout=C.CONF_TRAIN_DROPOUT)
    tr = G.make_trainer(name, model, dev)
    b = C.TRAIN_BATCH[name]
    batch = C.train_batch(b, list(model.cfg.labels), seed=40 + b, dev=dev)
    times = C.cuda_ms(lambda: tr.train_step(batch), reps=5, warmup=2)
    groups, busy, prof_ms = C.profile_step(lambda: tr.train_step(batch))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return {"step": {"batch": b, "step_ms": statistics.median(times), "samples_ms": times,
                     "kernel10_device_ms": groups["rnnt_loss"], "kernels_device_ms": busy,
                     "profiled_step_ms": prof_ms, "peak_gib": peak}}


def child(root, what):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import qasr_tpu_torch

    assert os.path.dirname(os.path.abspath(qasr_tpu_torch.__file__)).startswith(root)
    from qasr_tpu_torch.kernels import _build

    _build.library()
    res = turn_loss(root) if what == "loss" else turn_step(root)
    res.update(root=root, what=what, card=card_line())
    print("TURN " + json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="an unpacked earlier tree")
    ap.add_argument("--step", action="store_true", help="also the transducer's step, in turns")
    ap.add_argument("--out", help="write the turns as JSON here")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--what", default="loss", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.what)
    import torch

    if not torch.cuda.is_available():
        print("torch_rnnt_loss_turns: no CUDA device", file=sys.stderr)
        return 2
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    turns = []
    for what in ("loss", "step") if args.step else ("loss",):
        for tag, root in (("parent", args.parent), ("change", change), ("change", change),
                          ("parent", args.parent)):
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                                "--what", what], capture_output=True, text=True, timeout=1200)
            line = next((ln for ln in p.stdout.splitlines() if ln.startswith("TURN ")), None)
            if p.returncode != 0 or line is None:
                print(p.stdout[-3000:], p.stderr[-6000:], file=sys.stderr)
                raise SystemExit(f"turn {tag} {what} failed (exit {p.returncode})")
            res = dict(json.loads(line[5:]), tag=tag)
            turns.append(res)
            print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(turns, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
