"""Data-free synthetic calibration data (port of qasr_tpu/quantize/synth.py).

Zero-shot quantization's data: random mel inputs optimized so that every
pre-BN conv output's batch statistics match the BN running statistics,
under a per-channel Gaussian KL loss, with Adam on the input and a
ReduceLROnPlateau(patience=25, factor=0.1, min_lr=1e-4) schedule.  The
teacher is ``FloatExec`` on the model's unfolded params; the loss's
gradient comes from torch autograd, forward and backward in full float32
(TF32 off).  The ``num_batch`` problems are
independent and run one after another, each with its own BN statistics.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import as_device, no_tf32
from qasr_tpu_torch.models.jasper import EncoderPlan, FloatExec, encoder_forward
from qasr_tpu_torch.quantize.ranges import params_to_device

EPS = 1e-6


def bn_targets(plan: EncoderPlan, enc_params) -> Tuple[tuple, tuple]:
    """(running mean, sqrt(running var + 1e-6)) of every BN site, in walk
    order; params are torch tensors."""
    means, stds = [], []
    for bp, bparams in zip(plan.blocks, enc_params["blocks"]):
        for spec, p in zip(bp.convs, bparams["convs"]):
            if spec.has_bn:
                means.append(p["bn"]["mean"])
                stds.append(torch.sqrt(p["bn"]["var"] + EPS))
        for p in bparams["res"]:
            means.append(p["bn"]["mean"])
            stds.append(torch.sqrt(p["bn"]["var"] + EPS))
    return tuple(means), tuple(stds)


def _kl_loss(bn_mean, bn_std, tmp_mean, tmp_std):
    a = torch.log(tmp_std / bn_std)
    c = (bn_std ** 2 + (bn_mean - tmp_mean) ** 2) / tmp_std ** 2
    b = 0.5 * (1.0 - c)
    return torch.mean(a - b)


def distill_loss(plan: EncoderPlan, enc_params, x: torch.Tensor, lens: torch.Tensor,
                 targets) -> torch.Tensor:
    """The sum over BN sites of the KL between the BN running statistics
    and the batch statistics of x (B, T, C)'s pre-BN conv outputs."""
    ex = FloatExec(enc_params, activation=plan.activation, collect_bn_stats=True)
    encoder_forward(ex, plan, x, lens)
    total = 0.0
    for (m, v), bm, bs in zip(ex.bn_stats, *targets):
        total = total + _kl_loss(bm, bs, m, torch.sqrt(v + EPS))
    return total


def backward_no_tf32(loss_fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor) -> torch.Tensor:
    """loss_fn(x) and its backward into ``x.grad``, both with TF32 off (the
    backward's convs and matmuls too); returns the loss.  Every synthesis
    step runs through here."""
    with no_tf32():
        loss = loss_fn(x)
        loss.backward()
    return loss


def loss_and_backward(plan: EncoderPlan, enc_params, x: torch.Tensor, lens: torch.Tensor,
                      targets) -> torch.Tensor:
    """``distill_loss`` and its backward (``backward_no_tf32``)."""
    return backward_no_tf32(lambda v: distill_loss(plan, enc_params, v, lens, targets), x)


def _capture_step(loss_fn, x: torch.Tensor, opt) -> Tuple[torch.cuda.CUDAGraph, torch.Tensor]:
    """One iteration (forward, backward, Adam step) captured in a CUDA
    graph, and its loss tensor.  Three warm-up steps on a side stream make
    the lazy initializations and the optimizer's state; x and that state
    are then reset, so the first replay is the first step."""
    x0 = x.detach().clone()
    side = torch.cuda.Stream(x.device)
    side.wait_stream(torch.cuda.current_stream(x.device))
    with torch.cuda.stream(side):
        for _ in range(3):
            opt.zero_grad(set_to_none=True)
            backward_no_tf32(loss_fn, x)
            opt.step()
    torch.cuda.current_stream(x.device).wait_stream(side)
    with torch.no_grad():
        x.copy_(x0)
        for state in opt.state.values():
            for v in state.values():
                v.zero_()
    graph = torch.cuda.CUDAGraph()
    opt.zero_grad(set_to_none=True)
    with torch.cuda.graph(graph):
        loss = backward_no_tf32(loss_fn, x)
        opt.step()
    return graph, loss


def optimize_input(loss_fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor, *,
                   train_iter: int, lr: float) -> Tuple[torch.Tensor, List[float]]:
    """Minimize loss_fn over its input from x0: ``train_iter`` Adam steps
    (torch's defaults) under the plateau schedule, which reads each step's
    loss.  Returns (the input, the losses).  On CUDA an iteration is one
    CUDA graph replay (an eager loop is bound by its thousands of kernel
    launches), with a capturable Adam whose learning rate is a device
    tensor the schedule updates in place."""
    x = x0.detach().clone().requires_grad_(True)
    graphed = x.device.type == "cuda"
    lr_t = torch.tensor(float(lr), device=x.device) if graphed else lr
    opt = torch.optim.Adam([x], lr=lr_t, capturable=graphed)
    sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
        opt, mode="min", factor=0.1, patience=25, threshold=1e-4, min_lr=1e-4)
    if graphed:
        graph, loss = _capture_step(loss_fn, x, opt)
    losses: List[float] = []
    for _ in range(train_iter):
        if graphed:
            graph.replay()
        else:
            opt.zero_grad(set_to_none=True)
            loss = backward_no_tf32(loss_fn, x)
            opt.step()
        losses.append(loss.item())
        sched.step(losses[-1])
        group = opt.param_groups[0]
        if graphed and group["lr"] is not lr_t:  # the graph reads lr_t
            lr_t.fill_(float(group["lr"]))
            group["lr"] = lr_t
    return x.detach(), losses


def synthesize_batch(plan: EncoderPlan, enc_params, x0: torch.Tensor, *,
                     train_iter: int, lr: float, targets) -> Tuple[torch.Tensor, List[float]]:
    """One distillation problem from the start point x0 (B, T, C):
    ``optimize_input`` on ``distill_loss``.  Returns (the batch, the
    losses)."""
    lens = torch.full((x0.shape[0],), x0.shape[1], dtype=torch.int32, device=x0.device)
    return optimize_input(lambda x: distill_loss(plan, enc_params, x, lens, targets), x0,
                          train_iter=train_iter, lr=lr)


def start_points(num_batch: int, batch_size: int, seqlen: int, dim: int,
                 seed: int) -> List[torch.Tensor]:
    """The problems' start points, U(-0.3, 0.3), drawn in turn from one CPU
    ``torch.Generator`` seeded with ``seed`` (so every device starts alike)."""
    g = torch.Generator().manual_seed(seed)
    return [torch.empty((batch_size, seqlen, dim)).uniform_(-0.3, 0.3, generator=g)
            for _ in range(num_batch)]


def get_synthetic_data(plan: EncoderPlan, enc_params, *, batch_size: int = 8,
                       dim: int = 64, seqlen: int = 500, train_iter: int = 200,
                       num_batch: int = 1, lr: float = 0.01, seed: int = 0,
                       verbose: bool = True, device=None,
                       x0: Optional[Sequence] = None, return_losses: bool = False):
    """``num_batch`` synthetic (B, T, C) batches on ``device`` (None: the
    CUDA device).  ``enc_params`` are the unfolded encoder params (numpy or
    torch); ``x0`` replaces the seeded start points.  With
    ``return_losses``, returns (batches, per-problem loss lists)."""
    dev = as_device(device)
    params = params_to_device(enc_params, dev)
    targets = bn_targets(plan, params)
    starts = start_points(num_batch, batch_size, seqlen, dim, seed) if x0 is None else x0
    out, all_losses = [], []
    for i, start in enumerate(starts):
        t0 = time.perf_counter()
        start = start if isinstance(start, torch.Tensor) else torch.from_numpy(
            np.array(start, np.float32))
        x, losses = synthesize_batch(plan, params, start.to(dev, torch.float32),
                                     train_iter=train_iter, lr=lr, targets=targets)
        out.append(x)
        all_losses.append(losses)
        if verbose:
            print(f"Distillation: {i + 1} / {len(starts)} (final loss: {losses[-1]:.4f}; "
                  f"{(time.perf_counter() - t0) / max(train_iter, 1) * 1e3:.1f} ms an "
                  f"iteration)", flush=True)
    return (out, all_losses) if return_losses else out
