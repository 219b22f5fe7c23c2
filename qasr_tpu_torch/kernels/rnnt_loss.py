"""Kernel 10: the RNN-Transducer loss and its gradient (kernels/csrc/rnnt_loss.cu).

Two entries, each a ``torch.autograd.Function`` on CUDA tensors:

- ``rnnt_loss_from_logits(logits, targets, input_lengths, target_lengths,
  blank_id)``: each utterance's negative log-likelihood of the joint's
  float32 logits (B, T, U+1, V+1), the JAX package's
  ``rnnt_loss(log_softmax(logits))``, differentiable in ``logits``: a
  pass over the cells (each cell's log-sum-exp; the blank's and the next
  label's log-probs into diagonal-major rows), the lattice kernel (alpha
  and, when a gradient is wanted, beta side by side), and in the backward
  one pass that writes the logits' gradient.  No log-softmax tensor is
  made.
- ``rnnt_loss(blank_lp, emit_lp, input_lengths, target_lengths)``: the
  same from the lattice's blank log-probs (B, T, U+1) and the target
  labels' log-probs (B, T, U) (float32), differentiable in both: the
  log-probs into diagonal-major rows, the same lattice kernel, and in the
  backward the occupancy gradients.

Lengths are clamped to T_b in [1, T] and U_b in [0, U].  Replaces no
Pallas kernel: the JAX package's loss is a lax.scan over the
anti-diagonals (qasr_tpu/models/rnnt.py:156-216, rnnt_loss_wavefront),
differentiated by autodiff.  ``rnnt_loss_plain`` is that wavefront in
torch and ``rnnt_loss_from_logits_plain`` the same after
``torch.log_softmax`` and the lattice's gather, differentiated by
autograd.  Each wrapper runs its plain version for CPU tensors and
launches the kernels for CUDA tensors (its ``launches`` counts every
launch: 2 in a forward, 1 in a backward); it never falls back from one to
the other.  Shape limit: the lattice kernel holds two diagonals and a ring
of STAGES x 2 rows of U + 1 doubles in one block's shared memory (80
bytes a column), U + 1 <= SMEM_LIMIT / 80 = 2,905.
"""
from __future__ import annotations

from typing import Optional

import torch

from qasr_tpu_torch.kernels import _build

NEG_INF = -1e30       # the JAX package's stand-in for -inf in the lattice
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on an H100
STAGES = 4            # the lattice kernel's ring of staged rows (csrc kStages)
STAMPS = 6            # clock64 stamps a lattice round (csrc kStamps)


def _clamped(input_lengths: torch.Tensor, target_lengths: torch.Tensor, t_max: int, u_max: int):
    return (input_lengths.to(torch.int64).clamp(1, t_max),
            target_lengths.to(torch.int64).clamp(0, u_max))


def lattice_log_probs(log_probs: torch.Tensor, targets: torch.Tensor, blank_id: int):
    """(B, T, U+1, V+1) log-probs -> (blank (B, T, U+1), emit (B, T, U)):
    the blank's and each next target label's log-prob at every lattice
    cell, gathered so that autograd scatters the gradients back."""
    b, t, u1, _ = log_probs.shape
    idx = targets[:, None, :u1 - 1, None].to(torch.int64).expand(b, t, u1 - 1, 1)
    return log_probs[..., blank_id], torch.gather(log_probs[:, :, :u1 - 1], 3, idx)[..., 0]


def _wavefront(blank_lp, emit_lp, input_lengths, target_lengths):
    b, t_max, u1 = blank_lp.shape
    u_max = u1 - 1
    dev = blank_lp.device
    il, tl = _clamped(input_lengths.to(dev), target_lengths.to(dev), t_max, u_max)
    u_range = torch.arange(u1, device=dev)
    u_valid = u_range[None, :] <= tl[:, None]
    neg = torch.full((), NEG_INF, dtype=blank_lp.dtype, device=dev)
    neg_col = neg.expand(b, 1)
    alpha = torch.where(u_range[None, :] == 0, 0.0, neg).expand(b, u1)
    alpha = torch.where(u_valid, alpha, neg)
    diags = [alpha]
    for d in range(1, t_max + u_max + 1):
        t_h = (d - 1 - u_range).clamp(0, t_max - 1)
        t_v = (d - u_range).clamp(0, t_max - 1)
        horiz = alpha + blank_lp[:, t_h, u_range]
        vert = torch.cat([neg_col, alpha[:, :-1]], dim=1) + torch.cat(
            [neg_col, emit_lp[:, t_v[1:], u_range[:-1]]], dim=1)
        ok_h = (d - 1 - u_range >= 0) & (d - u_range <= t_max - 1) & (d - u_range >= 0)
        ok_v = (u_range >= 1) & (d - u_range >= 0) & (d - u_range <= t_max - 1)
        alpha = torch.logaddexp(torch.where(ok_h[None], horiz, neg),
                                torch.where(ok_v[None], vert, neg))
        alpha = torch.where(u_valid, alpha, neg)
        diags.append(alpha)
    diags = torch.stack(diags)                       # (T + U + 1, B, U + 1)
    bi = torch.arange(b, device=dev)
    final = diags[il - 1 + tl, bi, tl] + blank_lp[bi, il - 1, tl]
    return -final


def rnnt_loss_plain(blank_lp: torch.Tensor, emit_lp: torch.Tensor, input_lengths: torch.Tensor,
                    target_lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch version (the JAX package's wavefront, -1e30 for -inf):
    same arguments and result as ``rnnt_loss``."""
    rnnt_loss_plain.launches += 1
    return _wavefront(blank_lp, emit_lp, input_lengths, target_lengths)


rnnt_loss_plain.launches = 0


def rnnt_loss_from_logits_plain(logits: torch.Tensor, targets: torch.Tensor,
                                input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                                blank_id: int) -> torch.Tensor:
    """Plain torch version of ``rnnt_loss_from_logits``: the wavefront of
    the lattice's log-probs gathered from ``torch.log_softmax(logits)``."""
    rnnt_loss_from_logits_plain.launches += 1
    blank_lp, emit_lp = lattice_log_probs(torch.log_softmax(logits, dim=-1),
                                          targets.to(logits.device), blank_id)
    return _wavefront(blank_lp, emit_lp, input_lengths, target_lengths)


rnnt_loss_from_logits_plain.launches = 0


def smem_bytes(u_max: int) -> int:
    """The lattice kernel's shared memory: two diagonals and STAGES x 2
    staged rows of U + 1 doubles."""
    return (2 + 2 * STAGES) * (u_max + 1) * 8


def lattice_threads(u_max: int) -> int:
    """The lattice kernel's block: a thread a column, whole warps, <= 1,024."""
    return min(1024, -(-(u_max + 1) // 32) * 32)


def _check_lengths(name, b, dev, input_lengths, target_lengths, u_max):
    for arg, t in (("input_lengths", input_lengths), ("target_lengths", target_lengths)):
        if t.shape != (b,) or t.device != dev:
            raise ValueError(f"{name}: {arg} must be ({b},) on {dev}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if smem_bytes(u_max) > SMEM_LIMIT:
        raise ValueError(f"{name}: U = {u_max} needs {smem_bytes(u_max)} bytes of shared "
                         f"memory, above {SMEM_LIMIT} (U + 1 <= {SMEM_LIMIT // smem_bytes(0)})")


def _check(blank_lp: torch.Tensor, emit_lp: torch.Tensor, input_lengths: torch.Tensor,
           target_lengths: torch.Tensor):
    b, t_max, u1 = blank_lp.shape
    if t_max < 1 or emit_lp.shape != (b, t_max, u1 - 1):
        raise ValueError(f"rnnt_loss: blank_lp (B, T, U+1) with T >= 1 and emit_lp "
                         f"(B, T, U), got {tuple(blank_lp.shape)} and {tuple(emit_lp.shape)}")
    for name, t in (("blank_lp", blank_lp), ("emit_lp", emit_lp)):
        if t.dtype != torch.float32:
            raise ValueError(f"rnnt_loss: {name} must be float32, got {t.dtype}")
    _check_lengths("rnnt_loss", b, blank_lp.device, input_lengths, target_lengths, u1 - 1)


def _check_logits(logits: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
                  target_lengths: torch.Tensor, blank_id: int):
    if logits.dim() != 4 or logits.shape[1] < 1 or logits.dtype != torch.float32:
        raise ValueError(f"rnnt_loss_from_logits: logits (B, T, U+1, V+1) float32 with "
                         f"T >= 1, got {tuple(logits.shape)} {logits.dtype}")
    b, _, u1, v1 = logits.shape
    if not 0 <= blank_id < v1:
        raise ValueError(f"rnnt_loss_from_logits: blank_id {blank_id} outside [0, {v1})")
    if targets.dim() != 2 or targets.shape[0] != b or targets.shape[1] < u1 - 1 \
            or targets.device != logits.device:
        raise ValueError(f"rnnt_loss_from_logits: targets must be ({b}, >= {u1 - 1}) on "
                         f"{logits.device}, got {tuple(targets.shape)} on {targets.device}")
    _check_lengths("rnnt_loss_from_logits", b, logits.device, input_lengths, target_lengths,
                   u1 - 1)


def lattice(blank_d: torch.Tensor, emit_d: torch.Tensor, il: torch.Tensor, tl: torch.Tensor,
            t_max: int, two_sided: bool, stamps: Optional[torch.Tensor] = None):
    """One launch of the lattice kernel on diagonal-major log-probs (B, T+U,
    U+1) double and int32 lengths: (nll (B,) float32, ll (B,) double, alpha
    (B, T, U+1) double, hb, he (B, T, U+1) double or None).  ``stamps``: an
    int64 tensor of (grid, T + U, STAMPS) for the kernel's clock64 stamps."""
    b, _, u1 = blank_d.shape
    dev = blank_d.device
    cells = (b, t_max, u1)
    alpha = torch.empty(cells, dtype=torch.float64, device=dev)
    hb = torch.empty(cells, dtype=torch.float64, device=dev) if two_sided else None
    he = torch.empty(cells, dtype=torch.float64, device=dev) if two_sided else None
    ll = torch.empty((b,), dtype=torch.float64, device=dev)
    nll = torch.empty((b,), dtype=torch.float32, device=dev)
    p = _build.ptr
    rc = _build.library().qasr_rnnt_lattice(
        p(blank_d), p(emit_d), p(il), p(tl), p(alpha), p(hb), p(he), p(ll), p(nll), p(stamps),
        b, t_max, u1 - 1, int(two_sided), _build.stream_of(blank_d))
    _build.check(rc, "rnnt_loss (lattice)")
    return nll, ll, alpha, hb, he


def _lengths(input_lengths, target_lengths):
    return (input_lengths.to(torch.int32).contiguous(),
            target_lengths.to(torch.int32).contiguous())


def cell_pass(logits: torch.Tensor, tg: torch.Tensor, il: torch.Tensor, tl: torch.Tensor,
              blank_id: int):
    """One launch of the cell pass on contiguous float32 logits (B, T, U+1,
    V+1), int32 targets (B, U) and lengths: (lse (B, T, U+1), blank_d,
    emit_d (B, T+U, U+1) diagonal-major), all double."""
    b, t_max, u1, v1 = logits.shape
    dev = logits.device
    lse = torch.empty((b, t_max, u1), dtype=torch.float64, device=dev)
    rows = (b, t_max + u1 - 1, u1)
    blank_d = torch.empty(rows, dtype=torch.float64, device=dev)
    emit_d = torch.empty(rows, dtype=torch.float64, device=dev)
    p = _build.ptr
    rc = _build.library().qasr_rnnt_lse(
        p(logits), p(tg), p(il), p(tl), p(lse), p(blank_d), p(emit_d), b, t_max, u1 - 1, v1,
        int(blank_id), _build.stream_of(logits))
    _build.check(rc, "rnnt_loss_from_logits (cell pass)")
    return lse, blank_d, emit_d


def logits_inputs(logits: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
                  target_lengths: torch.Tensor):
    """(logits, targets (B, U) int32, lengths int32), contiguous, as the
    kernels take them."""
    u1 = logits.shape[2]
    return (logits.contiguous(), targets[:, :u1 - 1].to(torch.int32).contiguous(),
            *_lengths(input_lengths, target_lengths))


class _RNNTLossFromLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, input_lengths, target_lengths, blank_id):
        t_max = logits.shape[1]
        logits, tg, il, tl = logits_inputs(logits, targets, input_lengths, target_lengths)
        lse, blank_d, emit_d = cell_pass(logits, tg, il, tl, blank_id)
        rnnt_loss_from_logits.launches += 1
        two_sided = ctx.needs_input_grad[0]
        nll, ll, alpha, hb, he = lattice(blank_d, emit_d, il, tl, t_max, two_sided)
        rnnt_loss_from_logits.launches += 1
        if two_sided:
            ctx.save_for_backward(logits, tg, il, tl, lse, alpha, hb, he, ll)
            ctx.blank_id = int(blank_id)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        logits, tg, il, tl, lse, alpha, hb, he, ll = ctx.saved_tensors
        b, t_max, u1, v1 = logits.shape
        g = grad_nll.to(torch.float32).contiguous()
        grad = torch.empty_like(logits)
        p = _build.ptr
        rc = _build.library().qasr_rnnt_grad(
            p(logits), p(tg), p(il), p(tl), p(lse), p(alpha), p(hb), p(he), p(ll), p(g),
            p(grad), b, t_max, u1 - 1, v1, ctx.blank_id, _build.stream_of(logits))
        _build.check(rc, "rnnt_loss_from_logits (gradient)")
        rnnt_loss_from_logits.launches += 1
        return grad, None, None, None, None


class _RNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, emit_lp, input_lengths, target_lengths):
        b, t_max, u1 = blank_lp.shape
        dev = blank_lp.device
        blank_lp, emit_lp = blank_lp.contiguous(), emit_lp.contiguous()
        il, tl = _lengths(input_lengths, target_lengths)
        rows = (b, t_max + u1 - 1, u1)
        blank_d = torch.empty(rows, dtype=torch.float64, device=dev)
        emit_d = torch.empty(rows, dtype=torch.float64, device=dev)
        p = _build.ptr
        rc = _build.library().qasr_rnnt_diag(
            p(blank_lp), p(emit_lp), p(il), p(tl), p(blank_d), p(emit_d), b, t_max, u1 - 1,
            _build.stream_of(blank_lp))
        _build.check(rc, "rnnt_loss (diagonals)")
        rnnt_loss.launches += 1
        two_sided = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        nll, ll, alpha, hb, he = lattice(blank_d, emit_d, il, tl, t_max, two_sided)
        rnnt_loss.launches += 1
        if two_sided:
            ctx.save_for_backward(il, tl, alpha, hb, he, ll)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        il, tl, alpha, hb, he, ll = ctx.saved_tensors
        b, t_max, u1 = alpha.shape
        g = grad_nll.to(torch.float32).contiguous()
        gblank = torch.empty((b, t_max, u1), dtype=torch.float32, device=alpha.device)
        gemit = torch.empty((b, t_max, u1 - 1), dtype=torch.float32, device=alpha.device)
        p = _build.ptr
        rc = _build.library().qasr_rnnt_occ(
            p(il), p(tl), p(alpha), p(hb), p(he), p(ll), p(g), p(gblank), p(gemit), b, t_max,
            u1 - 1, _build.stream_of(alpha))
        _build.check(rc, "rnnt_loss (occupancies)")
        rnnt_loss.launches += 1
        return gblank, gemit, None, None


def rnnt_loss(blank_lp: torch.Tensor, emit_lp: torch.Tensor, input_lengths: torch.Tensor,
              target_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) negative log-likelihoods of blank_lp (B, T, U+1) and emit_lp
    (B, T, U) float32 log-probs at lengths (B,); differentiable in both."""
    if blank_lp.device.type == "cpu":
        return rnnt_loss_plain(blank_lp, emit_lp, input_lengths, target_lengths)
    if blank_lp.device.type != "cuda":
        raise ValueError(f"rnnt_loss: unsupported device {blank_lp.device}")
    _check(blank_lp, emit_lp, input_lengths, target_lengths)
    return _RNNTLoss.apply(blank_lp, emit_lp, input_lengths, target_lengths)


rnnt_loss.launches = 0


def rnnt_loss_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                          input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                          blank_id: int) -> torch.Tensor:
    """(B,) negative log-likelihoods of the joint's float32 logits (B, T,
    U+1, V+1) for targets (B, >= U) at lengths (B,); differentiable in
    ``logits``."""
    if logits.device.type == "cpu":
        return rnnt_loss_from_logits_plain(logits, targets, input_lengths, target_lengths,
                                           blank_id)
    if logits.device.type != "cuda":
        raise ValueError(f"rnnt_loss_from_logits: unsupported device {logits.device}")
    _check_logits(logits, targets, input_lengths, target_lengths, blank_id)
    return _RNNTLossFromLogits.apply(logits, targets, input_lengths, target_lengths, blank_id)


rnnt_loss_from_logits.launches = 0


def round_floor(blocks: int, threads: int, rounds: int, device=None) -> None:
    """Launch the lattice's latency floor (csrc rnnt_round_floor_kernel):
    ``rounds`` rounds of a barrier and a double log-add-exp on registers
    in ``blocks`` blocks of ``threads`` threads, on the current stream (a
    measurement launch, on no training path)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"round_floor: unsupported device {dev}")
    out = torch.empty((blocks,), dtype=torch.float64, device=dev)
    rc = _build.library().qasr_rnnt_round_floor(int(blocks), int(threads), int(rounds),
                                                _build.ptr(out), _build.stream_of(out))
    _build.check(rc, "round_floor")
