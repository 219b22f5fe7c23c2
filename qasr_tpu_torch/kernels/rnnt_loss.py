"""Kernel 10: the RNN-Transducer loss and its gradient (kernels/csrc/rnnt_loss.cu).

``rnnt_loss(blank_lp, emit_lp, input_lengths, target_lengths)`` is each
utterance's negative log-likelihood over the (T, U+1) lattice, from the
blank log-probs (B, T, U+1) and the target labels' log-probs (B, T, U)
(float32), differentiable in both through a ``torch.autograd.Function``:
the forward kernel computes alpha by anti-diagonals and keeps it (double,
(B, T, U+1)) with ll for the backward kernel, which computes beta the same
way and writes every lattice cell's occupancy gradient (see the .cu).
Lengths are clamped to T_b in [1, T] and U_b in [0, U].

Replaces no Pallas kernel: the JAX package's loss is a lax.scan over the
anti-diagonals (qasr_tpu/models/rnnt.py:156-216, rnnt_loss_wavefront),
differentiated by autodiff.  ``rnnt_loss_plain`` is that wavefront in
torch, differentiated by autograd.  The wrapper runs the plain version for
CPU tensors and launches the kernels for CUDA tensors (``launches`` counts
both the forward and the backward launch); it never falls back from one to
the other.  Shape limit: two diagonals of U + 1 doubles in one block's
shared memory, U + 1 <= SMEM_LIMIT / 16.
"""
from __future__ import annotations

import torch

from qasr_tpu_torch.kernels import _build

NEG_INF = -1e30       # the JAX package's stand-in for -inf in the lattice
SMEM_LIMIT = 232448   # dynamic shared memory one block may use on an H100


def _clamped(input_lengths: torch.Tensor, target_lengths: torch.Tensor, t_max: int, u_max: int):
    return (input_lengths.to(torch.int64).clamp(1, t_max),
            target_lengths.to(torch.int64).clamp(0, u_max))


def rnnt_loss_plain(blank_lp: torch.Tensor, emit_lp: torch.Tensor, input_lengths: torch.Tensor,
                    target_lengths: torch.Tensor) -> torch.Tensor:
    """Plain torch version (the JAX package's wavefront, -1e30 for -inf):
    same arguments and result as ``rnnt_loss``."""
    rnnt_loss_plain.launches += 1
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


rnnt_loss_plain.launches = 0


def smem_bytes(u_max: int) -> int:
    return 2 * (u_max + 1) * 8


def _check(blank_lp: torch.Tensor, emit_lp: torch.Tensor, input_lengths: torch.Tensor,
           target_lengths: torch.Tensor):
    b, t_max, u1 = blank_lp.shape
    if t_max < 1 or emit_lp.shape != (b, t_max, u1 - 1):
        raise ValueError(f"rnnt_loss: blank_lp (B, T, U+1) with T >= 1 and emit_lp "
                         f"(B, T, U), got {tuple(blank_lp.shape)} and {tuple(emit_lp.shape)}")
    for name, t in (("blank_lp", blank_lp), ("emit_lp", emit_lp)):
        if t.dtype != torch.float32:
            raise ValueError(f"rnnt_loss: {name} must be float32, got {t.dtype}")
    for name, t in (("input_lengths", input_lengths), ("target_lengths", target_lengths)):
        if t.shape != (b,) or t.device != blank_lp.device:
            raise ValueError(f"rnnt_loss: {name} must be ({b},) on {blank_lp.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if smem_bytes(u1 - 1) > SMEM_LIMIT:
        raise ValueError(f"rnnt_loss: U = {u1 - 1} needs {smem_bytes(u1 - 1)} bytes of "
                         f"shared memory, above {SMEM_LIMIT} (U + 1 <= {SMEM_LIMIT // 16})")


class _RNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blank_lp, emit_lp, input_lengths, target_lengths):
        b, t_max, u1 = blank_lp.shape
        dev = blank_lp.device
        blank_lp, emit_lp = blank_lp.contiguous(), emit_lp.contiguous()
        il = input_lengths.to(torch.int32).contiguous()
        tl = target_lengths.to(torch.int32).contiguous()
        alpha = torch.empty((b, t_max, u1), dtype=torch.float64, device=dev)
        ll = torch.empty((b,), dtype=torch.float64, device=dev)
        nll = torch.empty((b,), dtype=torch.float32, device=dev)
        p = _build.ptr
        rc = _build.library().qasr_rnnt_loss_fwd(
            p(blank_lp), p(emit_lp), p(il), p(tl), p(alpha), p(ll), p(nll), b, t_max, u1 - 1,
            _build.stream_of(blank_lp))
        _build.check(rc, "rnnt_loss (forward)")
        rnnt_loss.launches += 1
        ctx.save_for_backward(blank_lp, emit_lp, il, tl, alpha, ll)
        return nll

    @staticmethod
    def backward(ctx, grad_nll):
        blank_lp, emit_lp, il, tl, alpha, ll = ctx.saved_tensors
        b, t_max, u1 = blank_lp.shape
        g = grad_nll.to(torch.float32).contiguous()
        gblank = torch.empty_like(blank_lp)
        gemit = torch.empty_like(emit_lp)
        p = _build.ptr
        rc = _build.library().qasr_rnnt_loss_bwd(
            p(blank_lp), p(emit_lp), p(il), p(tl), p(alpha), p(ll), p(g), p(gblank), p(gemit),
            b, t_max, u1 - 1, _build.stream_of(blank_lp))
        _build.check(rc, "rnnt_loss (backward)")
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
