"""CTC loss (port of qasr_tpu/train/ctc_loss.py).

``F.ctc_loss`` (reduction "none", blank = V, the last index) gives each
sample's negative log-likelihood; the four reductions follow the JAX
package.  Two conventions differ from optax's and are handled here:

  - ``F.ctc_loss``'s backward returns exp(lp) - gamma for the log-probs,
    which is the gradient with respect to the logits under a
    log_softmax, not with respect to the log-probs themselves; through
    the model's log_softmax the logits' and parameters' gradients equal
    optax's (which applies its own log_softmax), so hold gradients there;
  - a sample with no alignment (too few frames for its labels and
    repeats) is inf in torch; optax gives a large finite loss from its
    log-epsilon (-1e5) recursion.  Those samples, found from the lengths,
    are recomputed by ``optax_ctc_plain`` (optax's recursion in torch,
    differentiated by autograd), so their value and gradient are optax's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LOG_EPSILON = -1e5   # optax.ctc_loss's log_epsilon


def optax_ctc_plain(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                    targets: torch.Tensor, target_lengths: torch.Tensor,
                    blank_id: int) -> torch.Tensor:
    """Per-sample CTC NLL by optax.ctc_loss's recursion (log_softmax of the
    input, phi / emit states, log-epsilon for forbidden moves), a loop over
    T; (B, T, V+1), (B,), (B, L), (B,) -> (B,)."""
    b, t_max, _ = log_probs.shape
    n = targets.shape[1]
    lp = torch.log_softmax(log_probs, dim=-1)
    targets = targets.to(torch.int64)
    dev = lp.device
    repeat = torch.zeros((b, n), dtype=lp.dtype, device=dev)
    if n > 1:
        repeat[:, :-1] = (targets[:, :-1] == targets[:, 1:]).to(lp.dtype)
    lp_phi = lp[:, :, blank_id:blank_id + 1]                          # (B, T, 1)
    lp_emit = torch.gather(lp, 2, targets[:, None, :].expand(b, t_max, n))  # (B, T, N)
    pads = (torch.arange(t_max, device=dev)[None, :]
            >= input_lengths.to(dev)[:, None]).to(lp.dtype)            # (B, T)
    phi = torch.full((b, n + 1), LOG_EPSILON, dtype=lp.dtype, device=dev)
    phi = torch.cat([torch.zeros((b, 1), dtype=lp.dtype, device=dev), phi[:, 1:]], dim=1)
    emit = torch.full((b, n), LOG_EPSILON, dtype=lp.dtype, device=dev)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], dim=1)

    for t in range(t_max):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + LOG_EPSILON * repeat)
        le, lph, pad = lp_emit[:, t], lp_phi[:, t], pads[:, t:t + 1]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + le, emit + le)
        next_phi = update_phi(prev_phi + lph, emit + lph + LOG_EPSILON * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = update_phi(phi, emit)
    return -torch.gather(last, 1, target_lengths.to(dev, torch.int64)[:, None])[:, 0]


def alignable(input_lengths: torch.Tensor, targets: torch.Tensor,
              target_lengths: torch.Tensor) -> torch.Tensor:
    """(B,) bool: a CTC alignment exists (frames >= labels + the repeats
    that need a blank between them)."""
    n = targets.shape[1]
    pos = torch.arange(max(n - 1, 0), device=targets.device)
    rep = (targets[:, :-1] == targets[:, 1:]) & (pos[None, :] + 1 < target_lengths[:, None])
    need = target_lengths.to(torch.int64) + rep.sum(dim=1)
    return input_lengths.to(torch.int64) >= need


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor, targets: torch.Tensor,
             target_lengths: torch.Tensor, blank_id: int,
             reduction: str = "mean_batch") -> torch.Tensor:
    """log_probs (B, T, V+1) log-softmaxed, targets (B, L) int ids ->
    the reduced loss: 'mean_batch' (mean of the per-sample NLL), 'sum',
    'mean' (each NLL over its target length, then the batch mean) or
    'none' (B,)."""
    if reduction not in ("mean_batch", "sum", "mean", "none"):
        raise ValueError(reduction)
    dev = log_probs.device
    il = input_lengths.to(dev, torch.int64)
    tl = target_lengths.to(dev, torch.int64)
    tg = targets.to(dev, torch.int64)
    per = F.ctc_loss(log_probs.transpose(0, 1), tg, il, tl, blank=blank_id,
                     reduction="none", zero_infinity=True)
    ok = alignable(il, tg, tl)
    if not bool(ok.all()):
        bad = torch.nonzero(~ok)[:, 0]
        fix = optax_ctc_plain(log_probs[bad], il[bad], tg[bad], tl[bad], blank_id)
        per = per.index_put((bad,), fix)
    if reduction == "mean_batch":
        return per.mean()
    if reduction == "sum":
        return per.sum()
    if reduction == "mean":
        return (per / tl.clamp_min(1).to(per.dtype)).mean()
    return per
