"""RNN-Transducer: prediction network, joint, the loss, greedy and beam
decoding (port of qasr_tpu/models/rnnt.py).

  - the prediction network: an embedding (its blank row is the
    start-of-sequence input) and an LSTM stack, gates ordered i, f, g, o;
  - the joint: project the encoder frame and the prediction, add,
    activation, project to the vocabulary plus blank;
  - the loss: Kernel 10 (kernels/rnnt_loss.py) from the joint's logits
    (``rnnt_loss_from_logits``, training's), or from the lattice's blank
    and label log-probs gathered from log-softmaxed outputs
    (``rnnt_loss``, the JAX package's API);
  - greedy decoding: a host loop over device-stepped cells (at most
    ``max_symbols_per_step`` symbols a frame, the prediction network
    advanced only where a symbol was emitted), its carry threaded through
    ``greedy_decode_frames`` so that chunked streaming decodes exactly as
    offline;
  - beam search: the reference's three algorithms ('beam' / 'default',
    'tsd', 'alsd'), host-driven over a sequence-keyed cache of
    prediction-network steps (``_HypScorer``).

Params are the JAX package's numpy tree (``init_rnnt_params``, equal from
the same seed); the functions take them as float32 torch tensors on one
device (``quantize.ranges.params_to_device``) and compute in float32 with
TF32 off, the JAX package's ``precision=HIGHEST``.  Blank is the last id
(num_classes).  Nothing here imports jax.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import no_tf32
from qasr_tpu_torch.kernels.rnnt_loss import NEG_INF, lattice_log_probs
from qasr_tpu_torch.kernels.rnnt_loss import rnnt_loss as kernel_rnnt_loss
from qasr_tpu_torch.kernels.rnnt_loss import rnnt_loss_from_logits as kernel_rnnt_loss_from_logits


@dataclass(frozen=True)
class RNNTConfig:
    num_classes: int            # vocab size WITHOUT blank
    enc_hidden: int
    pred_hidden: int = 320
    pred_rnn_layers: int = 1
    joint_hidden: int = 320
    activation: str = "relu"
    forget_gate_bias: float = 1.0

    @property
    def blank_id(self) -> int:
        return self.num_classes


def init_rnnt_params(seed, cfg: RNNTConfig) -> Dict[str, Any]:
    """The prediction network's and the joint's params as numpy, equal to
    the JAX package's from the same seed or generator."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)

    def uni(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    h = cfg.pred_hidden
    layers = []
    for _ in range(cfg.pred_rnn_layers):
        lp = {"wi": uni((h, 4 * h), h), "wh": uni((h, 4 * h), h),
              "b": np.zeros((4 * h,), np.float32)}
        lp["b"][h: 2 * h] = cfg.forget_gate_bias   # the forget gate's bias
        layers.append(lp)
    return {
        "embed": rng.normal(0, 1.0, (cfg.num_classes + 1, h)).astype(np.float32),
        "lstm": layers,
        "joint": {
            "enc": {"w": uni((cfg.enc_hidden, cfg.joint_hidden), cfg.enc_hidden),
                    "b": np.zeros((cfg.joint_hidden,), np.float32)},
            "pred": {"w": uni((h, cfg.joint_hidden), h),
                     "b": np.zeros((cfg.joint_hidden,), np.float32)},
            "out": {"w": uni((cfg.joint_hidden, cfg.num_classes + 1), cfg.joint_hidden),
                    "b": np.zeros((cfg.num_classes + 1,), np.float32)},
        },
    }


def _device_of(params) -> torch.device:
    return params["embed"].device


class LSTMState(NamedTuple):
    h: torch.Tensor  # (layers, B, H)
    c: torch.Tensor


def lstm_init_state(cfg: RNNTConfig, batch: int, device) -> LSTMState:
    z = torch.zeros((cfg.pred_rnn_layers, batch, cfg.pred_hidden), dtype=torch.float32,
                    device=device)
    return LSTMState(z, z)


def _lstm_cell(p, x, h, c):
    gates = x @ p["wi"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c2), c2


@torch.no_grad()
def pred_step(params, cfg: RNNTConfig, token: torch.Tensor, state: LSTMState
              ) -> Tuple[torch.Tensor, LSTMState]:
    """One prediction-network step: token ids (B,) -> (B, H) and the new
    state; blank embeds the start-of-sequence row."""
    x = params["embed"][token.to(torch.int64)]
    hs, cs = [], []
    with no_tf32():
        for li, lp in enumerate(params["lstm"]):
            x, c2 = _lstm_cell(lp, x, state.h[li], state.c[li])
            hs.append(x)
            cs.append(c2)
    return x, LSTMState(torch.stack(hs), torch.stack(cs))


def pred_outputs(params, cfg: RNNTConfig, targets: torch.Tensor) -> torch.Tensor:
    """Teacher-forced prediction network over (B, U) targets -> (B, U+1, H),
    the start-of-sequence (blank) step first; differentiable in the params
    (the training path)."""
    b = targets.shape[0]
    sos = torch.full((b, 1), cfg.blank_id, dtype=targets.dtype, device=targets.device)
    x_all = params["embed"][torch.cat([sos, targets], dim=1).to(torch.int64)]
    h = [torch.zeros((b, cfg.pred_hidden), dtype=torch.float32, device=targets.device)
         for _ in params["lstm"]]
    c = list(h)
    outs = []
    with no_tf32():
        for u in range(x_all.shape[1]):
            x = x_all[:, u]
            for li, lp in enumerate(params["lstm"]):
                h[li], c[li] = _lstm_cell(lp, x, h[li], c[li])
                x = h[li]
            outs.append(x)
    return torch.stack(outs, dim=1)


@torch.no_grad()
def pred_network(params, cfg: RNNTConfig, targets: torch.Tensor) -> torch.Tensor:
    """``pred_outputs`` without gradients."""
    return pred_outputs(params, cfg, targets)


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "relu":
        return torch.relu(x)
    if kind == "tanh":
        return torch.tanh(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    return x


def joint_logits(params, cfg: RNNTConfig, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(B, T, De) x (B, U+1, Dp) -> (B, T, U+1, V+1) logits: project both,
    add, activation, project to the vocabulary (differentiable)."""
    jp = params["joint"]
    with no_tf32():
        f = enc @ jp["enc"]["w"] + jp["enc"]["b"]
        g = pred @ jp["pred"]["w"] + jp["pred"]["b"]
        x = _activation(f[:, :, None, :] + g[:, None, :, :], cfg.activation)
        return x @ jp["out"]["w"] + jp["out"]["b"]


@torch.no_grad()
def joint(params, cfg: RNNTConfig, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """``joint_logits`` without gradients."""
    return joint_logits(params, cfg, enc, pred)


# ---------------------------------------------------------------------------
# the RNNT loss
# ---------------------------------------------------------------------------


def _reduce(nll: torch.Tensor, target_lengths: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean_batch":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    if reduction == "none":
        return nll
    if reduction == "mean":
        return (nll / target_lengths.to(nll).clamp_min(1)).mean()
    raise ValueError(reduction)


def _rnnt_nll_rowscan(blank_lp: torch.Tensor, emit_lp: torch.Tensor,
                      input_lengths: torch.Tensor, target_lengths: torch.Tensor) -> torch.Tensor:
    """The JAX package's row-scan recursion (a loop over T of an in-row
    loop over U), for the tests: (B,) NLL."""
    b, t_max, u1 = blank_lp.shape
    dev = blank_lp.device
    neg = torch.full((b,), NEG_INF, dtype=blank_lp.dtype, device=dev)
    u_valid = torch.arange(u1, device=dev)[None, :] <= target_lengths.to(dev)[:, None]

    def row(horiz, t):
        vals, carry = [], neg
        for u in range(u1):
            carry = horiz[:, 0] if u == 0 else torch.logaddexp(horiz[:, u],
                                                                carry + emit_lp[:, t, u - 1])
            vals.append(carry)
        return torch.where(u_valid, torch.stack(vals, dim=1), NEG_INF)

    vals, carry = [], neg
    for u in range(u1):
        carry = torch.zeros((b,), dtype=blank_lp.dtype, device=dev) if u == 0 \
            else carry + emit_lp[:, 0, u - 1]
        vals.append(carry)
    alphas = [torch.where(u_valid, torch.stack(vals, dim=1), NEG_INF)]
    for t in range(1, t_max):
        alphas.append(row(alphas[-1] + blank_lp[:, t - 1], t))
    alphas = torch.stack(alphas)                     # (T, B, U+1)
    ti = input_lengths.to(dev, torch.int64) - 1
    ui = target_lengths.to(dev, torch.int64)
    bi = torch.arange(b, device=dev)
    return -(alphas[ti, bi, ui] + blank_lp[bi, ti, ui])


def rnnt_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
              target_lengths: torch.Tensor, blank_id: int, reduction: str = "mean_batch",
              impl: str = "wavefront") -> torch.Tensor:
    """The transducer's negative log-likelihood of (B, T, U+1, V+1)
    log-softmaxed joint outputs for (B, U) targets, reduced as the CTC loss
    is ('mean_batch', 'sum', 'mean', 'none').  The lattice runs in Kernel
    10 on CUDA tensors (its plain wavefront on CPU tensors);
    ``impl="rowscan"`` runs the row-scan recursion instead (tests)."""
    blank_lp, emit_lp = lattice_log_probs(log_probs, targets, blank_id)
    il = input_lengths.to(log_probs.device)
    tl = target_lengths.to(log_probs.device)
    if impl == "rowscan":
        nll = _rnnt_nll_rowscan(blank_lp, emit_lp, il, tl)
    elif impl == "wavefront":
        nll = kernel_rnnt_loss(blank_lp, emit_lp, il, tl)
    else:
        raise ValueError(f"unknown impl {impl!r}")
    return _reduce(nll, tl, reduction)


def rnnt_loss_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                          input_lengths: torch.Tensor, target_lengths: torch.Tensor,
                          blank_id: int, reduction: str = "mean_batch") -> torch.Tensor:
    """``rnnt_loss(torch.log_softmax(logits), ...)`` of the joint's
    (B, T, U+1, V+1) logits, reduced the same way: Kernel 10 from the
    logits on CUDA tensors (no log-softmax tensor; the backward writes the
    logits' gradient), the plain version on CPU tensors."""
    dev = logits.device
    il, tl = input_lengths.to(dev), target_lengths.to(dev)
    nll = kernel_rnnt_loss_from_logits(logits, targets.to(dev), il, tl, blank_id)
    return _reduce(nll, tl, reduction)


def _joint_logprobs(params, cfg: RNNTConfig, e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, De) frames x (B, H) predictions -> (B, V+1) log-probs."""
    return torch.log_softmax(joint(params, cfg, e[:, None, :], g[:, None, :])[:, 0, 0], dim=-1)


# ---------------------------------------------------------------------------
# greedy decoding
# ---------------------------------------------------------------------------


def greedy_init(params, cfg: RNNTConfig, batch: int):
    """The greedy carry: the start-of-sequence step's output and state, and
    empty hypotheses; thread it through ``greedy_decode_frames`` (offline
    once, streaming once a chunk)."""
    dev = _device_of(params)
    tok = torch.full((batch,), cfg.blank_id, dtype=torch.int32, device=dev)
    g, state = pred_step(params, cfg, tok, lstm_init_state(cfg, batch, dev))
    return g, state, [[] for _ in range(batch)]


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@torch.no_grad()
def greedy_decode_frames(params, cfg: RNNTConfig, enc, enc_lens, carry,
                         max_symbols_per_step: int = 10):
    """The greedy emit loop over one span of encoder frames (B, T, De),
    returning the new carry: per frame, symbols until blank (at most
    ``max_symbols_per_step``), the prediction network advanced only in the
    rows that emitted.  One device-to-host copy of the B symbols a step."""
    g, state, hyps = carry
    dev = _device_of(params)
    enc = torch.as_tensor(enc).to(dev, torch.float32)
    enc_lens = _host(enc_lens)
    for t in range(enc.shape[1]):
        active = enc_lens > t
        if not active.any():
            break
        e_t = enc[:, t]
        for _ in range(max_symbols_per_step):
            sym = _joint_logprobs(params, cfg, e_t, g).argmax(dim=-1).cpu().numpy()
            emit = (sym != cfg.blank_id) & active
            if not emit.any():
                break
            tok = torch.from_numpy(np.where(emit, sym, cfg.blank_id).astype(np.int32)).to(dev)
            g2, state2 = pred_step(params, cfg, tok, state)
            keep = torch.from_numpy(emit).to(dev)[:, None]
            g = torch.where(keep, g2, g)
            state = LSTMState(torch.where(keep[None], state2.h, state.h),
                              torch.where(keep[None], state2.c, state.c))
            for i in np.nonzero(emit)[0]:
                hyps[int(i)].append(int(sym[i]))
    return g, state, hyps


def greedy_decode(params, cfg: RNNTConfig, enc, enc_lens,
                  max_symbols_per_step: int = 10) -> List[List[int]]:
    """Batched greedy transducer decoding of (B, T, De) frames."""
    carry = greedy_init(params, cfg, enc.shape[0])
    return greedy_decode_frames(params, cfg, enc, enc_lens, carry, max_symbols_per_step)[2]


# ---------------------------------------------------------------------------
# beam search (the reference BeamRNNTInfer's 'beam', 'tsd' and 'alsd')
# ---------------------------------------------------------------------------


@dataclass(eq=False)  # identity comparison: list.remove takes the object
class Hypothesis:
    score: float
    y_sequence: List[int]   # a leading blank: the start of sequence
    dec_state: Any          # LSTMState after y_sequence[:-1]
    g: Any                  # (1, H) prediction for y_sequence[-1]


class _HypScorer:
    """Hypothesis scoring with the reference's sequence-keyed cache: the
    prediction network steps a hypothesis' last token from its parent
    state; the initial [blank] hypothesis steps the blank row from the zero
    state."""

    def __init__(self, params, cfg: RNNTConfig):
        self.params, self.cfg = params, cfg
        self.device = _device_of(params)
        self.cache: Dict[tuple, Any] = {}

    def g_state(self, hyp: Hypothesis):
        seq = tuple(hyp.y_sequence)
        hit = self.cache.get(seq)
        if hit is None:
            tok = torch.full((1,), hyp.y_sequence[-1], dtype=torch.int32, device=self.device)
            state = (lstm_init_state(self.cfg, 1, self.device)
                     if hyp.y_sequence[-1] == self.cfg.blank_id else hyp.dec_state)
            hit = self.cache[seq] = pred_step(self.params, self.cfg, tok, state)
        return hit

    def logp(self, e: torch.Tensor, hyp: Hypothesis):
        """((V+1,) host log-probs of frame ``e`` under hyp, the state after
        its step, its prediction)."""
        g, st = self.g_state(hyp)
        lp = _joint_logprobs(self.params, self.cfg, e[None], g)[0].cpu().numpy()
        return lp, st, g


def _sort_nbest(hyps: List[Hypothesis], score_norm: bool) -> List[Hypothesis]:
    if score_norm:
        return sorted(hyps, key=lambda x: x.score / len(x.y_sequence), reverse=True)
    return sorted(hyps, key=lambda x: x.score, reverse=True)


def _initial(cfg: RNNTConfig, device) -> Hypothesis:
    return Hypothesis(0.0, [cfg.blank_id], lstm_init_state(cfg, 1, device), None)


def _default_beam_search(params, cfg: RNNTConfig, enc_t, beam_size: int,
                         score_norm: bool) -> List[Hypothesis]:
    """The ESPnet one-best expansion (rnnt_beam_decoding.py:320-413)."""
    v = cfg.num_classes
    beam = min(beam_size, v)
    beam_k = min(beam, v - 1)
    sc = _HypScorer(params, cfg)
    kept_hyps = [_initial(cfg, sc.device)]
    for t in range(enc_t.shape[0]):
        e = enc_t[t]
        hyps = kept_hyps
        kept_hyps = []
        while True:
            max_hyp = max(hyps, key=lambda x: x.score)
            hyps.remove(max_hyp)
            lp, state, _ = sc.logp(e, max_hyp)
            top_k = np.argsort(-lp[:v], kind="stable")[:beam_k]
            steps = [(float(lp[k]), int(k)) for k in top_k]
            steps.append((float(lp[cfg.blank_id]), cfg.blank_id))
            for logp_k, k in steps:
                new_hyp = Hypothesis(max_hyp.score + logp_k, max_hyp.y_sequence[:],
                                     max_hyp.dec_state, None)
                if k == cfg.blank_id:
                    kept_hyps.append(new_hyp)
                else:
                    new_hyp.dec_state = state
                    new_hyp.y_sequence.append(k)
                    hyps.append(new_hyp)
            hyps_max = float(max(hyps, key=lambda x: x.score).score)
            kept_most_prob = sorted([h for h in kept_hyps if h.score > hyps_max],
                                    key=lambda x: x.score)
            if len(kept_most_prob) >= beam:
                kept_hyps = kept_most_prob
                break
    return _sort_nbest(kept_hyps, score_norm)


def _time_sync_decoding(params, cfg: RNNTConfig, enc_t, beam_size: int, score_norm: bool,
                        max_sym_exp: int) -> List[Hypothesis]:
    """Time-synchronous decoding (rnnt_beam_decoding.py:415-497)."""
    v = cfg.num_classes
    beam = min(beam_size, v)
    sc = _HypScorer(params, cfg)
    B = [_initial(cfg, sc.device)]
    for t in range(enc_t.shape[0]):
        e = enc_t[t]
        A: List[Hypothesis] = []
        C = B
        for _ in range(max_sym_exp):
            D: List[Hypothesis] = []
            scored = [sc.logp(e, hyp) for hyp in C]
            seq_A = [h.y_sequence for h in A]
            for j, hyp in enumerate(C):
                lp = scored[j][0]
                if hyp.y_sequence not in seq_A:
                    A.append(Hypothesis(hyp.score + float(lp[cfg.blank_id]),
                                        hyp.y_sequence[:], hyp.dec_state, None))
                else:
                    # merge the blank path into the existing hypothesis
                    pos = seq_A.index(hyp.y_sequence)
                    A[pos].score = float(np.logaddexp(
                        A[pos].score, hyp.score + float(lp[cfg.blank_id])))
            for j, hyp in enumerate(C):
                lp, state, _ = scored[j]
                for k in np.argsort(-lp[:v], kind="stable")[:beam]:
                    D.append(Hypothesis(hyp.score + float(lp[k]), hyp.y_sequence + [int(k)],
                                        state, None))
            C = sorted(D, key=lambda x: x.score, reverse=True)[:beam]
        B = sorted(A, key=lambda x: x.score, reverse=True)[:beam]
    return _sort_nbest(B, score_norm)


def _recombine_hypotheses(hypotheses: List[Hypothesis]) -> List[Hypothesis]:
    """rnnt_beam_decoding.py:659-680 as the reference has it: the first
    occurrence of a sequence absorbs its duplicates' scores, and the
    *input* list comes back (duplicates kept)."""
    final: List[Hypothesis] = []
    for hyp in hypotheses:
        seq_final = [f.y_sequence for f in final if f.y_sequence]
        if hyp.y_sequence in seq_final:
            pos = seq_final.index(hyp.y_sequence)
            final[pos].score = float(np.logaddexp(final[pos].score, hyp.score))
        else:
            final.append(hyp)
    return hypotheses


def _align_length_sync_decoding(params, cfg: RNNTConfig, enc_t, beam_size: int,
                                score_norm: bool, max_target_len) -> List[Hypothesis]:
    """Alignment-length-synchronous decoding (rnnt_beam_decoding.py:499-657)."""
    v = cfg.num_classes
    beam = min(beam_size, v)
    h_length = enc_t.shape[0]
    u_max = (int(max_target_len * h_length) if isinstance(max_target_len, float)
             else int(max_target_len))
    sc = _HypScorer(params, cfg)
    B = [_initial(cfg, sc.device)]
    final: List[Hypothesis] = []
    for i in range(h_length + u_max):
        A: List[Hypothesis] = []
        B_: List[Hypothesis] = []
        h_states: List[int] = []
        for hyp in B:
            t = i - (len(hyp.y_sequence) - 1) + 1
            if t > h_length - 1:
                continue
            B_.append(hyp)
            h_states.append(t)
        if not B_:
            break   # every hypothesis ran past the frame axis (reference :651-652)
        scored = [sc.logp(enc_t[h_states[j]], hyp) for j, hyp in enumerate(B_)]
        for j, hyp in enumerate(B_):
            lp, state, _ = scored[j]
            new_hyp = Hypothesis(hyp.score + float(lp[cfg.blank_id]), hyp.y_sequence[:],
                                 hyp.dec_state, None)
            A.append(new_hyp)
            if h_states[j] == h_length - 1:
                final.append(new_hyp)
            for k in np.argsort(-lp[:v], kind="stable")[:beam]:
                A.append(Hypothesis(hyp.score + float(lp[k]), hyp.y_sequence + [int(k)],
                                    state, None))
        B = _recombine_hypotheses(sorted(A, key=lambda x: x.score, reverse=True)[:beam])
    if final:
        return _sort_nbest(final, score_norm)
    return B


def beam_search(params, cfg: RNNTConfig, enc_t, beam_size: int = 4,
                search_type: str = "beam", score_norm: bool = True,
                tsd_max_sym_exp: int = 50, alsd_max_target_len=1.0) -> List[Hypothesis]:
    """N-best transducer beam search over one utterance's encoder frames
    (T, De) (a tensor, moved to the params' device, or numpy);
    search_type in {'beam' / 'default', 'tsd', 'alsd'}."""
    enc_t = torch.as_tensor(enc_t).to(_device_of(params), torch.float32)
    if search_type in ("beam", "default"):
        return _default_beam_search(params, cfg, enc_t, beam_size, score_norm)
    if search_type == "tsd":
        return _time_sync_decoding(params, cfg, enc_t, beam_size, score_norm, tsd_max_sym_exp)
    if search_type == "alsd":
        return _align_length_sync_decoding(params, cfg, enc_t, beam_size, score_norm,
                                           alsd_max_target_len)
    raise NotImplementedError(
        f"The search type ({search_type}) supplied is not supported!\n"
        f"Please use one of : (default, tsd, alsd)")


def beam_decode_one(params, cfg: RNNTConfig, enc_t, beam_size: int = 4,
                    search_type: str = "beam", **kwargs) -> List[int]:
    """The best label sequence (without the leading blank) of one
    utterance's (T, De) frames."""
    best = beam_search(params, cfg, enc_t, beam_size=beam_size, search_type=search_type,
                       **kwargs)[0].y_sequence
    return [t for t in best if t != cfg.blank_id]
