"""Frozen integer transducer decoder: the int8 prediction network (an
integer LSTM) and joint (port of qasr_tpu/quantize/rnnt_freeze.py).

With the frozen integer Conformer encoder this makes the transducer's
serving path integer arithmetic from the subsampler's output to the
argmax, but for the encoder's last float affine and the quantization of
the encoder frame at the joint's input.

Integer LSTM cell (per layer, gates i, f, g, o):
  * both GEMMs int8 x int8 -> int32; each accumulator is requantized onto
    the fixed i-sigmoid grid S_IN = 20/16383 with per-column dyadic
    multipliers, then added (with the bias on the grid) and clipped at
    +-N_IN: the gate pre-activations need no calibration;
  * sigmoid is ``i_sigmoid_grid``; tanh(x) = 2 sigmoid(2x) - 1 rides a
    doubled-ratio requant of the same accumulators (the g gate only);
  * the cell state c is int32 at 2^-14 (K_C = 2 K_SIG, where
    i * tanh(g) lands exactly), clipped at +-2^23; h = o * tanh(c) is at
    most 1, so its int8 scale is the static 1/127.
Joint: enc8 @ W and h8 @ W each requantized to the calibrated joint grid,
added with the bias, ReLU to [0, n], the out GEMM requantized per column
to one common logits scale, so that the argmax compares raw int32.

Host half (numpy): ``freeze_rnnt_decoder`` builds the JAX package's
tables bit for bit; ``rnnt_tables_to_device`` puts them on a torch device
with the weights K-contiguous (out, in), Kernel 9's layout.
``pred_step_frozen`` and ``joint_logits_frozen`` are the plain torch
versions of the cell and the joint (integer products as int32 matmuls on
the CPU, exact float64 on the card).  The greedy loop is one launch of
Kernel 9's ``rnnt_greedy`` (``kernels/rnnt_decoder.py``) a call, after
the start-of-sequence step's ``rnnt_pred_step``; CPU tensors take the
plain versions.
Only two ranges need data: the encoder output's and the pre-ReLU joint
hidden's (``calibrate_decoder_ranges``, a float greedy pass).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.device import as_device, no_tf32
from qasr_tpu_torch.kernels.rnnt_decoder import rnnt_greedy, rnnt_pred_step
from qasr_tpu_torch.ops.integer_sigmoid import K_SIG, i_sigmoid_grid
from qasr_tpu_torch.ops.integer_softmax import N_IN, S_IN
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static, f32_div
from qasr_tpu_torch.quantize.conformer_freeze import _rq_table as _rq
from qasr_tpu_torch.quantize.conformer_freeze import _w_quant
from qasr_tpu_torch.quantize.freeze import tables_digest

K_C = 2 * K_SIG          # cell-state fraction bits: i * tanh(g) lands exactly
_C_CLIP = 1 << 23        # |c| <= 512.0: f_fp * c_q stays inside int32
_H_SCALE = 1.0 / 127.0   # |h| = |sigmoid * tanh| <= 1: a static int8 scale


def _rshift_round(v: torch.Tensor, k: int) -> torch.Tensor:
    return torch.bitwise_right_shift(v + (1 << (k - 1)), k)


def _i_tanh_grid(q2: torch.Tensor) -> torch.Tensor:
    """tanh from values on the S_IN grid representing 2x: 2 sigmoid(2x) - 1,
    int32 in [-2^K_SIG, 2^K_SIG] at 2^-K_SIG."""
    return 2 * i_sigmoid_grid(q2) - (1 << K_SIG)


# ---------------------------------------------------------------------------
# freeze (host numpy)
# ---------------------------------------------------------------------------


def freeze_rnnt_decoder(params, cfg, *, enc_range: float, joint_range: float,
                        weight_bit: int = 8) -> Dict[str, Any]:
    """The integer decoder's tables (numpy, equal to the JAX package's)
    from the float params and the two calibrated |max| ranges: the encoder
    output's and the pre-ReLU joint hidden's."""
    wb = weight_bit
    n8 = 2 ** (wb - 1) - 1
    emb_int, emb_sc = _w_quant(np.asarray(params["embed"]), wb, (0, 1))
    s_h = _H_SCALE
    layers: List[Dict[str, Any]] = []
    s_x = float(emb_sc)
    for lp in params["lstm"]:
        wi_int, wi_sc = _w_quant(lp["wi"], wb, (0,))   # (4H,) per column
        wh_int, wh_sc = _w_quant(lp["wh"], wb, (0,))
        b = np.asarray(lp["b"], np.float64)
        # the accumulators onto the sigmoid grid, and onto the doubled grid
        # (tanh of the g gate)
        mi, ei = _rq(s_x * wi_sc, S_IN)
        mh, eh = _rq(s_h * wh_sc, S_IN)
        mi2, ei2 = _rq(2.0 * s_x * wi_sc, S_IN)
        mh2, eh2 = _rq(2.0 * s_h * wh_sc, S_IN)
        layers.append({
            "wi": wi_int, "wh": wh_int,
            "mi": mi, "ei": ei, "mh": mh, "eh": eh,
            "mi2": mi2, "ei2": ei2, "mh2": mh2, "eh2": eh2,
            "b_grid": np.round(b / S_IN).astype(np.int32),
            "b2_grid": np.round(2.0 * b / S_IN).astype(np.int32),
        })
        s_x = s_h  # the upper layers read h8
    m_c2, e_c2 = _rq(2.0 / (1 << K_C), S_IN)          # c -> the grid as 2c
    m_h, e_h = _rq(1.0 / (1 << (2 * K_SIG)), s_h)     # h_fp -> int8 at 1/127

    jp = params["joint"]
    s_enc = max(float(enc_range), 1e-8) / n8
    s_j = max(float(joint_range), 1e-8) / n8
    wenc_int, wenc_sc = _w_quant(jp["enc"]["w"], wb, (0,))
    wpred_int, wpred_sc = _w_quant(jp["pred"]["w"], wb, (0,))
    wout_int, wout_sc = _w_quant(jp["out"]["w"], wb, (0,))
    m_f, e_f = _rq(s_enc * wenc_sc, s_j)
    m_g, e_g = _rq(s_h * wpred_sc, s_j)
    b_j = np.asarray(jp["enc"]["b"], np.float64) + np.asarray(jp["pred"]["b"], np.float64)
    # one logits scale for every column: the coarsest product scale
    s_logit = float(np.max(s_j * wout_sc))
    m_o, e_o = _rq(s_j * wout_sc, s_logit)
    return {
        "act_bit": wb,
        "embed": emb_int, "layers": layers,
        "m_c2": m_c2, "e_c2": e_c2, "m_h": m_h, "e_h": e_h,
        "joint": {
            "wenc": wenc_int, "wpred": wpred_int, "wout": wout_int,
            "m_f": m_f, "e_f": e_f, "m_g": m_g, "e_g": e_g,
            "b_j": np.round(b_j / s_j).astype(np.int32),
            "m_o": m_o, "e_o": e_o,
            "b_out_logit": np.round(np.asarray(jp["out"]["b"], np.float64)
                                    / s_logit).astype(np.int32),
            "S_enc": s_enc,
        },
        "activation": cfg.activation,
    }


def decoder_tables_digest(host) -> str:
    """SHA-256 (``quantize.freeze.tables_digest``) of host decoder tables,
    without the JAX package's cached closures ('_' keys)."""
    return tables_digest({k: v for k, v in host.items() if not k.startswith("_")})


def rnnt_tables_to_device(host, device) -> Dict[str, Any]:
    """Host tables -> the device form on ``device``: int8 weights as
    (out, in) K-contiguous ("wt_*"), per-column int32 mantissas and biases,
    exponents and the scalar mantissas as Python ints; ``host`` keeps the
    numpy tables."""
    dev = torch.device(device)

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

    def wt(w):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.int8).T)).to(dev)

    layers = []
    for lt in host["layers"]:
        d = {"wt_i": wt(lt["wi"]), "wt_h": wt(lt["wh"])}
        for k in ("mi", "mh", "mi2", "mh2", "b_grid", "b2_grid"):
            d[k] = t32(lt[k])
        d.update({k: int(lt[k]) for k in ("ei", "eh", "ei2", "eh2")})
        layers.append(d)
    jt = host["joint"]
    joint = {"wt_enc": wt(jt["wenc"]), "wt_pred": wt(jt["wpred"]), "wt_out": wt(jt["wout"]),
             "m_f": t32(jt["m_f"]), "m_g": t32(jt["m_g"]), "m_o": t32(jt["m_o"]),
             "b_j": t32(jt["b_j"]), "b_out_logit": t32(jt["b_out_logit"]),
             "e_f": int(jt["e_f"]), "e_g": int(jt["e_g"]), "e_o": int(jt["e_o"]),
             "S_enc": float(jt["S_enc"])}
    return {"host": host, "device": dev, "act_bit": int(host["act_bit"]),
            "activation": host["activation"],
            "embed": torch.from_numpy(np.ascontiguousarray(host["embed"], np.int8)).to(dev),
            "layers": layers, "joint": joint,
            "m_c2": int(np.asarray(host["m_c2"])), "e_c2": int(host["e_c2"]),
            "m_h": int(np.asarray(host["m_h"])), "e_h": int(host["e_h"])}


# ---------------------------------------------------------------------------
# the plain integer cell and joint
# ---------------------------------------------------------------------------


def _dot8(x8: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x8 (B, K) int8 @ wt (N, K)^T -> (B, N) int32, exactly: an int32
    matmul on the CPU, float64 on the card (every sum is below 2^31)."""
    if x8.device.type == "cpu":
        return x8.to(torch.int32) @ wt.to(torch.int32).t()
    return (x8.to(torch.float64) @ wt.to(torch.float64).t()).to(torch.int32)


def pred_step_frozen(tables, token: torch.Tensor, h8: torch.Tensor, c_q: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One integer prediction-network step: token (B,) int32, h8 (L, B, H)
    int8 at 1/127, c_q (L, B, H) int32 at 2^-K_C -> (the top layer's h8,
    the new h8 stack, the new c_q stack)."""
    x8 = tables["embed"][token.to(torch.int64)]
    hs, cs = [], []
    for li, t in enumerate(tables["layers"]):
        h = t["wt_h"].shape[1]
        acc_i = _dot8(x8, t["wt_i"])
        acc_h = _dot8(h8[li], t["wt_h"])
        g1 = (dyadic_requant_static(acc_i, t["mi"], t["ei"])
              + dyadic_requant_static(acc_h, t["mh"], t["eh"]) + t["b_grid"])
        g1 = g1.clamp(-N_IN, N_IN)
        gs = slice(2 * h, 3 * h)   # the g gate's columns on the doubled grid
        g2g = (dyadic_requant_static(acc_i[:, gs], t["mi2"][gs], t["ei2"])
               + dyadic_requant_static(acc_h[:, gs], t["mh2"][gs], t["eh2"])
               + t["b2_grid"][gs]).clamp(-N_IN, N_IN)
        gi, gf, _, go = torch.split(g1, h, dim=-1)
        i_fp, f_fp, o_fp = i_sigmoid_grid(gi), i_sigmoid_grid(gf), i_sigmoid_grid(go)
        c2 = _rshift_round(f_fp * c_q[li], K_SIG) + i_fp * _i_tanh_grid(g2g)
        c2 = c2.clamp(-_C_CLIP, _C_CLIP)
        q2c = dyadic_requant_static(c2, tables["m_c2"], tables["e_c2"]).clamp(-N_IN, N_IN)
        h_fp = o_fp * _i_tanh_grid(q2c)          # at 2^-2K_SIG, |.| <= 2^14
        x8 = dyadic_requant_static(h_fp, tables["m_h"], tables["e_h"]).clamp(-127, 127).to(
            torch.int8)
        hs.append(x8)
        cs.append(c2)
    return x8, torch.stack(hs), torch.stack(cs)


def quantize_frame(tables, enc_f: torch.Tensor) -> torch.Tensor:
    """The float encoder frame onto the joint's input grid:
    clip(round(enc_f / S_enc), -n, n) int8 (an IEEE division)."""
    n8 = 2 ** (tables["act_bit"] - 1) - 1
    q = torch.round(f32_div(enc_f.to(torch.float32), tables["joint"]["S_enc"]))
    return q.clamp(-n8, n8).to(torch.int8)


def joint_logits_frozen(tables, enc_f: torch.Tensor, h8: torch.Tensor) -> torch.Tensor:
    """(B, De) float encoder frames x (B, H) int8 predictions -> (B, V+1)
    int32 logits on one common scale."""
    jt = tables["joint"]
    if tables["activation"] != "relu":
        raise NotImplementedError("the frozen joint takes relu (the float joint's default)")
    n8 = 2 ** (tables["act_bit"] - 1) - 1
    enc8 = quantize_frame(tables, enc_f)
    f_j = dyadic_requant_static(_dot8(enc8, jt["wt_enc"]), jt["m_f"], jt["e_f"])
    g_j = dyadic_requant_static(_dot8(h8, jt["wt_pred"]), jt["m_g"], jt["e_g"])
    x8 = (f_j + g_j + jt["b_j"]).clamp(0, n8).to(torch.int8)
    out = dyadic_requant_static(_dot8(x8, jt["wt_out"]), jt["m_o"], jt["e_o"])
    return out + jt["b_out_logit"]


# ---------------------------------------------------------------------------
# greedy decoding on Kernel 9
# ---------------------------------------------------------------------------


def frozen_decoder_init(tables, cfg, batch: int):
    """The integer greedy carry, start-of-sequence primed: (g8, (h8, c_q),
    hyps)."""
    dev = tables["device"]
    n_l = len(tables["layers"])
    h_dim = tables["layers"][0]["wt_h"].shape[1]
    h8 = torch.zeros((n_l, batch, h_dim), dtype=torch.int8, device=dev)
    c_q = torch.zeros((n_l, batch, h_dim), dtype=torch.int32, device=dev)
    tok = torch.full((batch,), cfg.blank_id, dtype=torch.int32, device=dev)
    g8, h8, c_q = rnnt_pred_step(tables, tok, h8, c_q)
    return g8, (h8, c_q), [[] for _ in range(batch)]


def greedy_decode_frames_frozen(tables, cfg, enc, enc_lens, carry,
                                max_symbols_per_step: int = 10,
                                stats: Optional[Dict[str, Any]] = None):
    """The integer counterpart of ``models/rnnt.py::greedy_decode_frames``
    over (B, T, De) float frames: one ``rnnt_greedy`` launch (the whole
    emit loop on the card, each row walking its own frames), then one copy
    of the ids and per-row counts to the host.  ``stats``, if given,
    accumulates "symbols", "joint_steps" (per row), "max_row_steps" (the
    most joint steps of a row, summed over calls: the decode's chain of
    dependent steps) and "calls"."""
    g8, (h8, c_q), hyps = carry
    dev = tables["device"]
    enc = torch.as_tensor(enc).to(dev, torch.float32)
    res, (g8, h8, c_q) = rnnt_greedy(tables, enc, enc_lens, (g8, h8, c_q),
                                     max_symbols_per_step, cfg.blank_id)
    res = res.cpu().numpy()   # the decode's one sync
    for i, row in enumerate(res):
        hyps[i].extend(row[2:2 + row[0]].tolist())
    if stats is not None:
        steps = res[:, 1].astype(np.int64)
        prev = stats.get("joint_steps")
        stats["joint_steps"] = (steps if prev is None else np.asarray(prev) + steps).tolist()
        stats["symbols"] = stats.get("symbols", 0) + int(res[:, 0].sum())
        stats["max_row_steps"] = stats.get("max_row_steps", 0) + int(steps.max(initial=0))
        stats["calls"] = stats.get("calls", 0) + 1
    return g8, (h8, c_q), hyps


def greedy_decode_frozen(tables, cfg, enc, enc_lens, max_symbols_per_step: int = 10,
                         stats: Optional[Dict[str, Any]] = None) -> List[List[int]]:
    carry = frozen_decoder_init(tables, cfg, enc.shape[0])
    return greedy_decode_frames_frozen(tables, cfg, enc, enc_lens, carry,
                                       max_symbols_per_step, stats)[2]


def decoder_launches(tables, stats: Dict[str, Any]) -> Dict[str, int]:
    """Kernel 9's launches for a greedy decode that ``stats`` counted:
    "rnnt_greedy", one a ``greedy_decode_frames_frozen`` call (in the form
    that the kernel's shared-memory plan picks: ``rnnt_greedy.forms``
    counts it); "rnnt_pred", one a layer for the start-of-sequence step."""
    return {"rnnt_greedy": stats.get("calls", 0), "rnnt_pred": len(tables["layers"])}


# ---------------------------------------------------------------------------
# calibration (the two data-dependent ranges)
# ---------------------------------------------------------------------------


@torch.no_grad()
def calibrate_decoder_ranges(model, calib_batches, max_symbols_per_step: int = 10,
                             device=None) -> Tuple[float, float]:
    """A float greedy pass over calibration audio batches (audio, lengths)
    on ``device`` (None: the CUDA device): the |max| of the encoder output
    (valid frames) and of the pre-ReLU joint hidden (every row of every
    step)."""
    from qasr_tpu_torch.models.rnnt import LSTMState, greedy_init, pred_step

    dev = as_device(device)
    params, cfg = model.float_decoder(dev), model.rnnt_cfg
    jp = params["joint"]
    enc_max = 1e-8
    j_max = 1e-8
    for audio, alens in calib_batches:
        enc, enc_lens = model.encode(audio, alens, device=dev)
        enc_lens = enc_lens.cpu().numpy()
        for i in range(enc.shape[0]):
            n = int(enc_lens[i])
            if n:
                enc_max = max(enc_max, float(enc[i, :n].abs().max()))
        g, state, _ = greedy_init(params, cfg, enc.shape[0])
        for t in range(enc.shape[1]):
            active = enc_lens > t
            if not active.any():
                break
            e_t = enc[:, t]
            for _ in range(max_symbols_per_step):
                with no_tf32():
                    x_pre = (e_t @ jp["enc"]["w"] + jp["enc"]["b"]) \
                        + (g @ jp["pred"]["w"] + jp["pred"]["b"])
                    logits = torch.relu(x_pre) @ jp["out"]["w"] + jp["out"]["b"]
                j_max = max(j_max, float(x_pre.abs().max()))
                sym = logits.argmax(dim=-1).cpu().numpy()
                emit = (sym != cfg.blank_id) & active
                if not emit.any():
                    break
                tok = torch.from_numpy(np.where(emit, sym, cfg.blank_id).astype(np.int32))
                g2, state2 = pred_step(params, cfg, tok.to(dev), state)
                keep = torch.from_numpy(emit).to(dev)[:, None]
                g = torch.where(keep, g2, g)
                state = LSTMState(torch.where(keep[None], state2.h, state.h),
                                  torch.where(keep[None], state2.c, state.c))
    return enc_max, j_max
