"""Kernel 9: the frozen transducer decoder's symbol step
(kernels/csrc/rnnt_decoder.cu): ``rnnt_pred_step``, one launch per LSTM
layer, and ``rnnt_joint``, one launch for the joint's logits and argmax.

Replaces no Pallas kernel: the JAX package runs the step as the XLA ops of
qasr_tpu/quantize/rnnt_freeze.py::pred_step_frozen (:157-196) and
joint_logits_frozen (:199-217), and keeps the old state of the rows that
did not emit with ``where`` in its greedy loop (:272-275); here that keep
is fused into the pred step.  As a chain of torch ops a step is some 30-40
tiny launches, and ``torch._int_mm`` takes no fewer than 17 rows (a
streamer decodes one).

The wrappers launch the CUDA kernels for CUDA tensors and run the plain
versions (``rnnt_pred_step_plain``, ``rnnt_joint_plain``: the port's
``pred_step_frozen`` / ``joint_logits_frozen``) for CPU tensors; they never
fall back from one to the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec


def rnnt_pred_step_plain(tables, token: torch.Tensor, h8: torch.Tensor, c_q: torch.Tensor,
                         emit: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version.  Same arguments and result as ``rnnt_pred_step``."""
    from qasr_tpu_torch.quantize.rnnt_freeze import pred_step_frozen

    _, h2, c2 = pred_step_frozen(tables, token, h8, c_q)
    if emit is not None:
        keep = emit.to(torch.bool)[None, :, None]
        h2, c2 = torch.where(keep, h2, h8), torch.where(keep, c2, c_q)
    return h2[-1], h2, c2


def rnnt_joint_plain(tables, enc_f: torch.Tensor, h8: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version.  Same arguments and result as ``rnnt_joint``."""
    from qasr_tpu_torch.quantize.rnnt_freeze import joint_logits_frozen

    logits = joint_logits_frozen(tables, enc_f, h8)
    return logits, logits.argmax(dim=-1).to(torch.int32)


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


_LAYER_KEYS = ("wt_i", "wt_h", "mi", "mh", "mi2", "mh2", "b_grid", "b2_grid")
_JOINT_KEYS = ("wt_enc", "wt_pred", "wt_out", "m_f", "m_g", "m_o", "b_j", "b_out_logit")


def _table_state(tables):
    """(every tensor the kernels read, every static scalar they take), in
    launch order."""
    jt = tables["joint"]
    tensors = [tables["embed"]] + [t[k] for t in tables["layers"] for k in _LAYER_KEYS] + [
        jt[k] for k in _JOINT_KEYS]
    scalars = [t[k] for t in tables["layers"] for k in ("ei", "eh", "ei2", "eh2")] + [
        jt["e_f"], jt["e_g"], jt["e_o"]] + [tables[k] for k in ("m_c2", "e_c2", "m_h", "e_h")]
    return tensors, scalars


def _check_tables(tables, dev: torch.device):
    """Validate the tables' tensors for Kernel 9 on ``dev``: int8 weights
    (out, in) with every width a multiple of 4, int32 per-column vectors,
    exponents >= 1, mantissas below 2^31.  The result, with the tensors and
    their device pointers, is kept in the tables ("_valid") and reused while
    every tensor is the same object and every scalar the same value, so
    the per-step calls check only their inputs and a replaced tensor is
    checked again.  Returns (each layer's pointers, the joint's)."""
    tensors, scalars = _table_state(tables)
    v = tables.get("_valid")
    if v is not None and v[0] == dev and v[2] == scalars and len(v[1]) == len(tensors) and all(
            a is b for a, b in zip(v[1], tensors)):
        return v[3], v[4]
    emb = tables["embed"]
    hid = emb.shape[1]
    if hid % 4 or hid < 4:
        raise ValueError(f"Kernel 9: prediction width {hid} is not a positive multiple of 4")
    check_vec("rnnt_pred_step", "embed", emb, torch.int8, tuple(emb.shape), dev)
    for t in tables["layers"]:
        for k in ("wt_i", "wt_h"):
            check_vec("rnnt_pred_step", k, t[k], torch.int8, (4 * hid, hid), dev)
        for k in ("mi", "mh", "mi2", "mh2", "b_grid", "b2_grid"):
            check_vec("rnnt_pred_step", k, t[k], torch.int32, (4 * hid,), dev)
    jt = tables["joint"]
    jh, de = jt["wt_enc"].shape
    vout = jt["wt_out"].shape[0]
    if de % 4 or jh % 4:
        raise ValueError(f"Kernel 9: joint widths De {de}, J {jh} must be multiples of 4")
    check_vec("rnnt_joint", "wt_enc", jt["wt_enc"], torch.int8, (jh, de), dev)
    check_vec("rnnt_joint", "wt_pred", jt["wt_pred"], torch.int8, (jh, hid), dev)
    check_vec("rnnt_joint", "wt_out", jt["wt_out"], torch.int8, (vout, jh), dev)
    for k, n in (("m_f", jh), ("m_g", jh), ("b_j", jh), ("m_o", vout), ("b_out_logit", vout)):
        check_vec("rnnt_joint", k, jt[k], torch.int32, (n,), dev)
    exps = [jt["e_f"], jt["e_g"], jt["e_o"], tables["e_c2"], tables["e_h"]] + [
        t[k] for t in tables["layers"] for k in ("ei", "eh", "ei2", "eh2")]
    if not all(isinstance(e, int) and e >= 1 for e in exps) or not all(
            0 < tables[k] < 2 ** 31 for k in ("m_c2", "m_h")):
        raise ValueError("Kernel 9: exponents must be static ints >= 1 and the scalar "
                         "mantissas in (0, 2^31)")
    layer_ptrs = [tuple(t[k].data_ptr() for k in _LAYER_KEYS) for t in tables["layers"]]
    joint_ptrs = tuple(jt[k].data_ptr() for k in _JOINT_KEYS)
    tables["_valid"] = (dev, tensors, scalars, layer_ptrs, joint_ptrs)
    return layer_ptrs, joint_ptrs


def rnnt_pred_step(tables, token: torch.Tensor, h8: torch.Tensor, c_q: torch.Tensor,
                   emit: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One integer prediction-network step over every layer of ``tables``
    (``rnnt_tables_to_device``): token (B,) int32 (layer 0 reads its
    embedding row), h8 (L, B, H) int8, c_q (L, B, H) int32, emit (B,) int32
    or bool (nonzero: the row emits) or None (every row) -> (the top
    layer's h8 (B, H), the new h8 stack, the new c_q stack), the old state
    kept in the rows that do not emit.  One launch a layer."""
    if token.device.type == "cpu":
        return rnnt_pred_step_plain(tables, token, h8, c_q, emit)
    _check_cuda("rnnt_pred_step", token)
    dev = token.device
    layer_ptrs, _ = _check_tables(tables, dev)
    n_l, b, hid = h8.shape
    emb = tables["embed"]
    if n_l != len(tables["layers"]) or emb.shape[1] != hid:
        raise ValueError(f"rnnt_pred_step: h8 {tuple(h8.shape)} does not match "
                         f"{len(tables['layers'])} layers of width {emb.shape[1]}")
    check_vec("rnnt_pred_step", "token", token, torch.int32, (b,), dev)
    check_vec("rnnt_pred_step", "h8", h8, torch.int8, (n_l, b, hid), dev)
    check_vec("rnnt_pred_step", "c_q", c_q, torch.int32, (n_l, b, hid), dev)
    if emit is not None:
        if emit.dtype == torch.bool:
            emit = emit.to(torch.int32)
        check_vec("rnnt_pred_step", "emit", emit, torch.int32, (b,), dev)
    h_out = torch.empty_like(h8)
    c_out = torch.empty_like(c_q)
    lib = _build.library()
    stream = _build.stream_of(token)
    for li, (t, ptrs) in enumerate(zip(tables["layers"], layer_ptrs)):
        rc = lib.qasr_rnnt_pred_step(
            _build.ptr(token), _build.ptr(emb), None if li == 0 else _build.ptr(h_out[li - 1]),
            _build.ptr(h8[li]), _build.ptr(c_q[li]), *ptrs, _build.ptr(emit),
            _build.ptr(h_out[li]), _build.ptr(c_out[li]), b, hid, hid, emb.shape[0], t["ei"],
            t["eh"], t["ei2"], t["eh2"], tables["m_c2"], tables["e_c2"], tables["m_h"],
            tables["e_h"], stream)
        _build.check(rc, "rnnt_pred_step")
        rnnt_pred_step.launches += 1
    return h_out[-1], h_out, c_out


rnnt_pred_step.launches = 0


def rnnt_joint(tables, enc_f: torch.Tensor, h8: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The integer joint of (B, De) float32 encoder frames (rows may be
    strided, e.g. enc[:, t]) and (B, H) int8 predictions -> ((B, V+1)
    int32 logits on one common scale, (B,) int32 ids: each row's first
    maximum).  One launch."""
    if enc_f.device.type == "cpu":
        return rnnt_joint_plain(tables, enc_f, h8)
    _check_cuda("rnnt_joint", enc_f)
    if tables["activation"] != "relu":
        raise NotImplementedError("the frozen joint takes relu (the float joint's default)")
    dev = enc_f.device
    _, joint_ptrs = _check_tables(tables, dev)
    jt = tables["joint"]
    jh, de = jt["wt_enc"].shape
    vout, hp = jt["wt_out"].shape[0], jt["wt_pred"].shape[1]
    b = enc_f.shape[0]
    if (enc_f.dtype != torch.float32 or enc_f.dim() != 2 or enc_f.shape[1] != de
            or enc_f.stride(1) != 1):
        raise ValueError(f"rnnt_joint: needs float32 (B, {de}) frames with unit column stride, "
                         f"got {enc_f.dtype} {tuple(enc_f.shape)}")
    check_vec("rnnt_joint", "h8", h8, torch.int8, (b, hp), dev)
    logits = torch.empty((b, vout), dtype=torch.int32, device=dev)
    ids = torch.empty((b,), dtype=torch.int32, device=dev)
    rc = _build.library().qasr_rnnt_joint(
        _build.ptr(enc_f), enc_f.stride(0), _build.ptr(h8), *joint_ptrs, _build.ptr(logits),
        _build.ptr(ids), b, de, hp, jh, vout, ctypes.c_float(jt["S_enc"]), jt["e_f"], jt["e_g"],
        jt["e_o"], 2 ** (tables["act_bit"] - 1) - 1, _build.stream_of(enc_f))
    _build.check(rc, "rnnt_joint")
    rnnt_joint.launches += 1
    return logits, ids


rnnt_joint.launches = 0
