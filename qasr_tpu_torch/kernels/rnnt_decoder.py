"""Kernel 9: the frozen transducer decoder (kernels/csrc/rnnt_decoder.cu).

``rnnt_greedy`` (the serving path) runs the whole greedy decode of a batch
of frames in one launch: a thread-block cluster holds the decoder's
weights in its CTAs' shared memory (the resident form; the streamed form
reads them from L2 where they do not fit), each row walks its own frames,
and the emit loop stays on the card; ids, per-row counts and the new carry
come back in one copy.  ``rnnt_pred_step`` (one launch per LSTM layer) and
``rnnt_joint`` (one launch for the joint's logits and argmax) are the step
kernels of the host loop it replaced; the SOS-primed start of a decode
(``quantize/rnnt_freeze.py::frozen_decoder_init``) still takes
``rnnt_pred_step``.

Replaces no Pallas kernel: the JAX package runs the step as the XLA ops of
qasr_tpu/quantize/rnnt_freeze.py::pred_step_frozen (:157-196) and
joint_logits_frozen (:199-217), and its greedy loop (:251-278) on the host.

The wrappers launch the CUDA kernels for CUDA tensors and run the plain
versions (``rnnt_greedy_plain``: a loop of its own for each row on
``pred_step_frozen`` / ``joint_logits_frozen``; ``rnnt_pred_step_plain``,
``rnnt_joint_plain``) for CPU tensors; they never fall back from one to
the other.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec
from qasr_tpu_torch.kernels.conv_block import SIG_TAB, sigmoid_table


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


# ---------------------------------------------------------------------------
# rnnt_greedy: the whole greedy decode in one launch
# ---------------------------------------------------------------------------

GREEDY_CLUSTER = 8          # CTAs of a cluster (the portable maximum)
GREEDY_MAX_LAYERS = 4
_LAYER_OFFS = ("kWi", "kWh", "kMi", "kMh", "kBg", "kMi2", "kMh2", "kB2")
_LAYER_EXPS = ("kEi", "kEh", "kEi2", "kEh2")
# the C entry's integer arguments, in the order of rnnt_decoder.cu's
# greedy::Arg (a test reads that enum)
GREEDY_ARGS = ("kBatch", "kT", "kDe", "kHid", "kLayers", "kJ", "kV", "kNEmbed", "kCap",
               "kBlank", "kN8", "kEncSB", "kEncST", "kEF", "kEG", "kEO", "kMC2", "kEC2",
               "kMH", "kEH", "kCluster", "kUnits", "kJSlice", "kBlobBytes", "kOffEmbed",
               "kOffWenc", "kOffWpred", "kOffWout", "kOffMf", "kOffMg", "kOffBj", "kOffMo",
               "kOffBo", "kOffSig") + tuple(f"kOffLayer{l}.{k}" for l in range(GREEDY_MAX_LAYERS)
                                 for k in _LAYER_OFFS) + tuple(
    f"kExpLayer{l}.{k}" for l in range(GREEDY_MAX_LAYERS) for k in _LAYER_EXPS)


def _rup16(n: int) -> int:
    return (n + 15) & ~15


def greedy_layout(hid: int, layers: int, joint: int, vout: int, de: int, n_embed: int):
    """The per-CTA blob of ``rnnt_greedy``: CTA q of the cluster owns hidden
    units [q U0, (q+1) U0) of every layer and joint columns [q JC0, (q+1)
    JC0) (JC0 a multiple of 4), and its blob holds, each piece at a 16-byte
    offset: the embedding (n_embed rows of Hp bytes); per layer its units'
    wt_i and wt_h rows (unit-major, gates i f g o: row 4u + g, Hp bytes),
    mi / mh / b_grid at 4u + g and mi2 / mh2 / b2_grid at u (int32); the
    slice's wt_enc rows (Dep bytes) and wt_pred rows (Hp); every wt_out row
    cut to the slice (JCp bytes); m_f / m_g / b_j over the slice and m_o /
    b_out_logit over every output (int32); the i-sigmoid's table
    (``conv_block.sigmoid_table``, SIG_TAB bytes).  Hp, Dep, JCp: H, De,
    JC0 rounded up to 16 (zero padding).  Returns {"units", "jslice", "off":
    {name: offset}, "blob_bytes"}."""
    if layers > GREEDY_MAX_LAYERS:
        raise NotImplementedError(f"rnnt_greedy takes at most {GREEDY_MAX_LAYERS} layers")
    u0 = -(-hid // GREEDY_CLUSTER)
    jc0 = -(-joint // (4 * GREEDY_CLUSTER)) * 4
    hp, dep, jcp = _rup16(hid), _rup16(de), _rup16(jc0)
    off, o = {}, 0
    pieces = [("embed", n_embed * hp)]
    for li in range(layers):
        pieces += [(f"l{li}.wi", 4 * u0 * hp), (f"l{li}.wh", 4 * u0 * hp)]
        pieces += [(f"l{li}.{k}", 16 * u0) for k in ("mi", "mh", "b_grid")]
        pieces += [(f"l{li}.{k}", 4 * u0) for k in ("mi2", "mh2", "b2_grid")]
    pieces += [("wenc", jc0 * dep), ("wpred", jc0 * hp), ("wout", vout * jcp)]
    pieces += [(k, 4 * jc0) for k in ("m_f", "m_g", "b_j")]
    pieces += [(k, 4 * vout) for k in ("m_o", "b_out_logit")] + [("sig", SIG_TAB)]
    for name, nbytes in pieces:
        off[name] = o
        o += _rup16(nbytes)
    return {"units": u0, "jslice": jc0, "off": off, "blob_bytes": o}


def _greedy_dims(tables):
    jt = tables["joint"]
    return {"hid": tables["embed"].shape[1], "layers": len(tables["layers"]),
            "joint": jt["wt_enc"].shape[0], "vout": jt["wt_out"].shape[0],
            "de": jt["wt_enc"].shape[1], "n_embed": tables["embed"].shape[0]}


def greedy_blob(tables, lay) -> np.ndarray:
    """(GREEDY_CLUSTER, blob_bytes) uint8: each CTA's blob (``greedy_layout``)
    packed from the tables' (K-contiguous) device tensors."""
    def host(t):
        return t.detach().cpu().numpy()

    d = _greedy_dims(tables)
    hid, joint, de = d["hid"], d["joint"], d["de"]
    u0, jc0, off = lay["units"], lay["jslice"], lay["off"]
    hp, dep, jcp = _rup16(hid), _rup16(de), _rup16(jc0)
    emb = host(tables["embed"])
    layers = [{k: host(t[k]) for k in _LAYER_KEYS} for t in tables["layers"]]
    jt = {k: host(tables["joint"][k]) for k in _JOINT_KEYS}
    sig = sigmoid_table("cpu").numpy()
    blob = np.zeros((GREEDY_CLUSTER, lay["blob_bytes"]), np.uint8)

    def rows8(b, name, a, width):
        n, k = a.shape
        b[off[name]:off[name] + n * width].reshape(n, width)[:, :k] = a.view(np.uint8)

    def vec32(b, name, a):
        a = np.ascontiguousarray(a, "<i4").view(np.uint8)
        b[off[name]:off[name] + a.size] = a

    for q in range(GREEDY_CLUSTER):
        b = blob[q]
        rows8(b, "embed", emb, hp)
        units = np.arange(q * u0, min(hid, (q + 1) * u0))
        gate_cols = (units[:, None] + hid * np.arange(4)[None, :]).reshape(-1)   # 4u + g
        for li, t in enumerate(layers):
            rows8(b, f"l{li}.wi", t["wt_i"][gate_cols], hp)
            rows8(b, f"l{li}.wh", t["wt_h"][gate_cols], hp)
            for k in ("mi", "mh", "b_grid"):
                vec32(b, f"l{li}.{k}", t[k][gate_cols])
            for k in ("mi2", "mh2", "b2_grid"):
                vec32(b, f"l{li}.{k}", t[k][2 * hid + units])
        ks = np.arange(q * jc0, min(joint, (q + 1) * jc0))
        rows8(b, "wenc", jt["wt_enc"][ks], dep)
        rows8(b, "wpred", jt["wt_pred"][ks], hp)
        rows8(b, "wout", np.ascontiguousarray(jt["wt_out"][:, ks]), jcp)
        for k in ("m_f", "m_g", "b_j"):
            vec32(b, k, jt[k][ks])
        for k in ("m_o", "b_out_logit"):
            vec32(b, k, jt[k])
        b[off["sig"]:off["sig"] + SIG_TAB] = sig
    return blob


def _greedy_pack(tables, dev: torch.device):
    """(the blob on ``dev``, the static integer arguments by name) for the
    tables, built once and kept while ``_check_tables``' validation
    holds."""
    _check_tables(tables, dev)
    valid = tables["_valid"]
    pk = tables.get("_greedy")
    if pk is not None and pk[0] is valid:
        return pk[1], pk[2]
    d = _greedy_dims(tables)
    lay = greedy_layout(**d)
    jt = tables["joint"]
    args = {"kDe": d["de"], "kHid": d["hid"], "kLayers": d["layers"], "kJ": d["joint"],
            "kV": d["vout"], "kNEmbed": d["n_embed"], "kN8": 2 ** (tables["act_bit"] - 1) - 1,
            "kEF": jt["e_f"], "kEG": jt["e_g"], "kEO": jt["e_o"], "kMC2": tables["m_c2"],
            "kEC2": tables["e_c2"], "kMH": tables["m_h"], "kEH": tables["e_h"],
            "kCluster": GREEDY_CLUSTER, "kUnits": lay["units"], "kJSlice": lay["jslice"],
            "kBlobBytes": lay["blob_bytes"]}
    names = {"embed": "kOffEmbed", "wenc": "kOffWenc", "wpred": "kOffWpred",
             "wout": "kOffWout", "m_f": "kOffMf", "m_g": "kOffMg", "b_j": "kOffBj",
             "m_o": "kOffMo", "b_out_logit": "kOffBo", "sig": "kOffSig"}
    args.update({names[k]: lay["off"][k] for k in names})
    lkeys = ("wi", "wh", "mi", "mh", "b_grid", "mi2", "mh2", "b2_grid")
    for li, t in enumerate(tables["layers"]):
        args.update({f"kOffLayer{li}.{c}": lay["off"][f"l{li}.{k}"]
                     for c, k in zip(_LAYER_OFFS, lkeys)})
        args.update({f"kExpLayer{li}.{c}": t[k] for c, k in zip(_LAYER_EXPS,
                                                                ("ei", "eh", "ei2", "eh2"))})
    blob = torch.from_numpy(greedy_blob(tables, lay).view(np.int8)).to(dev)
    tables["_greedy"] = (valid, blob, args)
    return blob, args


def rnnt_greedy_plain(tables, enc: torch.Tensor, enc_lens, carry, max_symbols_per_step: int,
                      blank_id: int):
    """Plain torch version of ``rnnt_greedy`` (same arguments and result):
    each row decodes in a loop of its own on ``pred_step_frozen`` /
    ``joint_logits_frozen`` (integer products as integer matmuls on the
    CPU, exact float64 on the card)."""
    from qasr_tpu_torch.quantize.rnnt_freeze import joint_logits_frozen, pred_step_frozen

    g8, h8, c_q = carry
    b_n, t_n = enc.shape[0], enc.shape[1]
    cap = max_symbols_per_step
    lens = np.clip(np.asarray(torch.as_tensor(enc_lens).cpu(), np.int64), 0, t_n)
    out = np.full((b_n, 2 + t_n * cap), -1, np.int32)
    g_out, h_out, c_out = g8.clone(), h8.clone(), c_q.clone()
    for b in range(b_n):
        g, h, c = g8[b:b + 1], h8[:, b:b + 1], c_q[:, b:b + 1]
        ids, steps = [], 0
        for t in range(int(lens[b])):
            e = enc[b:b + 1, t].to(torch.float32)
            for _ in range(cap):
                tok = int(joint_logits_frozen(tables, e, g).argmax(dim=-1)[0])
                steps += 1
                if tok == blank_id:
                    break
                ids.append(tok)
                g, h, c = pred_step_frozen(
                    tables, torch.full((1,), tok, dtype=torch.int32, device=enc.device), h, c)
        out[b, :2] = len(ids), steps
        out[b, 2:2 + len(ids)] = ids
        g_out[b], h_out[:, b], c_out[:, b] = g[0], h[:, 0], c[:, 0]
    return torch.from_numpy(out).to(enc.device), (g_out, h_out, c_out)


def rnnt_greedy(tables, enc: torch.Tensor, enc_lens, carry, max_symbols_per_step: int,
                blank_id: int):
    """The greedy emit loop over (B, T, De) float32 encoder frames with
    lengths ``enc_lens`` (B,) (a tensor or array; lengths past T read as
    T), from the integer carry (g8 (B, H) int8, h8 (L, B, H) int8, c_q (L,
    B, H) int32): each row, at each of its frames, takes joint -> argmax
    and stops at ``blank_id`` or after ``max_symbols_per_step`` emissions,
    else steps the prediction network with the token.  Returns ((B, 2 + T
    cap) int32: per row its symbols, its joint steps, its ids and -1 after
    them; the new carry).  One launch on the card, in the form that the C
    entry's shared-memory plan picks ("resident" where a CTA's weights and
    a row's state fit in shared memory, else "streamed"): the launch
    counts go to ``launches`` and ``forms``, the plan to ``last_config``.
    CPU tensors take ``rnnt_greedy_plain``."""
    if enc.device.type == "cpu":
        return rnnt_greedy_plain(tables, enc, enc_lens, carry, max_symbols_per_step, blank_id)
    _check_cuda("rnnt_greedy", enc)
    if tables["activation"] != "relu":
        raise NotImplementedError("the frozen joint takes relu (the float joint's default)")
    dev = enc.device
    blob, static = _greedy_pack(tables, dev)
    g8, h8, c_q = carry
    n_l, hid, de = static["kLayers"], static["kHid"], static["kDe"]
    if enc.dtype != torch.float32 or enc.dim() != 3 or enc.shape[2] != de:
        raise ValueError(f"rnnt_greedy: needs float32 (B, T, {de}) frames, got {enc.dtype} "
                         f"{tuple(enc.shape)}")
    b_n, t_n = enc.shape[0], enc.shape[1]
    if (enc.stride(2) != 1 or enc.stride(0) % 4 or enc.stride(1) % 4 or enc.data_ptr() % 16
            or max(enc.stride(0), enc.stride(1)) >= 2 ** 31):
        enc = enc.contiguous()
    check_vec("rnnt_greedy", "g8", g8, torch.int8, (b_n, hid), dev)
    check_vec("rnnt_greedy", "h8", h8, torch.int8, (n_l, b_n, hid), dev)
    check_vec("rnnt_greedy", "c_q", c_q, torch.int32, (n_l, b_n, hid), dev)
    if not 0 <= blank_id < static["kV"] or max_symbols_per_step < 1:
        raise ValueError(f"rnnt_greedy: blank {blank_id} outside [0, {static['kV']}) or "
                         f"max_symbols_per_step {max_symbols_per_step} < 1")
    if t_n == 0:
        return (torch.zeros((b_n, 2), dtype=torch.int32, device=dev),
                (g8.clone(), h8.clone(), c_q.clone()))
    if isinstance(enc_lens, torch.Tensor) and enc_lens.device == dev:
        lens = enc_lens.to(torch.int32).contiguous()
    else:   # from the host without a sync: a pinned buffer, copied on the stream
        lens = torch.from_numpy(np.ascontiguousarray(
            np.asarray(torch.as_tensor(enc_lens).cpu()), np.int32)).pin_memory().to(
            dev, non_blocking=True)
    check_vec("rnnt_greedy", "enc_lens", lens, torch.int32, (b_n,), dev)
    out = torch.empty((b_n, 2 + t_n * max_symbols_per_step), dtype=torch.int32, device=dev)
    g_out, h_out, c_out = torch.empty_like(g8), torch.empty_like(h8), torch.empty_like(c_q)
    args = dict(static, kBatch=b_n, kT=t_n, kCap=max_symbols_per_step, kBlank=blank_id,
                kEncSB=enc.stride(0), kEncST=enc.stride(1))
    iargs = (ctypes.c_int * len(GREEDY_ARGS))(*(int(args.get(k, 0)) for k in GREEDY_ARGS))
    cfg = (ctypes.c_int * 4)()
    rc = _build.library().qasr_rnnt_greedy(
        _build.ptr(enc), _build.ptr(lens), _build.ptr(g8), _build.ptr(h8), _build.ptr(c_q),
        _build.ptr(g_out), _build.ptr(h_out), _build.ptr(c_out), _build.ptr(out),
        _build.ptr(blob), ctypes.addressof(iargs), len(GREEDY_ARGS),
        ctypes.c_float(tables["joint"]["S_enc"]), ctypes.addressof(cfg),
        _build.stream_of(enc))
    _build.check(rc, "rnnt_greedy")
    ran = "resident" if cfg[0] else "streamed"
    rnnt_greedy.launches += 1
    rnnt_greedy.forms[ran] += 1
    rnnt_greedy.last_config = {"form": ran, "rows": cfg[1], "clusters": cfg[2],
                               "smem": cfg[3]}
    return out, (g_out, h_out, c_out)


rnnt_greedy.launches = 0
rnnt_greedy.forms = {"resident": 0, "streamed": 0}
rnnt_greedy.last_config = None


def cluster_exchange(iters: int, clusters: int = 1, exchange: bool = True,
                     device=None) -> torch.Tensor:
    """Launch ``iters`` dependent rounds of one cluster barrier (each after
    every CTA has pushed a word into every CTA's shared memory, when
    ``exchange``) on ``clusters`` clusters of GREEDY_CLUSTER CTAs: the
    latency floor of a ``rnnt_greedy`` step's exchange, timed by the
    caller.  A measurement launch, off the decode path; returns its
    (clusters x GREEDY_CLUSTER,) int32 output."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"cluster_exchange: unsupported device {dev}")
    out = torch.empty((clusters * GREEDY_CLUSTER,), dtype=torch.int32, device=dev)
    rc = _build.library().qasr_cluster_exchange(iters, GREEDY_CLUSTER, int(exchange), clusters,
                                                _build.ptr(out), _build.stream_of(out))
    _build.check(rc, "cluster_exchange")
    return out
