"""Kernel 9's whole greedy decode, ``rnnt_greedy`` (qasr_tpu_torch/kernels/
rnnt_decoder.py), on the CPU against the JAX package, at tiny widths (H 16
/ 32, J 32, V+1 9, De 32, L 1 / 2).

(a) On CPU tensors ``rnnt_greedy`` runs its plain version (a loop of its
    own for each row); its ids and final (g8, h8, c_q) equal the JAX
    package's jitted ``greedy_decode_frames_frozen`` on the same tables
    (frozen by the JAX package, carried across by
    ``compat/from_jax.py::rnnt_model_from_jax``): B=3 with unequal lengths
    and one zero, caps 1 / 2 / 10, the random head and a blank-biased one,
    and over two chunks with the carry fed back.
(b) Each row's joint steps equal a count from the JAX loop's trace (the
    loop run a frame at a time): the sum over the row's frames of emits +
    [emits < cap].
(c) The kernel's host side: each CTA's blob holds every piece where
    ``greedy_layout`` puts it (read back into the tables, ragged slices
    and zero padding included), the integer arguments follow
    rnnt_decoder.cu's ``greedy::Arg``, the forms the shared-memory plan
    picks, and the decode's launch plan.
(d) Importing the new code imports neither jax nor qasr_tpu.
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qasr_tpu.models import rnnt as JR
from qasr_tpu.models.config import DecoderConfig as JDec
from qasr_tpu.models.config import ModelConfig as JModel
from qasr_tpu.models.rnnt_model import RNNTModel as JaxRNNTModel
from qasr_tpu.quantize import rnnt_freeze as JF
from qasr_tpu_torch.compat.from_jax import rnnt_model_from_jax
from qasr_tpu_torch.kernels import rnnt_decoder as K9
from qasr_tpu_torch.quantize import rnnt_freeze as PF
from test_jasper_model import FEAT, tiny_encoder_cfg

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((1, 32), (2, 16))    # (L, H)
# the heads: the random one, and one whose blank out bias is raised until
# these frames give blanks at most frames (a shape's own amount)
HEADS = ("random", "blank-biased")
BLANK_BIAS = {(1, 32): 0.2, (2, 16): 0.8}
CAPS = (1, 2, 10)
B, T, DE, SPLIT = 3, 8, 32, 3
LENS = np.asarray([T, 5, 0], np.int32)
_MODELS = {}


def _pair(n_l, hid, head):
    """(JAX host tables, JAX config, the port's CPU tables, its config): a
    JAX transducer with a tiny head (V+1 9, J 32, De 32; the blank's out
    bias raised for the blank-biased head), its decoder frozen by the JAX
    package and carried into the port by ``rnnt_model_from_jax``."""
    key = (n_l, hid, head)
    bias = BLANK_BIAS[n_l, hid] if head == "blank-biased" else 0.0
    if key not in _MODELS:
        rcfg = JR.RNNTConfig(num_classes=8, enc_hidden=DE, pred_hidden=hid, joint_hidden=32,
                             pred_rnn_layers=n_l)
        jm = JaxRNNTModel.from_config(JModel(encoder=tiny_encoder_cfg(),
                                             decoder=JDec(feat_in=40, num_classes=8),
                                             preprocessor={"features": FEAT, "dither": 0.0}),
                                      rnnt_cfg=rcfg, seed=hid + n_l)
        jm.params["rnnt"]["joint"]["out"]["b"][rcfg.blank_id] += bias
        jm.dec_frozen = JF.freeze_rnnt_decoder(jm.params["rnnt"], rcfg, enc_range=3.0,
                                               joint_range=5.0)
        pm = rnnt_model_from_jax(jm)
        _MODELS[key] = (jm.dec_frozen, rcfg, pm.decoder_tables(torch.device("cpu")), pm.rnnt_cfg)
    return _MODELS[key]


def _frames(seed=0):
    return (np.random.default_rng(seed).normal(size=(B, T, DE)) * 2).astype(np.float32)


def _jax_decode(jt, jc, enc, lens, carry, cap):
    g8, (h8, c_q), hyps = JF.greedy_decode_frames_frozen(jt, jc, enc, lens, carry, cap)
    return np.asarray(g8), np.asarray(h8), np.asarray(c_q), hyps


def _port_decode(dt, pc, enc, lens, carry, cap):
    res, (g8, h8, c_q) = K9.rnnt_greedy(dt, torch.from_numpy(enc), torch.from_numpy(lens), carry,
                                        cap, pc.blank_id)
    res = res.numpy()
    assert res.shape == (enc.shape[0], 2 + enc.shape[1] * cap)
    ids = [row[2:2 + row[0]].tolist() for row in res]
    assert all((row[2 + row[0]:] == -1).all() for row in res)
    return res, ids, (g8, h8, c_q)


def _port_carry(carry):
    g8, (h8, c_q), _ = carry
    return g8, h8, c_q


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("n_l,hid", SHAPES)
def test_greedy_matches_jax(n_l, hid, head, cap):
    jt, jc, dt, pc = _pair(n_l, hid, head)
    enc = _frames()
    jg, jh, jcq, want = _jax_decode(jt, jc, enc, LENS, JF.frozen_decoder_init(jt, jc, B), cap)
    res, ids, (g8, h8, c_q) = _port_decode(dt, pc, enc, LENS,
                                           _port_carry(PF.frozen_decoder_init(dt, pc, B)), cap)
    assert ids == want and any(want) and not want[2]
    assert np.array_equal(g8.numpy(), jg) and np.array_equal(h8.numpy(), jh)
    assert np.array_equal(c_q.numpy(), jcq)
    assert res[2, 1] == 0   # the row without frames takes no step


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("n_l,hid", SHAPES)
def test_greedy_two_chunks_match_jax(n_l, hid, head):
    """A second chunk decoded from the first's carry (strided frames), as
    the streaming transducer feeds it."""
    jt, jc, dt, pc = _pair(n_l, hid, head)
    enc = _frames(1)
    jcarry = JF.frozen_decoder_init(jt, jc, B)
    pcarry = _port_carry(PF.frozen_decoder_init(dt, pc, B))
    ids = [[] for _ in range(B)]
    for t0, t1 in ((0, SPLIT), (SPLIT, T)):
        lens = np.clip(LENS - t0, 0, t1 - t0).astype(np.int32)
        jcarry = JF.greedy_decode_frames_frozen(jt, jc, enc[:, t0:t1], lens, jcarry, 10)
        _, got, pcarry = _port_decode(dt, pc, enc[:, t0:t1], lens, pcarry, 10)
        ids = [a + b for a, b in zip(ids, got)]
    assert ids == jcarry[2] and any(ids)
    for got, want in zip(pcarry, (jcarry[0],) + tuple(jcarry[1])):
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("n_l,hid", SHAPES)
def test_joint_steps_match_jax_trace(n_l, hid, head, cap):
    """A row's joint steps: at each of its frames one an emission and one
    for the blank that ends the frame below the cap."""
    jt, jc, dt, pc = _pair(n_l, hid, head)
    enc = _frames(2)
    carry = JF.frozen_decoder_init(jt, jc, B)
    want = np.zeros(B, np.int64)
    for t in range(T):
        before = [len(h) for h in carry[2]]
        carry = JF.greedy_decode_frames_frozen(jt, jc, enc[:, t:t + 1],
                                               (LENS > t).astype(np.int32), carry, cap)
        emits = np.asarray([len(h) for h in carry[2]]) - before
        want += np.where(LENS > t, emits + (emits < cap), 0)
    res, ids, _ = _port_decode(dt, pc, enc, LENS,
                               _port_carry(PF.frozen_decoder_init(dt, pc, B)), cap)
    assert ids == carry[2]
    assert res[:, 1].tolist() == want.tolist() and res[:, 0].tolist() == [len(i) for i in ids]
    stats = {}
    PF.greedy_decode_frames_frozen(dt, pc, torch.from_numpy(enc), LENS,
                                   PF.frozen_decoder_init(dt, pc, B), cap, stats=stats)
    assert stats["joint_steps"] == want.tolist() and stats["max_row_steps"] == want.max()


def _read_blob(blob, lay, cluster, dims):
    """The tables as the kernel reads them back out of the CTAs' blobs."""
    hid, n_l, joint, vout, de, n_emb = (dims[k] for k in ("hid", "layers", "joint", "vout",
                                                          "de", "n_embed"))
    u0, jc0, off = lay["units"], lay["jslice"], lay["off"]
    hp, dep, jcp = (-(-n // 16) * 16 for n in (hid, de, jc0))

    def rows8(b, name, n, width, k):
        a = b[off[name]:off[name] + n * width].reshape(n, width).view(np.int8)
        assert not a[:, k:].any()   # zero padding
        return a[:, :k]

    def vec32(b, name, n):
        return b[off[name]:off[name] + 4 * n].view("<i4")

    out = {"embed": [], "layers": [{k: np.zeros((4 * hid, hid if k.startswith("wt") else 1),
                                                np.int64) for k in K9._LAYER_KEYS}
                                   for _ in range(n_l)],
           "joint": {"wt_enc": np.zeros((joint, de), np.int64),
                     "wt_pred": np.zeros((joint, hid), np.int64),
                     "wt_out": np.zeros((vout, joint), np.int64)}}
    for k in ("m_f", "m_g", "b_j"):
        out["joint"][k] = np.zeros(joint, np.int64)
    for q in range(cluster):
        b = blob[q]
        out["embed"].append(rows8(b, "embed", n_emb, hp, hid))
        units = range(q * u0, min(hid, (q + 1) * u0))
        for li, lt in enumerate(out["layers"]):
            for k, name in (("wt_i", "wi"), ("wt_h", "wh")):
                w = rows8(b, f"l{li}.{name}", 4 * u0, hp, hid)
                for j, u in enumerate(units):
                    for g in range(4):
                        lt[k][g * hid + u] = w[4 * j + g]
                assert not w[4 * len(units):].any()
            for k in ("mi", "mh", "b_grid"):
                v = vec32(b, f"l{li}.{k}", 4 * u0)
                for j, u in enumerate(units):
                    lt[k][u + hid * np.arange(4), 0] = v[4 * j:4 * j + 4]
            for k in ("mi2", "mh2", "b2_grid"):
                v = vec32(b, f"l{li}.{k}", u0)
                for j, u in enumerate(units):
                    lt[k][2 * hid + u, 0] = v[j]
        ks = range(q * jc0, min(joint, (q + 1) * jc0))
        jt = out["joint"]
        for k, name, width in (("wt_enc", "wenc", dep), ("wt_pred", "wpred", hp)):
            w = rows8(b, name, jc0, width, jt[k].shape[1])
            jt[k][list(ks)] = w[:len(ks)]
            assert not w[len(ks):].any()
        wo = rows8(b, "wout", vout, jcp, jc0)
        jt["wt_out"][:, list(ks)] = wo[:, :len(ks)]
        assert not wo[:, len(ks):].any()
        for k in ("m_f", "m_g", "b_j"):
            jt[k][list(ks)] = vec32(b, k, jc0)[:len(ks)]
        for k in ("m_o", "b_out_logit"):
            jt[k] = vec32(b, k, vout)
        out.setdefault("sig", []).append(b[off["sig"]:off["sig"] + K9.SIG_TAB])
    return out


@pytest.mark.parametrize("hid,joint", [(32, 32), (20, 36)])
def test_greedy_blob_layout(hid, joint):
    """Every CTA's blob, read back as the kernel reads it, gives the
    tables (the (20, 36) case has ragged slices and CTAs with no units or
    no joint columns); pieces sit at 16-byte offsets."""
    from qasr_tpu_torch.models.rnnt import RNNTConfig, init_rnnt_params

    cfg = RNNTConfig(num_classes=8, enc_hidden=28, pred_hidden=hid, joint_hidden=joint,
                     pred_rnn_layers=2)
    dt = PF.rnnt_tables_to_device(PF.freeze_rnnt_decoder(init_rnnt_params(4, cfg), cfg,
                                                         enc_range=3.0, joint_range=5.0), "cpu")
    dims = K9._greedy_dims(dt)
    lay = K9.greedy_layout(**dims)
    assert all(o % 16 == 0 for o in lay["off"].values()) and lay["blob_bytes"] % 16 == 0
    blob = K9.greedy_blob(dt, lay)
    assert blob.shape == (K9.GREEDY_CLUSTER, lay["blob_bytes"])
    got = _read_blob(blob, lay, K9.GREEDY_CLUSTER, dims)
    assert all(np.array_equal(e, dt["embed"].numpy()) for e in got["embed"])
    for lt, want in zip(got["layers"], dt["layers"]):
        for k in ("wt_i", "wt_h"):
            assert np.array_equal(lt[k], want[k].numpy())
        for k in ("mi", "mh", "b_grid"):
            assert np.array_equal(lt[k][:, 0], want[k].numpy())
        for k in ("mi2", "mh2", "b2_grid"):   # the g gate's columns only
            assert np.array_equal(lt[k][2 * hid:3 * hid, 0], want[k].numpy()[2 * hid:3 * hid])
    for k, v in got["joint"].items():
        assert np.array_equal(v, dt["joint"][k].numpy()), k
    # the i-sigmoid table the cell reads, equal to the plain function
    from qasr_tpu_torch.ops.integer_sigmoid import i_sigmoid_grid
    q = torch.arange(K9.SIG_TAB, dtype=torch.int32)
    assert all(np.array_equal(t, i_sigmoid_grid(q).numpy()) for t in got["sig"])


def test_greedy_args_follow_the_kernel_enum():
    src = (ROOT / "qasr_tpu_torch/kernels/csrc/rnnt_decoder.cu").read_text()
    body = re.search(r"enum Arg : int \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"\b(k[A-Z]\w*)\b", body.split("kOffLayer,")[0])
    consts = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", src))
    assert names + ["kOffLayer"] == [n for n in K9.GREEDY_ARGS if "." not in n] + ["kOffLayer"]
    assert int(consts["kMaxLayers"]) == K9.GREEDY_MAX_LAYERS
    assert int(consts["kMaxCluster"]) == K9.GREEDY_CLUSTER
    per_layer = len(re.search(r"enum LayerOff : int \{(.*?)\}", src).group(1).split(","))
    per_exp = len(re.search(r"enum LayerExp : int \{(.*?)\}", src).group(1).split(","))
    assert len(K9.GREEDY_ARGS) == len(names) + K9.GREEDY_MAX_LAYERS * (per_layer + per_exp)


def test_greedy_forms_and_launch_plan():
    """The serving head (H = J = 320, one layer, V+1 29, De 256) packs into
    a CTA's shared memory with room for the rows' state, so the kernel's
    plan keeps it resident in a cluster of 8; the blob of two layers, or of
    H 640, exceeds shared memory, so those stream from L2.  A decode plans
    one rnnt_greedy a call and the start-of-sequence pred step a layer."""
    from qasr_tpu_torch.models.rnnt import RNNTConfig, init_rnnt_params

    src = (ROOT / "qasr_tpu_torch/kernels/csrc/gemm_s8.cuh").read_text()
    smem = int(re.search(r"constexpr int kSmemLimit = (\d+);", src).group(1))

    def tables(hid, n_l):
        cfg = RNNTConfig(num_classes=28, enc_hidden=256, pred_hidden=hid, joint_hidden=320,
                         pred_rnn_layers=n_l)
        host = PF.freeze_rnnt_decoder(init_rnnt_params(0, cfg), cfg, enc_range=4.0,
                                      joint_range=6.0)
        return PF.rnnt_tables_to_device(host, "cpu")

    def blob_bytes(t):
        return K9.greedy_layout(**K9._greedy_dims(t))["blob_bytes"]

    serving = tables(320, 1)
    lay = K9.greedy_layout(**K9._greedy_dims(serving))
    assert lay["units"] == 40 and lay["jslice"] == 40
    assert smem - lay["blob_bytes"] >= 64 * 1024
    assert all(blob_bytes(tables(h, n)) > smem for h, n in ((320, 2), (640, 1), (640, 2)))
    assert PF.decoder_launches(serving, {"calls": 1}) == {"rnnt_greedy": 1, "rnnt_pred": 1}


def test_greedy_code_imports_neither_jax_nor_reference():
    code = ("import sys; import qasr_tpu_torch.kernels.rnnt_decoder, "
            "qasr_tpu_torch.quantize.rnnt_freeze, qasr_tpu_torch.decode.streaming; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'qasr_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(ROOT))
