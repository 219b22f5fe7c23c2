"""Kernel 4: the frozen Conformer's attention-output join plus its whole
conv module (kernels/csrc/conv_block.cu).

Replaces qasr_tpu/kernels/conf_module.py::fused_conv_block.  The TPU runs
one grid step per utterance; on the H100 that would fill 32 of 132 SMs,
so the kernel splits in time instead, in two launches with ``glu8`` as
the only intermediate in device memory:

  stage A, per 64-row tile of the (B*T, d) stream: att_out GEMM + bias
  and stream requants -> x1 (kept in the output buffer); i-LayerNorm ->
  affine requant; one (d -> 2d) GLU GEMM with per-half requants and the
  i-sigmoid of the gate; rows at or past ``len`` zeroed; glu_prod requant
  -> glu8.
  stage B, per 64-frame tile of one utterance with a (K-1)/2 halo:
  depthwise taps over glu8 (zero outside [0, T)); BN affine requant;
  i-swish; pw2 GEMM with the j3 stream join against x1 -> out.

``conv_block`` launches both stages for CUDA tensors (one launch count
per call) and runs ``conv_block_plain`` (the XLA composition of
qasr_tpu/quantize/conformer_freeze.py, in torch) for CPU tensors; it
never falls back from one to the other.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from qasr_tpu_torch.kernels import _build
from qasr_tpu_torch.kernels.checks import check_vec, check_x
from qasr_tpu_torch.models.jasper import mask_values
from qasr_tpu_torch.ops.integer_layernorm import i_layernorm_core
from qasr_tpu_torch.ops.quant_prims import dyadic_requant_static
from qasr_tpu_torch.quantize.conformer_int import (
    _apply_affine_rq,
    _conv_tail_mid,
    _glu_int,
    _join_lin,
    clip8,
)

ROWS = 64            # rows per block in both stages (csrc/conv_block.cu)
MAX_D = 512


def conv_block_plain(c8: torch.Tensor, x8: torch.Tensor, lens: torch.Tensor,
                     tbl, padding, *, nbits: int) -> torch.Tensor:
    """Plain torch version: att_out join -> ln_conv -> GLU -> pad mask ->
    depthwise -> BN -> i-swish -> pw2 join.  Same arguments and result as
    ``conv_block``."""
    x1 = _join_lin(c8, tbl["att_out"], x8, tbl["j2_stream"], nbits)
    yln = _apply_affine_rq(i_layernorm_core(x1), tbl["ln_conv"], nbits)
    y_int = mask_values(_glu_int(tbl, yln, nbits), lens)
    glu8 = clip8(dyadic_requant_static(y_int, *tbl["glu_prod"]), nbits)
    mid8 = _conv_tail_mid(tbl, glu8, padding, nbits)
    return _join_lin(mid8, tbl["pw2"], x1, tbl["j3_stream"], nbits)


def _packed(tbl) -> Dict[str, Any]:
    """The kernel's table layout, built once per layer table and cached in
    it: the GLU weights interleaved so that each 64-row chunk holds 16 a-
    rows then the matching 16 g-rows, twice; the per-channel int32 vectors
    stacked (14, d); the static scalars as one int32 vector."""
    if "_conv_block" in tbl:
        return tbl["_conv_block"]
    a, g = tbl["pw1_a"], tbl["pw1_g"]
    d = a["wt"].shape[0]
    w_ag = torch.stack([a["wt"].reshape(d // 16, 16, d),
                        g["wt"].reshape(d // 16, 16, d)], dim=1).reshape(2 * d, d)
    vec = torch.stack([
        tbl["att_out"]["b"], tbl["att_out"]["m"],
        tbl["ln_conv"]["sgn"], tbl["ln_conv"]["b"], tbl["ln_conv"]["m"],
        a["b"], a["m"], g["b"], g["m"],
        tbl["dw_bn"]["sgn"], tbl["dw_bn"]["b"], tbl["dw_bn"]["m"],
        tbl["pw2"]["b"], tbl["pw2"]["m"]]).to(torch.int32).contiguous()
    scalars = [tbl["att_out"]["e"], *tbl["j2_stream"], tbl["ln_conv"]["e"],
               a["e"], g["e"], *tbl["glu_prod"], tbl["dw_bn"]["e"],
               *tbl["bn_grid"], *tbl["bn_prod"], tbl["pw2"]["e"], *tbl["j3_stream"]]
    dev = a["wt"].device
    packed = {"w_ao": tbl["att_out"]["wt"].contiguous(), "w_ag": w_ag.contiguous(),
              "dw_w": tbl["dw_w"].contiguous(), "w_2": tbl["pw2"]["wt"].contiguous(),
              "vec": vec,
              "sc": torch.tensor([int(s) for s in scalars], dtype=torch.int32, device=dev)}
    tbl["_conv_block"] = packed
    return packed


def conv_block(c8: torch.Tensor, x8: torch.Tensor, lens: torch.Tensor, tbl,
               padding, *, nbits: int) -> torch.Tensor:
    """The frozen conv-module sublayer with the attention-output join in
    front: c8 the attention context (B, T, d) int8, x8 the int8 stream
    entering the attention sublayer, lens (B,) int32, tbl one layer of
    ``conformer_tables_to_device``, padding the depthwise (left, right).
    Returns the int8 stream after the conv module's join."""
    if x8.device.type == "cpu":
        return conv_block_plain(c8, x8, lens, tbl, padding, nbits=nbits)
    if x8.device.type != "cuda":
        raise ValueError(f"conv_block: unsupported device {x8.device}")
    check_x("conv_block x8", x8, 3)
    check_x("conv_block c8", c8, 3)
    b, t, d = x8.shape
    dev = x8.device
    check_vec("conv_block", "c8", c8, torch.int8, (b, t, d), dev)
    check_vec("conv_block", "lens", lens, torch.int32, (b,), dev)
    k_size = tbl["dw_w"].shape[0]
    pad_l, pad_r = int(padding[0]), int(padding[1])
    if b * t == 0 or d % 64 or d > MAX_D or pad_l + pad_r != k_size - 1 \
            or not 2 <= nbits <= 8 or x8.data_ptr() % 16 or c8.data_ptr() % 16:
        raise ValueError(f"conv_block: needs B*T > 0, d a multiple of 64 up to "
                         f"{MAX_D}, padding summing to K-1, nbits in [2, 8] and "
                         f"aligned inputs (got B={b} T={t} d={d} K={k_size} "
                         f"padding={padding})")
    p = _packed(tbl)
    for name, shape in (("w_ao", (d, d)), ("w_ag", (2 * d, d)), ("dw_w", (k_size, d)),
                        ("w_2", (d, d)), ("vec", (14, d)), ("sc", (16,))):
        check_vec("conv_block", name, p[name], torch.int32 if name in ("vec", "sc")
                  else torch.int8, shape, dev)
    glu8 = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    out = torch.empty((b, t, d), dtype=torch.int8, device=dev)
    rc = _build.library().qasr_conv_block(
        _build.ptr(c8), _build.ptr(x8), _build.ptr(lens), _build.ptr(p["w_ao"]),
        _build.ptr(p["w_ag"]), _build.ptr(p["dw_w"]), _build.ptr(p["w_2"]),
        _build.ptr(p["vec"]), _build.ptr(p["sc"]), _build.ptr(glu8), _build.ptr(out),
        b, t, d, k_size, pad_l, 2 ** (nbits - 1) - 1, _build.stream_of(x8))
    _build.check(rc, "conv_block")
    conv_block.launches += 1
    return out


conv_block.launches = 0
