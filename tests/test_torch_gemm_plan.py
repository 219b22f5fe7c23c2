"""Tile plans of the int8 GEMM kernels on the wgmma / TMA mainloop
(kernels/csrc/gemm_s8.cuh): Kernel 2 ``pw_gemm`` and Kernel 5
``lin_epilogue``.

Each wrapper's ``plan`` states the tiles, the stages and the dynamic shared
memory its .cu uses, and ``check_launch`` is the wrapper's shape check on a
CUDA launch.  QuartzNet15x5's serving path runs here on the CPU (the
wrappers take their plain versions) with every launch recorded: every
launch in both dyadic modes (94, the C3 and decoder prologues on int32
inputs among them) must fit a block's shared memory, meet TMA's alignment
and pass the shape check.  (The Conformer-CTC 16x256's Kernel 5 launches
are held to the same inside test_torch_conformer's golden forwards.)
"""
from __future__ import annotations

import pytest
import torch

from qasr_tpu_torch import golden
from qasr_tpu_torch.kernels import lin_epilogue as port_lin
from qasr_tpu_torch.kernels import pw_gemm as port_pw
from qasr_tpu_torch.models.ctc_model import frozen_executor
from qasr_tpu_torch.quantize import freeze as port_freeze

SM_SMEM = 233472      # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # the system's share of it per resident block


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: with several test workers on the same cores,
    torch's default thread pool makes the flagship's integer walk ~70x slower;
    its integer results do not depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _blocks_per_sm(smem: int) -> int:
    return SM_SMEM // (smem + BLOCK_RESERVED)


def _assert_tma_aligned(plan: dict, row_pitches) -> None:
    """TMA boxes of bm or bn rows x 128 bytes with the 128B swizzle: the
    box's inner extent is the swizzle span, at most 256 rows, every row
    pitch a multiple of 16 bytes, and every tile (a K chunk of bm or bn
    rows) starting on the swizzle's 1024-byte repeat."""
    assert port_pw.CHUNK == port_lin.CHUNK == 128
    assert plan["bm"] <= 256 and plan["bn"] <= 256
    assert plan["bm"] % 8 == 0 and plan["bn"] % 8 == 0
    assert (plan["bm"] * 128) % 1024 == 0 and (plan["bn"] * 128) % 1024 == 0
    assert all(p % 16 == 0 for p in row_pitches), row_pitches


def _record(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def recording(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    monkeypatch.setattr(module, name, recording)
    return calls


@pytest.fixture(scope="module")
def quartznet():
    return golden.quartznet15x5_w6a6()


@pytest.mark.parametrize("dyadic", ["static_e", "per_channel"])
def test_pw_gemm_plan_takes_every_quartznet_launch(quartznet, monkeypatch, dyadic):
    model = quartznet
    tables = model.freeze(dyadic, device="cpu")
    calls = _record(monkeypatch, port_freeze, "pw_gemm")
    feats, lens = golden.golden_features(model.plan.feat_in)
    golden.frozen_from_features(model, tables, feats, lens, executor=frozen_executor(tables))
    assert len(calls) == port_freeze.kernel_launches(model.plan, tables)["pw_gemm"] == 94
    sites = set()
    for (x, wt), kw in calls:
        b, t, cin = x.shape
        cout = wt.shape[0]
        pro = kw.get("m1") is not None
        plan = port_pw.check_launch(b * t, cin, cout, pro, x.dtype)
        assert plan == port_pw.plan(cin, cout)
        assert plan["smem"] <= port_pw.SMEM_LIMIT
        assert _blocks_per_sm(plan["smem"]) >= 2, (cin, cout, plan)
        # x by TMA (prologue off) and wt always: rows of Cin int8
        _assert_tma_aligned(plan, [cin])
        sites.add((cin, cout, pro, x.dtype))
    if dyadic == "static_e":
        # C3 and the decoder requantize a raw int32 accumulator in the prologue
        assert (512, 1024, True, torch.int32) in sites
        assert (1024, 29, True, torch.int32) in sites
        assert any(pro and dt == torch.int8 for _, _, pro, dt in sites)
    assert {cin for cin, _, _, _ in sites} == {64, 256, 512, 1024}


def test_pw_gemm_plan_layout():
    """The shared memory of csrc/pw_gemm.cu's block: the resident A tile,
    2 stages of the weight ring, the int32 staging tile, 5 mbarriers, two
    row masks and the 1024-byte alignment slack; BN 32 for Cout <= 32.
    Three blocks share an SM at Cin = 512."""
    p = port_pw.plan(512, 512)
    assert (p["bm"], p["bn"], p["stages"], p["nk"]) == (64, 64, 2, 4)
    assert p["smem"] == 64 * 512 + 2 * 64 * 128 + 64 * (4 * 64 + 32) + 8 * 5 + 2 * 64 + 1024
    assert _blocks_per_sm(p["smem"]) == 3
    assert port_pw.plan(1024, 29)["bn"] == 32 and port_pw.plan(64, 256)["nk"] == 1
    assert port_pw.plan(1000, 256)["nk"] == 8        # K padded to whole chunks


def test_lin_epilogue_plan_layout():
    """csrc/lin_epilogue.cu's block: up to 3 ring stages of a 64-row x chunk
    and a 128-row weight chunk, the int32 staging tile in the drained ring,
    the swish table, the mbarriers and the alignment slack."""
    p = port_lin.plan(12000, 4864, 256)
    assert (p["bm"], p["bn"], p["stages"], p["nk"], p["grid"]) == (64, 128, 3, 38, (188, 2))
    assert p["smem"] == 3 * (64 + 128) * 128 + 256 + 8 * 2 * 3 + 1024
    small = port_lin.plan(1, 128, 256)     # one chunk: the staging tile outgrows the ring
    assert small["stages"] == 1
    assert small["smem"] == 64 * (4 * 128 + 32) + 256 + 8 * 2 + 1024


@pytest.mark.parametrize("n_rows, cin, cout, pro, dtype", [
    (0, 256, 256, False, torch.int8),        # no rows
    (64, 200, 256, False, torch.int8),       # Cin not a multiple of 16 (TMA row pitch)
    (64, 8, 256, True, torch.int32),         # Cin below 16
    (64, 256, 256, False, torch.int32),      # int32 input needs the prologue
    (64, 4096, 256, False, torch.int8),      # the resident A tile outgrows shared memory
])
def test_pw_gemm_check_launch_refuses(n_rows, cin, cout, pro, dtype):
    with pytest.raises(ValueError):
        port_pw.check_launch(n_rows, cin, cout, pro, dtype)


@pytest.mark.parametrize("n_rows, k, d", [(0, 256, 256), (12, 100, 256), (12, 256, 0)])
def test_lin_epilogue_check_launch_refuses(n_rows, k, d):
    with pytest.raises(ValueError):
        port_lin.check_launch(n_rows, k, d)
