"""Kernels 2 (pw_gemm) and 5 (lin_epilogue) at their serving sites on a GPU:
each held bit for bit against its plain version, then its device time
(torch.profiler over 10 calls, chip_smoke.device_ms) beside
torch._int_mm's for the GEMM alone.

    python3 experiments/torch_gemm_sites.py

QuartzNet's B=64 x 15 s sites (N = 49,152 rows: the requant, join and
no-epilogue modes, the int8 and int32 prologues) and the Conformer-CTC
16x256's Kernel 5 sites (N = 12,000; the pos projection 749). Faster to
run than chip_smoke.py when only these two kernels change.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from qasr_tpu_torch import golden
    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels.lin_epilogue import lin_epilogue, lin_epilogue_plain
    from qasr_tpu_torch.kernels.pw_gemm import pw_gemm, pw_gemm_plain

    dev = require_cuda(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    b, t = 64, 768
    full = torch.full((b,), t, dtype=torch.int32, device=dev)

    def t8(*s):
        return torch.from_numpy(rng.integers(-64, 64, s).astype(np.int8)).to(dev)

    def t32(*s):
        return torch.from_numpy(rng.integers(-2**20, 2**20, s).astype(np.int32)).to(dev)

    def vec(c, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, c).astype(np.int32)).to(dev)

    # (Cin, Cout, epilogue, prologue input: None / int8 / int32)
    for cin, cout, mode, pro in [(64, 256, "requant", None), (256, 256, "requant", None),
                                 (512, 512, "requant", None), (512, 512, "join", None),
                                 (512, 1024, "none", None), (1024, 29, "none", None),
                                 (256, 256, "none", "int8"), (512, 1024, "none", "int32"),
                                 (1024, 29, "none", "int32")]:
        x = t32(b, t, cin) if pro == "int32" else t8(b, t, cin)
        wt = t8(cout, cin)
        kw = dict(bias=vec(cout, -3000, 3000))
        if mode != "none":
            kw.update(m=vec(cout, 2**29, 2**31 - 1), e=37, bits=6)
        if mode == "requant":
            kw.update(relu=True, lens=full)
        if mode == "join":
            kw.update(res=t32(b, t, cout), m_r=vec(cout, 2**29, 2**31 - 1), e_r=40)
        if pro is not None:
            kw.update(m1=vec(cin, 2**29, 2**31 - 1), e1=43 if pro == "int32" else 29, bits1=7,
                      in_relu=True, in_len=full if cout != 29 else None)
            if pro == "int32":
                kw["in_bias"] = vec(cin, -2**18, 2**18)
        if not torch.equal(pw_gemm(x, wt, **kw), pw_gemm_plain(x, wt, **kw)):
            raise AssertionError(f"pw_gemm {cin}->{cout} {mode} differs from plain")
        k, _ = cs.device_ms(lambda x=x, wt=wt, kw=kw: pw_gemm(x, wt, **kw), "pw_gemm_kernel")
        line = f"pw_gemm N={b * t} {cin}->{cout} {mode} prologue={pro}: {k:.4f} ms"
        if cout % 8 == 0:
            x8, wt_t = t8(b * t, cin), wt.t()
            lib, _ = cs.device_ms(lambda: torch._int_mm(x8, wt_t))
            line += f", torch._int_mm {lib:.4f} ms (x{k / lib:.2f})"
        print(line, flush=True)
    tables = golden.conformer16x256_w8a8().freeze(dev)
    for label, mode, site, kw in cs._lin_sites(tables):
        dout, kin = site["wt"].shape
        rows = 749 if label.startswith("pos") else 12000
        x = t8(rows, kin)
        args = dict(kw, nbits=8)
        if mode == "join":
            args["stream8"] = t8(rows, dout)
        if not torch.equal(lin_epilogue(x, site, **args), lin_epilogue_plain(x, site, **args)):
            raise AssertionError(f"lin_epilogue {label} differs from plain")
        k, _ = cs.device_ms(lambda: lin_epilogue(x, site, **args), "lin_epilogue_kernel")
        wt_t = site["wt"].t()
        lib, _ = cs.device_ms(lambda: torch._int_mm(x, wt_t))
        print(f"lin_epilogue N={rows} {label} {mode}: {k:.4f} ms, torch._int_mm {lib:.4f} ms "
              f"(x{k / lib:.2f})", flush=True)


if __name__ == "__main__":
    main()
