"""Where the stream step's cache-form kernels spend their time on a GPU.

Writes a copy of qasr_tpu_torch into DEST (a .gitignore'd directory, by
default chip_parent/phases) whose conv_block_cached_kernel (Kernel 4) and
int_attention_cached_kernel (Kernel 3) record clock64() at their phase
boundaries (thread 0 of the first CTA), builds it, runs both on the
causal flagship's layer 0 (chip_smoke.py phase 12's inputs, a full
cache) at (B, n) (1, 4), (32, 4) and (32, 16), and prints the median
cycles from the kernel's entry to each boundary over the last runs, and
the SM clock.  The stamps go in after lines of the sources (ANCHORS); a
missing line stops the script, so it follows the kernels' code.

    python3 experiments/torch_stream_phases.py [--dest DIR] [--runs N]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (source, stamp array, the kernel's first line, [(stamp, line after which it goes)]);
# "end" goes before the kernel's closing brace
ANCHORS = [
    ("conv_block_cached.cu", "k4", "conv_block_cached_kernel(const CachedArgs p) {", [
        ("entry", "extern __shared__ __align__(16) uint8_t smem[];\n"),
        ("a_ready", "    gemm_s8::bar_sync(1, 128);\n"),
        ("a_done", "        *reinterpret_cast<short*>(X1 + rl * d + o) = qasr_pack2(v0, v1);\n"
                   "      }\n    }\n"),
        ("round0", "  qasr_cluster_wait();   // round 0\n"),
        ("x1_in", "  gemm_s8::mbar_wait(bar + 3, 0);   // every CTA's x1 columns are in the x1 "
                  "tile\n"),
        ("part_b", "  gemm_s8::mbar_wait(bar + 1, 0);   // part B\n"),
        ("ln_done", "ln_rows_cached<kMaxPer, kF64>(X1, A8, lda, Lnv, Lnf, d, dd, s_ln, p.n8, lo, "
                    "hi);\n    __syncthreads();\n"),
        ("yln_in", "  gemm_s8::mbar_wait(bar + 4, 0);   // every CTA's yln rows are in A8\n"),
        ("glu_done", "        *reinterpret_cast<short*>(G8 + rl * kCh + ol) = qasr_pack2(v[0], "
                     "v[1]);\n      }\n    }\n  }\n  __syncthreads();\n"),
        ("dw_ready", "  gemm_s8::mbar_wait(bar + 2, 0);   // part C\n  __syncthreads();\n"),
        ("dw_done", "          M8[(u * n + t) * lda * 4 + c0 + c] = static_cast<int8_t>(Sw[bn + "
                    "128]);\n        }\n      }\n    }\n  }\n  __syncthreads();\n"),
        ("mid8_in", "  gemm_s8::mbar_wait(bar + 5, 0);   // every CTA's mid8 columns are in the "
                    "mid8 tile\n")]),
    ("int_attention.cu", "k3", "int_attention_cached_kernel(const int8_t* __restrict__ qu", [
        ("entry", "extern __shared__ __align__(16) uint8_t smem_c[];\n"),
        ("qk_in", "  qasr_cp_wait<1>();\n  __syncthreads();\n"),
        ("v_in", "  qasr_cp_wait<0>();\n  __syncthreads();\n"),
        ("vt_done", "      for (int kq = 0; kq < 4; ++kq) Vt[(4 * dq + kq) * vtw + sq] = "
                    "static_cast<int>(o[kq]);\n    }\n  }\n  __syncthreads();\n"),
    ]),
]


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def instrument(dest):
    """The stamped copy of the package in ``dest``; {array: stamp names}."""
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "qasr_tpu_torch"), os.path.join(dest, "qasr_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    names = {}
    for source, arr, first, stamps in ANCHORS:
        path = os.path.join(dest, "qasr_tpu_torch", "kernels", "csrc", source)
        with open(path) as f:
            s = f.read()
        k0 = s.index(first)
        for i, (stamp, line) in enumerate(stamps):
            at = s.index(line, k0) + len(line)
            s = s[:at] + f"  QASR_STAMP({arr}, {i});\n" + s[at:]
        end = s.index("\n}\n", s.index(stamps[-1][1], k0))
        s = s[:end] + f"\n  QASR_STAMP({arr}, {len(stamps)});" + s[end:]
        names[arr] = [stamp for stamp, _ in stamps] + ["end"]
        head = (f"__device__ long long g_stamps_{arr}[32];\n"
                "#define QASR_STAMP(arr, k) do { if (blockIdx.x + blockIdx.y + blockIdx.z == 0 "
                "&& threadIdx.x == 0) g_stamps_##arr[k] = clock64(); } while (0)\n")
        s = s.replace("namespace {\n", head + "namespace {\n", 1)
        s += (f'\nextern "C" int qasr_read_stamps_{arr}(long long* h) {{\n'
              f"  return static_cast<int>(cudaMemcpyFromSymbol(h, g_stamps_{arr}, "
              f"sizeof(g_stamps_{arr})));\n}}\n")
        with open(path, "w") as f:
            f.write(s)
    return names


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dest", default=os.path.join(HERE, "chip_parent", "phases"))
    ap.add_argument("--runs", type=int, default=8, help="launches a shape (the first 3 warm)")
    args = ap.parse_args()
    names = instrument(os.path.abspath(args.dest))
    sys.path.insert(0, os.path.abspath(args.dest))
    cs = _load("smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    import numpy as np
    import torch

    from qasr_tpu_torch.device import require_cuda
    from qasr_tpu_torch.kernels import _build
    from qasr_tpu_torch.kernels.conv_block import conv_block_cached
    from qasr_tpu_torch.kernels.int_attention import int_attention_cached
    from qasr_tpu_torch.quantize.conformer_freeze import _stream_p8

    dev = require_cuda(0)
    print(cs.card_line(), flush=True)
    lib = _build.library()
    readers = {arr: getattr(lib, f"qasr_read_stamps_{arr}") for arr in names}
    for fn in readers.values():
        fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    buf = (ctypes.c_longlong * 32)()
    model, tables = cs.causal_flagship(dev)
    enc, ccfg = tables["encoder"], model.ccfg
    h, d, k_size = ccfg.n_heads, ccfg.d_model, ccfg.conv_kernel_size
    tbl, p8 = enc["layers"][0], _stream_p8(enc, ccfg)[0]
    kw = dict(ac=tbl["ac_grid"], bd=tbl["bd_grid"], ctx_rq=tbl["ctx_rq"], nbits=8)
    for b, n in cs.STREAM_TIMED:
        (qu, qv, k, v), kc, vc, c8, x8, gc = cs.stream_inputs(np.random.default_rng(17), dev, b,
                                                              n, h, d // h, d, k_size)
        runs = {"k4": lambda: conv_block_cached(c8, x8, gc, tbl, nbits=8),
                "k3": lambda: int_attention_cached(qu, qv, k, v, kc, vc, p8, 500, **kw)}
        for arr, fn in runs.items():
            rows = []
            for _ in range(args.runs):
                fn()
                torch.cuda.synchronize()
                _build.check(readers[arr](ctypes.addressof(buf)), "read stamps")
                rows.append(list(buf)[:len(names[arr])])
            cyc = np.median(np.array(rows[3:], dtype=np.int64) - np.array(rows[3:])[:, :1], 0)
            print(f"{'conv_block_cached' if arr == 'k4' else 'int_attention_cached'} B={b} "
                  f"n={n}, cycles from entry: " + ", ".join(
                      f"{name} {int(c)}" for name, c in zip(names[arr], cyc)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          "(SM clock now, max)", flush=True)


if __name__ == "__main__":
    main()
