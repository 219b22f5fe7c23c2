"""Build the port's CUDA kernels from ``kernels/csrc`` at first use.

Every ``csrc/*.cu`` is compiled by nvcc for ``sm_90a`` (one nvcc process
per source, all started together) and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
Each C entry takes pointers and the stream as ``void*`` and returns
``cudaGetLastError()`` after its launch; ``check`` raises on anything but
0.  The library's file name carries a hash of the sources and flags, so an
edited source rebuilds.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C prototypes of the entries in csrc/*.cu (pointers and the stream as void*)
_SIGNATURES = {
    "qasr_dw_conv": [_P] * 6 + [_I] * 13 + [_P],
    "qasr_pw_gemm": [_P] * 8 + [_I] * 10 + [_P],
    "qasr_requant_check": [_P] * 4 + [_I, _P],
    "qasr_int_attention": [_P] * 7 + [_I] * 13 + [_P],
    "qasr_conv_block": [_P] * 11 + [_I] * 6 + [_P],
    "qasr_int_fn_check": [_I] + [_P] * 3 + [_I, _P],
    "qasr_ln_check": [_P] * 2 + [_I] * 2 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class BuildInfo:
    """What the last build or load of this process did (for reporting)."""

    path: Optional[str] = None
    seconds: float = 0.0
    compiled: bool = False
    log: str = ""


def find_nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from kernels/csrc at first use")


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu, headers


def build() -> str:
    """Compile csrc/*.cu into the build directory (if not already built
    from these exact sources); returns the library path."""
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libqasr_kernels_{h.hexdigest()[:16]}.so")
    BuildInfo.path = out
    if os.path.exists(out):
        BuildInfo.compiled = False
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [f"{tmp}.{os.path.basename(c)}.o" for c in cu]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, c], cwd=CSRC,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c, o in zip(cu, objs)]
    logs = [p.communicate()[0] for p in procs]
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    failed = [(c, p.returncode, lg) for c, p, lg in zip(cu, procs, logs) if p.returncode]
    link = None if failed else subprocess.run(cmd, capture_output=True, text=True, cwd=CSRC)
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.log = "".join(logs) + ("" if link is None else link.stdout + link.stderr)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        c, rc, lg = failed[0]
        raise RuntimeError(f"nvcc failed on {os.path.basename(c)} (exit {rc}):\n{lg}")
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{' '.join(cmd)}\n{BuildInfo.log}")
    os.replace(tmp, out)
    BuildInfo.compiled = True
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.qasr_error_string.argtypes = [ctypes.c_int]
            lib.qasr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = library().qasr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor for a void* argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_of(t):
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
