"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source compiles with its own ``nvcc`` process, all started
together, for ``sm_90a`` into an object file; one link then makes a
shared library with a plain C interface, loaded with ``ctypes``.  The
library is named by a hash of the sources, so an edited source rebuilds
and an unchanged checkout reuses what it built.  The build runs at first
use, never at import: this module imports on hosts without ``nvcc``.

The build directory is ``build/kernels`` at the root of the checkout
(listed in ``.gitignore``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("grouped_matmul.cu", "grouped_matmul_chained.cu", "conv2d.cu",
           "matmul.cu", "grouped_matmul_bwd.cu", "grouped_matmul_experts.cu",
           "grouped_matmul_experts_bwd.cu", "branch_matmul.cu")
HEADERS = ("tile_gemm.cuh", "moe_act.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

#: Seconds the last build in this process took (0.0 when it reused one).
BUILD_SECONDS = {"last": 0.0}

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong

_SIGNATURES = {
    "rt_gmm_concat": [_I, _PP, _PP, _PP, _P, _IP, _IP, _I, _IP, _IP, _P, _I,
                      _I, _I, _I, _P],
    "rt_gmm_pooled": [_I, _PP, _PP, _PP, _PP, _IP, _IP, _IP, _P, _I, _I, _I,
                      _I, _P],
    "rt_gmm_chained": [_I, _PP, _PP, _IP, _IP, _IP, _IP, _I, _PP, _IP, _I,
                       _PP, _IP, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                       _P],
    "rt_conv2d_direct": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _P],
    "rt_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_gmm_bwd": [_I, _PP, _PP, _PP, _PP, _PP, _PP, _PP, _IP, _IP, _IP, _IP,
                   _P, _I, _I, _P],
    "rt_experts_fwd": [_P] * 10 + [_I] * 7 + [_P],
    "rt_experts_bwd": [_P] * 14 + [_I] * 7 + [_P],
    "rt_branch_matmul": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _I, _I,
                         _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    fails = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            fails.append(f"$ {' '.join(cmd)}\n{out}")
    if fails:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(fails))


def build(verbose: bool = False) -> Path:
    """Compile the sources (in parallel) and link the shared library;
    returns its path.  Reuses a library built from identical sources."""
    lib = BUILD_DIR / f"libreprotorch-{_digest()}.so"
    if lib.exists():
        BUILD_SECONDS["last"] = 0.0
        return lib
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    ptxas = ("-Xptxas", "-v") if verbose else ()
    _run_all([[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler",
               "-fPIC", *ptxas, "-c", str(CSRC / s), "-o", str(o)]
              for s, o in zip(SOURCES, objs)])
    tmp = lib.with_suffix(f".{tag}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    BUILD_SECONDS["last"] = time.perf_counter() - t0
    return lib


def lib():
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = handle
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def ptrs(values) -> ctypes.Array:
    """Host array of device pointers (ints; 0 for None)."""
    vals = [0 if v is None else int(v) for v in values]
    return (ctypes.c_void_p * max(len(vals), 1))(*vals)


def ints(values) -> ctypes.Array:
    vals = [int(v) for v in values]
    return (ctypes.c_int * max(len(vals), 1))(*vals)
