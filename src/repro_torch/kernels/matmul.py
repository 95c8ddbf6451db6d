"""Tiled f32 GEMM (K4) and its plain version.

The counterpart of ``repro/kernels/matmul.py``'s ``mxu128`` and
``large_tile`` algorithms behind ``repro/kernels/ops.py::matmul``:
(M, K) @ (K, N).  CUDA: ``csrc/matmul.cu`` (``rt_matmul``); the two
algorithms are tile-size choices of that one kernel (64 x 64 and
128 x 128 output tiles).  ``ksplit`` is the split-K kernel (K8), not
ported yet, and raises.

Either 2-D operand may be row-major or the transpose of a row-major
array (``x.t()``): the kernel reads both layouts in place, so the
backward GEMMs ``x2.t() @ dy2`` and ``dy2 @ wmat.t()`` need no copy.
CPU tensors take ``matmul_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt

MATMUL_ALGORITHMS = ("mxu128", "large_tile", "ksplit")


def _check(x, y, algorithm):
    if algorithm not in MATMUL_ALGORITHMS:
        raise ValueError(f"matmul: unknown algorithm {algorithm!r}")
    if algorithm == "ksplit":
        raise NotImplementedError(
            "matmul: the ksplit algorithm is the split-K kernel (K8), not "
            "ported yet (ROADMAP queue 2)")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: {tuple(x.shape)} @ {tuple(y.shape)}")


def _layout(name, t):
    """(transposed, leading dimension) of a 2-D operand the kernel reads
    in place: row-major (unit column stride) or the transpose of a
    row-major array (unit row stride); anything else raises."""
    r, c = t.shape
    s0, s1 = t.stride()
    if (s1 == 1 or c == 1) and s0 >= max(c, 1):
        return 0, max(s0, 1)
    if (s0 == 1 or r == 1) and s1 >= max(r, 1):
        return 1, max(s1, 1)
    raise ValueError(f"{name}: operand {tuple(t.shape)} with strides "
                     f"{t.stride()} is neither row-major nor transposed")


def matmul_ref(x, y, *, algorithm: str = "mxu128"):
    """Plain version of ``matmul``: ``x @ y``."""
    _check(x, y, algorithm)
    return x @ y


def matmul(x, y, *, algorithm: str = "mxu128"):
    """(M, K) @ (K, N) -> (M, N) in f32 through K4."""
    name = "matmul"
    dev = _rt.kernel_device(name, [x, y])
    _check(x, y, algorithm)
    if dev.type == "cpu":
        return matmul_ref(x, y, algorithm=algorithm)
    m, k = x.shape
    n = y.shape[1]
    a_t, lda = _layout(name, x)
    b_t, ldb = _layout(name, y)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, n, k,
                       lda, ldb, a_t, b_t, int(algorithm == "large_tile"),
                       _rt.stream_handle(dev))
    _build.check(rc, name)
    return out
