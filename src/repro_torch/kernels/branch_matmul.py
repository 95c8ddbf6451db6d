"""Stacked independent GEMMs (K9) and their plain version.

The counterpart of ``repro/kernels/branch_matmul.py`` behind
``repro/kernels/ops.py::branch_matmul``: (G, M, K) @ (G, K, N) ->
(G, M, N) in f32, the G branch GEMMs of a ``stacked`` group in one
launch.  CUDA: ``csrc/branch_matmul.cu`` (``rt_branch_matmul``).  The
reference pads M, K and N to 128 before its launch and slices after; the
kernel masks the edges instead and computes the same values on the
unpadded region.

Either 3-D operand may be row-major per branch or the transpose of a
row-major array (``x.transpose(1, 2)``), at any batch stride: the kernel
reads both layouts in place, so the backward GEMMs ``g @ yᵀ`` and
``xᵀ @ g`` need no copy.  CPU tensors take ``branch_matmul_ref``; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt


def _check(x, y):
    if x.dim() != 3 or y.dim() != 3 or x.shape[0] != y.shape[0] \
            or x.shape[2] != y.shape[1]:
        raise ValueError(f"branch_matmul: {tuple(x.shape)} @ "
                         f"{tuple(y.shape)}")


def _layout(name, t):
    """(transposed, leading dimension, batch stride) of a 3-D operand the
    kernel reads in place: each branch row-major (unit column stride) or
    the transpose of a row-major array (unit row stride); anything else
    raises."""
    _, r, c = t.shape
    sg, s0, s1 = t.stride()
    if (s1 == 1 or c == 1) and s0 >= max(c, 1):
        return 0, max(s0, 1), sg
    if (s0 == 1 or r == 1) and s1 >= max(r, 1):
        return 1, max(s1, 1), sg
    raise ValueError(f"{name}: operand {tuple(t.shape)} with strides "
                     f"{t.stride()} is neither row-major nor transposed "
                     f"per branch")


def branch_matmul_ref(x, y):
    """Plain version of ``branch_matmul``: one ``x[g] @ y[g]`` per
    branch."""
    _check(x, y)
    return torch.stack([x[g] @ y[g] for g in range(x.shape[0])])


def branch_matmul(x, y):
    """(G, M, K) @ (G, K, N) -> (G, M, N) in f32 through K9."""
    name = "branch_matmul"
    dev = _rt.kernel_device(name, [x, y])
    _check(x, y)
    if dev.type == "cpu":
        return branch_matmul_ref(x, y)
    g, m, k = x.shape
    n = y.shape[2]
    a_t, lda, sa = _layout(name, x)
    b_t, ldb, sb = _layout(name, y)
    out = torch.empty((g, m, n), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_branch_matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(), g,
                              m, n, k, sa, sb, lda, ldb, a_t, b_t,
                              _rt.stream_handle(dev))
    _build.check(rc, name)
    return out
