"""The fused complementary pair (K10) and its plain version.

The counterpart of ``repro/kernels/fused_branches.py``: ONE launch
computes a compute-bound GEMM and a memory-bound streamed reduction,

    c = x @ y                 x (M, K), y (K, N)
    r = silu(z).sum(0)        z (R, C), in f32, returned in z's dtype

the ``fused`` plan mode, the paper's intra-SM co-location of a
compute-bound kernel with a memory-bound one (Table 1).  CUDA:
``csrc/fused_branches.cu`` (``rt_fused_gemm_reduce``): each CTA owns one
128 x 128 tile of c (the reference's 128-blocks) and a contiguous share
of z's rows, reduced between its k-steps; each CTA's column sums land
in its row of a (#CTAs, C) f32 workspace, which the wrapper sums over
rows, as the reference's wrapper sums its per-step rows.  The reference pads M, K and N to 128 and R to a
multiple of its grid; the kernel masks the edges instead and never reads
past R (padding rows add silu(0) = 0).

CPU tensors take ``fused_gemm_reduce_ref``; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt

MAX_COLUMNS = 1024  # z columns the kernel takes (4 per thread of 256)
TILE = 128         # the side of the kernel's c tile


def _check(name, x, y, z):
    if x.dim() != 2 or y.dim() != 2 or z.dim() != 2 \
            or x.shape[1] != y.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ y {tuple(y.shape)} "
                         f"beside z {tuple(z.shape)}")


def fused_gemm_reduce_ref(x, y, z):
    """Plain version: ``(x @ y, silu(z).sum(0))``, the sum in f32."""
    _check("fused_gemm_reduce", x, y, z)
    return x @ y, F.silu(z.float()).sum(0).to(z.dtype)


def fused_gemm_reduce(x, y, z):
    """``(x @ y, silu(z).sum(0))`` in ONE K10 launch (see the module
    docstring); all three f32 and contiguous."""
    name = "fused_gemm_reduce"
    dev = _rt.kernel_device(name, [x, y, z])
    _check(name, x, y, z)
    _rt.require_contiguous(name, [x, y, z])
    if dev.type == "cpu":
        return fused_gemm_reduce_ref(x, y, z)
    m, k = x.shape
    n = y.shape[1]
    r, cz = z.shape
    if m < 1 or n < 1 or cz < 1 or cz > MAX_COLUMNS:
        raise ValueError(f"{name}: the kernel takes M, N >= 1 and 1 <= C <= "
                         f"{MAX_COLUMNS}, got M {m}, N {n}, C {cz}")
    ctas = -(-m // TILE) * -(-n // TILE)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    part = torch.empty((ctas, cz), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_fused_gemm_reduce(x.data_ptr(), y.data_ptr(), z.data_ptr(),
                                  c.data_ptr(), part.data_ptr(), m, n, k, r,
                                  cz, -(-r // ctas), _rt.stream_handle(dev))
    _build.check(rc, name)
    return c, part.sum(0)
