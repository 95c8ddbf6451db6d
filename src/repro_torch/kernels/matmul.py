"""The GEMM algorithm zoo: the tiled f32 GEMM (K4), the split-K GEMM
(K8), their plain versions and the zoo's accounting.

The counterpart of ``repro/kernels/matmul.py`` behind
``repro/kernels/ops.py::matmul``: (M, K) @ (K, N) by ``algorithm``.

  mxu128, large_tile  K4, ``csrc/matmul.cu`` (``rt_matmul``): two tile
                      sizes of one kernel (64 x 64 and 128 x 128 output
                      tiles), no workspace.
  ksplit              K8, ``csrc/matmul_ksplit.cu`` (``rt_matmul_ksplit``,
                      wrapper ``matmul_ksplit``): K is cut into up to 4
                      splits of whole 128-deep blocks, as the reference's
                      ``_alg_ksplit`` cuts it (``ksplit_splits``); each
                      split writes its f32 partial product into a (splits,
                      M, N) workspace, summed over splits afterwards in a
                      fixed order (``partials.sum(0)``, as in the
                      reference).  The workspace is the paper's C4
                      quantity (``matmul_workspace_bytes``).

Either 2-D operand may be row-major or the transpose of a row-major
array (``x.t()``): both kernels read both layouts in place, so the
backward GEMMs ``x2.t() @ dy2`` and ``dy2 @ wmat.t()`` need no copy.
CPU tensors take ``matmul_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt

MATMUL_ALGORITHMS = ("mxu128", "large_tile", "ksplit")


_KBLOCK = 128       # the reference's contraction block, ksplit's unit


def matmul_block_shape(algorithm: str) -> tuple[int, int, int]:
    """(bm, bn, bk) of the reference's algorithm, which its accounting
    uses (the port's kernels tile at 64 x 64 or 128 x 128)."""
    return {"mxu128": (128, 128, 128),
            "large_tile": (256, 256, 128),
            "ksplit": (128, 128, 128)}[algorithm]


def matmul_workspace_bytes(algorithm: str, m: int, n: int, k: int,
                           splits: int = 4) -> int:
    """Device-memory workspace per algorithm — the paper's Table-2
    quantity: ksplit's (splits, M, N) f32 partials, none otherwise."""
    if algorithm == "ksplit":
        return splits * m * n * 4
    return 0


def matmul_vmem_bytes(algorithm: str, bytes_per_el: int = 2) -> int:
    """The reference's static on-chip claim per grid cell (its lhs, rhs
    and f32 accumulator blocks) — the SM register/shared-memory
    analogue."""
    bm, bn, bk = matmul_block_shape(algorithm)
    return bm * bk * bytes_per_el + bk * bn * bytes_per_el + bm * bn * 4


def ksplit_splits(k: int) -> int:
    """The split count of ``_alg_ksplit``: the largest count up to 4 that
    divides the number of 128-deep blocks, ceil(K/128)."""
    nkb = -(-k // _KBLOCK)
    splits = 4
    while splits > 1 and nkb % splits:
        splits -= 1
    return splits


def _ksplit_depth(k: int, splits: int) -> int:
    """The depth of every split but the last (whole 128-deep blocks; the
    last split is the short one when K is ragged)."""
    return -(-k // _KBLOCK) // splits * _KBLOCK


def _check(x, y, algorithm):
    if algorithm not in MATMUL_ALGORITHMS:
        raise ValueError(f"matmul: unknown algorithm {algorithm!r}")
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


def matmul_ksplit_ref(x, y):
    """Plain version of ``matmul_ksplit``: each split's partial product
    over its K range, stacked, then summed over splits."""
    _check(x, y, "ksplit")
    k = x.shape[1]
    splits = ksplit_splits(k)
    kper = _ksplit_depth(k, splits)
    edges = [min(k, s * kper) for s in range(splits + 1)]
    return torch.stack([x[:, a:b] @ y[a:b]
                        for a, b in zip(edges, edges[1:])]).sum(0)


def matmul_ref(x, y, *, algorithm: str = "mxu128"):
    """Plain version of ``matmul``: ``x @ y`` (ksplit: its split partials,
    summed)."""
    _check(x, y, algorithm)
    if algorithm == "ksplit":
        return matmul_ksplit_ref(x, y)
    return x @ y


def matmul_ksplit(x, y):
    """(M, K) @ (K, N) -> (M, N) in f32 through K8: ``ksplit_splits(K)``
    partial products in a (splits, M, N) f32 workspace, allocated per
    call, then summed over splits."""
    name = "matmul_ksplit"
    dev = _rt.kernel_device(name, [x, y])
    _check(x, y, "ksplit")
    if dev.type == "cpu":
        return matmul_ksplit_ref(x, y)
    m, k = x.shape
    n = y.shape[1]
    a_t, lda = _layout(name, x)
    b_t, ldb = _layout(name, y)
    splits = ksplit_splits(k)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_matmul_ksplit(x.data_ptr(), y.data_ptr(), ws.data_ptr(), m,
                              n, k, lda, ldb, a_t, b_t, splits,
                              _ksplit_depth(k, splits),
                              _rt.stream_handle(dev))
    _build.check(rc, name)
    return ws.sum(0)


def matmul(x, y, *, algorithm: str = "mxu128"):
    """(M, K) @ (K, N) -> (M, N) in f32 through K4 (``mxu128``,
    ``large_tile``) or K8 (``ksplit``)."""
    name = "matmul"
    _check(x, y, algorithm)
    if algorithm == "ksplit":
        return matmul_ksplit(x, y)
    dev = _rt.kernel_device(name, [x, y])
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
