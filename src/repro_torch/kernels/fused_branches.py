"""The fused complementary pair (K10) and its plain version.

The counterpart of ``repro/kernels/fused_branches.py``: ONE launch
computes a compute-bound GEMM and a memory-bound streamed reduction,

    c = x @ y                 x (M, K), y (K, N)
    r = silu(z).sum(0)        z (R, C), in f32, returned in z's dtype

the ``fused`` plan mode, the paper's intra-SM co-location of a
compute-bound kernel with a memory-bound one (Table 1).  CUDA:
``csrc/fused_branches.cu`` (``rt_fused_gemm_reduce``), on the pipelined
engine of ``csrc/gemm_pipe.cuh``.  Its first T CTAs are K4's ``mxu128``
launch of the GEMM (128 x 128 tiles, K split over the SMs when the
tiles do not cover them, ``matmul.matmul_launch``), so c equals
``matmul(x, y, algorithm="mxu128")`` bit for bit.  z rides the same
cp.async ring: each CTA, and the CTAs past T that carry no GEMM work,
take an equal contiguous share of z's rows (``fused_launch``), add silu
of the elements each thread copied to its own column sums, and write
them to their row of a (P, C) f32 workspace; the last CTA to arrive
sums the rows in CTA order and writes r.  One device launch, no sum in
the wrapper, results repeat bit for bit.  The reference pads M, K and N
to 128 and R to a multiple of its grid; the kernel masks the edges
instead and never reads past R (padding rows add silu(0) = 0).

CPU tensors take ``fused_gemm_reduce_ref``; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import runtime as _rt

MAX_COLUMNS = 1024  # z columns the kernel takes (4 per thread of 256)
#: z rows below which a further CTA does not pay: z spreads over at most
#: ceil(R / FUSED_ROWS_FLOOR) CTAs ...
FUSED_ROWS_FLOOR = 16
#: ... and at most this many CTAs an SM (two of K4's mxu128 CTAs fit one)
FUSED_Z_CTAS = 2


def _check(name, x, y, z):
    if x.dim() != 2 or y.dim() != 2 or z.dim() != 2 \
            or x.shape[1] != y.shape[0]:
        raise ValueError(f"{name}: x {tuple(x.shape)} @ y {tuple(y.shape)} "
                         f"beside z {tuple(z.shape)}")


def fused_gemm_reduce_ref(x, y, z):
    """Plain version: ``(x @ y, silu(z).sum(0))``, the sum in f32."""
    _check("fused_gemm_reduce", x, y, z)
    return x @ y, F.silu(z.float()).sum(0).to(z.dtype)


def fused_launch(m, n, k, r, c, sms) -> dict:
    """K10's launch for an (M, K) @ (K, N) beside an (R, C) z on a card
    of ``sms`` SMs: the GEMM's tiles, splits of K and their depth (K4's
    ``mxu128`` launch), its T = tiles x splits CTAs, the launch's P =
    max(T, min(FUSED_Z_CTAS x SMs, ceil(R / FUSED_ROWS_FLOOR))) CTAs,
    the z rows each takes (``share``; CTA p takes ``shares[p]``, rows
    [p x share, (p + 1) x share) cut at R), and the workspace bytes (the
    GEMM's split partials, then P x C column sums)."""
    return _fused_launch(m, n, k, r, c, sms, FUSED_ROWS_FLOOR, FUSED_Z_CTAS)


@functools.lru_cache(maxsize=4096)
def _fused_launch(m, n, k, r, c, sms, rows_floor, z_ctas) -> dict:
    g = _mm.matmul_launch(m, n, k, "mxu128", sms)
    t = g["ctas"]
    ctas = max(t, min(z_ctas * sms, -(-r // rows_floor)))
    share = -(-r // ctas)
    return {"tiles": g["tiles"], "splits": g["splits"], "kper": g["kper"],
            "gemm_ctas": t, "ctas": ctas, "share": share,
            "shares": tuple((min(r, p * share), min(r, (p + 1) * share))
                            for p in range(ctas)),
            "ws_bytes": g["ws_bytes"] + ctas * c * 4}


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
    # each operand's copy layout as K4's wrapper picks it
    a_t, lda = _mm._layout(name, x)
    b_t, ldb = _mm._layout(name, y)
    la = _mm._copy_layout(x, a_t, lda, along_k=0)
    lb = _mm._copy_layout(y, b_t, ldb, along_k=1)
    plan = fused_launch(m, n, k, r, cz, _rt.sm_count(dev))
    stream = _rt.stream_handle(dev)
    c = torch.empty((m, n), dtype=torch.float32, device=dev)
    out = torch.empty((cz,), dtype=torch.float32, device=dev)
    ws = torch.empty(plan["ws_bytes"] // 4, dtype=torch.float32, device=dev)
    counters = _rt.split_counters(dev, stream, plan["tiles"] + 1)
    z16 = cz % 4 == 0 and z.data_ptr() % 16 == 0
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_fused_gemm_reduce(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), c.data_ptr(),
        out.data_ptr(), ws.data_ptr(), counters.data_ptr(), m, n, k, lda,
        ldb, la, lb, plan["splits"], plan["kper"], r, cz, plan["ctas"],
        plan["share"], int(z16), stream)
    _build.check(rc, name)
    return c, out
