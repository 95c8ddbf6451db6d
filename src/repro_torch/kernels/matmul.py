"""The GEMM algorithm zoo: the tiled f32 GEMM (K4), the split-K GEMM
(K8), their plain versions and the zoo's accounting.

The counterpart of ``repro/kernels/matmul.py`` behind
``repro/kernels/ops.py::matmul``: (M, K) @ (K, N) by ``algorithm``.

  mxu128, large_tile  K4, ``csrc/matmul.cu`` (``rt_matmul``): two tile
                      sizes of one kernel (128 x 128 and 256 x 128
                      output tiles) on the pipelined engine of
                      ``csrc/gemm_pipe.cuh``.  An output with fewer tiles
                      than the card has SMs has its K cut into
                      ``split_plan`` splits, reduced in split order
                      inside the launch through a workspace the wrapper
                      allocates (not the reference's accounting: its
                      ``mxu128`` takes none).
  ksplit              K8, ``csrc/matmul_ksplit.cu`` (``rt_matmul_ksplit``,
                      wrapper ``matmul_ksplit``): K is cut into up to 4
                      splits of whole 128-deep blocks, as the reference's
                      ``_alg_ksplit`` cuts it (``ksplit_splits``); each
                      split's slice runs as K4's ``mxu128`` CTAs, cut
                      again where the (split, tile) units do not cover the
                      SMs (``ksplit_launch``), and writes its f32 partial
                      product into a (splits, M, N) workspace, which the
                      same launch sums over splits in split order.  The
                      workspace is the paper's C4 quantity
                      (``matmul_workspace_bytes``).

Either 2-D operand may be row-major or the transpose of a row-major
array (``x.t()``): both kernels read both layouts in place, so the
backward GEMMs ``x2.t() @ dy2`` and ``dy2 @ wmat.t()`` need no copy.
CPU tensors take ``matmul_ref``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt

MATMUL_ALGORITHMS = ("mxu128", "large_tile", "ksplit")


_KBLOCK = 128       # the reference's contraction block, ksplit's unit

#: K4's output tile (rows, columns) per algorithm
K4_TILES = {"mxu128": (128, 128), "large_tile": (256, 128)}
#: the engine's k-step: split depths are whole multiples of it
SPLIT_BK = 16
#: split-K: cover at least this many waves of one CTA per SM ...
SPLIT_WAVES = 2
#: ... with no split shallower than this ...
SPLIT_MIN_DEPTH = 512
#: ... and a workspace of (splits, tiles, tile) f32 partials under this
SPLIT_WS_CAP = 64 << 20
# copy layouts of an operand (csrc/gemm_pipe.cuh gp::Layout): contiguous
# along K; along M / N with 4-byte copies; the same with 16-byte copies
_KC, _XC, _XC16 = 0, 1, 2


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


def split_plan(tiles: int, depth: int, sms: int, *,
               tile_elems: int = 128 * 128,
               min_depth: int = SPLIT_MIN_DEPTH) -> tuple[int, int]:
    """(splits, depth of each split but the last) for an output of
    ``tiles`` tiles contracting over ``depth`` on a card of ``sms`` SMs.

    No split when the tiles alone cover the SMs.  Otherwise splits of
    whole ``SPLIT_BK`` multiples, so that tiles x splits reaches
    ``SPLIT_WAVES`` waves of ``sms``, none shallower than ``min_depth``
    (``SPLIT_MIN_DEPTH`` by default), and (splits x tiles) partial tiles
    of ``tile_elems`` f32 within ``SPLIT_WS_CAP`` bytes; the last split
    takes what is left."""
    if tiles <= 0 or tiles >= sms or depth <= min_depth:
        return 1, max(depth, 0)
    want = -(-SPLIT_WAVES * sms // tiles)
    kper = max(min_depth, _round_up(-(-depth // want), SPLIT_BK))
    cap = max(1, SPLIT_WS_CAP // (tiles * tile_elems * 4))
    if -(-depth // kper) > cap:
        kper = _round_up(-(-depth // cap), SPLIT_BK)
    splits = -(-depth // kper)
    return (splits, kper) if splits > 1 else (1, depth)


def _round_up(v: int, step: int) -> int:
    return -(-v // step) * step


@functools.lru_cache(maxsize=4096)
def matmul_launch(m: int, n: int, k: int, algorithm: str,
                  sms: int) -> dict:
    """K4's launch for an (M, K) @ (K, N): output tiles, splits of K and
    their depth, CTAs, and workspace bytes (0 without a split)."""
    bm, bn = K4_TILES[algorithm]
    tiles = -(-m // bm) * -(-n // bn)
    splits, kper = split_plan(tiles, k, sms, tile_elems=bm * bn)
    return {"tiles": tiles, "splits": splits, "kper": kper,
            "ctas": tiles * splits,
            "ws_bytes": tiles * splits * bm * bn * 4 if splits > 1 else 0}


@functools.lru_cache(maxsize=4096)
def ksplit_launch(m: int, n: int, k: int, sms: int) -> dict:
    """K8's launch for an (M, K) @ (K, N): the reference's ``splits``
    (``ksplit_splits``) of ``kref`` (``_ksplit_depth``), each split's
    slice on K4's ``mxu128`` tiles and cut again into ``inner`` splits of
    ``kper_in`` where (split, tile) units do not cover the SMs
    (``split_plan`` over the units).  ``ctas`` lists the launch's CTAs in
    launch order (m-block fastest, then n-block, then split, then inner
    split) as (split, m-block, n-block, inner split, k_lo, k_hi), each
    the K range it multiplies (empty in a short last split); the
    (splits, M, N) workspace takes ``ws_bytes`` (the reference's
    ``matmul_workspace_bytes``), the inner partials ``part_bytes``, and
    the in-launch sums ``counters`` counters (splits x tiles for the
    inner splits, then one a tile for the sum over splits)."""
    splits = ksplit_splits(k)
    kref = _ksplit_depth(k, splits)
    bm, bn = K4_TILES["mxu128"]
    mb, nb = -(-m // bm), -(-n // bn)
    tiles = mb * nb
    inner, kper_in = split_plan(splits * tiles, kref, sms,
                                tile_elems=bm * bn)
    ctas = []
    for s in range(splits):
        lo, hi = s * kref, min(k, (s + 1) * kref)
        for i in range(inner):
            a, b = min(hi, lo + i * kper_in), min(hi, lo + (i + 1) * kper_in)
            ctas += [(s, mi, ni, i, a, b)
                     for ni in range(nb) for mi in range(mb)]
    return {"splits": splits, "kref": kref, "tiles": tiles,
            "inner": inner, "kper_in": kper_in, "ctas": tuple(ctas),
            "ws_bytes": matmul_workspace_bytes("ksplit", m, n, k, splits),
            "part_bytes": (splits * tiles * inner * bm * bn * 4
                           if inner > 1 else 0),
            "counters": (splits + 1) * tiles}


def _copy_layout(t, transposed: int, ld: int, along_k: int) -> int:
    """An operand's copy layout: contiguous along K (``along_k``: A
    row-major, B transposed) takes 4-byte copies that transpose; along M /
    N takes 16-byte copies when its address and leading dimension are
    multiples of 16 bytes, else 4-byte ones."""
    if transposed == along_k:
        return _KC
    return _XC16 if t.data_ptr() % 16 == 0 and ld % 4 == 0 else _XC


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


def _ksplit_run(x, y):
    """K8's one launch on CUDA operands: (ws, out), the (splits, M, N)
    workspace and its sum over splits (``ws[0]`` itself at one split)."""
    name = "matmul_ksplit"
    dev = x.device
    m, k = x.shape
    n = y.shape[1]
    a_t, lda = _layout(name, x)
    b_t, ldb = _layout(name, y)
    la = _copy_layout(x, a_t, lda, along_k=0)
    lb = _copy_layout(y, b_t, ldb, along_k=1)
    plan = ksplit_launch(m, n, k, _rt.sm_count(dev))
    splits = plan["splits"]
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    ws = new(splits, m, n)
    out = new(m, n) if splits > 1 else None
    part = new(plan["part_bytes"] // 4) if plan["inner"] > 1 else None
    stream = _rt.stream_handle(dev)
    counters = _rt.split_counters(dev, stream, plan["counters"])
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_matmul_ksplit(ptr(x), ptr(y), ptr(ws), ptr(part), ptr(out),
                              ptr(counters), m, n, k, lda, ldb, la, lb,
                              splits, plan["kref"], plan["inner"],
                              plan["kper_in"], stream)
    _build.check(rc, name)
    return ws, ws[0] if out is None else out


def matmul_ksplit(x, y):
    """(M, K) @ (K, N) -> (M, N) in f32 through K8, ONE launch: the
    ``ksplit_splits(K)`` partial products in a (splits, M, N) f32
    workspace, allocated per call, summed over splits in split order by
    the launch's last CTA of each output tile (``ksplit_launch``)."""
    dev = _rt.kernel_device("matmul_ksplit", [x, y])
    _check(x, y, "ksplit")
    if dev.type == "cpu":
        return matmul_ksplit_ref(x, y)
    return _ksplit_run(x, y)[1]


def matmul(x, y, *, algorithm: str = "mxu128"):
    """(M, K) @ (K, N) -> (M, N) in f32 through K4 (``mxu128``,
    ``large_tile``) or K8 (``ksplit``).  K4 splits K when the output has
    fewer tiles than the card has SMs (``matmul_launch``)."""
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
    la = _copy_layout(x, a_t, lda, along_k=0)
    lb = _copy_layout(y, b_t, ldb, along_k=1)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan = matmul_launch(m, n, k, algorithm, _rt.sm_count(dev))
    stream = _rt.stream_handle(dev)
    ws = counters = None
    if plan["splits"] > 1:
        ws = torch.empty(plan["ws_bytes"] // 4, dtype=torch.float32,
                         device=dev)
        counters = _rt.split_counters(dev, stream, plan["tiles"])
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_matmul(x.data_ptr(), y.data_ptr(), out.data_ptr(),
                       None if ws is None else ws.data_ptr(),
                       None if counters is None else counters.data_ptr(),
                       m, n, k, lda, ldb, la, lb,
                       int(algorithm == "large_tile"), plan["splits"],
                       plan["kper"], stream)
    _build.check(rc, name)
    return out
