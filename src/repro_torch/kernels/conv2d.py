"""The conv2d algorithm zoo: direct convolution (K3), the im2col GEMM
convolution (K4) and Winograd F(2x2, 3x3) (its 16 transform-domain
GEMMs on K9), the plain direct version, the im2col patch gather, the
padding arithmetic they share and each algorithm's workspace.

The counterpart of ``repro/kernels/conv2d.py``.
Layouts: x (N, H, W, C), w (KH, KW, C, K), NHWC out.  SAME padding is
TensorFlow's, asymmetric — the extra row/column goes at the bottom/right —
so it is padded explicitly (torch's ``padding=`` is symmetric).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import branch_matmul as _bmm
from repro_torch.kernels import build as _build
from repro_torch.kernels import matmul as _mm
from repro_torch.kernels import runtime as _rt


def _out_size(h: int, kh: int, stride: int, padding: str) -> int:
    if padding == "SAME":
        return -(-h // stride)
    return (h - kh) // stride + 1


def _pad_amount(h: int, kh: int, stride: int,
                padding: str) -> tuple[int, int]:
    if padding == "VALID":
        return (0, 0)
    oh = -(-h // stride)
    total = max((oh - 1) * stride + kh - h, 0)
    return (total // 2, total - total // 2)


def _check(x, w, stride, padding):
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"conv2d_direct: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (HWIO) do not match")
    if padding not in ("SAME", "VALID") or int(stride) < 1:
        raise ValueError(f"conv2d_direct: padding={padding!r} "
                         f"stride={stride}")


def conv2d_direct_ref(x, w, *, stride: int = 1, padding: str = "SAME"):
    """Plain version: explicit (asymmetric) pad, then one matmul per
    filter tap on the strided shifted input, summed."""
    _check(x, w, stride, padding)
    n, h, wd, c = x.shape
    kh, kw, _, k = w.shape
    oh = _out_size(h, kh, stride, padding)
    ow = _out_size(wd, kw, stride, padding)
    ph = _pad_amount(h, kh, stride, padding)
    pw = _pad_amount(wd, kw, stride, padding)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    acc = x.new_zeros((n * oh * ow, k))
    for i in range(kh):
        for j in range(kw):
            tap = xp[:, i:i + (oh - 1) * stride + 1:stride,
                     j:j + (ow - 1) * stride + 1:stride, :]
            acc = acc + tap.reshape(-1, c) @ w[i, j]
    return acc.reshape(n, oh, ow, k)


#: K3's output tile (rows and columns) and k-step (channels)
DIRECT_TILE = 128
DIRECT_BK = 16
#: CTAs an SM holds (the kernel's launch bounds): a conv whose tiles
#: number fewer than this many CTAs on every SM has its k-steps split ...
DIRECT_SPLIT_CTAS = 2
#: ... into splits no shallower than this (``split_plan``'s
#: ``min_depth``, in depth units: whole k-steps of ``DIRECT_BK``)
DIRECT_SPLIT_MIN_DEPTH = 128


def direct_launch(x_shape, w_shape, stride: int, padding: str,
                  sms: int) -> dict:
    """K3's launch for an (N, H, W, C) x (KH, KW, C, K) conv on a card of
    ``sms`` SMs; pure Python, cached per shape.  The one place the launch
    is decided.

    The depth runs tap-major, channel-minor, in k-steps of ``DIRECT_BK``
    channels that never straddle a tap: ``steps`` lists each k-step's
    (dh, dw, first channel, live channels), the last k-step of a tap only
    as wide as its channels left.  Output tiles are ``DIRECT_TILE``
    square; when they number fewer than ``DIRECT_SPLIT_CTAS`` CTAs on every
    SM, the k-steps are cut into ``splits`` of ``kper`` k-steps (the last
    may be shorter; ``split_plan`` with ``DIRECT_SPLIT_MIN_DEPTH``), and
    the workspace holds one partial tile per split CTA."""
    return _direct_launch(tuple(int(v) for v in x_shape),
                          tuple(int(v) for v in w_shape), int(stride),
                          padding, int(sms), DIRECT_SPLIT_MIN_DEPTH,
                          DIRECT_SPLIT_CTAS)


@functools.lru_cache(maxsize=1024)
def _direct_launch(x_shape, w_shape, stride, padding, sms, min_depth,
                   split_ctas):
    n, h, wd, c = x_shape
    kh, kw, _, k = w_shape
    oh = _out_size(h, kh, stride, padding)
    ow = _out_size(wd, kw, stride, padding)
    t, bk = DIRECT_TILE, DIRECT_BK
    steps = tuple((dh, dw, c0, min(bk, c - c0))
                  for dh in range(kh) for dw in range(kw)
                  for c0 in range(0, c, bk))
    m = n * oh * ow
    tiles = -(-m // t) * -(-k // t)
    splits, kper = _mm.split_plan(tiles, len(steps) * bk,
                                  sms * split_ctas,
                                  tile_elems=t * t, min_depth=min_depth)
    kper = kper // bk if splits > 1 else len(steps)
    return {"m": m, "oh": oh, "ow": ow,
            "pad": (_pad_amount(h, kh, stride, padding)[0],
                    _pad_amount(wd, kw, stride, padding)[0]),
            "steps": steps, "tiles": tiles, "splits": splits, "kper": kper, "ctas": tiles * splits,
            "ws_bytes": tiles * splits * t * t * 4 if splits > 1 else 0}


def conv2d_direct(x, w, *, stride: int = 1, padding: str = "SAME"):
    """Direct conv, no im2col buffer: (N, H, W, C) x (KH, KW, C, K) ->
    (N, OH, OW, K), no bias or activation (the caller's epilogue).
    CUDA: ``csrc/conv2d.cu``, launched as ``direct_launch`` plans it (a
    split's partial tiles in a workspace the wrapper allocates; not the
    reference's accounting, whose direct conv takes none); CPU tensors
    take ``conv2d_direct_ref``."""
    name = "conv2d_direct"
    dev = _rt.kernel_device(name, [x, w])
    _check(x, w, stride, padding)
    _rt.require_contiguous(name, [x, w])
    if dev.type == "cpu":
        return conv2d_direct_ref(x, w, stride=stride, padding=padding)
    n, h, wd, c = x.shape
    kh, kw, _, k = w.shape
    if n * h * wd >= 2 ** 31:
        raise ValueError(f"conv2d_direct: {n * h * wd} input pixels exceed "
                         f"the kernel's 32-bit pixel index")
    la = direct_launch(x.shape, w.shape, stride, padding, _rt.sm_count(dev))
    y = torch.empty((n, la["oh"], la["ow"], k), dtype=torch.float32,
                    device=dev)
    if y.numel() == 0:
        return y
    steps = _rt.device_tables.get(
        ("conv2d_direct", kh, kw, c),
        lambda: [v for st in la["steps"] for v in st], dev)
    stream = _rt.stream_handle(dev)
    ws = counters = None
    if la["splits"] > 1:
        ws = torch.empty(la["ws_bytes"] // 4, dtype=torch.float32,
                         device=dev)
        counters = _rt.split_counters(dev, stream, la["tiles"])
    x16 = int(c % 4 == 0 and x.data_ptr() % 16 == 0)
    w16 = int(k % 4 == 0 and w.data_ptr() % 16 == 0)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_conv2d_direct(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                              steps.data_ptr(),
                              None if ws is None else ws.data_ptr(),
                              None if counters is None
                              else counters.data_ptr(),
                              n, h, wd, c, k, kw, int(stride), la["oh"],
                              la["ow"], *la["pad"], len(la["steps"]),
                              la["kper"], la["splits"], x16, w16, stream)
    _build.check(rc, name)
    return y


def _im2col(x, kh, kw, stride, padding="SAME"):
    """Padded im2col patches (B, OH, OW, C*KH*KW), feature order
    (C, KH, KW) — the GEMM lhs of a KxK conv (the reference's
    ``repro/models/cnn.py::_im2col``).  Pad + strided slices + stack, so
    autograd through it is the col2im scatter."""
    b, h, w, c = x.shape
    oh = _out_size(h, kh, stride, padding)
    ow = _out_size(w, kw, stride, padding)
    ph = _pad_amount(h, kh, stride, padding)
    pw = _pad_amount(w, kw, stride, padding)
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    taps = [xp[:, ki:ki + (oh - 1) * stride + 1:stride,
               kj:kj + (ow - 1) * stride + 1:stride, :]
            for ki in range(kh) for kj in range(kw)]
    return torch.stack(taps, dim=-1).reshape(b, oh, ow, c * kh * kw)


def conv2d_im2col_gemm(x, w, *, stride: int = 1, padding: str = "SAME"):
    """The im2col + GEMM conv: the (N*OH*OW, C*KH*KW) patch matrix (the
    algorithm's workspace), then ONE K4 GEMM against the (C*KH*KW, K)
    weight view; no bias or activation."""
    _check(x, w, stride, padding)
    kh, kw, c, k = w.shape
    patches = _im2col(x, kh, kw, int(stride), padding)
    n, oh, ow, _ = patches.shape
    wmat = w.permute(2, 0, 1, 3).reshape(c * kh * kw, k)
    y = _mm.matmul(patches.reshape(-1, c * kh * kw), wmat)
    return y.reshape(n, oh, ow, k)


def conv2d_im2col_workspace_bytes(x_shape, w_shape, stride=1,
                                  padding="SAME", bytes_per_el: int = 2):
    """The im2col patch matrix's bytes."""
    n, h, wd, c = x_shape
    kh, kw, _, _ = w_shape
    oh = _out_size(h, kh, stride, padding)
    ow = _out_size(wd, kw, stride, padding)
    return n * oh * ow * c * kh * kw * bytes_per_el


# ---------------------------------------------------------------------------
# Winograd F(2x2, 3x3)
# ---------------------------------------------------------------------------

_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_G = ((1, 0, 0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0, 0, 1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))


def conv2d_winograd3x3(x, w, *, stride: int = 1, padding: str = "SAME"):
    """F(2x2, 3x3) Winograd: the input, filter and inverse transforms in
    plain torch (the reference runs them in XLA) and the 16 independent
    transform-domain GEMMs (T, C) @ (C, K), T = N * ceil(OH/2) *
    ceil(OW/2) 4x4 input tiles, as ONE K9 launch
    (``kernels.branch_matmul``).  K9 masks its edges, so the reference's
    padding of T, C and K to 128 is dropped.  3x3 filters at stride 1
    only (``ops.conv2d_supported``); anything else raises."""
    _check(x, w, stride, padding)
    n, h, wd, c = x.shape
    kh, kw, _, k = w.shape
    if (kh, kw) != (3, 3) or int(stride) != 1:
        raise ValueError(f"conv2d_winograd3x3: needs a 3x3 filter at "
                         f"stride 1, got {kh}x{kw} at stride {stride}")
    oh = _out_size(h, 3, 1, padding)
    ow = _out_size(wd, 3, 1, padding)
    ph, pw = _pad_amount(h, 3, 1, padding), _pad_amount(wd, 3, 1, padding)
    # tile grid: 4x4 input tiles at stride 2, each giving 2x2 outputs
    th, tw = -(-oh // 2), -(-ow // 2)
    xp = F.pad(x, (0, 0, pw[0], max(2 * tw + 2 - wd - pw[0], 0),
                   ph[0], max(2 * th + 2 - h - ph[0], 0)))
    tiles = xp.unfold(1, 4, 2).unfold(2, 4, 2)[:, :th, :tw]  # N th tw C 4 4
    bt, g, at = (torch.tensor(a, dtype=x.dtype, device=x.device)
                 for a in (_BT, _G, _AT))
    v = torch.einsum("ij,nxycjk,lk->nxyilc", bt, tiles, bt)   # B^T d B
    u = torch.einsum("ij,jkco,lk->ilco", g, w, g)             # G g G^T
    t = n * th * tw
    v16 = v.permute(3, 4, 0, 1, 2, 5).reshape(16, t, c)
    m16 = _bmm.branch_matmul(v16, u.reshape(16, c, k))
    m = m16.reshape(4, 4, n, th, tw, k)
    y = torch.einsum("ij,jkntwo,lk->ntwilo", at, m, at)       # A^T m A
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * th, 2 * tw, k)
    return y[:, :oh, :ow]


def conv2d_winograd_workspace_bytes(x_shape, w_shape, padding="SAME",
                                    bytes_per_el: int = 2) -> int:
    """The transform-domain operands and products: 16 x (T C + C K +
    T K) elements."""
    n, h, wd, c = x_shape
    _, _, _, k = w_shape
    oh = _out_size(h, 3, 1, padding)
    ow = _out_size(wd, 3, 1, padding)
    t = n * -(-oh // 2) * -(-ow // 2)
    return 16 * (t * c + c * k + t * k) * bytes_per_el


CONV2D_ALGORITHMS = {
    "im2col_gemm": conv2d_im2col_gemm,
    "direct": conv2d_direct,
    "winograd3x3": conv2d_winograd3x3,
}


def conv2d_workspace_bytes(algorithm: str, x_shape, w_shape, stride=1,
                           padding="SAME", bytes_per_el: int = 2) -> int:
    """Device-memory workspace per algorithm — the paper's Table-2
    quantity (direct needs none)."""
    if algorithm == "im2col_gemm":
        return conv2d_im2col_workspace_bytes(x_shape, w_shape, stride,
                                             padding, bytes_per_el)
    if algorithm == "winograd3x3":
        return conv2d_winograd_workspace_bytes(x_shape, w_shape, padding,
                                               bytes_per_el)
    return 0
