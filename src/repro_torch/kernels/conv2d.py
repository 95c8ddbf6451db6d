"""Direct convolution (K3) and the im2col GEMM convolution (K4) with
TF-SAME padding, the plain direct version, the im2col patch gather and
the padding arithmetic they share.

The counterpart of ``repro/kernels/conv2d.py``'s ``direct`` and
``im2col_gemm`` algorithms.
Layouts: x (N, H, W, C), w (KH, KW, C, K), NHWC out.  SAME padding is
TensorFlow's, asymmetric — the extra row/column goes at the bottom/right —
so it is padded explicitly (torch's ``padding=`` is symmetric).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def conv2d_direct(x, w, *, stride: int = 1, padding: str = "SAME"):
    """Zero-workspace direct conv: (N, H, W, C) x (KH, KW, C, K) ->
    (N, OH, OW, K), no bias or activation (the caller's epilogue).
    CUDA: ``csrc/conv2d.cu``; CPU tensors take ``conv2d_direct_ref``."""
    name = "conv2d_direct"
    dev = _rt.kernel_device(name, [x, w])
    _check(x, w, stride, padding)
    _rt.require_contiguous(name, [x, w])
    if dev.type == "cpu":
        return conv2d_direct_ref(x, w, stride=stride, padding=padding)
    n, h, wd, c = x.shape
    kh, kw, _, k = w.shape
    oh = _out_size(h, kh, stride, padding)
    ow = _out_size(wd, kw, stride, padding)
    ph = _pad_amount(h, kh, stride, padding)
    pw = _pad_amount(wd, kw, stride, padding)
    y = torch.empty((n, oh, ow, k), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_conv2d_direct(x.data_ptr(), w.data_ptr(), y.data_ptr(), n,
                              h, wd, c, k, kh, kw, int(stride), oh, ow,
                              ph[0], pw[0], _rt.stream_handle(dev))
    _build.check(rc, name)
    return y


def _im2col(x, kh, kw, stride):
    """SAME-padded im2col patches (B, OH, OW, C*KH*KW), feature order
    (C, KH, KW) — the GEMM lhs of a KxK conv (the reference's
    ``repro/models/cnn.py::_im2col``).  Pad + strided slices + stack, so
    autograd through it is the col2im scatter."""
    b, h, w, c = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph = _pad_amount(h, kh, stride, "SAME")
    pw = _pad_amount(w, kw, stride, "SAME")
    xp = F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]))
    taps = [xp[:, ki:ki + (oh - 1) * stride + 1:stride,
               kj:kj + (ow - 1) * stride + 1:stride, :]
            for ki in range(kh) for kj in range(kw)]
    return torch.stack(taps, dim=-1).reshape(b, oh, ow, c * kh * kw)


def conv2d_im2col_gemm(x, w, *, stride: int = 1, padding: str = "SAME"):
    """The im2col + GEMM conv: the (N*OH*OW, C*KH*KW) patch matrix, then
    ONE K4 GEMM against the (C*KH*KW, K) weight view; no bias or
    activation.  SAME padding only (the reference's main path)."""
    _check(x, w, stride, padding)
    if padding != "SAME":
        raise ValueError("conv2d_im2col_gemm: SAME padding only")
    kh, kw, c, k = w.shape
    patches = _im2col(x, kh, kw, int(stride))
    n, oh, ow, _ = patches.shape
    wmat = w.permute(2, 0, 1, 3).reshape(c * kh * kw, k)
    y = _mm.matmul(patches.reshape(-1, c * kh * kw), wmat)
    return y.reshape(n, oh, ow, k)
