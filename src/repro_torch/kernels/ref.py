"""Plain torch oracles the port's model path and tests hold kernels to."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.conv2d import _pad_amount


def conv2d_ref(x, w, *, stride: int = 1, padding: str = "SAME"):
    """NHWC x HWIO convolution with TF-SAME (asymmetric) padding, through
    ``torch.nn.functional.conv2d`` on an explicitly padded input."""
    _, h, wd, _ = x.shape
    kh, kw = w.shape[:2]
    ph = _pad_amount(h, kh, stride, padding)
    pw = _pad_amount(wd, kw, stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()
