"""Plain torch oracles the port's model path and tests hold kernels to."""
from __future__ import annotations

import torch
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


def ssd_ref(x, a_log, b, c, *, d_skip=None):
    """Mamba-2 SSD oracle in the quadratic (attention-like) form
    (``repro/kernels/ref.py::ssd_ref``).

    x: (B, S, H, P) inputs, already multiplied by dt; a_log: (B, S, H)
    per-step log decays (negative); b, c: (B, S, G, N) with H % G == 0.
    y[t] = sum_{s<=t} exp(cum[t] - cum[s]) * (c[t] . b[s]) * x[s], with
    the mask inside the exp, as the reference takes it."""
    bsz, s, h, p = x.shape
    g = b.shape[2]
    rep = h // g
    xf, bf, cf = x.float(), b.float(), c.float()
    cum = torch.cumsum(a_log.float(), dim=1)                  # (B, S, H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]            # (B, T, S, H)
    ts = torch.arange(s, device=x.device)
    causal = (ts[:, None] >= ts[None, :])[None, :, :, None]
    decay = torch.exp(torch.where(causal, diff,
                                  torch.full((), -1e30, device=x.device)))
    cb = torch.einsum("btgn,bsgn->btsg", cf, bf)              # (B, T, S, G)
    cb = cb.repeat_interleave(rep, dim=3)                     # (B, T, S, H)
    y = torch.einsum("btsh,bshp->bthp", cb * decay, xf)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)
