"""Mamba-2 (SSD) mixer block (``repro/models/mamba2.py``): init and
apply, over a whole sequence or one decode step.

impl="xla"    — the chunked SSD in plain torch (``kernels.ssd.ssd_chunked``
                with ``plain=True``: ``ssd_chunk_ref`` over every cell;
                the reference's default path, a scan over chunks there).
impl="pallas" — the SSD chunk kernel (K14) through
                ``kernels.ssd.ssd_chunked``, as the reference's docstring
                specifies (its own call site binds the re-exported
                function instead of the module and fails; the port calls
                the module).

A decode step (S == 1) runs the single-step recurrence in plain torch
on either impl, with the recurrent state (B, H, N, P) and the causal
conv's tail (B, W-1, C_conv) from the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as _ssd
from repro_torch.models import layers as L


def mamba_init(generator: torch.Generator, d: int, *, d_inner: int,
               n_heads: int, head_dim: int, d_state: int, n_groups: int,
               conv_width: int = 4, dtype=torch.float32, device=None):
    if d_inner != n_heads * head_dim:
        raise ValueError(f"d_inner {d_inner} != n_heads {n_heads} x "
                         f"head_dim {head_dim}")
    d_xbc = d_inner + 2 * n_groups * d_state
    d_proj = d_inner + d_xbc + n_heads          # z, xBC, dt
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads))
    return {
        "w_in": L.normal_init(generator, (d, d_proj), d ** -0.5, dtype,
                              device),
        "conv_w": L.normal_init(generator, (conv_width, d_xbc), 0.1, dtype,
                                device),
        "conv_b": torch.zeros((d_xbc,), dtype=dtype, device=device),
        "A_log": a_log.to(dtype=dtype, device=device),
        "D": torch.ones((n_heads,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((n_heads,), dtype=dtype, device=device),
        "norm": L.rmsnorm_init(d_inner, dtype, device),
        "w_out": L.normal_init(generator, (d_inner, d), d_inner ** -0.5,
                               dtype, device),
    }


def _split_proj(proj, d_inner, n_groups, d_state, n_heads):
    d_xbc = d_inner + 2 * n_groups * d_state
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_xbc]
    dt = proj[..., d_inner + d_xbc:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv of width W over xbc (B, S, C); conv_state
    (B, W-1, C) is the tail of the tokens before (zeros without one).
    Returns (silu(conv + bias), the last W-1 rows of the padded input)."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], w - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # (B, S+W-1, C)
    s = xbc.shape[1]
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, w):
        out = out + xp[:, i:i + s] * conv_w[i]
    return F.silu(out + conv_b), xp[:, -(w - 1):]


def mamba_apply(params, x, *, d_inner: int, n_heads: int, head_dim: int,
                d_state: int, n_groups: int, chunk: int = 128,
                ssm_state=None, conv_state=None, impl: str = "xla"):
    """x (B, S, D) -> (out (B, S, D), (new ssm state (B, H, N, P) f32,
    new conv tail (B, W-1, C_conv))).  Training: no states.  Prefill: S
    tokens from the cache's states.  Decode: S == 1."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown mamba impl {impl!r}")
    b, s, _ = x.shape
    proj = x @ params["w_in"]
    z, xbc, dt = _split_proj(proj, d_inner, n_groups, d_state, n_heads)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, head_dim)
    bmat = xbc[..., d_inner:d_inner + n_groups * d_state] \
        .reshape(b, s, n_groups, d_state)
    cmat = xbc[..., d_inner + n_groups * d_state:] \
        .reshape(b, s, n_groups, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"].float())     # (B, S, H)
    a = -torch.exp(params["A_log"].float())                     # (H,)
    a_log = a[None, None, :] * dt                               # (B, S, H)
    xdt = xs.float() * dt[..., None]

    if s > 1:
        y, new_ssm = _ssd.ssd_chunked(
            xdt, a_log, bmat, cmat, chunk=chunk, init_state=ssm_state,
            return_final_state=True, plain=impl == "xla")
    else:
        # single-step recurrence (decode)
        state = ssm_state.float() if ssm_state is not None else \
            torch.zeros((b, n_heads, d_state, head_dim),
                        dtype=torch.float32, device=x.device)
        rep = n_heads // n_groups
        bh = bmat[:, 0].repeat_interleave(rep, dim=1).float()   # (B, H, N)
        ch = cmat[:, 0].repeat_interleave(rep, dim=1).float()
        state = state * torch.exp(a_log[:, 0])[:, :, None, None] + \
            torch.einsum("bhn,bhp->bhnp", bh, xdt[:, 0])
        y = torch.einsum("bhn,bhnp->bhp", ch, state)[:, None]   # (B,1,H,P)
        new_ssm = state

    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = L.rmsnorm(params["norm"], y * F.silu(z))
    out = y @ params["w_out"]
    return out, (new_ssm, new_conv[:, -(params["conv_w"].shape[0] - 1):])
