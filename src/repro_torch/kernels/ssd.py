"""Mamba-2 SSD (state-space duality): the chunked algorithm on the SSD
chunk kernel (K14), its plain version, and the quadratic algorithm.

The counterpart of ``repro/kernels/ssd.py`` behind
``repro/kernels/ops.py::ssd``:

  chunked   — ``ssd_chunked``: per (batch, chunk) cell, K14 computes the
              quadratic intra-chunk output, the end-of-chunk state and the
              within-chunk cumulative log decay (``ssd_chunk``; CUDA:
              ``csrc/ssd_chunk.cu``, ``rt_ssd_chunk``); the inter-chunk
              linear recurrence and the off-diagonal term are plain torch
              outside the kernel, as in the reference.
  quadratic — ``ssd_quadratic``: the full S x S semiseparable matrix
              (``kernels.ref.ssd_ref``).

Interface, pre-discretized (the model layer applies dt): x (B, S, H, P),
a_log (B, S, H) negative log decays, b, c (B, S, G, N) with H % G == 0.
``ssd_chunk`` takes CPU tensors to ``ssd_chunk_ref`` and launches K14 for
CUDA tensors, or raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt
from repro_torch.kernels.ref import ssd_ref

#: The longest chunk K14 takes (the reference's default chunk).
MAX_CHUNK = 128
#: The widest head K14 takes (its x stages and accumulators).
MAX_HEAD_DIM = 64
#: Heads a CTA of K14 takes, at most.
SSD_HEADS_MAX = 16
#: What a CTA of K14 spends on its own work (staging B and C, forming
#: C Bᵀ), in heads' worth: at the full-width mamba2-370m layer on an H100
#: (``scripts/bench_ssd.py --variants``), 8 heads a CTA in 2 waves took
#: 0.2262 ms and 16 heads in 1 wave 0.2094 ms, so f = 1.4 h.
SSD_CTA_HEADS = 1.4
#: Dynamic shared memory a CTA may use on Hopper (bytes).
_SMEM_LIMIT = 232448


def _check(x, a, b, c):
    if x.dim() != 5 or a.dim() != 4 or b.dim() != 5 or c.shape != b.shape \
            or a.shape != x.shape[:4] or b.shape[:3] != x.shape[:3] \
            or x.shape[3] % b.shape[3]:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}, a {tuple(a.shape)}"
                         f", b {tuple(b.shape)}, c {tuple(c.shape)}")


@functools.lru_cache(maxsize=256)
def ssd_launch(bsz: int, nc: int, l: int, h: int, p: int, g: int, n: int,
               sms: int) -> dict:
    """K14's launch over ``bsz * nc`` cells (``csrc/ssd_chunk.cu``):
    ``nw`` warps a CTA (4 for a chunk of at most 64, else 8), ``lp`` rows
    (16 a warp), ``pp`` the head dim its tiles take (32 or 64), ``ldb``
    the pitch of its B and C rows (d_state rounded up to 16, plus 8).
    ``hb`` heads a CTA, so that C Bᵀ is formed once for ``hb`` heads of
    one group: the divisor of H / G up to ``SSD_HEADS_MAX`` for which
    the waves of the grid (``per_sm`` CTAs resident on each of the
    ``sms`` SMs) times the work of a CTA (hb heads and
    ``SSD_CTA_HEADS`` of its own) is least, the larger on a tie.
    ``ctas`` lists, in launch order (the 1-D ``grid``), each CTA's
    (cell, first head): CTA i takes cell i // (H / hb), heads from
    (i % (H / hb)) * hb.  ``smem_bytes`` is a CTA's dynamic shared
    memory; ``limit`` names what the kernel cannot take (None if it takes
    the shape).  The kernel computes the same offsets itself, so a change
    to either copy of that arithmetic is made to both."""
    cells, rep = bsz * nc, h // g
    nw = 4 if l <= 64 else 8
    lp, pp = 16 * nw, 32 if p <= 32 else 64
    ldb = -(-n // 16) * 16 + 8
    per_sm = 2 if nw == 4 else 1

    def cost(d):
        waves = -(-(cells * h // d) // (per_sm * sms))
        return waves * (d + SSD_CTA_HEADS), -d
    hb = min((d for d in range(1, min(rep, SSD_HEADS_MAX) + 1)
              if rep % d == 0), key=cost)
    xs = lp * pp
    smem = 4 * (lp * ldb + xs + max(lp * ldb, 2 * xs) + hb * lp + lp)
    limit = None
    if l > MAX_CHUNK:
        limit = f"chunk {l} > {MAX_CHUNK}, the longest the kernel takes"
    elif p > MAX_HEAD_DIM:
        limit = f"head dim {p} > {MAX_HEAD_DIM}, the widest the kernel takes"
    elif smem > _SMEM_LIMIT:
        limit = (f"d_state {n} needs {smem} bytes of shared memory, more "
                 f"than a CTA has")
    blocks = h // hb
    return {"nw": nw, "lp": lp, "pp": pp, "ldb": ldb, "hb": hb,
            "per_sm": per_sm,
            "grid": (cells * blocks,),
            "ctas": tuple((i // blocks, (i % blocks) * hb)
                          for i in range(cells * blocks)),
            "smem_bytes": smem, "limit": limit}


def ssd_chunk_ref(x, a, b, c):
    """Plain version of K14 over every (batch, chunk) cell.

    x (B, nc, L, H, P), a (B, nc, L, H), b, c (B, nc, L, G, N) ->
    y_diag (B, nc, L, H, P) in x's dtype, states (B, nc, H, N, P) f32 and
    cum (B, nc, L, H) f32: ``cum = cumsum(a)`` over the chunk,
    ``y_diag[t] = sum_{s<=t} exp(cum[t] - cum[s]) (c[t] . b[s]) x[s]``
    and ``state = sum_s exp(cum[L-1] - cum[s]) b[s] (x) x[s]``."""
    _check(x, a, b, c)
    l, h = x.shape[2], x.shape[3]
    rep = h // b.shape[3]
    xf, bf, cf = x.float(), b.float(), c.float()
    cum = torch.cumsum(a.float(), dim=2)                       # (B,nc,L,H)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,T,S,H)
    ts = torch.arange(l, device=x.device)
    causal = (ts[:, None] >= ts[None, :])[:, :, None]
    decay = torch.exp(torch.where(causal, diff,
                                  torch.full((), -1e30, device=x.device)))
    cb = torch.einsum("bctgn,bcsgn->bctsg", cf, bf) \
        .repeat_interleave(rep, dim=4)                         # (B,nc,T,S,H)
    y = torch.einsum("bctsh,bcshp->bcthp", cb * decay, xf)
    sdecay = torch.exp(cum[:, :, -1:] - cum)                   # (B,nc,L,H)
    bh = bf.repeat_interleave(rep, dim=3)                      # (B,nc,L,H,N)
    st = torch.einsum("bcshn,bcshp->bchnp", bh * sdecay[..., None], xf)
    return y.to(x.dtype), st, cum


def ssd_chunk(x, a, b, c):
    """K14 over every (batch, chunk) cell: (y_diag, states, cum) as
    ``ssd_chunk_ref`` returns them; f32 operands."""
    name = "ssd_chunked"
    dev = _rt.kernel_device(name, [x, a, b, c])
    _check(x, a, b, c)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, a, b, c)):
        raise NotImplementedError(
            f"{name}: K14 has no backward (nor has the reference's Pallas "
            f"kernel); differentiate the mamba mixer with impl='xla'")
    if dev.type == "cpu":
        return ssd_chunk_ref(x, a, b, c)
    _rt.require_contiguous(name, [x, a, b, c])
    bsz, nc, l, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    la = ssd_launch(bsz, nc, l, h, p, g, n, _rt.sm_count(dev))
    if la["limit"]:
        raise ValueError(f"{name}: {la['limit']}")
    y = torch.empty_like(x)
    st = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=dev)
    cum = torch.empty((bsz, nc, l, h), dtype=torch.float32, device=dev)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_ssd_chunk(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                          c.data_ptr(), y.data_ptr(), st.data_ptr(),
                          cum.data_ptr(), bsz * nc, l, h, p, g, n,
                          la["hb"], _rt.stream_handle(dev))
    _build.check(rc, name)
    return y, st, cum


def ssd_chunked(x, a_log, b, c, *, chunk: int = 128, d_skip=None,
                init_state=None, return_final_state: bool = False,
                plain: bool = False):
    """The chunked SSD: the sequence zero-padded to a multiple of the
    chunk (padded x contributes nothing, padded a_log decays by 1), K14
    per cell (``ssd_chunk_ref`` on any device if ``plain``: the model's
    ``impl="xla"`` path), then the inter-chunk recurrence
    ``S_in[c+1] = S_in[c] * exp(sum a over chunk c) + states[c]`` from
    ``init_state`` (zeros by default) and the off-diagonal term
    ``y_off[t] = (c[t] . S_in) exp(cum[t])``.  Returns y in x's dtype,
    and the final state (B, H, N, P) f32 if ``return_final_state``."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    l = min(chunk, s)
    s_p = -(-s // l) * l
    pad = s_p - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = F.pad(a_log, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = s_p // l
    xc = x.reshape(bsz, nc, l, h, p).contiguous()
    ac = a_log.reshape(bsz, nc, l, h).contiguous()
    bc = b.reshape(bsz, nc, l, g, n).contiguous()
    cc = c.reshape(bsz, nc, l, g, n).contiguous()

    cells = ssd_chunk_ref if plain else ssd_chunk
    y_diag, states, cum = cells(xc, ac, bc, cc)

    # inter-chunk recurrence: the state entering each chunk
    decay = torch.exp(cum[:, :, -1])                           # (B, nc, H)
    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    s_in = []
    for ci in range(nc):
        s_in.append(state)
        state = state * decay[:, ci, :, None, None] + states[:, ci]
    s_in = torch.stack(s_in, dim=1).reshape(bsz, nc, g, h // g, n, p)

    # off-diagonal: y_off[t] = (c[t] . S_in) * exp(cum[t])
    y_off = torch.einsum("bclgn,bcgrnp->bclgrp", cc.float(), s_in) \
        .reshape(bsz, nc, l, h, p) * torch.exp(cum)[..., None]
    y = (y_diag.float() + y_off).reshape(bsz, s_p, h, p)[:, :s]
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * \
            xc.reshape(bsz, s_p, h, p)[:, :s].float()
    y = y.to(x.dtype)
    if return_final_state:
        return y, state
    return y


def ssd_quadratic(x, a_log, b, c, *, chunk: int | None = None, d_skip=None):
    """The materialized S x S algorithm (workspace B * S * S * H f32);
    ``chunk`` is taken, and unused, so that every algorithm of
    ``SSD_ALGORITHMS`` takes the same keywords."""
    return ssd_ref(x, a_log, b, c, d_skip=d_skip)


SSD_ALGORITHMS = {
    "chunked": ssd_chunked,
    "quadratic": ssd_quadratic,
}
