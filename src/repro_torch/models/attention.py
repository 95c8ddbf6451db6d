"""GQA self-attention (``repro/models/attention.py``'s ``attn_init``,
``_sdpa_materialized``, ``_sdpa_xla`` and ``attn_apply``), over the
whole sequence or against a KV cache.

The reference computes attention outside any Pallas kernel on its
``impl="xla"`` path, so it stays plain torch here: the materialized
softmax when the f32 score matrix is small (granite at seq 512), the
kv-chunked online softmax past that, so any sequence length computes
what the reference computes.  With a KV cache (prefill and decode) the
reference takes that path on every impl, and so does the port.  Without
a cache, ``impl="pallas"`` is the flash-attention kernel K13
(``kernels.ops.attention(algorithm="flash")``), forward only: a tensor
that needs a gradient raises, as the reference's has no VJP.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as K
from repro_torch.models import layers as L

_NEG_INF = -1e30


def attn_init(generator: torch.Generator, d: int, hq: int, hkv: int,
              hd: int, dtype=torch.float32, device=None,
              qkv_bias: bool = False):
    std = d ** -0.5
    p = {
        "wq": L.normal_init(generator, (d, hq * hd), std, dtype, device),
        "wk": L.normal_init(generator, (d, hkv * hd), std, dtype, device),
        "wv": L.normal_init(generator, (d, hkv * hd), std, dtype, device),
        "wo": L.normal_init(generator, (hq * hd, d), (hq * hd) ** -0.5,
                            dtype, device),
    }
    if qkv_bias:
        for k, n in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[k] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def _mask(qpos, kpos, *, causal, window, skv=None):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if skv is not None:
        m &= kpos[None, :] < skv
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _sdpa_materialized(q, k, v, *, causal, window, softcap, scale,
                       qpos_base=None):
    """Softmax over the whole (Sq, Skv) f32 score matrix.  q: (B, Sq, Hq,
    D); k, v: (B, Skv, Hkv, D); query heads grouped Hq/Hkv per kv head."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    if qpos_base is None:
        qpos_base = skv - sq
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device) + qpos_base
    kpos = torch.arange(skv, device=q.device)
    mask = _mask(qpos, kpos, causal=causal, window=window)
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _sdpa_xla(q, k, v, *, causal, window, softcap, scale, qpos_base=None,
              chunk_kv: int = 1024, chunk_q: int = 1024):
    """The reference's attention: materialized when Sq*Skv <= 1024^2 (or
    Sq == 1), else an online softmax over kv chunks for each q chunk
    (flash-equivalent math, bounded memory).  qpos_base: position of q[0]
    among the keys (default Skv - Sq)."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if qpos_base is None:
        qpos_base = skv - sq
    if sq * skv <= 1024 * 1024 or sq == 1:
        return _sdpa_materialized(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  qpos_base=qpos_base)
    g = hq // hkv
    dev = q.device
    nq = -(-sq // chunk_q)
    nk = -(-skv // chunk_kv)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * chunk_q - sq))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * chunk_kv - skv))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * chunk_kv - skv))
    neg = torch.full((), _NEG_INF, device=dev)
    outs = []
    for iq in range(nq):
        qi = qp[:, iq * chunk_q:(iq + 1) * chunk_q].float() \
            .reshape(b, chunk_q, hkv, g, d)
        qpos = iq * chunk_q + torch.arange(chunk_q, device=dev) + qpos_base
        acc = torch.zeros((b, hkv, g, chunk_q, d), device=dev)
        m = torch.full((b, hkv, g, chunk_q), _NEG_INF, device=dev)
        l = torch.zeros((b, hkv, g, chunk_q), device=dev)
        for jk in range(nk):
            kj = kp[:, jk * chunk_kv:(jk + 1) * chunk_kv].float()
            vj = vp[:, jk * chunk_kv:(jk + 1) * chunk_kv].float()
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj) * scale
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            kpos = jk * chunk_kv + torch.arange(chunk_kv, device=dev)
            s = torch.where(_mask(qpos, kpos, causal=causal, window=window,
                                  skv=skv), s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vj)
            m = m_new
        l = torch.where(l == 0.0, torch.ones((), device=dev), l)
        out = (acc / l[..., None]).permute(0, 3, 1, 2, 4)  # (B, cq, hkv, g, D)
        outs.append(out.reshape(b, chunk_q, hq, d))
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def attn_apply(params, x, *, hq: int, hkv: int, hd: int, positions=None,
               kv_cache=None, cache_pos=None, causal: bool = True,
               window: int | None = None, softcap: float | None = None,
               rope_theta: float | None = 10000.0,
               query_scale: float | None = None, impl: str = "xla"):
    """Self-attention, x (B, S, D) -> (out (B, S, D), new KV cache).

    kv_cache: (2, B, Smax, Hkv, hd) or None (training: returns None).
    With a cache, the new k/v are written at ``cache_pos`` (an int, the
    position of x's first token) into a copy of the cache, kept in its
    dtype, and the queries attend over the whole copy, masked from
    ``qpos_base = cache_pos`` so the slots not yet written drop out."""
    if impl not in ("xla", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    b, s, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, hkv, hd)
    v = v.reshape(b, s, hkv, hd)
    if rope_theta is not None:
        if positions is None:
            base = 0 if cache_pos is None else cache_pos
            positions = base + torch.arange(s, device=x.device)[None, :]
        q = L.rope(q, positions, rope_theta)
        k = L.rope(k, positions, rope_theta)
    new_cache = None
    if kv_cache is not None:
        new_cache = kv_cache.clone()
        new_cache[:, :, cache_pos:cache_pos + s] = \
            torch.stack([k, v]).to(kv_cache.dtype)
        k, v = new_cache[0].to(x.dtype), new_cache[1].to(x.dtype)
    scale = query_scale if query_scale is not None else hd ** -0.5
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if impl == "pallas" and kv_cache is None:
        out = K.attention(q, k, v, algorithm="flash", **kw)
    else:
        out = _sdpa_xla(q, k, v, **kw,
                        qpos_base=cache_pos if kv_cache is not None else None)
    return out.reshape(b, s, hq * hd) @ params["wo"], new_cache
