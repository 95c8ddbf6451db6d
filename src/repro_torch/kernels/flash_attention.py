"""Attention algorithms: flash (the flash-attention kernel K13) and
materialized.

The counterpart of ``repro/kernels/flash_attention.py`` behind
``repro/kernels/ops.py::attention``:

  flash        — ``flash_attention``: an online softmax over key blocks
                 that keeps the score tile on chip and writes no
                 workspace (CUDA: ``csrc/flash_attention.cu``,
                 ``rt_flash_attention``); ``flash_attention_ref`` is its
                 plain version, taken for CPU tensors.
  materialized — ``attention_materialized``: the (B, Hq, Sq, Skv) f32
                 score matrix in device memory.

Layout: q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); Hq % Hkv == 0 (GQA, the
query heads of a kv head adjacent).  Query i is aligned to key
i + (Skv - Sq), so one function serves a full sequence (Sq == Skv) and a
suffix of queries (Sq < Skv).  K13 has no backward, nor has the
reference's Pallas kernel: the wrapper refuses a tensor that needs a
gradient.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt

#: The largest head dim K13 takes (its tiles hold a whole head in
#: shared memory).
MAX_HEAD_DIM = 128
#: Rows ((query position, query head) pairs) of a K13 CTA: 16 for each
#: of its 4 warps.
FLASH_ROWS = 64
_NEG_INF = -1e30


@functools.lru_cache(maxsize=256)
def flash_launch(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                 causal: bool, window: int | None) -> dict:
    """K13's launch, as ``csrc/flash_attention.cu`` computes it: the head
    dim ``dp`` its tiles take (64 or 128), ``bk`` keys a block, the grid
    (row blocks, b * hkv) and, in launch order (longest causal ranges
    first), one entry per row block, the same for every (batch, kv head):
    (f0, f1, jbeg, jend, u0, u1) -- rows f0 <= f < f1 (row f is query
    position f // G, head f % G of the group, G = hq // hkv), key blocks
    jbeg <= j < jend ([j * bk, (j + 1) * bk)), of which u0 <= j < u1
    skip the per-element mask (clipped to the block range; u0 == u1 when
    every block is masked).  ``blocks`` and ``masked`` count a head's
    key blocks and masked ones; ``smem_bytes`` is a CTA's shared
    memory.  The kernel does not read this table: it computes the same
    ranges itself, so a change to either copy of that arithmetic is
    made to both."""
    dp = 64 if d <= 64 else 128
    bk = 32 if dp > 64 else 64
    g = hq // hkv
    rows, off = sq * g, skv - sq
    ctas, blocks, masked = [], 0, 0
    for f0 in reversed(range(0, rows, FLASH_ROWS)):
        f1 = min(f0 + FLASH_ROWS, rows)
        qlo, qhi = f0 // g + off, (f1 - 1) // g + off
        kend = min(skv, qhi + 1) if causal else skv
        kbeg = max(0, qlo - window + 1) if window is not None else 0
        jbeg = kbeg // bk
        jend = -(-kend // bk) if kend > 0 else 0
        u1 = skv // bk
        if causal:
            u1 = min(u1, max(qlo + 1, 0) // bk)
        u0 = jbeg
        if window is not None:
            u0 = max(u0, -(-max(qhi - window + 1, 0) // bk))
        u0 = min(max(u0, jbeg), max(jend, jbeg))
        u1 = min(max(u1, u0), max(jend, jbeg))
        ctas.append((f0, f1, jbeg, jend, u0, u1))
        blocks += max(jend - jbeg, 0)
        masked += max(jend - jbeg, 0) - (u1 - u0)
    return {"dp": dp, "bk": bk, "grid": (len(ctas), b * hkv),
            "ctas": tuple(ctas), "blocks": blocks, "masked": masked,
            "smem_bytes": 4 * (FLASH_ROWS * (dp + 16)
                               + 2 * bk * (2 * dp + 16))}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _masks(sq, skv, causal, window, device):
    """(Sq, Skv) bool: key j visible to query i (aligned to key
    i + Skv - Sq)."""
    qpos = torch.arange(sq, device=device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None):
    """Plain version of K13: the reference kernel's function with the
    whole score matrix at once.  Scores ``(q . k) * scale``, then
    ``softcap * tanh(s / softcap)``; causal and window masks; softmax in
    f32 over the visible keys; a row that sees no key comes out as 0.
    Output in q's dtype.  Forward only (it updates its scores in
    place)."""
    _check(q, k, v)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s.mul_(scale)
    if softcap is not None:
        s.div_(softcap).tanh_().mul_(softcap)
    mask = _masks(sq, skv, causal, window, q.device)
    p = torch.softmax(s.masked_fill_(~mask, float("-inf")), dim=-1)
    del s
    p.masked_fill_(~mask.any(dim=-1, keepdim=True), 0.0)   # no key: 0
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None):
    """K13: ``flash_attention_ref``'s function on f32 tensors, launching
    the CUDA kernel for CUDA tensors and taking the plain version for CPU
    ones.  Raises for a tensor that needs a gradient (no backward) and
    for a head dim above ``MAX_HEAD_DIM``."""
    name = "flash_attention"
    dev = _rt.kernel_device(name, [q, k, v])
    _check(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            f"{name}: K13 has no backward (nor has the reference's Pallas "
            f"kernel); differentiate attention with impl='xla'")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} > {MAX_HEAD_DIM}, the "
                         f"largest the kernel takes")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    _rt.require_contiguous(name, [q, k, v])
    if b * hkv > 65535:
        raise ValueError(f"{name}: batch x kv heads {b * hkv} > 65535")
    scale = scale if scale is not None else d ** -0.5
    o = torch.empty_like(q)
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, skv,
        hq, hkv, d, int(bool(causal)), 0 if window is None else int(window),
        float(scale), 0.0 if softcap is None else float(softcap),
        _rt.stream_handle(dev))
    _build.check(rc, name)
    return o


def attention_materialized(q, k, v, *, causal: bool = True,
                           window: int | None = None,
                           softcap: float | None = None,
                           scale: float | None = None):
    """The materialized-scores algorithm (workspace B * Hq * Sq * Skv f32
    bytes), masked with -1e30 as the reference's is."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(_masks(sq, skv, causal, window, q.device), logits,
                         torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


ATTENTION_ALGORITHMS = {
    "flash": flash_attention,
    "materialized": attention_materialized,
}


def attention_workspace_bytes(algorithm: str, b, sq, skv, hq) -> int:
    if algorithm == "materialized":
        return b * hq * sq * skv * 4
    return 0
