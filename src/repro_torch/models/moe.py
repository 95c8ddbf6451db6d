"""Mixture-of-Experts layer: top-k router + capacity-bounded sort dispatch
(``repro/models/moe.py``'s counterpart, one device).

Experts are the paper's independent branches: E disjoint GEMM chains
forked by the router and joined by the weighted combine.  Two expert
engines share one routing (``_route``), so they drop and combine the
same tokens:

  einsum   the capacity-padded stacked einsum over (B, E, C, D) — the
           reference's oracle, plain torch;
  grouped  routed tokens packed into block-aligned per-expert segments
           of one buffer and run through ONE K11 call forward and ONE
           K12 call backward (``kernels.ops.grouped_matmul_experts``).

Dispatch is sort-based with a static capacity per batch row; FLOPs of
the grouped engine scale with the routed tokens, not E * capacity.  The
reference's shard_map paths (``moe_local``, ``moe_ep``) are multi-device
and not ported.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import ops as _ops
from repro_torch.models import layers as L


def moe_init(generator: torch.Generator, d: int, f: int, n_experts: int, *,
             shared_f: int = 0, gated: bool = True, dtype=torch.float32,
             device=None):
    std = d ** -0.5
    p = {
        "router": L.normal_init(generator, (d, n_experts), std, dtype,
                                device),
        "w_in": L.normal_init(generator, (n_experts, d, f), std, dtype,
                              device),
        "w_out": L.normal_init(generator, (n_experts, f, d), f ** -0.5,
                               dtype, device),
    }
    if gated:
        p["w_gate"] = L.normal_init(generator, (n_experts, d, f), std, dtype,
                                    device)
    if shared_f:
        p["shared"] = L.mlp_init(generator, d, shared_f, gated=gated,
                                 dtype=dtype, device=device)
    return p


def moe_capacity(sk: int, capacity_factor: float, e_route: int) -> int:
    """Static per-(row, expert) capacity: ceil to a multiple of 8 once
    past 8, never above S*k (the reference's rule)."""
    cap = int(-(-sk * capacity_factor // e_route))
    return max(1, min(-(-cap // 8) * 8 if cap >= 8 else cap, sk))


def _route(params, x, *, top_k: int, capacity_factor: float):
    """Router + per-row sort-based dispatch shared by both engines.

    Returns (probs, flat_e, se, st, sw, pos, keep, cap, brow, e, sk):
    router probabilities (B, S, E); each row's expert ids in token order
    (B, S*k); then, in each row's stable expert order, the expert, the
    token, the normalised combine weight, the rank within the expert,
    whether it fits the capacity; the capacity; the row index."""
    b, s, _ = x.shape
    e = params["w_in"].shape[0]
    logits = torch.einsum("bsd,de->bse", x, params["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)              # (B, S, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    sk = s * top_k
    cap = moe_capacity(sk, capacity_factor, e)
    flat_e = ids.reshape(b, sk)
    flat_t = torch.arange(s, device=x.device).repeat_interleave(top_k)[None] \
        .expand(b, sk)
    flat_w = w.reshape(b, sk)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.gather(flat_t, 1, order)
    sw = torch.gather(flat_w, 1, order)
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(sk, device=x.device)[None] - first  # rank in expert
    keep = pos < cap
    brow = torch.arange(b, device=x.device)[:, None].expand(b, sk)
    return probs, flat_e, se, st, sw, pos, keep, cap, brow, e, sk


def _moe_aux(probs, flat_e, keep, *, e, cap):
    """Switch load-balancing loss + drop/padding stats."""
    b, sk = flat_e.shape
    me = probs.mean((0, 1))                                 # (E,)
    ce = torch.zeros((b, e), device=probs.device).scatter_add_(
        1, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    ce = ce.sum(0) / (b * sk)
    aux_loss = e * torch.sum(me * ce)
    kept = keep.sum().float()
    slots = float(b * e * cap)               # the einsum engine's M rows
    return {"aux_loss": aux_loss,
            "drop_fraction": 1.0 - kept / max(float(b * sk), 1.0),
            "capacity": cap,
            "padded_slot_fraction": (slots - kept) / slots}


def _moe_apply_core(params, x, *, top_k: int, capacity_factor: float = 1.25,
                    activation: str = "silu"):
    """The einsum engine: dispatch into (B, E, C, D) capacity slots,
    stacked expert GEMMs over the expert axis, weighted combine."""
    b, s, d = x.shape
    probs, flat_e, se, st, sw, pos, keep, cap, brow, e, sk = _route(
        params, x, top_k=top_k, capacity_factor=capacity_factor)
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    disp = torch.full((b, e * cap + 1), s, dtype=torch.long, device=x.device)
    disp.scatter_(1, slot, torch.where(keep, st, torch.full_like(st, s)))
    xpad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    xe = torch.gather(xpad, 1, disp[:, :e * cap, None].expand(b, e * cap, d)) \
        .reshape(b, e, cap, d)

    act = L.ACTIVATIONS[activation]
    h = torch.einsum("becd,edf->becf", xe, params["w_in"])
    if "w_gate" in params:
        h = act(torch.einsum("becd,edf->becf", xe, params["w_gate"])) * h
    else:
        h = act(h)
    ye = torch.einsum("becf,efd->becd", h, params["w_out"])  # (B, E, C, D)

    ypad = torch.cat([ye.reshape(b, e * cap, d), ye.new_zeros((b, 1, d))],
                     dim=1)
    contrib = torch.gather(ypad, 1, slot[..., None].expand(b, sk, d)) \
        * sw[..., None].to(ye.dtype)
    out = torch.zeros((b, s, d), dtype=ye.dtype, device=x.device) \
        .scatter_add(1, st[..., None].expand(b, sk, d), contrib)
    if "shared" in params:
        out = out + L.mlp(params["shared"], x, activation).to(out.dtype)
    return out.to(x.dtype), _moe_aux(probs, flat_e, keep, e=e, cap=cap)


def _moe_apply_grouped(params, x, *, top_k: int,
                       capacity_factor: float = 1.25,
                       activation: str = "silu"):
    """The grouped engine: routed tokens packed into block-aligned
    per-expert segments of ONE (MBS*bm, D) buffer, the experts run by
    ONE ``grouped_matmul_experts`` call per direction.

    The pack order is a second stable argsort (by expert id, drops last)
    over ``_route``'s per-row order; ``pp`` maps each routed assignment
    to its packed row (drops to a trash row), so combine indices and
    values match the einsum engine element for element.  Everything stays
    on the device: ``counts`` is never read on the host."""
    b, s, d = x.shape
    probs, flat_e, se, st, sw, pos, keep, cap, brow, e, sk = _route(
        params, x, top_k=top_k, capacity_factor=capacity_factor)
    dev = x.device
    n = b * sk                                 # total routed assignments
    bm = _gmm.moe_block_m(n, e)
    n_pack = _gmm.moe_static_blocks(n, e, bm) * bm

    ge = torch.where(keep, se, torch.full_like(se, e)).reshape(-1)
    order2 = torch.argsort(ge, stable=True)               # by expert
    sge = ge[order2]
    counts = torch.zeros((e + 1,), dtype=torch.int32, device=dev) \
        .scatter_add_(0, sge, torch.ones_like(sge, dtype=torch.int32))[:e]
    firstq = torch.searchsorted(sge, sge, side="left")
    rank = torch.arange(n, device=dev) - firstq           # rank in expert
    rowoff = _gmm.expert_row_offsets(counts, bm).long()
    pp_sorted = torch.where(sge < e, rowoff[torch.clamp(sge, max=e - 1)]
                            + rank, torch.full_like(sge, n_pack))
    pp = torch.empty_like(pp_sorted)
    pp[order2] = pp_sorted

    keep_f = keep.reshape(-1)
    fi = (brow * s + st).reshape(-1)                      # flat token index
    dispv = torch.full((n_pack + 1,), b * s, dtype=torch.long, device=dev) \
        .scatter_(0, pp, torch.where(keep_f, fi, torch.full_like(fi, b * s)))
    xflat = torch.cat([x.reshape(b * s, d), x.new_zeros((1, d))])
    # index_select, not xflat[...]: the backward of advanced indexing
    # walks each repeated index serially, and every padding row repeats
    # the zero row's index
    xpk = xflat.index_select(0, dispv[:n_pack])
    swpk = torch.zeros((n_pack + 1,), dtype=torch.float32, device=dev) \
        .scatter(0, pp, torch.where(keep_f, sw.reshape(-1),
                                    torch.zeros_like(sw.reshape(-1))))[:n_pack]

    ypk = _ops.grouped_matmul_experts(
        xpk, swpk, params["w_in"], params["w_out"], params.get("w_gate"),
        counts, activation=activation, bm=bm)

    ypad = torch.cat([ypk, ypk.new_zeros((1, d))])
    contrib = ypad.index_select(0, pp).reshape(b, sk, d)  # drops: zero row
    out = torch.zeros((b, s, d), dtype=ypk.dtype, device=dev) \
        .scatter_add(1, st[..., None].expand(b, sk, d), contrib)
    if "shared" in params:
        out = out + L.mlp(params["shared"], x, activation).to(out.dtype)
    return out.to(x.dtype), _moe_aux(probs, flat_e, keep, e=e, cap=cap)


def moe_apply(params, x, *, top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", impl: str = "einsum"):
    """x: (B, S, D) -> (out (B, S, D), aux dict).  ``impl`` picks the
    expert engine: ``"einsum"`` (capacity-padded stacked einsum, plain
    torch) or ``"grouped"`` (the K11/K12 kernels on the card)."""
    if impl == "grouped":
        return _moe_apply_grouped(params, x, top_k=top_k,
                                  capacity_factor=capacity_factor,
                                  activation=activation)
    if impl != "einsum":
        raise ValueError(f"unknown moe impl {impl!r}")
    return _moe_apply_core(params, x, top_k=top_k,
                           capacity_factor=capacity_factor,
                           activation=activation)
