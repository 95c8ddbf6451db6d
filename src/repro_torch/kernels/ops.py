"""Differentiable grouped launches: the reference's custom VJPs
(``repro/kernels/ops.py``) as ``torch.autograd.Function``s.

  grouped_matmul_pooled   K2 forward (``_pooled_vjp``): a pooled
                          branch's lhs is a tuple of tap views.  Backward:
                          the taps fold to the pooled lhs (plain torch,
                          as the reference folds at pack time), ONE K5
                          launch with dy masked by the forward's ReLU
                          output, then the lhs cotangent scatters onto
                          the taps through the first-argmax mask.
  grouped_matmul          the same Function with no pooled branch
                          (``_grouped_vjp``).
  grouped_matmul_concat   K1 forward (``_concat_vjp``) with the join's
                          passthrough columns (inputs produced by earlier
                          groups) copied in INSIDE the Function, before
                          anything is saved, so nothing saved for backward
                          is written afterwards.  Backward: ONE K5 launch
                          over column slices of the joint cotangent and
                          of the saved join (the ReLU mask), read in
                          place; the passthrough columns' cotangent is
                          their slice of the joint one.

  branch_matmul           K9 forward (``_branch_matmul_vjp``): the G
                          same-shape GEMMs of a stacked group.  Backward:
                          dx = g @ yᵀ and dy = xᵀ @ g, each ONE K9 launch
                          reading the transposed operand in place.

  grouped_matmul_experts  K11 forward with ``train=True`` (the MoE
                          expert engine, the reference's
                          ``grouped_matmul_experts`` custom VJP).
                          Backward: ONE K12 call for dx and every dW;
                          the combine weight's cotangent dsw is a row
                          reduction of the saved output, outside the
                          kernel; ``counts`` gets no gradient.

``m_valid`` (ragged M, the serving path) calls the kernel directly, with
no Function, as the reference does: the serving path never
differentiates.  Under ``torch.no_grad()`` a Function runs its forward
only, the same launches as a direct call.  Kernels are looked up on
their modules at call time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import branch_matmul as _bmm
from repro_torch.kernels import grouped_matmul as _gmm


def _flatten(xs):
    """(tap count per branch — 0 for a plain lhs —, flat tensors)."""
    counts, flat = [], []
    for x in xs:
        if isinstance(x, (list, tuple)):
            counts.append(len(x))
            flat.extend(x)
        else:
            counts.append(0)
            flat.append(x)
    return tuple(counts), flat


def _unflatten(counts, flat):
    xs, i = [], 0
    for c in counts:
        if c == 0:
            xs.append(flat[i])
            i += 1
        else:
            xs.append(tuple(flat[i:i + c]))
            i += c
    return xs


def _fold(xs):
    """(one lhs per branch, {branch: folded pooled lhs}): the pack-time
    pool fold the forward kernel performs in its loader."""
    flat, pooled = [], {}
    for i, x in enumerate(xs):
        if isinstance(x, tuple):
            pooled[i] = _gmm.pool_from_taps(list(x))
            flat.append(pooled[i])
        else:
            flat.append(x)
    return flat, pooled


def _scatter(xs, pooled, dxs):
    """Each branch's lhs cotangent; a pooled branch's routed onto its
    taps."""
    out = []
    for i, x in enumerate(xs):
        if isinstance(x, tuple):
            out.extend(_gmm.pool_cotangent_taps(list(x), pooled[i], dxs[i]))
        else:
            out.append(dxs[i])
    return out


class _Pooled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, counts, nb, has_bias, relu, *tensors):
        nx = sum(max(c, 1) for c in counts)
        xs = _unflatten(counts, tensors[:nx])
        ws = list(tensors[nx:nx + nb])
        bs = list(tensors[nx + nb:]) if has_bias else None
        ys = _gmm.grouped_matmul_pooled(xs, ws, bs, relu=relu)
        ctx.counts, ctx.nb, ctx.has_bias, ctx.relu = counts, nb, has_bias, \
            relu
        ctx.save_for_backward(*tensors[:nx + nb], *(ys if relu else ()))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        saved = ctx.saved_tensors
        nx = sum(max(c, 1) for c in ctx.counts)
        xs = _unflatten(ctx.counts, saved[:nx])
        ws = list(saved[nx:nx + ctx.nb])
        mask = list(saved[nx + ctx.nb:]) if ctx.relu else None
        flat, pooled = _fold(xs)
        dys = [g.contiguous() for g in gs]
        dxs, dws, dbs = _gmm.grouped_matmul_bwd(flat, ws, dys, mask)
        return (None, None, None, None, *_scatter(xs, pooled, dxs), *dws,
                *(dbs if ctx.has_bias else ()))


def grouped_matmul_pooled(xs, ws, bs=None, *, relu: bool = False,
                          m_valid=None):
    """[maxpool(x_g) @ w_g (+ b_g) (+ ReLU)] in ONE K2 launch,
    differentiable through ONE K5 launch (see the module docstring);
    ``xs[g]`` an (M, K_g) tensor or a sequence of (M, K_g) tap views.
    Returns G tensors (M, N_g)."""
    if m_valid is not None:
        return _gmm.grouped_matmul_pooled(xs, ws, bs, relu=relu,
                                          m_valid=m_valid)
    counts, flat = _flatten(xs)
    return list(_Pooled.apply(counts, len(ws), bs is not None, bool(relu),
                              *flat, *ws, *(bs or ())))


def grouped_matmul(xs, ws, bs=None, *, relu: bool = False, m_valid=None):
    """[x_g @ w_g (+ b_g) (+ ReLU)] for ragged (K_g, N_g) in ONE launch,
    differentiable through ONE K5 launch: ``grouped_matmul_pooled`` with
    every branch unpooled."""
    if any(isinstance(x, (list, tuple)) for x in xs):
        raise ValueError("grouped_matmul: plain (M, K_g) lhs only; pooled "
                         "branches go through grouped_matmul_pooled")
    return grouped_matmul_pooled(xs, ws, bs, relu=relu, m_valid=m_valid)


def _copy_passthrough(y, passthrough, pt_offsets):
    for pt, off in zip(passthrough, pt_offsets):
        w = pt.shape[-1]
        y[:, off:off + w] = pt.reshape(-1, w)


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, nb, has_bias, offsets, total, relu, pt_offsets,
                *tensors):
        xs = list(tensors[:nb])
        ws = list(tensors[nb:2 * nb])
        bs = list(tensors[2 * nb:3 * nb]) if has_bias else None
        pts = tensors[(3 if has_bias else 2) * nb:]
        y = _gmm.grouped_matmul_concat(xs, ws, bs, offsets=offsets,
                                       total=total, relu=relu)
        _copy_passthrough(y, pts, pt_offsets)
        ctx.nb, ctx.has_bias, ctx.offsets, ctx.relu = nb, has_bias, \
            offsets, relu
        ctx.pt_offsets = pt_offsets
        ctx.pt_shapes = [p.shape for p in pts]
        ctx.save_for_backward(*xs, *ws, y)
        return y

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        nb = ctx.nb
        xs, ws, y = list(saved[:nb]), list(saved[nb:2 * nb]), saved[-1]
        g = g.contiguous()
        dys = [g[:, o:o + w.shape[1]] for o, w in zip(ctx.offsets, ws)]
        mask = [y[:, o:o + w.shape[1]]
                for o, w in zip(ctx.offsets, ws)] if ctx.relu else None
        dxs, dws, dbs = _gmm.grouped_matmul_bwd(xs, ws, dys, mask)
        dpts = [g[:, o:o + s[-1]].reshape(s)
                for o, s in zip(ctx.pt_offsets, ctx.pt_shapes)]
        return (None, None, None, None, None, None, *dxs, *dws,
                *(dbs if ctx.has_bias else ()), *dpts)


def grouped_matmul_concat(xs, ws, bs=None, *, offsets, total: int,
                          relu: bool = False, passthrough=(),
                          pt_offsets=(), m_valid=None):
    """[x_g @ w_g (+ b_g) (+ ReLU)] written into the join's (M, total)
    layout at ``offsets`` by ONE K1 launch, with each ``passthrough``
    tensor (..., w) copied into its columns at ``pt_offsets``;
    differentiable through ONE K5 launch (see the module docstring)."""
    offsets = tuple(int(o) for o in offsets)
    pt_offsets = tuple(int(o) for o in pt_offsets)
    if len(passthrough) != len(pt_offsets):
        raise ValueError(f"grouped_matmul_concat: {len(passthrough)} "
                         f"passthrough tensors, {len(pt_offsets)} offsets")
    if m_valid is not None:
        y = _gmm.grouped_matmul_concat(xs, ws, bs, offsets=offsets,
                                       total=int(total), relu=relu,
                                       m_valid=m_valid)
        _copy_passthrough(y, passthrough, pt_offsets)
        return y
    return _Concat.apply(len(xs), bs is not None, offsets, int(total),
                         bool(relu), pt_offsets, *xs, *ws, *(bs or ()),
                         *passthrough)


class BranchMatmul(torch.autograd.Function):
    """(G, M, K) @ (G, K, N) through K9, differentiable through K9: the
    backward GEMMs of G independent branches are themselves G independent
    same-shape GEMMs."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return _bmm.branch_matmul(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        g = g.contiguous()
        dx = _bmm.branch_matmul(g, y.transpose(1, 2)) \
            if ctx.needs_input_grad[0] else None
        dy = _bmm.branch_matmul(x.transpose(1, 2), g) \
            if ctx.needs_input_grad[1] else None
        return dx, dy


def branch_matmul(x, y):
    """G same-shape branch GEMMs in ONE K9 launch, differentiable through
    two (see ``BranchMatmul``)."""
    return BranchMatmul.apply(x, y)


class _Experts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, activation, bm, xp, swp, w_in, w_out, w_gate, counts):
        y, hinp, gatep = _gmm.grouped_matmul_experts(
            xp, swp, w_in, w_out, w_gate, counts, activation=activation,
            train=True, bm=bm)
        ctx.activation, ctx.bm = activation, bm
        ctx.save_for_backward(xp, swp, w_in, w_out, w_gate, counts, y, hinp,
                              gatep)
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, swp, w_in, w_out, w_gate, counts, y, hinp, gatep = \
            ctx.saved_tensors
        dy = dy.contiguous()
        dyp = dy * swp[:, None]
        dx, dwin, dwgate, dwout = _gmm.grouped_matmul_experts_bwd(
            xp, dyp, w_in, w_out, w_gate, hinp, gatep, counts,
            activation=ctx.activation, bm=ctx.bm)
        # dsw_r = <dy_r, y_r / sw_r>: the unscaled row recovered from the
        # saved output instead of a third kernel pass
        num = (dy * y).sum(-1)
        nz = swp != 0
        dsw = torch.where(nz, num / torch.where(nz, swp, torch.ones_like(swp)),
                          torch.zeros_like(swp))
        return None, None, dx, dsw, dwin, dwout, dwgate, None


def grouped_matmul_experts(xp, swp, w_in, w_out, w_gate, counts, *,
                           activation: str = "silu", bm: int):
    """The per-expert ragged expert stack (see the module docstring):
    ONE K11 call forward, ONE K12 call backward.  Without a gradient to
    take it is one K11 call with no residuals."""
    if not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xp, swp, w_in, w_out, w_gate))):
        return _gmm.grouped_matmul_experts(xp, swp, w_in, w_out, w_gate,
                                           counts, activation=activation,
                                           bm=bm)
    return _Experts.apply(activation, bm, xp, swp, w_in, w_out, w_gate,
                          counts)
