"""Grouped ragged branch GEMMs: the concat (K1), pooled (K2) and chained
(K6) launches of the serving path, the combined backward launch (K5) of
the training path, their plain versions, and the pure torch pool
helpers they share.

The counterpart of ``repro/kernels/grouped_matmul.py``.  Every wrapper
keeps the reference launcher's signature and results:

  grouped_matmul_concat   y_g = relu(x_g @ w_g + b_g) assembled into the
                          fork/join's (M, total) layout at per-branch
                          column ``offsets`` (``compact=False``: the padded
                          (M, sum ceil128(N_g)) buffer instead).
                          CUDA: ``csrc/grouped_matmul.cu`` (rt_gmm_fwd).
  grouped_matmul_pooled   the same per branch, where a pooled branch's
                          ``xs[g]`` is a sequence of tap views of the raw
                          input (``pool_tap_views``), read in place and
                          maxed into the lhs in the kernel.  CUDA:
                          ``csrc/grouped_matmul.cu`` (rt_gmm_fwd).
                          K1 and K2 run on the pipelined engine of
                          ``csrc/gemm_pipe.cuh``, their depth split over
                          the SMs when the tiles do not cover them
                          (``fwd_launch``).
  grouped_matmul_chained  a chain of grouped phases — lhs from packed x,
                          from a previous chain's panels in place, or from
                          an earlier phase's panel through shifted ring
                          taps — returning one padded (Mp, ncb*128) panel
                          per phase.  CUDA:
                          ``csrc/grouped_matmul_chained.cu``.
  grouped_matmul_bwd      (dx_g, dw_g, db_g) of a grouped launch, dy
                          masked by the forward's ReLU output, in ONE
                          launch.  CUDA: ``csrc/grouped_matmul_bwd.cu``.
  grouped_matmul_dw       (dw_g, db_g) alone in ONE launch (K7), the
                          reference's library call; no plan launches it
                          (K5 does its work on the training path).  CUDA:
                          ``csrc/grouped_matmul_bwd.cu`` (rt_gmm_dw): K5's
                          dw entries alone, split over M by the same rule
                          (``dw_launch``).

On CPU tensors each wrapper returns its plain version (``*_ref``, the
same signature, written as whole-tensor torch ops); on CUDA tensors it
launches its kernel or raises.  ``m_valid`` (a python int) makes a
launch ragged-M: rows at/past it are padding and store zeros.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build
from repro_torch.kernels import runtime as _rt
from repro_torch.kernels.matmul import split_plan

#: Taps a pooled branch maxes in the kernel; longer chains (e.g. the
#: 81-view (3,2)+(3,1) pool-proj chain) fold first, in plain torch, as the
#: reference folds them outside its kernel.
POOL_TAP_LIMIT = 16

_BLK = 128       # column block of padded layouts and chained k-steps


# ---------------------------------------------------------------------------
# pool helpers (pure torch)
# ---------------------------------------------------------------------------

def _tap_views_one(x, window: int, stride: int):
    """One SAME-padded maxpool stage as ``window**2`` shifted views of NHWC
    ``x``: view (dh, dw) holds, at output (oh, ow), the element the window
    reads at tap (dh, dw); out-of-image taps are -inf (the max identity,
    exactly the reference's SAME padding).  A pad + strided-slice layout
    pass, no pooling op."""
    b, h, w, c = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph = max((oh - 1) * stride + window - h, 0)
    pw = max((ow - 1) * stride + window - w, 0)
    plh, plw = ph // 2, pw // 2
    xp = F.pad(x, (0, 0, plw, pw - plw, plh, ph - plh), value=float("-inf"))
    return [xp[:, dh: dh + (oh - 1) * stride + 1: stride,
               dw: dw + (ow - 1) * stride + 1: stride, :]
            for dh in range(window) for dw in range(window)]


def pool_tap_views(x, chain):
    """A maxpool chain ``((window, stride), ...)`` on NHWC ``x`` as a flat
    list of shifted views whose elementwise max IS the pooled output, in
    the reference's order (the outer pool's taps are the major axis)."""
    views = [x]
    for window, stride in chain:
        exp = [_tap_views_one(v, window, stride) for v in views]
        ntap = window * window
        views = [exp[i][e] for e in range(ntap) for i in range(len(exp))]
    return views


def pool_from_taps(taps):
    """Left fold ``where(isnan(v) | (v > acc), v, acc)`` over tap views,
    the first tap seeding: the maxpool value, NaN propagating (a NaN tap
    poisons its windows, as the reference's max does)."""
    acc = taps[0]
    for v in taps[1:]:
        acc = torch.where(torch.isnan(v) | (v > acc), v, acc)
    return acc


def pool_cotangent_taps(taps, pooled, d_pooled):
    """Scatter the pooled-lhs cotangent back onto the tap views through
    the first-argmax window mask: tap t receives ``d_pooled`` where it
    equals the pooled max AND no earlier tap does (the reference's tap
    order makes ties of ReLU zeros route as its autodiff routes them; a
    NaN window matches no tap and routes nowhere)."""
    assigned = torch.zeros(pooled.shape, dtype=torch.bool,
                           device=pooled.device)
    outs = []
    for v in taps:
        take = (v == pooled) & ~assigned
        assigned = assigned | take
        outs.append(torch.where(take, d_pooled, torch.zeros_like(d_pooled)))
    return outs


# ---------------------------------------------------------------------------
# shared checks and plain math
# ---------------------------------------------------------------------------

def _lhs_shape(name, x):
    """(rows, K) of a branch's lhs: an (M, K) tensor, or a sequence of tap
    tensors of one shape (..., K) — (M, K) copies or (B, OH, OW, K) views
    — whose rows are the product of the leading dimensions."""
    if not isinstance(x, (list, tuple)):
        if x.dim() != 2:
            raise ValueError(f"{name}: lhs {tuple(x.shape)} is not (M, K)")
        return tuple(x.shape)
    if not x or any(t.shape != x[0].shape for t in x):
        raise ValueError(f"{name}: a pooled branch needs >= 1 tap views of "
                         f"one shape")
    if not 2 <= x[0].dim() <= 4:
        raise ValueError(f"{name}: tap {tuple(x[0].shape)} is neither (M, K) "
                         f"nor (B, OH, OW, K)")
    return math.prod(x[0].shape[:-1]), x[0].shape[-1]


def _check_branches(name, xs, ws, bs):
    g = len(xs)
    if g < 1 or g != len(ws) or (bs is not None and len(bs) != g):
        raise ValueError(f"{name}: {g} lhs, {len(ws)} weights, "
                         f"{None if bs is None else len(bs)} biases")
    if g > 8:
        raise ValueError(f"{name}: at most 8 branches per launch, got {g}")
    shapes = [_lhs_shape(name, x) for x in xs]
    m = shapes[0][0]
    for (rows, k), w in zip(shapes, ws):
        if w.dim() != 2 or rows != m or k != w.shape[0]:
            raise ValueError(f"{name}: lhs ({rows}, {k}) and weight "
                             f"{tuple(w.shape)} do not make a branch of a "
                             f"{m}-row launch")
    if bs is not None:
        for b, w in zip(bs, ws):
            if b.shape != (w.shape[1],):
                raise ValueError(f"{name}: bias {tuple(b.shape)} for "
                                 f"weight {tuple(w.shape)}")
    return m


def _gemm_ref(xs, ws, bs, relu, m_valid):
    """Per-branch relu(x @ w + b), rows at/past ``m_valid`` zeroed."""
    outs = []
    for i, (x, w) in enumerate(zip(xs, ws)):
        y = x @ w
        if bs is not None:
            y = y + bs[i]
        if relu:
            y = torch.relu(y)
        if m_valid is not None:
            y[int(m_valid):] = 0
        outs.append(y)
    return outs


def _padded_bases(ns):
    bases, base = [], 0
    for n in ns:
        bases.append(base)
        base += -(-n // _BLK) * _BLK
    return bases, base


_FWD_TILE = 128   # K1/K2's output tile (rows and columns)


def fwd_launch(m_lim, ks, ns, sms) -> dict:
    """K1/K2's launch for one call: the output tiles of the M-blocks below
    ``m_lim`` over each branch's ``ns`` stored columns; when they do not
    cover the card's ``sms`` SMs, the depth of a split (``split_plan`` on
    the deepest branch) and each branch's splits (1 for a branch no deeper
    than one split); CTAs, and the workspace bytes (0 without a split).
    The one place K1/K2's split is decided: ``_fwd_tiles`` lays out its
    table."""
    return _fwd_launch(int(m_lim), tuple(ks), tuple(ns), sms)


@functools.lru_cache(maxsize=4096)
def _fwd_launch(m_lim, ks, ns, sms) -> dict:
    t = _FWD_TILE
    mb = -(-m_lim // t)
    nb = [-(-n // t) for n in ns]
    tiles = mb * sum(nb)
    splits, kper = split_plan(tiles, max(ks, default=0), sms,
                              tile_elems=t * t)
    per = tuple(max(1, -(-k // kper)) if splits > 1 else 1 for k in ks)
    ctas = mb * sum(b * s for b, s in zip(nb, per))
    return {"tiles": tiles, "splits": per, "kper": kper, "ctas": ctas,
            "ws_bytes": ctas * t * t * 4 if splits > 1 else 0}


def _fwd_tiles(m_lim, ks, ns, sms):
    """K1/K2's per-CTA table, 7 ints an entry (branch, m-block i, n-block
    j, split s, S, k_lo, k_hi): branch by branch and m-block by m-block,
    so the n-blocks of an m-block (which read the same lhs rows) are
    neighbours; a tile's S entries consecutive, split s over depths
    [k_lo, k_hi) of its branch, in order."""
    t = _FWD_TILE
    plan = fwd_launch(m_lim, ks, ns, sms)
    kper = plan["kper"]
    rows = []
    for g, (k, n, splits) in enumerate(zip(ks, ns, plan["splits"])):
        for i in range(-(-m_lim // t)):
            for j in range(-(-n // t)):
                for s in range(splits):
                    rows += [g, i, j, s, splits, s * kper,
                             k if s == splits - 1 else (s + 1) * kper]
    return rows


def _tap_geometry(name, taps):
    """(rows per image, OW, sb, sh, sw): the one row map that every tap of
    a pooled branch shares — row m = (b, oh, ow) at b * sb + oh * sh +
    ow * sw from the tap's own base, channels contiguous; an (M, K) tap is
    one image of OH = 1, OW = M."""
    t0 = taps[0]
    if any(t.stride() != t0.stride() for t in taps):
        raise ValueError(f"{name}: the taps of a pooled branch must share "
                         f"their strides, got "
                         f"{sorted({t.stride() for t in taps})}")
    lead = 4 - t0.dim()
    b, oh, ow, k = (1,) * lead + tuple(t0.shape)
    sb, sh, sw, sc = (0,) * lead + tuple(t0.stride())
    if k > 1 and sc != 1:
        raise ValueError(f"{name}: tap {tuple(t0.shape)} with strides "
                         f"{t0.stride()} needs contiguous channels")
    return max(oh * ow, 1), max(ow, 1), sb, sh, sw


def _launch_fwd(name, dev, lhs, ws, bs, outs, ldo, ocol, nstore, m, m_lim,
                relu):
    """ONE launch of ``csrc/grouped_matmul.cu`` (K1 or K2): branch g's lhs
    ``lhs[g]`` (a contiguous (M, K_g) tensor, or a tuple of taps read in
    place), output columns [0, nstore[g]) stored at ``ocol[g]`` of
    ``outs[g]`` (row stride ``ldo[g]``)."""
    ks = tuple(w.shape[0] for w in ws)
    ns = [w.shape[1] for w in ws]
    nst = tuple(int(v) for v in nstore)
    sms = _rt.sm_count(dev)
    plan = _fwd_launch(m_lim, ks, nst, sms)
    tiles = _rt.device_tables.get(("gmm_fwd_tiles", m_lim, ks, nst, sms),
                                  lambda: _fwd_tiles(m_lim, ks, nst, sms),
                                  dev)
    stream = _rt.stream_handle(dev)
    wsp = counters = None
    if plan["ws_bytes"]:
        wsp = torch.empty(plan["ws_bytes"] // 4, dtype=torch.float32,
                          device=dev)
        counters = _rt.split_counters(dev, stream, plan["ctas"])
    dense, taps, geo = [], [], []
    for x in lhs:
        pooled = isinstance(x, tuple)
        if pooled and len(x) > POOL_TAP_LIMIT:
            raise ValueError(f"{name}: the kernel maxes at most "
                             f"{POOL_TAP_LIMIT} taps a branch, got {len(x)} "
                             f"(tap_limit above {POOL_TAP_LIMIT})")
        dense.append(None if pooled else x)
        taps.extend(x if pooled else ())
        geo.append(_tap_geometry(name, x) if pooled else (1, 1, 0, 0, 0))
    v4 = all(k % 4 == 0 and all(v % 4 == 0 for v in gm[2:])
             and all(t.data_ptr() % 16 == 0 for t in x)
             for x, k, gm in zip(lhs, ks, geo) if isinstance(x, tuple))
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_gmm_fwd(
        len(lhs),
        _build.ptrs([None if x is None else x.data_ptr() for x in dense]
                    + [w.data_ptr() for w in ws]
                    + [None if bs is None else b.data_ptr()
                       for b in (bs or [None] * len(lhs))]
                    + [o.data_ptr() for o in outs]
                    + [t.data_ptr() for t in taps]),
        _build.ints(list(ks) + ns
                    + [len(x) if isinstance(x, tuple) else 0 for x in lhs]
                    + [0 if x is None else x.shape[1] for x in dense]
                    + [gm[0] for gm in geo] + [gm[1] for gm in geo]
                    + list(ldo) + list(ocol) + list(nst)),
        _build.longs([gm[i] for i in (2, 3, 4) for gm in geo]),
        tiles.data_ptr(), plan["ctas"], m, m_lim, int(relu),
        None if wsp is None else wsp.data_ptr(),
        None if counters is None else counters.data_ptr(),
        int(_aligned16(ws, ns)), int(v4), stream)
    _build.check(rc, name)


# ---------------------------------------------------------------------------
# K1: fused epilogue-concat
# ---------------------------------------------------------------------------

def _concat_layout(name, ws, offsets, total, compact):
    ns = [w.shape[1] for w in ws]
    if len(offsets) != len(ws):
        raise ValueError(f"{name}: {len(offsets)} offsets for "
                         f"{len(ws)} branches")
    segs = sorted(zip((int(o) for o in offsets), ns))
    if segs[0][0] < 0 or any(o1 < o0 + n0 for (o0, n0), (o1, _)
                             in zip(segs, segs[1:])) \
            or segs[-1][0] + segs[-1][1] > total:
        raise ValueError(f"{name}: branch columns {list(zip(offsets, ns))} "
                         f"overlap or overrun total={total}")
    if compact:
        return [int(o) for o in offsets], int(total), ns
    bases, width = _padded_bases(ns)
    return bases, width, [-(-n // _BLK) * _BLK for n in ns]


def grouped_matmul_concat_ref(xs, ws, bs=None, *, offsets, total: int,
                              relu: bool = False, compact: bool = True,
                              m_valid=None):
    """Plain version of ``grouped_matmul_concat``: one matmul per branch,
    scattered into the join layout (uncovered columns zero)."""
    m = _check_branches("grouped_matmul_concat", xs, ws, bs)
    ocols, width, _ = _concat_layout("grouped_matmul_concat", ws, offsets,
                                     total, compact)
    out = xs[0].new_zeros((m, width))
    for y, oc in zip(_gemm_ref(xs, ws, bs, relu, m_valid), ocols):
        out[:, oc:oc + y.shape[1]] = y
    return out


def grouped_matmul_concat(xs, ws, bs=None, *, offsets, total: int,
                          relu: bool = False, compact: bool = True,
                          m_valid=None):
    """[x_g @ w_g (+ b_g) (+ ReLU)] assembled into the fork/join's concat
    layout: ONE (M, total) output, branch g's columns at ``offsets[g]``.
    Columns no branch owns (passthrough slices an earlier launch produced)
    are zero placeholders for the caller to overwrite.  ``compact=False``
    returns the padded (M, sum ceil128(N_g)) buffer instead, branch g's
    true columns at the cumulative padded base.  ``m_valid``: rows at/past
    it store zeros."""
    name = "grouped_matmul_concat"
    tensors = list(xs) + list(ws) + ([] if bs is None else list(bs))
    dev = _rt.kernel_device(name, tensors)
    m = _check_branches(name, xs, ws, bs)
    _rt.require_contiguous(name, tensors)
    ocols, width, nstore = _concat_layout(name, ws, offsets, total,
                                          compact)
    m_lim = _rt.row_limit(name, m, m_valid)
    if dev.type == "cpu":
        return grouped_matmul_concat_ref(xs, ws, bs, offsets=offsets,
                                         total=total, relu=relu,
                                         compact=compact, m_valid=m_valid)
    out = torch.zeros((m, width), dtype=torch.float32, device=dev)
    _launch_fwd(name, dev, list(xs), ws, bs, [out] * len(xs),
                [width] * len(xs), ocols, nstore, m, m_lim, relu)
    return out


# ---------------------------------------------------------------------------
# K2: pooled grouped launch
# ---------------------------------------------------------------------------

def _pooled_lhs(xs, tap_limit):
    """Each branch's lhs as the launch takes it: a tensor (unpooled), or a
    tuple of taps (pooled); a branch of more than ``tap_limit`` taps folds
    here, in plain torch, into an (M, K) lhs."""
    limit = POOL_TAP_LIMIT if tap_limit is None else int(tap_limit)
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.append(_fold_rows(tuple(x)) if len(x) > limit else tuple(x))
        else:
            out.append(x)
    return out


def _fold_rows(x):
    """A branch's lhs as one (M, K) tensor: its taps folded (``x`` a
    tuple), or ``x`` itself."""
    if not isinstance(x, tuple):
        return x
    if not x:
        raise ValueError("grouped_matmul_pooled: a pooled branch needs >= 1 "
                         "tap views of one shape")
    p = pool_from_taps(list(x))
    return p.reshape(-1, p.shape[-1])


def grouped_matmul_pooled_ref(xs, ws, bs=None, *, relu: bool = False,
                              m_valid=None, tap_limit=None):
    """Plain version of ``grouped_matmul_pooled``: fold each branch's
    taps, then one matmul per branch."""
    lhs = _pooled_lhs(xs, tap_limit)
    _check_branches("grouped_matmul_pooled", lhs, ws, bs)
    return _gemm_ref([_fold_rows(x) for x in lhs], ws, bs, relu, m_valid)


def grouped_matmul_pooled(xs, ws, bs=None, *, relu: bool = False,
                          m_valid=None, tap_limit=None):
    """[maxpool(x_g) @ w_g (+ b_g) (+ ReLU)] for ragged (K_g, N_g) in ONE
    launch, the maxpool computed in the kernel as the lhs loads.

    ``xs[g]`` is an (M, K_g) tensor (unpooled branch) or a sequence of tap
    tensors: (B, OH, OW, K_g) views of the pooling stage's padded input
    (``pool_tap_views``), or (M, K_g) tensors, M = B * OH * OW.  The CUDA
    kernel reads a pooled branch's taps where they lie, through the row
    map they share (``_tap_geometry``), and maxes them per lhs element
    with the NaN-propagating first-tap-seeded select; the pooled lhs never
    reaches device memory.  Chains over ``tap_limit`` (default
    ``POOL_TAP_LIMIT``) taps fold first.  Returns G tensors (M, N_g)."""
    name = "grouped_matmul_pooled"
    tensors = [t for x in xs
               for t in (x if isinstance(x, (list, tuple)) else (x,))] \
        + list(ws) + ([] if bs is None else list(bs))
    dev = _rt.kernel_device(name, tensors)
    lhs = _pooled_lhs(xs, tap_limit)
    m = _check_branches(name, lhs, ws, bs)
    _rt.require_contiguous(name, [x for x in lhs if not isinstance(x, tuple)]
                           + list(ws) + ([] if bs is None else list(bs)))
    m_lim = _rt.row_limit(name, m, m_valid)
    if dev.type == "cpu":
        return grouped_matmul_pooled_ref(lhs, ws, bs, relu=relu,
                                         m_valid=m_valid,
                                         tap_limit=tap_limit)
    ns = [w.shape[1] for w in ws]
    alloc = torch.zeros if m_lim < m else torch.empty
    outs = [alloc((m, n), dtype=torch.float32, device=dev) for n in ns]
    _launch_fwd(name, dev, lhs, ws, bs, outs, ns, [0] * len(ns), ns, m,
                m_lim, relu)
    return outs


# ---------------------------------------------------------------------------
# K6: chained grouped launch
# ---------------------------------------------------------------------------

def chained_layout(phases, blk: int = _BLK):
    """Per-branch (phase, col base, n-blocks, true n) of the panel layout
    a chained launch emits — what the NEXT launch's panel descriptors (and
    the caller's output slicing) address."""
    out = []
    for p, phase in enumerate(phases):
        cb = 0
        for br in phase:
            nbb = -(-br["n"] // blk)
            out.append((p, cb, nbb, br["n"]))
            cb += nbb
    return out


def _chain_spec(phases, npanels):
    """Validated static description of a chain, hashable: per phase, per
    branch (n, nbb, k-steps).  A k-step is ('x', array, col block, K,
    live), ('panel', panel, col block, live) or ('ring', producer phase,
    col block, dh, dw, live); ring columns resolve through the producers'
    ``ring_write`` to (producer phase, producer col block).  ``live`` is
    the number of the step's 128 columns that can be nonzero, from the
    layout alone: an x step's columns below K, a ring step's below the
    producer branch's true n in that block, a panel step's as the
    branch's optional ``panel_live`` gives them (one per panel step; 128
    each without it).  The columns past it are zeros that K6 or the
    caller stored, met by zero weight rows."""
    ringmap: dict[int, tuple[int, int, int]] = {}
    for p, phase in enumerate(phases):
        cb = 0
        for br in phase:
            n = int(br["n"])
            nbb = -(-n // _BLK)
            rw = tuple(br.get("ring_write") or ())
            if rw and len(rw) != nbb:
                raise ValueError(f"ring_write {rw} for {nbb} output blocks")
            for j, rc in enumerate(rw):
                ringmap[int(rc)] = (p, cb + j, min(_BLK, n - j * _BLK))
            cb += nbb
    spec = []
    for p, phase in enumerate(phases):
        pspec = []
        for br in phase:
            n = int(br["n"])
            tag = br["src"][0]
            if tag == "x":
                steps = []
                for ai, a in enumerate(br["src"][1]):
                    k = a.shape[1]
                    steps += [("x", ai, kb, k, min(_BLK, k - kb * _BLK))
                              for kb in range(-(-k // _BLK))]
            elif tag == "panel":
                blocks = list(br["src"][1])
                live = br.get("panel_live")
                live = (_BLK,) * len(blocks) if live is None \
                    else tuple(int(v) for v in live)
                if len(live) != len(blocks) \
                        or not all(0 < v <= _BLK for v in live):
                    raise ValueError(f"panel_live {live} for "
                                     f"{len(blocks)} panel blocks")
                steps = []
                for (pidx, cb), lv in zip(blocks, live):
                    if not 0 <= int(pidx) < npanels:
                        raise ValueError(f"panel source {pidx} of "
                                         f"{npanels} panels")
                    steps.append(("panel", int(pidx), int(cb), lv))
            elif tag == "ring":
                _, kh, kw, rcs = br["src"]
                steps = []
                for dh in range(kh):
                    for dw in range(kw):
                        for rc in rcs:
                            pp, pcb, lv = ringmap[int(rc)]
                            if pp >= p:
                                raise ValueError(
                                    f"phase {p} ring-reads phase {pp}")
                            steps.append(("ring", pp, pcb, dh - kh // 2,
                                          dw - kw // 2, lv))
            else:
                raise ValueError(f"unknown lhs source {tag!r}")
            if tuple(br["w"].shape) != (len(steps) * _BLK, n):
                raise ValueError(f"weight {tuple(br['w'].shape)} for "
                                 f"{len(steps)} k-steps of {_BLK} rows and "
                                 f"n={n} (rows must be k-step-major)")
            if br.get("b") is not None and br["b"].shape != (n,):
                raise ValueError(f"bias {tuple(br['b'].shape)} for n={n}")
            pspec.append((n, -(-n // _BLK), tuple(steps)))
        spec.append(tuple(pspec))
    return tuple(spec)


def _shift_spatial(seg2d, m, h, w, dh, dw):
    """Zero-padded spatial shift of an (rows >= m, C) activation
    (m = B*h*w): row r of the result is row r + dh*w + dw where
    (h + dh, w + dw) stays in the image, else 0 — one ring tap."""
    b = m // (h * w)
    img = seg2d[:m].reshape(b, h, w, -1)
    pb_h, pa_h = max(-dh, 0), max(dh, 0)
    pb_w, pa_w = max(-dw, 0), max(dw, 0)
    pimg = F.pad(img, (0, 0, pb_w, pa_w, pb_h, pa_h))
    return pimg[:, pa_h:pa_h + h, pa_w:pa_w + w].reshape(m, -1)


def _chain_key(phases, m, h, w, panels, m_valid):
    """Everything ``_chain_check`` reads of a call: its shapes and
    layout, no values."""
    def src(s):
        if s[0] == "x":
            return ("x",) + tuple(tuple(a.shape) for a in s[1])
        if s[0] == "panel":
            return ("panel",) + tuple(tuple(b) for b in s[1])
        return tuple(s[:3]) + (tuple(s[3]),) if s[0] == "ring" \
            else tuple(s)
    return (m, h, w, m_valid, tuple(tuple(pa.shape) for pa in panels),
            tuple(tuple((br["n"], src(br["src"]),
                         tuple(br.get("ring_write") or ()),
                         br.get("panel_live") and tuple(br["panel_live"]),
                         tuple(br["w"].shape),
                         br.get("b") is not None and tuple(br["b"].shape))
                        for br in ph) for ph in phases))


_CHAIN_SPECS: dict = {}


def _chain_check(phases, m, h, w, panels, block, m_valid):
    """(spec, m_lim) of a call, checked and built once per chain shape
    (``_chain_key``)."""
    key = (block,) + _chain_key(phases, m, h, w, panels, m_valid)
    hit = _CHAIN_SPECS.get(key)
    if hit is None:
        if len(_CHAIN_SPECS) >= 4096:
            _CHAIN_SPECS.clear()
        hit = _CHAIN_SPECS[key] = _chain_check_shapes(
            phases, m, h, w, panels, block, m_valid)
    return hit


def _chain_check_shapes(phases, m, h, w, panels, block, m_valid):
    name = "grouped_matmul_chained"
    if block != _BLK:
        raise ValueError(f"{name}: block must be {_BLK}, got {block}")
    if m % (h * w) != 0:
        raise ValueError(f"{name}: m={m} is not a whole number of "
                         f"{h}x{w} images")
    m_lim = _rt.row_limit(name, m, m_valid)
    if m_lim % (h * w) != 0:
        raise ValueError(f"{name}: m_valid={m_lim} is not image-aligned "
                         f"(h*w={h * w}): ring taps would cross the cutoff")
    for pa in panels:
        if pa.dim() != 2 or pa.shape[0] < m or pa.shape[1] % _BLK:
            raise ValueError(f"{name}: panel {tuple(pa.shape)} needs >= {m} "
                             f"rows and a multiple of {_BLK} columns")
    for phase in phases:
        for br in phase:
            if br["src"][0] == "x":
                for a in br["src"][1]:
                    if a.dim() != 2 or a.shape[0] != m or a.shape[1] < 1:
                        raise ValueError(f"{name}: x lhs {tuple(a.shape)} "
                                         f"for m={m}")
    return _chain_spec(phases, len(panels)), m_lim


def grouped_matmul_chained_ref(phases, *, m: int, h: int, w: int,
                               panels=(), block: int = _BLK, m_valid=None):
    """Plain version of ``grouped_matmul_chained``: per branch the whole
    lhs is assembled (padded x blocks, panel slices, shifted ring taps)
    and multiplied once.  Padding rows are zero here (the kernel leaves
    rows of M-blocks it does not run unwritten)."""
    spec, m_lim = _chain_check(phases, m, h, w, panels, block, m_valid)
    mp = -(-m // _BLK) * _BLK
    outs = []
    for phase, pspec in zip(phases, spec):
        segs = []
        for br, (n, nbb, steps) in zip(phase, pspec):
            parts = []
            for st in steps:
                if st[0] == "x":
                    a = br["src"][1][st[1]]
                    blk = a[:, st[2] * _BLK:(st[2] + 1) * _BLK]
                    parts.append(F.pad(blk, (0, _BLK - blk.shape[1])))
                elif st[0] == "panel":
                    parts.append(panels[st[1]][:m, st[2] * _BLK:
                                               (st[2] + 1) * _BLK])
                else:
                    seg = outs[st[1]][:m, st[2] * _BLK:(st[2] + 1) * _BLK]
                    parts.append(_shift_spatial(seg, m, h, w, st[3], st[4]))
            y = torch.cat(parts, dim=1) @ br["w"]
            if br.get("b") is not None:
                y = y + br["b"]
            y = torch.relu(y)
            y[m_lim:] = 0
            segs.append(F.pad(y, (0, nbb * _BLK - n, 0, mp - m)))
        outs.append(torch.cat(segs, dim=1))
    return outs


#: K6's output tile (rows and columns; ``csrc/grouped_matmul_chained.cu``)
CHAIN_TILE = 128
#: the engine's k-step (gp::BK): a k-step's live columns round up to it
CHAIN_BK = 16
#: a tile whose branch has at most this many columns left multiplies only
#: its left half; the right half is padding and stores zeros
CHAIN_HALF = 64
#: rows of one warp's micro-tiles: warps wholly past the row limit skip
#: the multiply
CHAIN_WARP_ROWS = 16
#: CTAs an SM holds (the kernel's launch bounds): the CTAs of one wave
CHAIN_CTAS_PER_SM = 2
#: no split of a phase's depth is shallower than this (``split_plan``'s
#: ``min_depth``).  The three settings below were chosen on an H100 from
#: ``scripts/bench_chained.py --variant``: a chain is a few dependent
#: phases, so its device time is its critical path, which shallow splits
#: and consumers listed well after their producers shorten (PERF.md)
CHAIN_SPLIT_MIN_DEPTH = 128
#: CTAs per SM that the split rule fills: a phase splits while its tiles
#: number fewer than this many CTAs on every SM
CHAIN_SPLIT_CTAS = CHAIN_CTAS_PER_SM
#: in ticket order a ring consumer's m-block trails the last producer
#: block it reads by this many more producer blocks (0: as soon as its
#: producers are listed), so that a consumer's CTA seldom holds an SM
#: while it waits
CHAIN_LAG = 64
# k-step kinds (StepKind in the kernel)
_CH_X, _CH_PANEL, _CH_RING = 0, 1, 2


def chained_launch(spec, npanels, m_lim, h, w, sms) -> dict:
    """K6's one launch for a chain (``_chain_spec``), ``m_lim`` live rows
    of ``h`` x ``w`` images, on a card of ``sms`` SMs: the int32 table the
    kernel reads and what the wrapper allocates.  The one place the
    launch is decided; pure Python, cached per chain shape.

    Work items are (phase p, m-block i, branch g, output tile n0, split s
    of S), for the m-blocks below ``m_lim`` only; a tile whose branch has
    at most ``CHAIN_HALF`` columns left multiplies only those (``cols``).
    A branch's depth is its k-steps' live columns, each rounded up to
    ``CHAIN_BK`` ("chunks"); a split item runs chunks [klo, khi).  The
    depth of a phase whose tiles do not fill ``CHAIN_SPLIT_CTAS`` CTAs on
    every SM is split (``split_plan`` on the phase's deepest branch, as K1
    splits, with no split shallower than ``CHAIN_SPLIT_MIN_DEPTH``).

    Tickets follow a wavefront: at each wave every phase, in order, emits
    its next m-block once every producer block it reads is emitted, so
    phase p+1's block i follows soon after the producer blocks it needs
    (the TPU's lag-1 wave where the halo is under one block), or
    ``CHAIN_LAG`` producer blocks later.  A ring item depends on the
    producer phase's m-blocks that its rows, widened by the taps' row
    offsets, overlap below ``m_lim``.

    Table rows (ints): items (p, i, g, n0, cols, s, S, klo, khi, split
    counter, first workspace slot, first dependency, dependencies);
    dependencies (producer phase, first block, last block); branches
    (p, n, first output column, first k-step, k-steps, chunks); k-steps
    (kind, array, col block, dh, dw, live, first chunk, weight slab); per
    phase the done count of one m-block (its tiles).  Counters: [ticket,
    finish, done per (phase, m-block), one per split tile]."""
    return _chained_launch(spec, int(npanels), int(m_lim), int(h), int(w),
                           int(sms), CHAIN_SPLIT_MIN_DEPTH, CHAIN_SPLIT_CTAS,
                           CHAIN_LAG)


def _chain_rows(spec, npanels, w):
    """Branch and k-step rows of a chain's table, and per branch (phase,
    n, nbb, chunks, {producer phase: ring row offsets})."""
    branches, steps, info = [], [], []
    nx = 0
    for p, pspec in enumerate(spec):
        ocol = 0
        for n, nbb, ks in pspec:
            step0, chunk, xs = len(steps), 0, 0
            reads: dict[int, list] = {}
            for s, st in enumerate(ks):
                live = st[-1]
                if st[0] == "x":
                    row = (_CH_X, nx + st[1], st[2], 0, 0)
                    xs = max(xs, st[1] + 1)
                elif st[0] == "panel":
                    row = (_CH_PANEL, st[1], st[2], 0, 0)
                else:
                    row = (_CH_RING, npanels + st[1], st[2], st[3], st[4])
                    reads.setdefault(st[1], []).append(st[3] * w + st[4])
                steps.append(row + (live, chunk, s))
                chunk += -(-live // CHAIN_BK)
            nx += xs
            branches.append((p, n, ocol, step0, len(ks), chunk))
            info.append((p, n, nbb, chunk, reads))
            ocol += nbb * _BLK
    return branches, steps, info


@functools.lru_cache(maxsize=1024)
def _chained_launch(spec, npanels, m_lim, h, w, sms, min_depth, split_ctas,
                    lag):
    t, nph = CHAIN_TILE, len(spec)
    nblk = -(-m_lim // t)
    branches, steps, info = _chain_rows(spec, npanels, w)
    of_phase = [[g for g, inf in enumerate(info) if inf[0] == p]
                for p in range(nph)]
    split = []
    for gs in of_phase:
        tiles = nblk * sum(info[g][2] for g in gs)
        depth = max(info[g][3] for g in gs) * CHAIN_BK
        splits, kper = split_plan(tiles, depth, sms * split_ctas,
                                  min_depth=min_depth)
        split.append((splits, kper // CHAIN_BK))

    def deps(g, i):
        m0, hi_row = i * t, min((i + 1) * t, m_lim) - 1
        out = []
        for pp, offs in sorted(info[g][4].items()):
            lo = max(m0 + min(offs), 0)
            hi = min(hi_row + max(offs), m_lim - 1)
            if lo <= hi:
                out.append((pp, lo // t, hi // t))
        return out

    order, emitted, nxt = [], set(), [0] * nph
    while len(order) < nph * nblk:
        moved = False
        for p in range(nph):
            i = nxt[p]
            if i < nblk and all((pp, j) in emitted for g in of_phase[p]
                                for pp, lo, hi in deps(g, i)
                                for j in range(lo, min(hi + lag,
                                                       nblk - 1) + 1)):
                order.append((p, i))
                emitted.add((p, i))
                nxt[p] += 1
                moved = True
        if not moved:
            raise ValueError("chained launch: ring dependencies that no "
                             "order satisfies")
    items, dep_rows = [], []
    ntile = nslot = 0
    for p, i in order:
        splits, kper = split[p]
        for g in of_phase[p]:
            _, n, nbb, nch, _ = info[g]
            dl = deps(g, i)
            d0 = len(dep_rows)
            dep_rows += dl
            s_g = max(1, -(-nch // kper)) if splits > 1 else 1
            for j in range(nbb):
                n0 = j * t
                cols = CHAIN_HALF if n - n0 <= CHAIN_HALF else t
                for s in range(s_g):
                    klo = s * kper if s_g > 1 else 0
                    khi = nch if s == s_g - 1 else (s + 1) * kper
                    items.append((p, i, g, n0, cols, s, s_g, klo, khi,
                                  ntile if s_g > 1 else -1,
                                  nslot if s_g > 1 else -1, d0, len(dl)))
                if s_g > 1:
                    ntile += 1
                    nslot += s_g
    targets = [sum(info[g][2] for g in gs) for gs in of_phase]
    sections = [items, dep_rows, branches, steps]
    offs, table, at = [], [], 0
    for rows in sections:
        offs.append(at)
        for r in rows:
            table.extend(r)
            at += len(r)
    offs.append(at)
    table.extend(targets)
    return {"table": table, "offsets": tuple(offs), "items": tuple(items),
            "deps": tuple(dep_rows), "branches": tuple(branches),
            "steps": tuple(steps), "targets": tuple(targets),
            "n_items": len(items), "nblk": nblk, "phases": nph,
            "tiles": sum(nblk * tg for tg in targets),
            "splits": tuple(sp for sp, _ in split),
            "waves": -(-len(items) // (CHAIN_CTAS_PER_SM * sms)),
            "counters": 2 + nph * nblk + ntile,
            "ws_floats": nslot * t * t, "m_lim": m_lim,
            "key": (spec, npanels, m_lim, h, w, sms, min_depth, split_ctas,
                    lag),
            "tile_rows": t, "warp_rows": CHAIN_WARP_ROWS}


def chained_issued_macs(launch) -> int:
    """Multiply-adds a K6 launch issues: per work item its rows (up to the
    last warp holding a row below ``m_lim``: ``tile_rows`` rows in
    warps of ``warp_rows``) x its columns (``cols``) x its chunks of
    ``CHAIN_BK``.  Any table of items (p, i, g, n0, cols, s, S, klo,
    khi, ...) counts the same way."""
    t, wr, m_lim = launch["tile_rows"], launch["warp_rows"], launch["m_lim"]
    total = 0
    for it in launch["items"]:
        rows = min(t, -(-(m_lim - it[1] * t) // wr) * wr)
        total += rows * it[4] * (it[8] - it[7]) * CHAIN_BK
    return total


def chained_live_macs(launch) -> int:
    """Multiply-adds a chain needs, from its launch's table: per branch
    ``m_lim`` rows x its true n x its k-steps' live columns."""
    steps = launch["steps"]
    return launch["m_lim"] * sum(
        n * sum(st[5] for st in steps[step0:step0 + nsteps])
        for _, n, _, step0, nsteps, _ in launch["branches"])


def chained_plan(phases, *, m: int, h: int, w: int, panels=(),
                 m_valid=None, sms: int) -> dict:
    """``chained_launch`` of a call's arguments (the wrapper's own
    decision, for callers that print or replay it)."""
    spec, m_lim = _chain_check(phases, m, h, w, panels, _BLK, m_valid)
    return chained_launch(spec, len(panels), m_lim, h, w, sms)


def grouped_matmul_chained(phases, *, m: int, h: int, w: int, panels=(),
                           block: int = _BLK, m_valid=None):
    """A chain of grouped branch phases; returns one padded
    (Mp, ncb_p * 128) panel per phase (Mp = ceil(m/128)*128), true values
    at [:m, col_base*128 : col_base*128 + n] per ``chained_layout`` and
    padding columns exactly 0.

    ``phases``: per phase a list of branch dicts
      n     true output width
      w     (S*128, n) weight, rows k-step-major (one 128-row slab per
            k-step, zero rows where the lhs slab is padding)
      b     (n,) bias or None
      src   ('x', [(m, K_i) tensors])                dense lhs
            ('panel', [(panel_idx, col_block), ...])  previous chain's panels
            ('ring', kh, kw, (ring_cols...))          in-chain KxK conv
      ring_write  per-n-block ring column this branch's output feeds
      panel_live  optional, per panel block its true columns (the rest
            of the block is zero padding the kernel need not multiply)

    Bias and ReLU are always applied.  The CUDA path runs every phase in
    ONE launch on the current stream (``chained_launch``); with
    ``m_valid`` given only the M-blocks below it run (image-aligned), rows
    at/past it inside a live block store zeros, and rows of blocks not
    run stay unwritten."""
    name = "grouped_matmul_chained"
    xs = [a for phase in phases for br in phase
          if br["src"][0] == "x" for a in br["src"][1]]
    brs = [br for phase in phases for br in phase]
    bias = [br["b"] for br in brs if br.get("b") is not None]
    tensors = xs + [br["w"] for br in brs] + bias + list(panels)
    dev = _rt.kernel_device(name, tensors)
    _rt.require_contiguous(name, tensors)
    if dev.type == "cpu":
        return grouped_matmul_chained_ref(phases, m=m, h=h, w=w,
                                          panels=panels, block=block,
                                          m_valid=m_valid)
    spec, m_lim = _chain_check(phases, m, h, w, panels, block, m_valid)
    mp = -(-m // _BLK) * _BLK
    outs = [torch.empty((mp, sum(nbb for _, nbb, _ in pspec) * _BLK),
                        dtype=torch.float32, device=dev) for pspec in spec]
    sms = _rt.sm_count(dev)
    la = chained_launch(spec, len(panels), m_lim, h, w, sms)
    if la["n_items"] == 0:
        return outs
    if len(xs) > 16 or len(panels) + len(outs) > 16 or len(brs) > 32:
        raise ValueError(f"{name}: {len(xs)} x arrays, "
                         f"{len(panels) + len(outs)} panels, {len(brs)} "
                         f"branches: the kernel takes at most 16, 16, 32")
    tab = _rt.device_tables.get(("chain",) + la["key"],
                                lambda: la["table"], dev)
    stream = _rt.stream_handle(dev)
    counters = _rt.split_counters(dev, stream, la["counters"])
    wsp = torch.empty(la["ws_floats"], dtype=torch.float32, device=dev) \
        if la["ws_floats"] else None
    srcs = list(panels) + outs
    w16 = _aligned16([br["w"] for br in brs], [br["n"] for br in brs])
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_gmm_chained(
        _build.ptrs([a.data_ptr() for a in xs]
                    + [s.data_ptr() for s in srcs]
                    + [br["w"].data_ptr() for br in brs]
                    + [None if br.get("b") is None else br["b"].data_ptr()
                       for br in brs]),
        _build.ints([a.shape[1] for a in xs]
                    + [int(a.shape[1] % 4 == 0 and a.data_ptr() % 16 == 0)
                       for a in xs]
                    + [s.shape[1] for s in srcs]),
        len(xs), len(srcs), len(brs), tab.data_ptr(),
        _build.ints(la["offsets"]), la["n_items"], la["nblk"],
        la["phases"], len(panels), m_lim, h, w, counters.data_ptr(),
        None if wsp is None else wsp.data_ptr(), int(w16), stream)
    _build.check(rc, name)
    _rt.CHAINED_CALLS += 1
    return outs



# ---------------------------------------------------------------------------
# K5: combined backward launch
# ---------------------------------------------------------------------------

def _check_bwd(name, xs, ws, dys, mask):
    g = len(xs)
    if g < 1 or g != len(ws) or g != len(dys) \
            or (mask is not None and len(mask) != g):
        raise ValueError(f"{name}: {g} lhs, {len(ws)} weights, {len(dys)} "
                         f"cotangents, "
                         f"{None if mask is None else len(mask)} masks")
    if g > 8:
        raise ValueError(f"{name}: at most 8 branches per launch, got {g}")
    m = xs[0].shape[0]
    for i, (x, w, dy) in enumerate(zip(xs, ws, dys)):
        if x.dim() != 2 or w.dim() != 2 or dy.dim() != 2 \
                or x.shape != (m, w.shape[0]) or dy.shape != (m, w.shape[1]) \
                or (mask is not None and mask[i].shape != dy.shape):
            raise ValueError(f"{name}: branch {i}: lhs {tuple(x.shape)}, "
                             f"weight {tuple(w.shape)}, cotangent "
                             f"{tuple(dy.shape)} do not make a {m}-row "
                             f"branch")
    return m


def grouped_matmul_bwd_ref(xs, ws, dys, mask=None):
    """Plain version of ``grouped_matmul_bwd``: per branch, dy zeroed
    where ``mask`` <= 0, then dx = dy @ w^T, dw = x^T @ dy, db = sum_M
    dy."""
    _check_bwd("grouped_matmul_bwd", xs, ws, dys, mask)
    dxs, dws, dbs = [], [], []
    for i, (x, w, dy) in enumerate(zip(xs, ws, dys)):
        if mask is not None:
            dy = torch.where(mask[i] > 0, dy, torch.zeros_like(dy))
        dxs.append(dy @ w.t())
        dws.append(x.t() @ dy)
        dbs.append(dy.sum(0))
    return dxs, dws, dbs


def _row_stride(name, t):
    """Row stride of a 2-D operand read in place row by row (unit column
    stride: a contiguous tensor or a column slice of one)."""
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: operand {tuple(t.shape)} with strides "
                         f"{t.stride()} needs unit column stride")
    return max(t.stride(0), t.shape[1], 1)


_BWD_TILE = 128   # K5's output tile (rows and columns)


def _dw_tiles(m, ks, ns, sms):
    """The dw entries of K5's per-CTA table, all of K7's, 8 ints an entry
    (kind 1, branch, k-block i, n-block j, s, S, m_lo, m_hi): every dw
    tile cut into the S splits of M that ``dw_launch`` chose, split s over
    rows [m_lo, m_hi), its S entries consecutive.  A branch with K_g = 0
    still gets its k-block-0 tiles, which sum db."""
    t = _BWD_TILE
    plan = dw_launch(m, ks, ns, sms)
    splits, kper = plan["splits"], plan["kper"]
    dw = [(g, i, j) for g, (k, n) in enumerate(zip(ks, ns))
          for j in range(-(-n // t)) for i in range(max(1, -(-k // t)))]
    rows = []
    for g, i, j in dw:
        for s in range(splits):
            rows += [1, g, i, j, s, splits, s * kper,
                     m if s == splits - 1 else (s + 1) * kper]
    return rows


def _bwd_tiles(m, ks, ns, sms):
    """K5's per-CTA table, 8 ints an entry (kind, branch, i, j, s, S,
    m_lo, m_hi): first the dw entries (``_dw_tiles``), then every dx tile
    (kind 0, m-block i, k-block j; s = 0, S = 1 over [0, M))."""
    t = _BWD_TILE
    rows = _dw_tiles(m, ks, ns, sms)
    for g, k in enumerate(ks):
        for i in range(-(-m // t)):
            for j in range(-(-k // t)):
                rows += [0, g, i, j, 0, 1, 0, m]
    return rows


def dw_launch(m, ks, ns, sms) -> dict:
    """The dw half of a grouped backward launch (K5's dw entries, all of
    K7): dw tiles, splits of M and their depth, CTAs, and the workspace
    bytes (0 without a split).  The one place the split of M is decided,
    for both kernels: ``_dw_tiles`` lays out their entries."""
    return _dw_launch(m, tuple(ks), tuple(ns), sms)


@functools.lru_cache(maxsize=4096)
def _dw_launch(m, ks, ns, sms) -> dict:
    t = _BWD_TILE
    dw = sum(-(-n // t) * max(1, -(-k // t)) for k, n in zip(ks, ns))
    splits, kper = split_plan(dw, m, sms, tile_elems=t * t)
    return {"dw_tiles": dw, "splits": splits, "kper": kper,
            "ctas": dw * splits,
            "ws_bytes": dw * splits * (t * t + t) * 4 if splits > 1 else 0}


def bwd_launch(m, ks, ns, sms) -> dict:
    """K5's launch for one group: its dw half (``dw_launch``), dx tiles,
    CTAs, and the workspace bytes."""
    return _bwd_launch(m, tuple(ks), tuple(ns), sms)


@functools.lru_cache(maxsize=4096)
def _bwd_launch(m, ks, ns, sms) -> dict:
    t = _BWD_TILE
    plan = dict(_dw_launch(m, ks, ns, sms))
    dx = sum(-(-m // t) * -(-k // t) for k in ks)
    plan.update(dx_tiles=dx, ctas=plan["ctas"] + dx)
    return plan


def _dw_workspace(dev, stream, plan):
    """(workspace, its db part's address, counters) of a split dw half:
    per dw entry a T x T partial tile, then T db partials, and one
    arrival counter per entry; (None, None, None) unsplit."""
    if plan["splits"] == 1:
        return None, None, None
    entries = plan["dw_tiles"] * plan["splits"]
    tile = _BWD_TILE
    wsp = torch.empty(entries * (tile * tile + tile), dtype=torch.float32,
                      device=dev)
    return (wsp, wsp.data_ptr() + entries * tile * tile * 4,
            _rt.split_counters(dev, stream, entries))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _dw_operands(name, xs, dys, mask):
    """(row strides of dy, of the masks, dy and the masks take 16-byte
    copies, x takes 16-byte copies) of a dw half: dy and the masks are
    read in place through their row strides."""
    lddy = [_row_stride(name, dy) for dy in dys]
    ldm = [0] * len(xs) if mask is None \
        else [_row_stride(name, mk) for mk in mask]
    dy16 = _aligned16(dys, lddy) and (mask is None
                                      or _aligned16(mask, ldm))
    return lddy, ldm, dy16, _aligned16(xs, [x.shape[1] for x in xs])


def _aligned16(ts, lds) -> bool:
    """Every tensor's address and row stride a multiple of 16 bytes."""
    return all(t.data_ptr() % 16 == 0 and ld % 4 == 0
               for t, ld in zip(ts, lds))


def grouped_matmul_bwd(xs, ws, dys, mask=None):
    """The whole backward of a grouped branch launch in ONE launch:
    dx_g = (dy_g * [mask_g > 0]) @ w_g^T, dw_g = x_g^T @ (same),
    db_g = sum_M (same).

    xs: G (M, K_g) forward lhs (contiguous); ws: G (K_g, N_g)
    (contiguous); dys: G (M, N_g) cotangents and ``mask``: optional G
    (M, N_g) forward outputs, each read in place with unit column stride
    (column slices of a joint buffer need no copy).  Returns (dxs, dws,
    dbs): G (M, K_g), G (K_g, N_g), G (N_g,), all f32.
    CUDA: ``csrc/grouped_matmul_bwd.cu``, the dw half split over M from
    the card's SM count (``bwd_launch``); CPU tensors take
    ``grouped_matmul_bwd_ref``."""
    name = "grouped_matmul_bwd"
    tensors = list(xs) + list(ws) + list(dys) \
        + ([] if mask is None else list(mask))
    dev = _rt.kernel_device(name, tensors)
    m = _check_bwd(name, xs, ws, dys, mask)
    _rt.require_contiguous(name, list(xs) + list(ws))
    if dev.type == "cpu":
        return grouped_matmul_bwd_ref(xs, ws, dys, mask)
    ks = tuple(w.shape[0] for w in ws)
    ns = tuple(w.shape[1] for w in ws)
    lddy, ldm, dy16, x16 = _dw_operands(name, xs, dys, mask)
    dxs = [torch.empty((m, k), dtype=torch.float32, device=dev) for k in ks]
    dws = [torch.empty((k, n), dtype=torch.float32, device=dev)
           for k, n in zip(ks, ns)]
    dbs = [torch.empty((n,), dtype=torch.float32, device=dev) for n in ns]
    sms = _rt.sm_count(dev)
    plan = _bwd_launch(m, ks, ns, sms)
    tiles = _rt.device_tables.get(("gmm_bwd_tiles", m, ks, ns, sms),
                                  lambda: _bwd_tiles(m, ks, ns, sms), dev)
    stream = _rt.stream_handle(dev)
    wsp, dbws, counters = _dw_workspace(dev, stream, plan)
    lib = _build.lib()
    _rt.count_launch(name)
    masks = [None] * len(xs) if mask is None else mask
    rc = lib.rt_gmm_bwd(
        len(xs),
        _build.ptrs([t.data_ptr() for group in (xs, ws, dys) for t in group]
                    + [_ptr(t) for t in masks]
                    + [t.data_ptr() for group in (dxs, dws, dbs)
                       for t in group]),
        _build.ints(ks + ns + tuple(lddy) + tuple(ldm)),
        tiles.data_ptr(), tiles.numel() // 8, m, _ptr(wsp), dbws,
        _ptr(counters), int(dy16), int(x16), stream)
    _build.check(rc, name)
    return dxs, dws, dbs


# ---------------------------------------------------------------------------
# K7: backward-weight launch
# ---------------------------------------------------------------------------

def _check_dw(name, xs, dys, mask):
    g = len(xs)
    if g < 1 or g != len(dys) or (mask is not None and len(mask) != g):
        raise ValueError(f"{name}: {g} lhs, {len(dys)} cotangents, "
                         f"{None if mask is None else len(mask)} masks")
    if g > 8:
        raise ValueError(f"{name}: at most 8 branches per launch, got {g}")
    m = xs[0].shape[0]
    for i, (x, dy) in enumerate(zip(xs, dys)):
        if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != m \
                or dy.shape[0] != m \
                or (mask is not None and mask[i].shape != dy.shape):
            raise ValueError(f"{name}: branch {i}: lhs {tuple(x.shape)}, "
                             f"cotangent {tuple(dy.shape)}"
                             + ("" if mask is None else
                                f", mask {tuple(mask[i].shape)}")
                             + f" do not make a {m}-row branch")
    return m


def grouped_matmul_dw_ref(xs, dys, mask=None):
    """Plain version of ``grouped_matmul_dw``: per branch, dy zeroed where
    ``mask`` <= 0, then dw = x^T @ dy and db = sum_M dy."""
    _check_dw("grouped_matmul_dw", xs, dys, mask)
    dws, dbs = [], []
    for i, (x, dy) in enumerate(zip(xs, dys)):
        if mask is not None:
            dy = torch.where(mask[i] > 0, dy, torch.zeros_like(dy))
        dws.append(x.t() @ dy)
        dbs.append(dy.sum(0))
    return dws, dbs


def grouped_matmul_dw(xs, dys, mask=None):
    """G transposed GEMMs dw_g = x_g^T @ dym_g with db_g = sum_M dym_g in
    the same pass, ONE launch; dym_g = dy_g where ``mask_g`` > 0, else 0
    (the fused-ReLU cotangent mask, applied before both).

    xs: G (M, K_g) forward lhs (contiguous); dys: G (M, N_g) cotangents
    and ``mask``: optional G (M, N_g), each read in place with unit column
    stride.  Returns (dws, dbs): G (K_g, N_g) and G (N_g,), f32.
    CUDA: ``csrc/grouped_matmul_bwd.cu`` (``rt_gmm_dw``): K5's dw entries
    without its dx entries (``_dw_tiles``), M split from the card's SM
    count by K5's rule (``dw_launch``), the splits summed in split order
    inside the launch, so dw and db equal K5's bit for bit; CPU tensors
    take ``grouped_matmul_dw_ref``."""
    name = "grouped_matmul_dw"
    tensors = list(xs) + list(dys) + ([] if mask is None else list(mask))
    dev = _rt.kernel_device(name, tensors)
    m = _check_dw(name, xs, dys, mask)
    _rt.require_contiguous(name, list(xs))
    if dev.type == "cpu":
        return grouped_matmul_dw_ref(xs, dys, mask)
    ks = tuple(x.shape[1] for x in xs)
    ns = tuple(dy.shape[1] for dy in dys)
    lddy, ldm, dy16, x16 = _dw_operands(name, xs, dys, mask)
    dws = [torch.empty((k, n), dtype=torch.float32, device=dev)
           for k, n in zip(ks, ns)]
    dbs = [torch.empty((n,), dtype=torch.float32, device=dev) for n in ns]
    sms = _rt.sm_count(dev)
    plan = _dw_launch(m, ks, ns, sms)
    tiles = _rt.device_tables.get(("gmm_dw_tiles", m, ks, ns, sms),
                                  lambda: _dw_tiles(m, ks, ns, sms), dev)
    stream = _rt.stream_handle(dev)
    wsp, dbws, counters = _dw_workspace(dev, stream, plan)
    masks = [None] * len(xs) if mask is None else mask
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_gmm_dw(
        len(xs),
        _build.ptrs([t.data_ptr() for group in (xs, dys) for t in group]
                    + [_ptr(t) for t in masks]
                    + [t.data_ptr() for group in (dws, dbs)
                       for t in group]),
        _build.ints(ks + ns + tuple(lddy) + tuple(ldm)),
        tiles.data_ptr(), tiles.numel() // 8, m, _ptr(wsp), dbws,
        _ptr(counters), int(dy16), int(x16), stream)
    _build.check(rc, name)
    return dws, dbs


# ---------------------------------------------------------------------------
# K11 / K12: the MoE expert engine
# ---------------------------------------------------------------------------
#
# Routed tokens are packed into block-aligned per-expert segments of ONE
# (MBS*bm, D) buffer: expert g's rows start at ``expert_row_offsets`` and
# its ``counts[g]`` live rows fill ceil(counts[g]/bm) M-blocks (at least
# one, so a zero-token expert still stores zero output rows and zero dW).
# The static bound MBS = n_slots//bm + E holds for any routing outcome;
# blocks past the last live one (the dead tail) take expert E-1 with 0
# valid rows.  The (2, MBS) block-meta table (expert id, valid rows) is
# built on the device from ``counts``, so a kernel call never reads
# ``counts`` on the host; both kernels take their blocks' experts and
# valid rows, and K12's dW tiles their experts' segments, from it alone.

def _act_code(activation: str) -> int:
    """The kernels' activation switch: 0 silu, 1 gelu (tanh form)."""
    if activation not in ("silu", "gelu"):
        raise ValueError(f"unknown expert activation {activation!r}")
    return 0 if activation == "silu" else 1


def _moe_act(activation: str):
    if _act_code(activation) == 0:
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def _moe_act_grad(x, activation: str):
    """d act / dx of the expert activation (silu, or gelu's tanh form)."""
    if activation == "silu":
        s = torch.sigmoid(x)
        return s * (1 + x * (1 - s))
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x * x * x))
    return 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * c \
        * (1 + 3 * 0.044715 * x * x)


def moe_block_m(n_slots: int, e: int) -> int:
    """Packed M-block rows: the largest power of two <= clamp(n_slots/E,
    8, 128) (the reference's rule)."""
    per = max(n_slots // max(e, 1), 1)
    bm = 8
    while bm * 2 <= min(per, 128):
        bm *= 2
    return bm


def moe_static_blocks(n_slots: int, e: int, bm: int) -> int:
    """Static M-block bound: sum_g ceil(c_g/bm) <= floor(sum_g c_g/bm) + E
    for any routing with sum c_g <= n_slots; the +E also funds the one
    block every expert keeps."""
    return n_slots // bm + e


def _expert_blocks(counts, bm: int):
    c = counts.to(torch.int64)
    return c, torch.clamp((c + bm - 1) // bm, min=1)


def _expert_block_meta(counts, mbs: int, bm: int):
    """(2, MBS) int32 on ``counts``' device: per static M-block [expert
    id, valid rows], the reference's first two meta rows.  Zero-token
    experts keep one block (valid 0); dead tail blocks take expert E-1
    with valid 0.  The expert-id row is sorted, so expert g's blocks are
    the range where it equals g (K12's dW tiles search it)."""
    c, blocks = _expert_blocks(counts, bm)
    e = c.shape[0]
    cum = torch.cumsum(blocks, 0)
    bi = torch.arange(mbs, device=c.device)
    eid = torch.clamp(torch.searchsorted(cum, bi, right=True), 0, e - 1)
    start = (cum - blocks)[eid]
    rows = torch.clamp(c[eid] - (bi - start) * bm, 0, bm)
    return torch.stack([eid, rows]).to(torch.int32)


#: K11's CTA tile (rows and columns): a row tile is min(bm, EXPERT_TILE)
#: rows of one M-block; gated, a stage-A tile multiplies EXPERT_TILE / 2
#: F columns of W_in and the same of W_gate side by side
EXPERT_TILE = 128


def _expert_row_tiles(mbs: int, bm: int) -> tuple:
    """(M-block, first packed row, rows) per row tile: ceil(bm /
    EXPERT_TILE) a block, none crossing it."""
    t = EXPERT_TILE
    return tuple((b, b * bm + s * t, min(t, bm - s * t))
                 for b in range(mbs) for s in range(-(-bm // t)))


@functools.lru_cache(maxsize=256)
def experts_launch(mbs: int, bm: int, d: int, f: int, gated: bool) -> dict:
    """K11's two launches (``csrc/grouped_matmul_experts.cu``) over MBS
    M-blocks of ``bm`` rows.  ``row_tiles``: (M-block, first packed row,
    rows) per row tile, ceil(bm / EXPERT_TILE) a block, none crossing
    it; ``in_tiles`` (stage A: x W over D and the activation, F columns
    ``f_cols`` a CTA) and ``out_tiles`` (stage B: h W_out over F, D
    columns EXPERT_TILE a CTA) list (M-block, row0, rows, col0, cols) in
    launch order, row tile fastest; ``in_grid``, ``out_grid`` and
    ``ctas`` count them."""
    t = EXPERT_TILE
    row_tiles = _expert_row_tiles(mbs, bm)
    fw = t // 2 if gated else t

    def tiles(width, step):
        return tuple((b, r0, nr, c0, min(step, width - c0))
                     for c0 in range(0, width, step)
                     for b, r0, nr in row_tiles)
    in_tiles, out_tiles = tiles(f, fw), tiles(d, t)
    return {"row_tiles": row_tiles, "f_cols": fw, "in_tiles": in_tiles,
            "out_tiles": out_tiles,
            "in_grid": (len(row_tiles), -(-f // fw)),
            "out_grid": (len(row_tiles), -(-d // t)),
            "ctas": len(in_tiles) + len(out_tiles)}


@functools.lru_cache(maxsize=256)
def experts_bwd_launch(mbs: int, bm: int, d: int, f: int, e: int,
                       gated: bool) -> dict:
    """K12's two launches (``csrc/grouped_matmul_experts_bwd.cu``) over
    MBS M-blocks of ``bm`` rows and E experts, in launch order.
    ``row_tiles`` as K11's (``experts_launch``).  ``dh_tiles`` (stage A:
    dH over D and the activation VJP) and ``dx_tiles`` (stage B's last
    CTAs: dX over nw * F) list (M-block, row0, rows, col0, cols), the
    EXPERT_TILE-wide column tile (over F, over D) fastest; ``dw_tiles``
    (stage B's first CTAs) list (expert, which, row0, col0, rows, cols)
    of the (F, D) dW_out ("out") and (D, F) dW_in ("in") and dW_gate
    ("gate") tiles, expert by expert, "out" then "in" then "gate", rows
    of a tile over its first operand's columns and its depth the
    expert's live rows.  ``dh_grid`` and ``dxw_grid`` are the 1-D grids;
    ``ctas`` counts them."""
    t = EXPERT_TILE
    row_tiles = _expert_row_tiles(mbs, bm)

    def cols(width):
        return [(c0, min(t, width - c0)) for c0 in range(0, width, t)]

    dh_tiles = tuple((b, r0, nr, c0, nc) for b, r0, nr in row_tiles
                     for c0, nc in cols(f))
    dx_tiles = tuple((b, r0, nr, c0, nc) for b, r0, nr in row_tiles
                     for c0, nc in cols(d))
    shapes = {"out": (f, d), "in": (d, f), "gate": (d, f)}
    kinds = ("out", "in", "gate") if gated else ("out", "in")
    dw_tiles = tuple((g, w, r0, c0, nr, nc) for g in range(e) for w in kinds
                     for r0, nr in cols(shapes[w][0])
                     for c0, nc in cols(shapes[w][1]))
    return {"row_tiles": row_tiles, "dh_tiles": dh_tiles,
            "dw_tiles": dw_tiles, "dx_tiles": dx_tiles,
            "dh_grid": (len(dh_tiles),),
            "dxw_grid": (len(dw_tiles) + len(dx_tiles),),
            "ctas": len(dh_tiles) + len(dw_tiles) + len(dx_tiles)}


def expert_row_offsets(counts, bm: int):
    """(E,) int32 packed-row offset of each expert's segment (block
    aligned), on ``counts``' device."""
    _, blocks = _expert_blocks(counts, bm)
    return ((torch.cumsum(blocks, 0) - blocks) * bm).to(torch.int32)


def grouped_matmul_experts_flops(n_slots: int, e: int, d: int, f: int, *,
                                 gated: bool, bm: int) -> int:
    """FLOPs of the reference's static experts grid (D and F padded to
    its 128-wide tiles): it scales with the routed budget n_slots plus at
    most one partial block per expert, not E * capacity."""
    mbs = moe_static_blocks(n_slots, e, bm)
    r128 = lambda v: -(-v // 128) * 128
    return 2 * mbs * bm * r128(d) * r128(f) * (2 + int(gated))


def _check_experts(name, xp, w_in, w_out, w_gate, counts, bm, row_vecs=(),
                   row_mats=()):
    """(E, D, F, rows, bm, MBS) of an expert call; raises on shapes that
    do not fit.  ``row_vecs`` are (rows,) operands, ``row_mats`` pairs
    (operand, "d" or "f"): (rows, D) or (rows, F) operands."""
    if w_in.dim() != 3:
        raise ValueError(f"{name}: w_in must be (E, D, F), got "
                         f"{tuple(w_in.shape)}")
    e, d, f = w_in.shape
    r = xp.shape[0]
    if xp.shape != (r, d) or w_out.shape != (e, f, d) \
            or (w_gate is not None and w_gate.shape != (e, d, f)) \
            or counts.shape != (e,):
        raise ValueError(
            f"{name}: xp {tuple(xp.shape)}, w_in {tuple(w_in.shape)}, w_out "
            f"{tuple(w_out.shape)}, w_gate "
            f"{None if w_gate is None else tuple(w_gate.shape)}, counts "
            f"{tuple(counts.shape)} do not fit (rows, D), (E, D, F), "
            f"(E, F, D), (E, D, F), (E,)")
    if counts.dtype.is_floating_point or counts.device != xp.device:
        raise TypeError(f"{name}: counts must be integers on {xp.device}")
    for v in row_vecs:
        if v.shape != (r,):
            raise ValueError(f"{name}: a row vector is {tuple(v.shape)}, "
                             f"expected ({r},)")
    for t, key in row_mats:
        cols = d if key == "d" else f
        if t.shape != (r, cols):
            raise ValueError(f"{name}: an operand is {tuple(t.shape)}, "
                             f"expected ({r}, {cols})")
    bm = moe_block_m(r, e) if bm is None else int(bm)
    if bm < 1 or bm & (bm - 1) or r % bm:
        raise ValueError(f"{name}: bm={bm} must be a power of two dividing "
                         f"the {r} packed rows")
    return e, d, f, r, bm, r // bm


def _segments(counts, bm):
    """[(first packed row, rows)] per expert, read on the host (plain
    versions only)."""
    offs = expert_row_offsets(counts, bm).tolist()
    return list(zip(offs, counts.tolist()))


def grouped_matmul_experts_ref(xp, swp, w_in, w_out, w_gate, counts, *,
                               activation: str = "silu", bm: int,
                               train: bool = False):
    """Plain version of ``grouped_matmul_experts``: per expert, over its
    live rows, h = act(x @ W_gate) * (x @ W_in) (act(x @ W_in) ungated),
    y = (h @ W_out) * sw; zeros on every other row.  ``train`` also
    returns the in/gate pre-activations (zeros off the live rows)."""
    name = "grouped_matmul_experts"
    e, d, f, r, bm, _ = _check_experts(name, xp, w_in, w_out, w_gate,
                                       counts, bm, row_vecs=(swp,))
    act = _moe_act(activation)
    y = xp.new_zeros((r, d))
    hin = xp.new_zeros((r, f))
    gate = xp.new_zeros((r, f)) if w_gate is not None else None
    for g, (a, n) in enumerate(_segments(counts, bm)):
        if n == 0:
            continue
        x = xp[a:a + n]
        pi = x @ w_in[g]
        hin[a:a + n] = pi
        if gate is not None:
            pg = x @ w_gate[g]
            gate[a:a + n] = pg
            h = act(pg) * pi
        else:
            h = act(pi)
        y[a:a + n] = (h @ w_out[g]) * swp[a:a + n, None]
    return (y, hin, gate) if train else y


def grouped_matmul_experts(xp, swp, w_in, w_out, w_gate, counts, *,
                           activation: str = "silu", train: bool = False,
                           bm: int | None = None):
    """E expert MLPs over per-expert ragged M in ONE call (two CUDA
    launches on the pipelined engine, ``experts_launch``: the in/gate
    stage, then the out stage).

    xp (rows, D) tokens packed into block-aligned per-expert segments,
    swp (rows,) the router's combine weight per packed row, w_in/w_gate
    (E, D, F) (``w_gate=None``: ungated), w_out (E, F, D), counts (E,)
    routed rows per expert.  Returns y (rows, D) = act-gated chain output
    row-scaled by swp, exact zeros past each block's valid rows; with
    ``train``, (y, in pre-activations, gate pre-activations or None),
    each (rows, F) and zero past the valid rows.
    CUDA: ``csrc/grouped_matmul_experts.cu``; CPU tensors take
    ``grouped_matmul_experts_ref``."""
    name = "grouped_matmul_experts"
    floats = [xp, swp, w_in, w_out] + ([] if w_gate is None else [w_gate])
    dev = _rt.kernel_device(name, floats)
    e, d, f, r, bm, mbs = _check_experts(name, xp, w_in, w_out, w_gate,
                                         counts, bm, row_vecs=(swp,))
    act = _act_code(activation)
    if dev.type == "cpu":
        return grouped_matmul_experts_ref(xp, swp, w_in, w_out, w_gate,
                                          counts, activation=activation,
                                          bm=bm, train=train)
    _rt.require_contiguous(name, floats)
    meta = _expert_block_meta(counts, mbs, bm)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    y, hpost = new(r, d), new(r, f)
    hin = new(r, f) if train else None
    gate = new(r, f) if train and w_gate is not None else None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_experts_fwd(
        ptr(xp), ptr(swp), ptr(w_in), ptr(w_gate), ptr(w_out), ptr(meta),
        ptr(y), ptr(hin), ptr(gate), ptr(hpost), r, d, f, e, bm, mbs, act,
        _rt.stream_handle(dev))
    _build.check(rc, name)
    _rt.CUDA_LAUNCHES[name] += 2
    return (y, hin, gate) if train else y


def _bwd_rows(dyp, hinp, gatep):
    return ((dyp, "d"), (hinp, "f")) + (() if gatep is None
                                        else ((gatep, "f"),))


def grouped_matmul_experts_bwd_ref(xp, dyp, w_in, w_out, w_gate, hinp,
                                   gatep, counts, *,
                                   activation: str = "silu", bm: int):
    """Plain version of ``grouped_matmul_experts_bwd``: per expert, over
    its live rows, dH = dYs @ W_out^T, the activation's VJP from the
    saved pre-activations, dX = dIn @ W_in^T (+ dGate @ W_gate^T),
    dW_in = X^T dIn, dW_gate = X^T dGate, dW_out = H^T dYs; zeros on
    every other row and for a zero-token expert's dW."""
    name = "grouped_matmul_experts_bwd"
    gated = w_gate is not None
    e, d, f, r, bm, _ = _check_experts(
        name, xp, w_in, w_out, w_gate, counts, bm,
        row_mats=_bwd_rows(dyp, hinp, gatep))
    act = _moe_act(activation)
    dx = xp.new_zeros((r, d))
    dwin, dwout = torch.zeros_like(w_in), torch.zeros_like(w_out)
    dwgate = torch.zeros_like(w_gate) if gated else None
    for g, (a, n) in enumerate(_segments(counts, bm)):
        if n == 0:
            continue
        x, dy, pi = xp[a:a + n], dyp[a:a + n], hinp[a:a + n]
        dh = dy @ w_out[g].t()
        if gated:
            pg = gatep[a:a + n]
            s = act(pg)
            hpost = s * pi
            din = dh * s
            dgate = _moe_act_grad(pg, activation) * (dh * pi)
            dx[a:a + n] = din @ w_in[g].t() + dgate @ w_gate[g].t()
            dwgate[g] = x.t() @ dgate
        else:
            hpost = act(pi)
            din = _moe_act_grad(pi, activation) * dh
            dx[a:a + n] = din @ w_in[g].t()
        dwin[g] = x.t() @ din
        dwout[g] = hpost.t() @ dy
    return dx, dwin, dwgate, dwout


def grouped_matmul_experts_bwd(xp, dyp, w_in, w_out, w_gate, hinp, gatep,
                               counts, *, activation: str = "silu", bm: int):
    """The whole backward of ``grouped_matmul_experts`` in ONE call (two
    CUDA launches on the pipelined engine, ``experts_bwd_launch``: dH and
    the activation VJP, then every dW and dX).

    ``dyp`` (rows, D) is the packed output cotangent with the router
    combine weight already folded in (dYs = dY * sw); ``hinp``/``gatep``
    (rows, F) are the forward's saved pre-activations.  Returns (dx
    (rows, D), dW_in, dW_gate or None, dW_out), f32; rows at or past a
    block's valid count contribute nothing and get dx 0.
    CUDA: ``csrc/grouped_matmul_experts_bwd.cu``; CPU tensors take
    ``grouped_matmul_experts_bwd_ref``."""
    name = "grouped_matmul_experts_bwd"
    gated = w_gate is not None
    floats = [xp, dyp, w_in, w_out, hinp] + ([w_gate, gatep] if gated
                                             else [])
    dev = _rt.kernel_device(name, floats)
    e, d, f, r, bm, mbs = _check_experts(
        name, xp, w_in, w_out, w_gate, counts, bm,
        row_mats=_bwd_rows(dyp, hinp, gatep))
    if dev.type == "cpu":
        return grouped_matmul_experts_bwd_ref(
            xp, dyp, w_in, w_out, w_gate, hinp, gatep, counts,
            activation=activation, bm=bm)
    act = _act_code(activation)
    _rt.require_contiguous(name, floats)
    meta = _expert_block_meta(counts, mbs, bm)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    dx = new(r, d)
    dwin, dwout = new(e, d, f), new(e, f, d)
    dwgate = new(e, d, f) if gated else None
    dpan, hpost = new(r, (2 if gated else 1) * f), new(r, f)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.lib()
    _rt.count_launch(name)
    rc = lib.rt_experts_bwd(
        ptr(xp), ptr(dyp), ptr(w_in), ptr(w_gate), ptr(w_out), ptr(hinp),
        ptr(gatep), ptr(meta), ptr(dx), ptr(dwin), ptr(dwgate), ptr(dwout),
        ptr(dpan), ptr(hpost), r, d, f, e, bm, mbs, act,
        _rt.stream_handle(dev))
    _build.check(rc, name)
    _rt.CUDA_LAUNCHES[name] += 2
    return dx, dwin, dwgate, dwout
