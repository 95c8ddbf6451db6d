"""Static C2 footprints — ONE budget computation per ExecGroup.

The counterpart of ``repro/analysis/budgets.py``: ``plan.lower``'s
feasibility gate (both directions under ``train=True``),
``plan.backward_plan``'s mirror gate, ``plan._absorb_pools``'s
pooled-launch re-check and ``plan._chain_budgets_ok``'s ring-scratch check
all call the two functions here, so the port's plans pass the same gates
as the reference's.

The accounting:

  base profiles    the chosen-algorithm ``cost_model.profile`` rows —
                   the serial fallback's footprint.
  GEMM workspace   a multi-op all-GEMM group executes the GEMM lowering,
                   whose im2col patch buffers can exceed the serial
                   fallback's workspace — the gate takes the max.
  pool riders      an absorbed pool packs up to ``POOL_TAP_LIMIT`` tap
                   tiles per pooled-lhs tile ((taps-1) * M * K extra
                   workspace bytes per pooled branch) and claims one
                   pooled-lhs scratch (128^2 blocks over the widest
                   pooled K).
  backward         each direction launches sequentially, so the
                   backward footprint is gated on its own (summed
                   ``cost_model.backward_profiles``), never added to
                   the forward's.
  chained          ``cost_model.chained_profiles`` workspace (ring
                   consumers drop their patch buffer) plus the launch's
                   ring scratch: 3 wave slots per ring column, the
                   (3*bm, blk) shift window and the f32 accumulator.

Every byte count is priced for the reference planner's profile
(``cost_model.TPU_PLANNER_PROFILE``), not for the GPU.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import cost_model as cm

@dataclasses.dataclass(frozen=True)
class Footprint:
    """A group's static C2 footprint: device workspace + scratch residency."""
    workspace_bytes: float
    vmem_bytes: float

    def fits(self, hbm_budget: float, vmem_budget: float) -> bool:
        return (self.workspace_bytes <= hbm_budget
                and self.vmem_bytes <= vmem_budget)


def tap_count(pool_op) -> int:
    """Tap tiles per pooled-lhs tile: the product of the pool chain's
    squared windows, folded to 1 past ``POOL_TAP_LIMIT``."""
    from repro_torch.kernels.grouped_matmul import POOL_TAP_LIMIT
    t = 1
    for win, _s in pool_op.p["chain"]:
        t *= win * win
    return t if t <= POOL_TAP_LIMIT else 1


def group_footprint(graph, names, algorithms, *, pools=(),
                    direction: str = "fwd",
                    include_gemm_ws: bool | None = None) -> Footprint:
    """The static footprint of one ExecGroup.

    ``names``/``algorithms`` identify the ops and their chosen
    algorithms; ``pools`` is the group's ``(branch, pool)`` rider list;
    ``direction="bwd"`` prices the mirrored backward launch instead
    (summed ``backward_profiles``, the algorithm falling back to
    ``best_algorithm`` when the group never chose one — matching
    ``backward_plan``).  ``include_gemm_ws`` forces the GEMM-lowering workspace max on (pooled
    re-checks price the grouped kernel even when a join op rides in the
    group); ``None`` applies it exactly when ``lower`` would — a multi-op
    group of GEMM-viewed ops.
    """
    ops = [graph.ops[n] for n in names]
    if direction == "bwd":
        bprofs = [p for op in ops
                  for p in cm.backward_profiles(
                      op, algorithms.get(op.name)
                      or cm.best_algorithm(op)[0])]
        return Footprint(sum(p.workspace_bytes for p in bprofs),
                         sum(p.vmem_bytes for p in bprofs))
    base = [cm.profile(op, algorithms[op.name]) for op in ops]
    ws = sum(p.workspace_bytes for p in base)
    vmem = sum(p.vmem_bytes for p in base)
    if include_gemm_ws is None:
        include_gemm_ws = (len(ops) > 1
                           and all(cm.gemm_shape(op) is not None
                                   for op in ops))
    if include_gemm_ws:
        ws = max(ws, sum(p.workspace_bytes for p in cm.gemm_profiles(ops)))
    extra_ws, extra_vmem = 0.0, 0.0
    for b, pn in pools:
        s = cm.gemm_shape(graph.ops[b])
        extra_ws += (tap_count(graph.ops[pn]) - 1) \
            * s[0] * s[1] * graph.ops[b].dtype_bytes
        extra_vmem = max(extra_vmem, -(-s[1] // 128) * 128 * 128 * 4)
    return Footprint(ws + extra_ws, vmem + extra_vmem)


def chained_footprint(graph, phases, ring, *, block: int = 128) -> Footprint:
    """The static footprint of one chained launch: chained-priced GEMM
    workspace plus the ring scratch — 3 wave slots per ring column over
    every consumed producer's K blocks, the (3*bm, blk) shift window and
    the f32 accumulator."""
    ops = [graph.ops[n] for ph in phases for n in ph]
    profs = cm.chained_profiles(ops, ring)
    allnames = {m for ph in phases for m in ph}
    consumed: set[str] = set()
    for ph in phases:
        for n in ph:
            if n in ring:
                consumed |= graph.pred[n] & allnames
    nring = sum(-(-graph.ops[n].p["k"] // block) for n in consumed)
    eb = max(op.dtype_bytes for op in ops)
    ring_vmem = (3 * nring + 3) * block * block * eb + block * block * 4
    return Footprint(sum(p.workspace_bytes for p in profs),
                     sum(p.vmem_bytes for p in profs) + ring_vmem)
