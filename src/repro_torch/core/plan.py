"""Executable plan IR — the lowering layer between Schedule and kernels.

The counterpart of ``repro/core/plan.py``.  ``lower()`` turns the
scheduler's CoGroups into ``ExecGroup``s with a concrete execution mode
through the same passes as the reference (pool absorption, concat-join
absorption, cross-module chaining), so the two packages lower identical
plans; ``run_plan`` executes them on torch tensors.

Modes ``run_plan`` runs, and the kernel each launches on the GPU:

  serial          one op after another, each conv through its scheduled
                  algorithm (``direct`` -> ``kernels.conv2d_direct``);
                  the join of an unabsorbed fork is a plain concatenate.
  grouped /       the branches of one fork as ONE grouped launch with the
  grouped_pooled  bias+ReLU epilogue fused and the absorbed maxpools
                  computed in-kernel before the GEMM
                  (``kernels.ops.grouped_matmul_pooled``).
  grouped_concat  a grouped launch whose epilogue writes each branch
                  straight into its column slice of the join
                  (``kernels.ops.grouped_matmul_concat``); join inputs
                  from earlier groups are copied in as passthrough
                  columns.
  grouped_chained a module's quad and its 3x3/5x5 pair, or a run of stem
                  convs, as one chain of phases
                  (``kernels.grouped_matmul_chained``): each phase's lhs
                  comes from packed x, from the previous chain's padded
                  panels in place, or from an earlier phase's panel
                  through shifted ring taps; the module output stays a
                  ``ChainPanels`` composite (no join, no concat).
                  Forward only: a chained group raises when gradients
                  are needed.
  stacked         same-shape branches padded to the widest (K, N) and
                  stacked into ONE (G, M, K) @ (G, K, N) launch
                  (``kernels.ops.branch_matmul``, K9); bias and ReLU run
                  after it.  The unfused baseline (``fuse_pool=False``)
                  lowers uniform quads to it.

The launches are autograd Functions (``kernels.ops``): training
differentiates through ``run_plan``, each grouped group pulling its
cotangents back through ONE combined backward launch, each stacked group
through two K9 launches, and serial convs through the GEMM-view backward
``models/cnn.py`` binds.  ``backward_plan`` prices that mirrored
backward.

The other modes of the reference (fused, spatial, xla, grouped_experts)
are lowered by nothing the port runs; ``run_plan`` raises
``NotImplementedError`` naming any of them rather than run a group some
other way.  So does a mode whose bindings are missing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.nn.functional as F

from repro_torch.analysis import budgets as _budgets
from repro_torch.core import cost_model as cm
from repro_torch.core.graph import OpGraph
from repro_torch.core.scheduler import Schedule

MODES = ("grouped", "grouped_concat", "grouped_pooled", "grouped_chained",
         "grouped_experts", "stacked", "fused", "spatial", "serial", "xla")

#: The modes ``run_plan`` executes.
RUN_MODES = ("serial", "grouped", "grouped_pooled", "grouped_concat",
             "grouped_chained", "stacked")


@dataclasses.dataclass(frozen=True)
class ExecGroup:
    """One schedulable unit of the executable plan."""
    mode: str                      # one of MODES
    ops: tuple[str, ...]
    algorithms: dict[str, str]     # op -> algorithm (serial path)
    modeled_time: float            # cost-model makespan under ``mode``
    reason: str = ""               # why ``mode`` was chosen (debugging)
    join: str = ""                 # grouped_concat: the absorbed join op
    # absorbed maxpools: (branch op, pool op) pairs — the branch's lhs is
    # pooled in-launch from the pool op's input
    pools: tuple[tuple[str, str], ...] = ()
    # grouped_chained: one tuple of op names per phase (the join, if any,
    # rides ``join`` and appears in ``ops`` but not in ``chain``)
    chain: tuple[tuple[str, ...], ...] = ()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode}")


@dataclasses.dataclass
class ChainPanels:
    """The composite value a chained launch leaves in ``env``: the padded
    per-phase output panels of ``grouped_matmul_chained`` plus the
    (panel, col-block base, true width) segment layout of the logical
    join, in join order.  The next chained launch consumes it in place
    (panel sources, or a per-segment pooled fold); any other consumer
    materializes it to NHWC through ``_env_val``."""
    panels: tuple                       # padded (Mp, ncb*blk) tensors
    segments: tuple[tuple[int, int, int], ...]   # (panel, col block, n)
    m: int                              # true rows (B*H*W)
    h: int
    w: int
    blk: int = 128

    @property
    def width(self) -> int:
        return sum(n for _, _, n in self.segments)


@dataclasses.dataclass
class Plan:
    """Ordered ExecGroups + the context needed to execute them."""
    groups: list[ExecGroup]
    context: dict = dataclasses.field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return sum(g.modeled_time for g in self.groups)

    @property
    def algorithms(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for g in self.groups:
            out.update(g.algorithms)
        return out

    def mode_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for g in self.groups:
            out[g.mode] = out.get(g.mode, 0) + 1
        return out

    def groups_of_mode(self, mode: str) -> list[ExecGroup]:
        return [g for g in self.groups if g.mode == mode]


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

# (M, K, N) GEMM view of an op — matmuls verbatim, convs via im2col
_gemm_shape = cm.gemm_shape


def _absorb_concat_joins(graph: OpGraph,
                         groups: list[ExecGroup]) -> list[ExecGroup]:
    """Fuse fork/join concats into the grouped launches that feed them.

    A grouped group absorbs a join when (a) the join is the ONLY consumer
    of every op in the group (their outputs exist solely to be
    concatenated), (b) the join is a pointwise op lowered as its own
    singleton group later in the plan, and (c) every OTHER join input is
    produced by an earlier group (those arrive as passthrough column
    slices).  The merged ``grouped_concat`` group prices at
    ``cost_model.group_execution_time(..., join=...)`` — branch slices
    leave the kernel inside the join buffer, so only the passthrough
    columns keep a copy cost — and the standalone join group is dropped.
    """
    out: list[ExecGroup | None] = list(groups)
    for idx, g in enumerate(out):
        if g is None or g.mode not in ("grouped", "grouped_pooled") \
                or len(g.ops) < 2:
            continue
        succs = {s for n in g.ops for s in graph.succ[n]}
        if len(succs) != 1:
            continue
        (jname,) = succs
        jop = graph.ops.get(jname)
        if jop is None or jop.kind != "pointwise":
            continue
        if any(graph.succ[n] != {jname} for n in g.ops):
            continue
        jidx = next((k for k, gg in enumerate(out)
                     if gg is not None and gg.ops == (jname,)), None)
        if jidx is None or jidx < idx:
            continue
        produced = {n for gg in out[:idx] if gg is not None for n in gg.ops}
        produced.update(n for n in graph.ops if not graph.pred[n])
        if not all(p in produced for p in graph.pred[jname] - set(g.ops)):
            continue
        ops = [graph.ops[n] for n in g.ops]
        profs = [cm.profile(op, g.algorithms[op.name]) for op in ops]
        mode, t = cm.group_execution_time(ops, profs, join=jop)
        if mode != "grouped_concat" \
                or t >= g.modeled_time + out[jidx].modeled_time:
            continue
        algs = dict(g.algorithms)
        algs.update(out[jidx].algorithms)
        out[idx] = ExecGroup(
            "grouped_concat", g.ops + (jname,), algs, t,
            "fused epilogue-concat: branch slices land in the join "
            "buffer in-kernel", join=jname, pools=g.pools)
        out[jidx] = None
    return [g for g in out if g is not None]


def _absorb_pools(graph: OpGraph,
                  groups: list[ExecGroup]) -> list[ExecGroup]:
    """Stream standalone maxpool ops through the grouped launches that
    consume them (the pool analogue of ``_absorb_concat_joins``).

    A maxpool singleton group is absorbed when EVERY consumer of the pool
    is a GEMM-viewed branch of a LATER grouped-family group and none of
    those branches already pools another input — each consuming group
    then gains a per-branch ``pools`` descriptor (its launch pools the
    pool op's RAW input in-kernel: tap tiles maxed into the pooled-lhs
    scratch, see ``kernels/grouped_matmul.py``) and the standalone
    ``reduce_window`` group is dropped.  The fused rider is ZERO
    (``cost_model.pool_profile`` — the tap reads stream through the
    launch's existing lhs DMA and the pooled activation never touches
    HBM), so absorption wins by exactly the pool group's makespan; a
    consuming STACKED group is re-priced onto the grouped kernel (the
    pad-to-max kernel has no pool stage), which must still beat keeping
    the pool standalone.  Consumers may span several groups — an
    inter-module pool feeding two launches is pooled by each (recomputed
    taps instead of a materialized pooled tensor; recompute is free under
    the rider model, the ROADMAP's hw-calibration caveat applies).

    The pooled launch's footprint is re-checked against the C2 budgets
    ``lower`` gated the unpooled group on: the tap-expanded X stack packs
    up to ``POOL_TAP_LIMIT`` tap tiles per pooled lhs tile (extra HBM
    workspace; past the limit the taps fold at pack time and add
    nothing), and the pooled-lhs scratch claims VMEM — a pool whose
    absorption would bust a consuming group's budget stays standalone."""
    out: list[ExecGroup | None] = list(groups)
    for idx, pg in enumerate(out):
        if pg is None or len(pg.ops) != 1:
            continue
        (pname,) = pg.ops
        pop = graph.ops.get(pname)
        if pop is None or pop.kind != "maxpool":
            continue
        consumers = sorted(graph.succ[pname])
        if not consumers:
            continue
        targets: dict[int, list[str]] = {}
        ok = True
        for c in consumers:
            j = next((k for k, gg in enumerate(out)
                      if gg is not None and c in gg.ops), None)
            if (j is None or j <= idx
                    or out[j].mode not in ("grouped", "grouped_pooled",
                                           "grouped_concat", "stacked")
                    or _gemm_shape(graph.ops[c]) is None
                    # the branch must read the pool as its ONLY input (its
                    # gemm_x maps each raw tap view single-argument) and a
                    # branch can absorb at most one pool chain
                    or graph.pred[c] != {pname}
                    or any(b == c for b, _ in out[j].pools)):
                ok = False
                break
            targets.setdefault(j, []).append(c)
        if not ok:
            continue
        # price every affected group first — absorption is all-or-nothing
        # across the pool's consumers (a partially absorbed pool would
        # still have to launch standalone), and the win check aggregates:
        # dropping the pool group saves its makespan exactly ONCE, so the
        # SUM of repriced-group increases (stacked consumers moving onto
        # the grouped kernel) must stay below it
        repriced: dict[int, ExecGroup] = {}
        delta = 0.0
        for j, branches in targets.items():
            gg = out[j]
            # C2 re-check on the WHOLE pooled launch (pools already
            # absorbed into this group included); ``include_gemm_ws``
            # prices the grouped kernel's im2col patch buffers even when
            # a join op rides in the group, matching the gate ``lower``
            # applied to the unpooled group
            fp = _budgets.group_footprint(
                graph, gg.ops, gg.algorithms, include_gemm_ws=True,
                pools=tuple(gg.pools) + tuple((b, pname)
                                              for b in branches))
            if not fp.fits(cm.HBM_BUDGET, cm.VMEM_BUDGET):
                ok = False
                break
            mode, t, reason = gg.mode, gg.modeled_time, gg.reason
            if gg.mode == "stacked":
                branch_ops = [graph.ops[n] for n in gg.ops]
                t = cm.grouped_time(branch_ops)
                mode = "grouped_pooled"
                reason = ("pool absorption: stacked branches take the "
                          "grouped kernel (the pooled lhs needs its "
                          "pool stage)")
                delta += t - gg.modeled_time
            elif gg.mode == "grouped":
                mode = "grouped_pooled"
                reason = ("in-kernel pre-GEMM maxpool: pooled lhs "
                          "streams from raw-input tap tiles")
            algs = dict(gg.algorithms)
            algs.update(pg.algorithms)   # the pool's choice survives
            repriced[j] = ExecGroup(
                mode, gg.ops, algs, t, reason, join=gg.join,
                pools=gg.pools + tuple((b, pname) for b in branches))
        if not ok or delta >= pg.modeled_time:
            continue
        for j, gg in repriced.items():
            out[j] = gg
        out[idx] = None
    return [g for g in out if g is not None]


def _chain_feasible(graph: OpGraph, phase0: list[str], branches: list[str],
                    join: str, *, block: int = 128) -> bool:
    """Geometry/topology gates for merging a quad group (phase 0) with the
    grouped_concat pair (phase 1) feeding off it into ONE chained launch:

      * every phase-1 branch is a stride-1 conv whose single producer is a
        phase-0 op and whose halo fits the ring window — the kernel loads
        row blocks i-1/i/i+1 into a (3*bm, blk) window and slices at
        bm+delta, so |delta| = (kh//2)*W + kw//2 must stay <= bm (= block);
      * phase-0 ops read no phase-0 op (the wave schedule runs a phase's
        branches at the same lag — intra-phase chaining has no ring slot);
      * nothing escapes the launch: every phase-0 output is consumed only
        by phase-1 branches or the join, and the join reads only in-launch
        branches (the ChainPanels segments must all come from this launch);
      * one shared GEMM M across every branch of both phases (the wave
        schedule advances all phases over the same row blocks).
    """
    qset, bset = set(phase0), set(branches)
    for b in branches:
        op = graph.ops.get(b)
        preds = graph.pred[b]
        if (op is None or op.kind != "conv2d"
                or op.p.get("stride", 1) != 1
                or len(preds) != 1 or not preds <= qset):
            return False
        halo = (op.p.get("kh", 1) // 2) * op.p["w"] + op.p.get("kw", 1) // 2
        if halo > block:
            return False
    for n in phase0:
        if graph.pred[n] & qset:
            return False
        if not graph.succ[n] <= bset | {join}:
            return False
    if not graph.pred[join] <= qset | bset:
        return False
    ms = {(_gemm_shape(graph.ops[n]) or (None,))[0] for n in phase0 + branches}
    return None not in ms and len(ms) == 1


def _chain_budgets_ok(graph: OpGraph, phases: list[list[str]], ring, *,
                      block: int = 128) -> bool:
    """C2 re-check on the chained launch: the HBM workspace of its
    chained-priced GEMM lowering (ring consumers drop their patch buffer —
    their lhs never exists outside VMEM) plus the launch's ring scratch
    against the VMEM budget: 3 wave slots per ring column, the (3*bm, blk)
    shift window and the f32 accumulator.  The footprint itself comes
    from ``analysis.budgets.chained_footprint``."""
    return _budgets.chained_footprint(graph, phases, ring,
                                      block=block).fits(cm.HBM_BUDGET,
                                                        cm.VMEM_BUDGET)


def _chain_modules(graph: OpGraph, groups: list[ExecGroup], *,
                   block: int = 128) -> list[ExecGroup]:
    """Chain grouped launches ACROSS module boundaries (the cross-module
    streaming pass, after ``_absorb_pools`` + ``_absorb_concat_joins``).

    Two rewrites, both producing ``grouped_chained`` groups that execute
    as ONE ``grouped_matmul_chained`` launch (kernels/grouped_matmul.py)
    running their phases in a lag-1 wave schedule — phase p+1 consumes
    phase p's freshly computed row blocks from an in-kernel VMEM ring,
    never touching HBM for that lhs:

      A. a quad group (grouped/grouped_pooled — e.g. an inception module's
         1x1/r3/r5/pp) merges with the grouped_concat pair riding on its
         reductions (3x3/5x5 + join) into a two-phase launch.  The join
         vanishes entirely: the launch's padded per-phase panels ARE the
         module output (a ``ChainPanels`` value), consumed in place by the
         next chained launch via panel lhs-source descriptors — the
         concat/copy the epilogue-concat mode still paid is gone.
      B. maximal runs of singleton serial conv groups (the stem) fold into
         one multi-phase launch, each conv a phase ring-consuming its
         predecessor — K*K convs stream as K^2 shifted tap-GEMMs.

    Gates: ``_chain_feasible`` (topology + ring-halo geometry),
    ``_chain_budgets_ok`` (C2), and a strict modeled win vs the groups
    merged (``cost_model.chained_time`` — co-execution over all phases
    with ring lhs traffic dropped, stretched by the wave-schedule fill
    factor).  Impl-level requirements (bias+ReLU epilogue, chain_geom)
    are the executor's to verify — a chained group whose bindings don't
    carry them raises in ``run_plan``."""
    out: list[ExecGroup | None] = list(groups)
    # --- pass A: quad + pair -> one two-phase chained launch -------------
    for idx in range(len(out)):
        q = out[idx]
        if q is None or q.mode not in ("grouped", "grouped_pooled"):
            continue
        match = None
        for jdx in range(idx + 1, len(out)):
            pg = out[jdx]
            if pg is None or pg.mode != "grouped_concat" or not pg.join:
                continue
            branches = [n for n in pg.ops if n != pg.join]
            if {p for n in branches for p in graph.pred[n]} <= set(q.ops):
                match = (jdx, pg, branches)
                break
        if match is None:
            continue
        jdx, pg, branches = match
        if not _chain_feasible(graph, list(q.ops), branches, pg.join,
                               block=block):
            continue
        phases = [list(q.ops), branches]
        ring = frozenset(branches)
        if not _chain_budgets_ok(graph, phases, ring, block=block):
            continue
        phase_ops = [[graph.ops[n] for n in ph] for ph in phases]
        t = cm.chained_time(phase_ops, ring)
        if t >= q.modeled_time + pg.modeled_time:
            continue
        algs = dict(q.algorithms)
        algs.update(pg.algorithms)
        out[idx] = ExecGroup(
            "grouped_chained", q.ops + pg.ops, algs, t,
            "cross-module chain: reduction outputs stream to the K*K "
            "convs through the VMEM ring and the module output stays a "
            "panel composite (no join, no concat)",
            join=pg.join, pools=q.pools + pg.pools,
            chain=(tuple(q.ops), tuple(branches)))
        out[jdx] = None
    out = [g for g in out if g is not None]
    # --- pass B: serial conv runs -> one multi-phase chained launch ------
    sidx: dict[str, int] = {}
    for i, g in enumerate(out):
        if g.mode == "serial" and len(g.ops) == 1:
            op = graph.ops.get(g.ops[0])
            if op is not None and op.kind == "conv2d" \
                    and _gemm_shape(op) is not None:
                sidx[g.ops[0]] = i
    dead: set[int] = set()
    used: set[str] = set()
    for name in list(sidx):
        if name in used:
            continue
        run = [name]
        cur = name
        while True:
            succ = graph.succ[cur]
            if len(succ) != 1:
                break
            (nxt,) = succ
            if nxt not in sidx or nxt in used or graph.pred[nxt] != {cur}:
                break
            opn = graph.ops[nxt]
            if opn.p.get("stride", 1) != 1:
                break
            halo = (opn.p.get("kh", 1) // 2) * opn.p["w"] \
                + opn.p.get("kw", 1) // 2
            if halo > block:
                break
            if _gemm_shape(opn)[0] != _gemm_shape(graph.ops[cur])[0]:
                break
            run.append(nxt)
            cur = nxt
        used.update(run)
        if len(run) < 2:
            continue
        phases = [[n] for n in run]
        ring = frozenset(run[1:])
        if not _chain_budgets_ok(graph, phases, ring, block=block):
            continue
        phase_ops = [[graph.ops[n]] for n in run]
        t = cm.chained_time(phase_ops, ring)
        base = sum(out[sidx[n]].modeled_time for n in run)
        if t >= base:
            continue
        algs: dict[str, str] = {}
        for n in run:
            algs.update(out[sidx[n]].algorithms)
        out[sidx[run[0]]] = ExecGroup(
            "grouped_chained", tuple(run), algs, t,
            "serial-conv chain: each conv a phase ring-consuming its "
            "predecessor (K*K convs as K^2 shifted tap-GEMMs)",
            chain=tuple((n,) for n in run))
        dead.update(sidx[n] for n in run[1:])
    return [g for i, g in enumerate(out) if g is not None and i not in dead]


def lower(graph: OpGraph, schedule: Schedule, *, train: bool = False,
          fuse_pool: bool = True, chain_modules: bool = False) -> Plan:
    """Lower a Schedule to an executable Plan.

    Mode choice per CoGroup: budget-infeasible or singleton -> serial;
    otherwise ``cost_model.group_execution_time`` picks the realizable
    single-chip mode (grouped ragged branch GEMM, or stacked uniform-shape
    GEMMs) at its modeled makespan.  Then ``fuse_pool`` (default) streams
    each standalone maxpool through the grouped launch(es) consuming it
    (``_absorb_pools``; a stacked consumer moves onto the grouped kernel),
    each fork/join concat is absorbed into the grouped launch feeding it
    (``_absorb_concat_joins``) and ``chain_modules`` chains the absorbed
    launches across module boundaries (``_chain_modules``) — the
    reference's passes, verbatim, at the reference's C2 budgets
    (``cost_model.HBM_BUDGET``/``VMEM_BUDGET``).  ``fuse_pool=False``
    keeps every maxpool a standalone serial group (the unfused baseline
    of the reference's benchmarks), which leaves uniform-shape quads in
    the ``stacked`` mode.

    ``train=True`` additionally checks the C2 budgets against the
    group's backward profiles (each direction on its own — forward and
    backward are sequential launches): a group whose backward footprint
    does not fit runs serial in BOTH directions, so the mirrored plan
    never takes a co-execution decision the backward cannot honor.
    """
    _REASON = {
        "grouped": "ragged shared-M GEMM branches -> grouped kernel "
                   "(uniform-K shared-X branches dedup to one wide GEMM "
                   "at execution)",
        "stacked": "same-shape GEMM branches",
        "fused": "compute+memory complementary pair",
        "xla": "heterogeneous group -> XLA interleave",
    }
    groups: list[ExecGroup] = []
    for cg in schedule.groups:
        ops = [graph.ops[n] for n in cg.ops]
        profs = [cm.profile(op, cg.algorithms[op.name]) for op in ops]
        feasible = _budgets.group_footprint(
            graph, cg.ops, cg.algorithms).fits(cm.HBM_BUDGET,
                                               cm.VMEM_BUDGET)
        if train and feasible:
            feasible = _budgets.group_footprint(
                graph, cg.ops, cg.algorithms,
                direction="bwd").fits(cm.HBM_BUDGET, cm.VMEM_BUDGET)
        if len(ops) == 1:
            mode, t, reason = "serial", cm.serial_time(profs), "singleton"
        elif cg.serialized or not feasible:
            mode, t = "serial", cm.serial_time(profs)
            reason = "budget-infeasible (C2 fallback)"
        else:
            mode, t = cm.group_execution_time(ops, profs)
            reason = _REASON[mode]
        groups.append(ExecGroup(mode, tuple(cg.ops), dict(cg.algorithms),
                                t, reason))
    if fuse_pool:
        groups = _absorb_pools(graph, groups)
    groups = _absorb_concat_joins(graph, groups)
    if chain_modules:
        groups = _chain_modules(graph, groups)
    return Plan(groups, context={"graph": graph})


# ---------------------------------------------------------------------------
# backward-plan lowering
# ---------------------------------------------------------------------------

def backward_plan(graph: OpGraph, plan: Plan) -> Plan:
    """Derive the mirrored backward Plan from a lowered forward plan.

    The backward graph of a fork/join network is the forward graph
    reversed — the same CoGroups in mirrored order — and autograd through
    ``run_plan`` realizes exactly that structure: a co-executed forward
    group pulls all its cotangents back through ONE autograd Function
    (``kernels.ops``), so each forward ExecGroup becomes one grad
    ExecGroup (ops ``grad:<name>``) whose mode is what that Function's
    backward launches:

      grouped / grouped_pooled / grouped_concat -> the same mode: ONE
                           combined masked-dx + dw/db launch
                           (``grouped_matmul_bwd``); the joint cotangent
                           of a concat is sliced straight into it, and a
                           pooled branch's cotangent scatters through the
                           first-argmax mask.
      grouped_chained ->   one combined launch per phase, reverse order.
      stacked -> stacked   the stacked kernel on the backward GEMMs.
      serial  -> serial    per-op backward (convs take the GEMM-view
                           backward ``models/cnn.py`` binds).
      fused / spatial -> serial; xla -> xla.

    The same C2 safety net applies (a grad group whose summed backward
    profiles exceed the budgets is priced serial).  The returned Plan is
    the lowering + pricing artifact for the training step's backward
    half — mode counts, ``Plan.makespan``; execution flows through the
    autograd Functions of the forward plan, not through ``run_plan``.
    """
    _REASON = {
        "grouped": "mirror: ONE combined masked-dx + dw/db launch",
        "grouped_concat": "mirror: ONE combined launch, joint cotangent "
                          "sliced straight into its packing",
        "grouped_pooled": "mirror: ONE combined launch, pooling cotangent "
                          "scattered through the argmax mask in its "
                          "unpacking",
        "grouped_chained": "mirror: reverse-phase chain — ONE combined "
                           "masked-dx + dw/db launch per phase",
        "stacked": "mirror: stacked kernel VJP on the backward GEMMs",
        "serial": "per-op VJPs",
        "fused": "fused VJP pulls back per-op",
        "spatial": "spatial VJP pulls back per-op",
        "xla": "forward group already XLA-interleaved",
    }
    groups: list[ExecGroup] = []
    for g in reversed(plan.groups):
        ops = [graph.ops[n] for n in g.ops]
        bprofs = [p for op in ops
                  for p in cm.backward_profiles(
                      op, g.algorithms.get(op.name)
                      or cm.best_algorithm(op)[0])]
        feasible = _budgets.group_footprint(
            graph, g.ops, g.algorithms,
            direction="bwd").fits(cm.HBM_BUDGET, cm.VMEM_BUDGET)
        if g.mode == "grouped_concat" and feasible:
            branch_ops = [op for op in ops if op.name != g.join]
            mode, t = cm.group_execution_time_bwd(
                branch_ops, g.algorithms, mode="grouped_concat",
                join=graph.ops[g.join])
            reason = _REASON[mode]
        elif g.mode == "grouped_chained" and feasible and g.chain:
            phase_ops = [[graph.ops[n] for n in ph] for ph in g.chain]
            mode, t = "grouped_chained", cm.chained_time_bwd(phase_ops,
                                                             g.algorithms)
            reason = _REASON[mode]
        elif g.mode in ("grouped", "grouped_pooled", "stacked") and feasible:
            mode, t = cm.group_execution_time_bwd(ops, g.algorithms,
                                                  mode=g.mode)
            reason = _REASON[mode]
        elif g.mode == "xla":
            mode, t = "xla", cm.xla_interleave_time(bprofs)
            reason = _REASON["xla"]
        else:
            mode, t = "serial", sum(p.time for p in bprofs)
            reason = ("budget-infeasible (C2 fallback)"
                      if g.mode in ("grouped", "grouped_concat",
                                    "grouped_pooled", "grouped_chained",
                                    "stacked")
                      else _REASON[g.mode])
        groups.append(ExecGroup(
            mode, tuple(f"grad:{n}" for n in g.ops),
            {f"grad:{n}": a for n, a in g.algorithms.items()}, t, reason,
            join=f"grad:{g.join}" if g.join else "",
            pools=tuple((f"grad:{b}", f"grad:{p}") for b, p in g.pools),
            chain=tuple(tuple(f"grad:{n}" for n in ph)
                        for ph in reversed(g.chain)) if g.chain else ()))
    return Plan(groups, context={"forward": plan, "graph": graph})


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpImpl:
    """Executable binding of one graph op (built by the model layer).

    ``fn(*dep_tensors, algorithm=...)`` runs the op on its own (serial
    groups).  The views the grouped-family launches need:

      gemm_x/gemm_w — the op as ``x2d @ w`` with x2d (M, K) from the deps
          and w (K, N); for a KxK conv, gemm_x is the im2col patch view.
      gemm_x_key — hashable token identifying the gemm_x transform: two
          impls with equal (deps, gemm_x_key) produce the identical x2d,
          so a grouped launch reads it once for both (one wide GEMM).
      gemm_bias/gemm_relu/gemm_reshape — the epilogue the kernels fuse
          (bias + ReLU) and the pure 2D -> NHWC view applied after.
      pool_chain — maxpool ops only: the ((window, stride), ...) chain a
          grouped launch absorbs (the consuming branch's ``gemm_x`` maps
          each raw-input tap view).
      chain_geom — convs only: (kh, kw, stride, cin, oh, ow), the raw
          geometry a chained launch needs for ring taps, weight repacking
          and border masks.
    """
    deps: tuple[str, ...]
    fn: Callable[..., Any]
    gemm_x: Callable[..., Any] | None = None
    gemm_x_key: Any = None
    gemm_w: Any = None
    gemm_bias: Any = None
    gemm_relu: bool = False
    gemm_reshape: Callable[..., Any] | None = None
    pool_chain: tuple | None = None
    chain_geom: tuple | None = None


def _materialize_chain(v: ChainPanels):
    """NHWC composite of a ChainPanels — the one concatenate a chained
    launch deleted, paid only when a non-chained consumer needs it."""
    parts = [v.panels[p][:v.m, cb * v.blk: cb * v.blk + n]
             for p, cb, n in v.segments]
    x2 = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
    return x2.reshape(-1, v.h, v.w, x2.shape[-1])


def _env_val(env: dict, d: str):
    """Read ``env[d]``, materializing (and caching back) a ChainPanels for
    consumers that expect the plain NHWC value."""
    v = env[d]
    if isinstance(v, ChainPanels):
        v = _materialize_chain(v)
        env[d] = v
    return v


def _dep_args(impl: OpImpl, env: dict):
    return [_env_val(env, d) for d in impl.deps]


def _require_views(group: ExecGroup, impls, names, *, chain=False):
    """The grouped-family launches fuse bias+ReLU and need the GEMM views;
    a binding without them cannot run the mode (no per-op fallback)."""
    for n in names:
        i = impls.get(n)
        if i is None or i.gemm_w is None or i.gemm_bias is None \
                or not i.gemm_relu or (not chain and (
                    i.gemm_x is None or i.gemm_reshape is None)) \
                or (chain and (i.chain_geom is None or len(i.deps) != 1)):
            raise NotImplementedError(
                f"{group.mode} group {group.ops}: op {n!r} has no binding "
                f"with the views this mode's launch needs")


def _branch_lhs(group: ExecGroup, impls, env, names):
    """Per-branch GEMM lhs: a 2D tensor, or — for a pool-absorbed branch —
    the tuple of raw-input tap views (each mapped through the branch's
    ``gemm_x``) that the pooled launch maxes in-kernel.  Tap views are
    built once per absorbed pool op; a chain over ``POOL_TAP_LIMIT`` taps
    folds here, before the per-tap ``gemm_x`` mapping (max commutes with
    the gather/reshape views)."""
    from repro_torch.kernels.grouped_matmul import (POOL_TAP_LIMIT,
                                                    pool_from_taps,
                                                    pool_tap_views)
    pools = dict(group.pools)
    views: dict[str, Any] = {}
    xs = []
    for n in names:
        impl = impls[n]
        if n in pools:
            pname = pools[n]
            if pname not in views:
                pimpl = impls[pname]
                vs = pool_tap_views(_env_val(env, pimpl.deps[0]),
                                    pimpl.pool_chain)
                views[pname] = pool_from_taps(vs) \
                    if len(vs) > POOL_TAP_LIMIT else vs
            v = views[pname]
            xs.append(impl.gemm_x(v).contiguous() if not isinstance(v, list)
                      else tuple(impl.gemm_x(t) for t in v))
        else:
            xs.append(impl.gemm_x(*_dep_args(impl, env)).contiguous())
    return xs


def _dedup_buckets(impls, names, pools) -> list[list[str]]:
    """Order-preserving partial shared-X dedup: branches with equal
    (deps, gemm_x_key, K, absorbed pool) read the identical GEMM lhs and
    bucket together — each multi-branch bucket becomes one wide sub-GEMM
    of the launch (lhs read once, weights concatenated along N), e.g. an
    inception quad's 1x1/r3/r5 trio.  ``gemm_x_key is None`` never
    buckets."""
    buckets: list[list[str]] = []
    keyof: dict = {}
    for n in names:
        i = impls[n]
        key = None if i.gemm_x_key is None else (
            i.deps, i.gemm_x_key, i.gemm_w.shape[0], pools.get(n))
        if key is not None and key in keyof:
            buckets[keyof[key]].append(n)
        else:
            if key is not None:
                keyof[key] = len(buckets)
            buckets.append([n])
    return buckets


def _valid_rows(xs, valid_images, batch):
    """Per-group ragged-M row count: ``valid_images`` requests pack
    contiguously at the head of the batch axis, and every lhs of a group
    has M = batch * rows_per_image for ITS spatial extent — so the true
    row count is ``valid_images * (M // batch)``.  None when the launch
    is not ragged.

    Every lhs must agree on M and M must divide by ``batch`` — a silent
    floor here would hand the kernel a cutoff that splits an image and
    the masked launch would serve truncated rows as if they were real.
    """
    if valid_images is None:
        return None
    ms = {(x[0] if isinstance(x, (list, tuple)) else x).shape[0]
          for x in xs}
    if len(ms) != 1:
        raise ValueError(
            f"ragged group mixes lhs row counts {sorted(ms)} — "
            "valid-row masking needs one M per launch")
    return _valid_rows_from_m(ms.pop(), valid_images, batch)


def _valid_rows_from_m(m, valid_images, batch):
    """``_valid_rows`` from a known M (the chained path carries M as a
    python int rather than arrays)."""
    if valid_images is None:
        return None
    if m % batch != 0:
        raise ValueError(
            f"lhs M={m} is not a multiple of batch={batch} — "
            "rows_per_image would be fractional, so an image-aligned "
            "ragged cutoff cannot exist")
    return valid_images * (m // batch)


def _run_grouped(group: ExecGroup, impls: dict[str, OpImpl], env: dict,
                 valid_images=None, batch=None):
    """One grouped launch over the group's branches: shared-lhs buckets
    become one wide sub-GEMM each (weights and biases concatenated along
    N), pooled branches hand the launch their tap views, and bias+ReLU
    run in the kernel's epilogue.  Differentiable: the launch's backward
    is ONE combined launch (``kernels.ops``)."""
    from repro_torch.kernels.ops import grouped_matmul_pooled
    names = group.ops
    _require_views(group, impls, names)
    buckets = _dedup_buckets(impls, names, dict(group.pools))
    xs = _branch_lhs(group, impls, env, [bk[0] for bk in buckets])
    ws = [impls[bk[0]].gemm_w if len(bk) == 1 else
          torch.cat([impls[n].gemm_w for n in bk], dim=1) for bk in buckets]
    bs = [impls[bk[0]].gemm_bias if len(bk) == 1 else
          torch.cat([impls[n].gemm_bias for n in bk]) for bk in buckets]
    ys = grouped_matmul_pooled(xs, ws, bs, relu=True,
                               m_valid=_valid_rows(xs, valid_images, batch))
    for bk, y in zip(buckets, ys):
        off = 0
        for n in bk:
            nw = impls[n].gemm_w.shape[1]
            env[n] = impls[n].gemm_reshape(y[:, off:off + nw])
            off += nw


def _run_grouped_concat(group: ExecGroup, impls: dict[str, OpImpl],
                        env: dict, valid_images=None, batch=None):
    """Fused epilogue-concat: the kernel writes every in-launch branch's
    bias+ReLU output straight into its column slice of the join's
    (M, sum N_g) buffer; join inputs produced by earlier groups are
    handed to the same call as passthrough columns, copied in before the
    launch's result is saved for backward (``kernels.ops``), so autograd
    never sees the join written after the fact.  Only the join gets an
    env entry — the absorption condition makes the join every branch's
    sole consumer."""
    from repro_torch.kernels.ops import grouped_matmul_concat
    if group.pools:
        raise NotImplementedError(
            f"grouped_concat group {group.ops} absorbs pools: the pooled "
            f"concat launch is not ported")
    jimpl = impls[group.join]
    branches = [n for n in group.ops if n != group.join]
    _require_views(group, impls, branches)
    offs: dict[str, int] = {}
    off = 0
    for d in jimpl.deps:
        offs[d] = off
        off += impls[d].gemm_w.shape[1] if d in branches \
            else _env_val(env, d).shape[-1]
    order = [d for d in jimpl.deps if d in branches]
    passthrough = [d for d in jimpl.deps if d not in branches]
    xs = _branch_lhs(group, impls, env, order)
    y2d = grouped_matmul_concat(
        xs, [impls[n].gemm_w for n in order],
        [impls[n].gemm_bias for n in order],
        offsets=[offs[n] for n in order], total=off, relu=True,
        passthrough=[_env_val(env, d) for d in passthrough],
        pt_offsets=[offs[d] for d in passthrough],
        m_valid=_valid_rows(xs, valid_images, batch))
    env[group.join] = jimpl.gemm_reshape(y2d)


def _run_stacked(group: ExecGroup, impls: dict[str, OpImpl], env: dict):
    """Pad-to-max stacking: every branch's lhs and weight are zero-padded
    to the widest (K, N) so the uniform-shape K9 launch applies — the
    baseline the grouped mode exists to beat on ragged branches — and
    bias + ReLU run after the kernel on each branch's true columns (the
    reference's ``gemm_post``).  Differentiable: the backward is two K9
    launches (``kernels.ops.BranchMatmul``)."""
    from repro_torch.kernels.ops import branch_matmul
    names = group.ops
    _require_views(group, impls, names)
    xs = [impls[n].gemm_x(*_dep_args(impls[n], env)) for n in names]
    ws = [impls[n].gemm_w for n in names]
    if len({x.shape[0] for x in xs}) != 1:
        raise ValueError(f"stacked group {names}: branches differ in M "
                         f"{[x.shape[0] for x in xs]}")
    k_max = max(w.shape[0] for w in ws)
    n_max = max(w.shape[1] for w in ws)
    x = torch.stack([F.pad(x, (0, k_max - x.shape[1])) for x in xs])
    w = torch.stack([F.pad(w, (0, n_max - w.shape[1], 0,
                               k_max - w.shape[0])) for w in ws])
    ys = branch_matmul(x, w)
    for i, n in enumerate(names):
        impl = impls[n]
        y = ys[i, :, :impl.gemm_w.shape[1]] + impl.gemm_bias
        env[n] = impl.gemm_reshape(torch.relu(y))


def _pool_fold(v, chain):
    """Maxpool ``chain`` applied to an NHWC tensor or — per segment, since
    pooling commutes with the channel concat — to a ChainPanels
    composite, as ONE dense (B*OH*OW, C) lhs."""
    from repro_torch.kernels.grouped_matmul import (pool_from_taps,
                                                    pool_tap_views)
    if not isinstance(v, ChainPanels):
        p = pool_from_taps(pool_tap_views(v, chain))
        return p.reshape(-1, p.shape[-1]).contiguous()
    segs = []
    for pidx, cb, n in v.segments:
        seg = v.panels[pidx][:v.m, cb * v.blk: cb * v.blk + n]
        p = pool_from_taps(pool_tap_views(seg.reshape(-1, v.h, v.w, n),
                                          chain))
        segs.append(p.reshape(-1, n))
    return segs[0].contiguous() if len(segs) == 1 \
        else torch.cat(segs, dim=1)


def _panel_desc(v: ChainPanels):
    """Panel lhs-source descriptors of a ChainPanels consumed in place:
    one (panel, col block) per padded block in segment (= join) order,
    plus the true-channel row range of the consumer's weight each block
    covers (block rows past a segment's true width meet zero weight rows,
    so the panels' zero padding columns contribute nothing)."""
    blocks, ranges = [], []
    coff = 0
    for pidx, cb, n in v.segments:
        nbb = -(-n // v.blk)
        for j in range(nbb):
            blocks.append((pidx, cb + j))
            lo = coff + j * v.blk
            ranges.append((lo, min(coff + n, lo + v.blk)))
        coff += n
    return blocks, ranges


def _pad_w_dense(wmat, blk):
    """Row-pad a dense (K, N) weight to the k-step grid (ceil(K/blk)*blk
    rows) — the layout matching a dense x lhs's padded col blocks."""
    kb = -(-wmat.shape[0] // blk)
    return F.pad(wmat, (0, 0, 0, kb * blk - wmat.shape[0]))


def _pack_w_blocks(wmat, ranges, blk):
    """Weight rows in panel-descriptor k-step order: block s holds
    ``wmat[lo:hi]`` at its top (zero rows elsewhere), matching the
    consumed panel block's true channels."""
    buf = wmat.new_zeros((len(ranges) * blk, wmat.shape[1]))
    for s, (lo, hi) in enumerate(ranges):
        buf[s * blk: s * blk + hi - lo] = wmat[lo:hi]
    return buf


def _pack_w_ring(wmat, kh, kw, cin, nrc, blk):
    """Ring-consumer weight in tap-major / ring-col-minor k-step order:
    the (C, KH, KW)-ordered im2col weight ``wmat`` strided-sliced per tap
    (rows dh*kw+dw :: kh*kw give w[dh, dw]) and laid out per ring column
    block."""
    buf = wmat.new_zeros((kh * kw * nrc * blk, wmat.shape[1]))
    s = 0
    for dh in range(kh):
        for dw in range(kw):
            tap = wmat[dh * kw + dw::kh * kw]          # (cin, nout)
            for j in range(nrc):
                lo = j * blk
                if lo < cin:
                    hi = min(lo + blk, cin)
                    buf[s * blk: s * blk + hi - lo] = tap[lo:hi]
                s += 1
    return buf


def _panel_index(panels: list, arr) -> int:
    for i, p in enumerate(panels):
        if p is arr:
            return i
    panels.append(arr)
    return len(panels) - 1


def _run_grouped_chained(group: ExecGroup, impls: dict[str, OpImpl],
                         env: dict, valid_images=None, batch=None):
    """Execute a ``grouped_chained`` group as one chain of phases.

    Per-branch lhs sources, in preference order:
      ring   — dep is an earlier phase of THIS chain: the kernel reads the
               producer's output panel through shifted taps (KxK convs as
               K^2 tap GEMMs; weights repacked tap-major).
      pooled — dep is an absorbed pool: the pool folds outside the kernel
               (``_pool_fold``, per ChainPanels segment) into one dense lhs.
      panel  — dep is the previous chain's ChainPanels and the conv is
               pointwise: the kernel addresses the producer's padded
               panels in place (weights repacked per block).
      x      — anything else: the branch's own ``gemm_x`` view (the stem
               head's strided im2col), packed by the kernel wrapper.

    The chain's padded output panels become a ``ChainPanels`` env value
    under the join's name (or the last phase op's, for stem chains)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_chained
    blk = 128
    names = [n for ph in group.chain for n in ph]
    _require_views(group, impls, names, chain=True)
    if torch.is_grad_enabled() and any(
            t.requires_grad for n in names
            for t in (impls[n].gemm_w, impls[n].gemm_bias)):
        raise NotImplementedError(
            f"grouped_chained group {group.ops}: the chained launch has no "
            f"backward yet (chained training, ROADMAP queue 1); train "
            f"an unchained plan")
    pools = dict(group.pools)
    opset = set(names)
    consumed = {impls[n].deps[0] for n in names
                if impls[n].deps[0] in opset}
    ring_cols: dict[str, tuple] = {}
    nxt = 0
    for n in names:
        if n in consumed:
            nbb = -(-impls[n].gemm_w.shape[1] // blk)
            ring_cols[n] = tuple(range(nxt, nxt + nbb))
            nxt += nbb
    pooled: dict[str, Any] = {}
    for _b, pname in group.pools:
        if pname not in pooled:
            pimpl = impls[pname]
            pooled[pname] = _pool_fold(env[pimpl.deps[0]],
                                       pimpl.pool_chain)
    panels: list = []
    phase_dicts = []
    m = None
    geom = None
    for ph in group.chain:
        brs = []
        for n in ph:
            impl = impls[n]
            kh, kw, stride, cin, oh, ow = impl.chain_geom
            wmat = impl.gemm_w
            d = impl.deps[0]
            if d in opset:
                rcs = ring_cols[d]
                src = ("ring", kh, kw, rcs)
                wpk = _pack_w_ring(wmat, kh, kw, cin, len(rcs), blk)
            elif n in pools:
                x2d = pooled[pools[n]]
                src, wpk, m = ("x", [x2d]), _pad_w_dense(wmat, blk), \
                    x2d.shape[0]
            else:
                v = env[d]
                if isinstance(v, ChainPanels) and (kh, kw) == (1, 1) \
                        and stride == 1:
                    blocks, ranges = _panel_desc(v)
                    used = sorted({p for p, _ in blocks})
                    if len(used) <= 2:     # a chain addresses <= 2 panels
                        remap = {p: _panel_index(panels, v.panels[p])
                                 for p in used}
                        src = ("panel", [(remap[p], cb)
                                         for p, cb in blocks])
                        wpk, m = _pack_w_blocks(wmat, ranges, blk), v.m
                    else:
                        x2d = _materialize_chain(v).reshape(v.m, -1)
                        src, wpk, m = ("x", [x2d]), \
                            _pad_w_dense(wmat, blk), v.m
                else:
                    x2d = impl.gemm_x(_env_val(env, d)).contiguous()
                    src, wpk, m = ("x", [x2d]), _pad_w_dense(wmat, blk), \
                        x2d.shape[0]
            if geom is None:
                geom = (oh, ow)
            brs.append({"n": wmat.shape[1], "w": wpk, "b": impl.gemm_bias,
                        "src": src, "ring_write": ring_cols.get(n)})
        phase_dicts.append(brs)
    if m is None or geom is None:
        raise ValueError(f"chained group {group.ops} has no lhs source "
                         f"outside its own phases")
    mv = _valid_rows_from_m(m, valid_images, batch)
    outs = grouped_matmul_chained(phase_dicts, m=m, h=geom[0], w=geom[1],
                                  panels=tuple(panels), block=blk,
                                  m_valid=mv)
    lay: dict[str, tuple[int, int, int]] = {}
    for p, ph in enumerate(group.chain):
        cb = 0
        for n in ph:
            nout = impls[n].gemm_w.shape[1]
            lay[n] = (p, cb, nout)
            cb += -(-nout // blk)
    if group.join:
        out_name = group.join
        order = list(impls[group.join].deps)
    else:
        out_name = group.chain[-1][-1]
        order = [out_name]
    env[out_name] = ChainPanels(
        panels=tuple(outs), segments=tuple(lay[n] for n in order),
        m=m, h=geom[0], w=geom[1], blk=blk)


def _run_serial(group: ExecGroup, impls: dict[str, OpImpl], env: dict):
    """One op after another through its scheduled algorithm."""
    if group.pools:
        raise NotImplementedError(
            f"serial group {group.ops} carries absorbed pools")
    for name in group.ops:
        impl = impls[name]
        env[name] = impl.fn(*_dep_args(impl, env),
                            algorithm=group.algorithms.get(name))


def run_plan(impls: dict[str, OpImpl], env: dict, plan: Plan, *,
             valid_images=None) -> dict:
    """Execute a lowered plan over ``impls``; returns the op->value env.

    ``env`` seeds graph sources (ops with no deps); a group whose ops are
    all seeded is skipped.  ``valid_images`` (a python int) makes every
    grouped-family launch ragged-M: requests pack contiguously at the head
    of the batch axis and only the first ``valid_images`` images are real
    — each launch stores zeros past the group's true row count, and a
    chained launch does not run its M-blocks wholly past it.  It needs
    ``plan.context["batch"]`` (the bucket size the plan was lowered for).
    Batch elements never mix inside a launch (im2col, pooling and ring
    taps are image-local), so the first ``valid_images`` outputs equal the
    dense run's.  Serial groups run dense, as in the reference.
    """
    batch = plan.context.get("batch")
    if valid_images is not None and batch is None:
        raise ValueError("valid_images needs plan.context['batch'] "
                         "(the bucket size)")
    for group in plan.groups:
        pending = [n for n in group.ops if n not in env]
        if not pending:
            continue
        if len(pending) != len(group.ops):
            raise ValueError(f"group {group.ops} is partially seeded")
        mode = group.mode
        if mode in ("grouped", "grouped_pooled"):
            _run_grouped(group, impls, env, valid_images, batch)
        elif mode == "grouped_concat":
            _run_grouped_concat(group, impls, env, valid_images, batch)
        elif mode == "grouped_chained":
            _run_grouped_chained(group, impls, env, valid_images, batch)
        elif mode == "stacked":
            _run_stacked(group, impls, env)
        elif mode == "serial":
            _run_serial(group, impls, env)
        else:
            raise NotImplementedError(
                f"run_plan: mode {mode!r} (group {group.ops}) is not "
                f"ported; the port runs {RUN_MODES}")
    return env
