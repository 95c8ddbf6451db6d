"""Ready-queue co-execution scheduling (paper C5) — the counterpart of
``repro/core/scheduler.py``.

"Selecting independent operations from the ready queue for concurrent
execution is a challenging scheduling problem that highly depends on the
network topology and resource utilization of operations."  This module is
that scheduler: Kahn's ready queue + list-scheduling by critical path,
packing ready ops into co-execution groups when (a) combined workspace and
VMEM fit the budgets and (b) the modeled co-execution makespan beats serial
execution.  Algorithm choice inside each group delegates to the
concurrency-aware selector.

A ``Schedule`` is a *decision*, not an execution: ``core/plan.py::lower``
turns it into an executable Plan (stacked / fused / spatial / serial / xla
per group) — without that lowering the co-execution choices never reach a
kernel, which is precisely the framework flaw the paper documents.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.core import cost_model as cm
from repro_torch.core import selector as sel
from repro_torch.core.graph import OpGraph

#: Most ops packed into one co-execution group (the reference's default).
MAX_GROUP = 4


@dataclasses.dataclass
class CoGroup:
    ops: list[str]
    algorithms: dict[str, str]
    time: float                      # modeled group makespan
    serialized: bool = False         # True if budgets forced serial fallback


@dataclasses.dataclass
class Schedule:
    groups: list[CoGroup]

    @property
    def makespan(self) -> float:
        return sum(g.time for g in self.groups)

    @property
    def algorithms(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for g in self.groups:
            out.update(g.algorithms)
        return out


def schedule(graph: OpGraph, *, train: bool = False) -> Schedule:
    """List-schedule the DAG into co-execution groups of at most
    ``MAX_GROUP`` ops under the planner's C2 budgets.

    train=True packs for the whole training step: candidate groups are
    judged (and CoGroup times recorded) at forward PLUS backward cost —
    the grad CoGroup mirrors the forward packing — so a group only forms
    when co-execution wins in both directions AND each direction's
    launch fits the C2 budgets on its own (matching
    ``plan.lower(train=True)``).
    """

    @functools.cache
    def bwd_serial(name: str) -> float:
        # memoized: the greedy packer re-prices the same op across
        # O(ready * max_group) candidate extensions
        op = graph.ops[name]
        return sum(p.time
                   for p in cm.backward_profiles(op, cm.best_algorithm(op)[0]))

    def bwd_feasible(ops, algs) -> bool:
        return sel._group_feasible(
            [p for op in ops
             for p in cm.backward_profiles(op, algs[op.name])])

    fastest = sel.select_fastest(graph)
    prio = graph.critical_path_weights(
        lambda op: fastest.profiles[op.name].time)

    indeg = {n: len(graph.pred[n]) for n in graph.ops}
    ready = sorted([n for n, d in indeg.items() if d == 0],
                   key=lambda n: -prio[n])
    groups: list[CoGroup] = []

    while ready:
        pool_ready = [n for n in ready
                      if graph.ops[n].kind == "maxpool"]
        if pool_ready:
            # Pooling primitives launch immediately as singletons: they
            # gate the fork's GEMM branches (draining them first exposes
            # the full branch width to the packer — else the pool-proj
            # conv surfaces one level late and misses its quad), and no
            # co-execution kernel runs a reduce_window — a maxpool's
            # co-execution story is ABSORPTION into the consuming grouped
            # launch, decided at lowering (plan._absorb_pools), never XLA
            # interleave.
            chosen = [pool_ready[0]]
            ready.remove(pool_ready[0])
        else:
            # Greedy pack: seed with the most critical ready op, then add
            # ready ops while the modeled group time improves on serial and
            # budgets hold.
            chosen = [ready.pop(0)]
            i = 0
            while i < len(ready) and len(chosen) < MAX_GROUP:
                cand = chosen + [ready[i]]
                ops = [graph.ops[n] for n in cand]
                algs, _ = sel.select_for_group(ops)
                t_serial = sum(
                    cm.best_algorithm(graph.ops[n])[1] for n in cand)
                profs = [cm.profile(graph.ops[n], algs[n]) for n in cand]
                # Judge the candidate at the mode a kernel can actually
                # realize (grouped/stacked/fused vs XLA interleave), not at
                # the ideal co-execution overlap: ragged GEMM branches keep
                # their full win (grouped has no padding-waste term) while
                # heterogeneous groups stop looking better than they run.
                _, t_group = cm.group_execution_time(ops, profs)
                if train:
                    t_serial += sum(bwd_serial(n) for n in cand)
                    t_group += cm.group_execution_time_bwd(ops, algs)[1]
                feasible = sel._group_feasible(profs)
                if train and feasible:
                    # mirror lower(train=True): the backward launch must
                    # fit the budgets on its own, or the lowered plan
                    # demotes the group this packing relied on
                    feasible = bwd_feasible(ops, algs)
                if feasible and t_group < t_serial * 0.98:
                    chosen = cand
                    ready.pop(i)
                else:
                    i += 1
        ops = [graph.ops[n] for n in chosen]
        algs, _ = sel.select_for_group(ops)
        profs = [cm.profile(graph.ops[n], algs[n]) for n in chosen]
        # Record the realizable-mode makespan (lower() re-derives the mode
        # itself — budgets can still override it there).
        _, t = cm.group_execution_time(ops, profs)
        if train:
            t += cm.group_execution_time_bwd(ops, algs)[1]
        serialized = (len(chosen) > 1 and not (
            sel._group_feasible(profs)
            and (not train or bwd_feasible(ops, algs))))
        if serialized:
            t = cm.serial_time(profs)
            if train:
                t += sum(bwd_serial(n) for n in chosen)
        groups.append(CoGroup(chosen, algs, t, serialized))
        # retire
        for n in chosen:
            for s in sorted(graph.succ[n]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        ready.sort(key=lambda n: -prio[n])
    return Schedule(groups)

