"""Algorithm selection — per-op-fastest vs concurrency-aware (paper C3);
the counterpart of ``repro/core/selector.py``.

Two policies:

  select_fastest    — what TF r1.10 does (paper Sec 2.1): per-op argmin of
                      modeled time, ignoring workspace and co-execution.
  select_for_group  — the paper's proposal, per co-execution group: jointly
                      choose algorithms minimizing the *group makespan*
                      under the co-execution model, subject to the
                      HBM-workspace and VMEM budgets (C2/C4,
                      ``cost_model.HBM_BUDGET``/``VMEM_BUDGET``).  Small
                      product spaces are solved exactly, larger ones
                      greedily.
"""
from __future__ import annotations

import dataclasses
import itertools

from repro_torch.core import cost_model as cm
from repro_torch.core.graph import Op, OpGraph


@dataclasses.dataclass
class Selection:
    """algorithm choice + modeled profile per op."""
    algorithms: dict[str, str]
    profiles: dict[str, cm.OpProfile]

    def time(self, name: str) -> float:
        return self.profiles[name].time


def select_fastest(graph: OpGraph) -> Selection:
    algs, profs = {}, {}
    for name, op in graph.ops.items():
        a, _ = cm.best_algorithm(op)
        algs[name] = a
        profs[name] = cm.profile(op, a)
    return Selection(algs, profs)


def _group_feasible(profiles: list[cm.OpProfile]) -> bool:
    return (sum(p.workspace_bytes for p in profiles) <= cm.HBM_BUDGET
            and sum(p.vmem_bytes for p in profiles) <= cm.VMEM_BUDGET)


def select_for_group(ops: list[Op]) -> tuple[dict[str, str], float]:
    """Joint algorithm choice minimizing co-execution makespan for one group.

    Returns ({op: algorithm}, modeled group time).  If no combination fits
    the budgets, falls back to per-op-fastest run *serially* (the paper's
    C2: workspace exhaustion forces serialization).
    """
    if len(ops) == 1:
        a, t = cm.best_algorithm(ops[0])
        return {ops[0].name: a}, t

    spaces = [cm.supported_algorithms(op) for op in ops]
    best: tuple[float, dict[str, str]] | None = None
    n_combos = 1
    for s in spaces:
        n_combos *= len(s)
    if n_combos <= 256:
        combos = itertools.product(*spaces)
    else:  # greedy: fastest for op 0, then coordinate descent
        combos = [_greedy_combo(ops, spaces)]
    for combo in combos:
        profs = [cm.profile(op, a) for op, a in zip(ops, combo)]
        if not _group_feasible(profs):
            continue
        t = cm.co_execution_time(profs)
        if best is None or t < best[0]:
            best = (t, dict(zip((o.name for o in ops), combo)))
    if best is None:  # C2: nothing fits together -> serialize
        sel = {}
        t = 0.0
        for op in ops:
            a, ti = cm.best_algorithm(op)
            sel[op.name] = a
            t += ti
        return sel, t
    return best[1], best[0]


def _greedy_combo(ops, spaces):
    combo = [cm.best_algorithm(op)[0] for op in ops]
    improved = True
    while improved:
        improved = False
        for i, op in enumerate(ops):
            cur = list(combo)
            base_profs = [cm.profile(o, a) for o, a in zip(ops, cur)]
            base = cm.co_execution_time(base_profs) \
                if _group_feasible(base_profs) \
                else float("inf")
            for a in spaces[i]:
                cur[i] = a
                profs = [cm.profile(o, aa) for o, aa in zip(ops, cur)]
                if not _group_feasible(profs):
                    continue
                t = cm.co_execution_time(profs)
                if t < base:
                    base = t
                    combo = list(cur)
                    improved = True
    return tuple(combo)

