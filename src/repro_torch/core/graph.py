"""Op-level computation graph with fork/join structure (paper C1/C5);
the counterpart of ``repro/core/graph.py``.

The paper's subject is the DAG a DL framework builds at op granularity
(conv / matmul / attention / ...) and the *independent chains* a non-linear
topology exposes.  ``OpGraph`` is that DAG: nodes carry enough shape
information for the analytic cost model, edges are data dependencies, and
the ready-queue view (`levels`, `ready_after`) is what the scheduler packs
into co-execution groups.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class Op:
    """One schedulable operator.

    kind/params drive the cost model:
      matmul:    m, k, n
      conv2d:    n, h, w, c, kh, kw, k, stride
      attention: b, sq, skv, hq, hkv, d
      ssd:       b, s, h, p, g, n
      pointwise: elements
    """
    name: str
    kind: str
    params: tuple  # sorted (key, value) pairs — hashable
    dtype_bytes: int = 2

    @property
    def p(self) -> dict:
        return dict(self.params)

    @staticmethod
    def make(name: str, kind: str, dtype_bytes: int = 2, **params) -> "Op":
        return Op(name, kind, tuple(sorted(params.items())), dtype_bytes)


class OpGraph:
    """DAG of Ops with fork/join queries."""

    def __init__(self):
        self.ops: dict[str, Op] = {}
        self.succ: dict[str, set[str]] = defaultdict(set)
        self.pred: dict[str, set[str]] = defaultdict(set)

    def add(self, op: Op, deps: Iterable[str] = ()) -> Op:
        if op.name in self.ops:
            raise ValueError(f"duplicate op {op.name}")
        self.ops[op.name] = op
        for d in deps:
            if d not in self.ops:
                raise ValueError(f"unknown dep {d} for {op.name}")
            self.succ[d].add(op.name)
            self.pred[op.name].add(d)
        return op

    # -- topology ----------------------------------------------------------

    def levels(self) -> list[list[str]]:
        """ALAP-free BFS levels: ops in the same level are independent
        *if* they share the level (sufficient, not necessary)."""
        indeg = {n: len(self.pred[n]) for n in self.ops}
        q = deque(sorted(n for n, d in indeg.items() if d == 0))
        out = []
        while q:
            nxt = []
            level = sorted(q)
            q.clear()
            out.append(level)
            for n in level:
                for s in sorted(self.succ[n]):
                    indeg[s] -= 1
                    if indeg[s] == 0:
                        nxt.append(s)
            for n in nxt:
                q.append(n)
        return out

    def independent(self, a: str, b: str) -> bool:
        """True iff neither op reaches the other (co-schedulable)."""
        return not self._reaches(a, b) and not self._reaches(b, a)

    def _reaches(self, src: str, dst: str) -> bool:
        seen, stack = set(), [src]
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            for s in self.succ[n]:
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return False

    def independent_sets(self) -> list[list[str]]:
        """Maximal antichains found greedily per level (the paper's
        'independent operations across layers' — 27 cases in GoogleNet)."""
        return [lvl for lvl in self.levels() if len(lvl) > 1]

    def critical_path_weights(self, time_fn) -> dict[str, float]:
        """Longest path to exit under ``time_fn(op)`` — list-scheduling
        priority."""
        order = [n for lvl in self.levels() for n in lvl]
        w: dict[str, float] = {}
        for n in reversed(order):
            tail = max((w[s] for s in self.succ[n]), default=0.0)
            w[n] = time_fn(self.ops[n]) + tail
        return w

    def __len__(self):
        return len(self.ops)
