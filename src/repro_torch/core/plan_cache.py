"""Plan + per-tile-table cache for serving.

The counterpart of ``repro/core/plan_cache.py``.  A warm serving request
pays no plan lowering and builds no kernel table: everything
shape-dependent is keyed once per (graph fingerprint, M-bucket, device
type, chain flag) and reused by every later request that lands in the
same bucket.  The port serves float32 only, so no dtype enters the key.

  lowered plan      ``PlanCacheEntry.plan``: the graph -> schedule ->
                    ExecGroup lowering of ``models.cnn.plan_cnn``, the
                    pure-python pass a request must never re-run.
  per-tile tables   the int32 tables the kernels read, built on the
                    device during the entry's first dispatch and kept,
                    keyed by launch shape, in the one registry
                    ``kernels.runtime.device_tables`` (the wrappers keep
                    the reference signatures and look them up there): a
                    warm dispatch finds the same device tensors and
                    builds none (``device_tables.builds`` stays put).
                    ``reset(clear_entries=True)`` drops them with the
                    plans.
  serve step        ``PlanCacheEntry.executable``: the bucket's eager
                    serve step (``launch.steps.make_cnn_serve_step``),
                    stored by the serving loop after its first use.

The cache is LRU-bounded (``CAPACITY`` entries).  ``graph_fingerprint``
hashes the op-DAG structure exactly as the reference does, so both
packages key the same graph identically.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any

from repro_torch.core.graph import OpGraph

#: LRU bound on cached entries.
CAPACITY = 32


def graph_fingerprint(graph: OpGraph) -> str:
    """Stable sha256 over the op-DAG: per-op (name, kind, sorted params,
    dtype_bytes, sorted preds), ops in sorted name order."""
    h = hashlib.sha256()
    for name in sorted(graph.ops):
        op = graph.ops[name]
        h.update(repr((op.name, op.kind, tuple(sorted(op.params)),
                       op.dtype_bytes,
                       tuple(sorted(graph.pred[name])))).encode())
    return h.hexdigest()


def plan_key(fingerprint: str, bucket: int, backend: str, *,
             chain_modules: bool = False) -> tuple:
    """The cache key: everything the lowered plan and the kernels' tables
    depend on.  ``bucket`` is the padded image count (M-bucket)."""
    return (fingerprint, int(bucket), backend, bool(chain_modules))


@dataclasses.dataclass
class PlanCacheEntry:
    plan: Any                      # core.plan.Plan (lowered for `bucket`)
    schedule: Any                  # the scheduler output it lowered from
    fingerprint: str
    bucket: int
    executable: Any = None         # serve step, set by the serving loop


_CACHE: "OrderedDict[tuple, PlanCacheEntry]" = OrderedDict()
_HITS = 0
_MISSES = 0
_EVICTIONS = 0


def stats() -> dict:
    total = _HITS + _MISSES
    return {"hits": _HITS, "misses": _MISSES, "entries": len(_CACHE),
            "hit_rate": (_HITS / total) if total else 0.0,
            "evictions": _EVICTIONS, "capacity": CAPACITY}


def _insert(key: tuple, entry: PlanCacheEntry) -> None:
    global _EVICTIONS
    _CACHE[key] = entry
    while len(_CACHE) > CAPACITY:
        _CACHE.popitem(last=False)              # least-recent first
        _EVICTIONS += 1


def reset(clear_entries: bool = False) -> None:
    """Zero the counters; ``clear_entries`` also drops the cached plans
    and the kernels' table registry (the serving loop's warmup boundary
    resets counters only)."""
    global _HITS, _MISSES, _EVICTIONS
    _HITS = _MISSES = _EVICTIONS = 0
    if clear_entries:
        from repro_torch.kernels.runtime import device_tables
        _CACHE.clear()
        device_tables.clear()


def _lookup(key: tuple) -> PlanCacheEntry | None:
    global _HITS
    entry = _CACHE.get(key)
    if entry is not None:
        _HITS += 1
        _CACHE.move_to_end(key)
    return entry


def cached_cnn_plan(cfg, bucket: int, *, backend="cuda",
                    chain_modules: bool = False) -> PlanCacheEntry:
    """(cfg, M-bucket) -> cached PlanCacheEntry.  ``build_graph`` runs on
    every call (cheap, and it yields the key); ``plan_cnn`` only on a
    miss.  The plan's ``context["batch"] == bucket``, which the ragged
    ``valid_images`` executor divides by."""
    global _MISSES
    from repro_torch.models import cnn

    fp = graph_fingerprint(cnn.build_graph(cfg, int(bucket)))
    key = plan_key(fp, bucket, backend, chain_modules=chain_modules)
    entry = _lookup(key)
    if entry is not None:
        return entry
    _MISSES += 1
    plan, sch = cnn.plan_cnn(cfg, int(bucket), chain_modules=chain_modules)
    entry = PlanCacheEntry(plan=plan, schedule=sch, fingerprint=fp,
                           bucket=int(bucket))
    _insert(key, entry)
    return entry
