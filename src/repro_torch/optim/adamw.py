"""AdamW over parameter trees, cosine schedule, global-norm clipping
(``repro/optim/adamw.py``'s), as plain functions over nested dicts and
lists of tensors.

The update is the reference's, not ``torch.optim.AdamW``'s: the
schedule is computed from the 1-based step count, gradients are clipped
by their global norm first, weight decay is added into the update
(``delta``) rather than applied to the parameter, the moments are bias
corrected, and ``eps`` sits outside the square root.  It is functional,
like the reference: ``update`` returns new parameter and moment trees.
Schedule scalars are float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def tree_leaves(tree) -> list:
    """Tensors of a nested dict/list/tuple tree, in a fixed order (dict
    keys sorted, as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the same-shaped trees
    ``rest``), keeping the nesting; leaves are visited in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def cosine_schedule(step, *, lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_frac * lr``; a float32
    0-d tensor on the CPU."""
    step = _f32(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return lr * warm * cos


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to global norm <= ``max_norm``, the global norm as a
    float32 0-d tensor on the grads' device)."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    total: int = 1000
    clip_norm: float = 1.0
    state_dtype: str = "float32"

    def init(self, params) -> dict:
        dt = getattr(torch, self.state_dtype)
        return {"step": 0,
                "m": tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                              params),
                "v": tree_map(lambda p: torch.zeros_like(p, dtype=dt),
                              params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step: returns (new params, new state, {"lr", "grad_norm"})
        with ``lr`` a python float and ``grad_norm`` a 0-d tensor."""
        step = state["step"] + 1
        lr = cosine_schedule(step, lr=self.lr, warmup=self.warmup,
                             total=self.total)
        grads, gnorm = clip_by_global_norm(grads, self.clip_norm)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - _f32(b1) ** _f32(step)
        bc2 = 1 - _f32(b2) ** _f32(step)
        lr_f, bc1_f, bc2_f = float(lr), float(bc1), float(bc2)

        def upd(p, g, m, v):
            gf = g.float()
            m_new = b1 * m.float() + (1 - b1) * gf
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            mhat = m_new / bc1_f
            vhat = v_new / bc2_f
            delta = mhat / (torch.sqrt(vhat) + self.eps) \
                + self.weight_decay * p.float()
            p_new = p.float() - lr_f * delta
            return (p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype))

        out = tree_map(upd, params, grads, state["m"], state["v"])
        return _pick(out, 0), {"step": step, "m": _pick(out, 1),
                               "v": _pick(out, 2)}, \
            {"lr": lr_f, "grad_norm": gnorm}


def _pick(tree, i):
    """Element ``i`` of every (param, m, v) triple in ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
