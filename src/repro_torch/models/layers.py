"""Shared layer helpers (``repro/models/layers.py``'s counterparts)."""
from __future__ import annotations

import torch


def normal_init(generator: torch.Generator, shape, std: float,
                dtype=torch.float32, device=None):
    """N(0, std^2) draws from ``generator`` (drawn on the generator's own
    device, then moved to ``device``)."""
    t = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=generator.device)
    return (t * std).to(device)


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean token NLL; logits (..., V) any dtype, f32 reduction."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
