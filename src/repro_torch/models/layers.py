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
