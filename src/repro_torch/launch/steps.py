"""Step functions (``repro/launch/steps.py``'s CNN serving step)."""
from __future__ import annotations

import torch


def make_cnn_serve_step(cfg, plan):
    """Inference step for the CNN serving path: one M-bucket's planned
    ragged forward.  ``plan`` must be lowered for the bucket's batch size
    (``core.plan_cache.cached_cnn_plan``); ``valid_images`` is a python
    int, so every request mix in the bucket runs the same plan and the
    same kernel tables.  It runs eagerly (no graph capture yet).  Returns
    (bucket, classes) logits whose rows at/past ``valid_images`` are
    padding."""
    from repro_torch.models import cnn as CNN

    @torch.no_grad()
    def serve_step(params, images, valid_images):
        return CNN.forward_plan(params, cfg, images, plan,
                                valid_images=valid_images)
    return serve_step
