"""Step functions (``repro/launch/steps.py``'s CNN train and serve
steps, and the optimizer they share)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.optim import AdamW, tree_leaves, tree_map


def train_config_for(cfg) -> TrainConfig:
    """Per-arch training knobs; bf16 moments above 100B parameters (the
    reference's rule; no port config is that large)."""
    opt_dtype = "bfloat16" if cfg.param_count() > 100e9 else "float32"
    return TrainConfig(opt_state_dtype=opt_dtype)


def make_optimizer(cfg, tc: TrainConfig | None = None) -> AdamW:
    tc = tc or train_config_for(cfg)
    return AdamW(lr=tc.lr, b1=tc.b1, b2=tc.b2,
                 weight_decay=tc.weight_decay, warmup=tc.warmup_steps,
                 total=tc.total_steps, clip_norm=tc.clip_norm,
                 state_dtype=tc.opt_state_dtype)


def to_device_batch(batch: dict, device) -> dict:
    """A data-pipeline batch (numpy or tensors) on ``device``: f32
    images, int64 labels."""
    return {"images": torch.as_tensor(np.asarray(batch["images"]),
                                      dtype=torch.float32).to(device),
            "labels": torch.as_tensor(np.asarray(batch["labels"])).long()
            .to(device)}


def cnn_loss_and_grads(params, cfg, batch, **kw):
    """(loss, grads): the CNN loss (``models.cnn.loss_fn``, ``kw`` passed
    on: ``plan=`` or ``algorithms=``) and its gradient with respect to
    every parameter, as a tree shaped like ``params`` — the counterpart
    of ``jax.value_and_grad(CNN.loss_fn)``."""
    from repro_torch.models import cnn as CNN
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, _ = CNN.loss_fn(live, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_cnn_train_step(cfg, optimizer: AdamW, *, plan=None,
                        algorithms=None, device=None):
    """Train step for the CNN family (the paper's native subject).

    ``plan`` is a ``core.plan.Plan`` from ``models.cnn.plan_cnn(...,
    train=True)`` — branch groups execute in their lowered co-execution
    mode and differentiate through the kernels' autograd Functions;
    ``plan=None`` runs the algorithms-dict path (``algorithms``; None is
    the plain torch forward).  ``device=None`` means the card (raises
    without one); batches move there.  The step is functional: it
    returns (new params, new optimizer state, metrics)."""
    dev = resolve_device(device)
    kw: dict = {"plan": plan} if plan is not None \
        else {"algorithms": algorithms}

    def train_step(params, opt_state, batch):
        loss, grads = cnn_loss_and_grads(params, cfg,
                                         to_device_batch(batch, dev), **kw)
        new_params, new_opt, info = optimizer.update(grads, opt_state,
                                                     params)
        return new_params, new_opt, {"loss": loss, **info}
    return train_step


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
