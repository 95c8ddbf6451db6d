"""Step functions (``repro/launch/steps.py``'s language-model train,
prefill and decode steps, the CNN train and serve steps, and the
optimizer they share)."""
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
    images or int64 tokens, and int64 labels."""
    out = {"labels": torch.as_tensor(np.asarray(batch["labels"])).long()
           .to(device)}
    if "images" in batch:
        out["images"] = torch.as_tensor(np.asarray(batch["images"]),
                                        dtype=torch.float32).to(device)
    if "tokens" in batch:
        out["tokens"] = torch.as_tensor(np.asarray(batch["tokens"])).long() \
            .to(device)
    return out


def loss_and_grads(loss_fn, params, cfg, batch, **kw):
    """(loss, parts, grads): ``loss_fn(params, cfg, batch, **kw)`` (which
    returns (loss, parts)) and its gradient with respect to every
    parameter, as a tree shaped like ``params`` — the counterpart of
    ``jax.value_and_grad(loss_fn, has_aux=True)``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, parts = loss_fn(live, cfg, batch, **kw)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    parts = {k: v.detach() if torch.is_tensor(v) else v
             for k, v in parts.items()}
    return loss.detach(), parts, tree_map(lambda _: next(it), params)


def cnn_loss_and_grads(params, cfg, batch, **kw):
    """(loss, grads) of the CNN loss (``models.cnn.loss_fn``, ``kw``
    passed on: ``plan=`` or ``algorithms=``)."""
    from repro_torch.models import cnn as CNN
    loss, _, grads = loss_and_grads(CNN.loss_fn, params, cfg, batch, **kw)
    return loss, grads


def make_train_step(cfg, optimizer: AdamW, *, impl="xla", remat=True,
                    moe_aux_weight=0.01, moe_impl="einsum", device=None):
    """Train step for the language models (``models.transformer``):
    ``loss_fn`` (cross-entropy + ``moe_aux_weight`` * the MoE
    load-balancing loss), its gradient by autograd, and one AdamW update
    (global-norm clipping, cosine schedule with warmup).  ``moe_impl``
    picks the MoE expert engine: ``"einsum"`` (plain torch) or
    ``"grouped"`` (the K11/K12 kernels); it is the one keyword the
    reference's ``make_train_step`` lacks.  ``device=None`` means the
    card (raises without one); batches move there.  The step is
    functional: it returns (new params, new optimizer state, metrics)."""
    from repro_torch.models import transformer as T
    dev = resolve_device(device)

    def train_step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(
            T.loss_fn, params, cfg, to_device_batch(batch, dev), impl=impl,
            moe_impl=moe_impl, remat=remat, moe_aux_weight=moe_aux_weight)
        new_params, new_opt, info = optimizer.update(grads, opt_state,
                                                     params)
        return new_params, new_opt, {"loss": loss, **parts, **info}
    return train_step


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


def make_prefill_step(cfg, *, impl="xla"):
    """Prompt prefill for the language models: ``prefill_step(params,
    tokens, cache) -> (last-token logits (B, V), new cache)``
    (``models.transformer.prefill``).  ``impl="pallas"`` runs a mamba
    block's chunked SSD on K14; ``"xla"`` is plain torch."""
    from repro_torch.models import transformer as T

    def prefill_step(params, tokens, cache):
        return T.prefill(params, cfg, tokens, cache, impl=impl)
    return prefill_step


def make_decode_step(cfg, *, impl="xla"):
    """One decode step: ``decode_step(params, cache, tokens (B, 1), pos)
    -> (logits (B, 1, V), new cache)`` (``models.transformer.
    decode_step``; plain torch on every impl, as in the reference)."""
    from repro_torch.models import transformer as T

    def decode_step(params, cache, tokens, pos):
        return T.decode_step(params, cfg, cache, tokens, pos, impl=impl)
    return decode_step
