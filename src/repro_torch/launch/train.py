"""Trainer: GoogLeNet through the execution plan, and the language
models (granite-moe-1b-a400m, mamba2-370m and the attention-only LMs).

The counterpart of ``repro/launch/train.py``, with its flags and
defaults:

    python -m repro_torch.launch.train --arch googlenet --steps 4 \\
        --batch 8 --plan concurrent
    python -m repro_torch.launch.train --arch googlenet --steps 4 \\
        --batch 8 --plan serial
    python -m repro_torch.launch.train --arch googlenet --reduced \\
        --steps 2 --batch 2 --plan concurrent --device cpu
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --steps 4 --batch 4 --seq 512
    python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --reduced --steps 2 --batch 2 --seq 16 --device cpu

CNN: ``--plan concurrent`` lowers the scheduler's co-execution groups
packed at forward+backward cost (``models.cnn.plan_cnn(train=True)``);
the grouped launches differentiate through their autograd Functions, so
the plan covers the backward half too (its mirrored backward plan is
printed).  ``--plan serial`` re-plans with concurrency off
(``plan_cnn(concurrent=False, train=True)``: every op its own group at
its per-op-fastest algorithm — the paper's serial baseline).  ``--plan
none`` is the plain torch forward with torch autograd.  The stacked
baseline (``plan_cnn(fuse_pool=False)``) is a library call only, as in
the reference.

Language models: ``make_train_step`` with ``--impl`` (``xla``; ``pallas``
raises: attention would need the backward of the flash-attention kernel
K13 and a mamba mixer that of the SSD chunk kernel K14, which the
reference has not either) and no remat, as the reference trainer runs
them; the MoE layers use the reference's default engine (einsum).

Data is the reference's seeded synthetic stream, so both packages see
the same batches.  Checkpointing and resume are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import Pipeline, SyntheticImages, SyntheticLM
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import cnn as CNN
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--plan", default="none",
                    choices=["none", "serial", "concurrent"],
                    help="CNN-family execution plan: lower the schedule "
                         "to core/plan.py ExecGroups (concurrent), keep it "
                         "serial (the paper's baseline), or bypass "
                         "planning (none)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    is_cnn = cfg.family == "cnn"
    if not is_cnn and args.impl == "pallas":
        raise NotImplementedError(
            "--impl pallas differentiates the SSD chunk kernel (K14), which "
            "has no backward (nor has the reference's); use --impl xla"
            if cfg.is_attention_free else
            "--impl pallas differentiates the flash-attention kernel (K13, "
            "repro/kernels/flash_attention.py::_flash_kernel), which has no "
            "backward (nor has the reference's); use --impl xla")
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: N={cfg.param_count() / 1e6:.2f}M params, "
          f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    gen = torch.Generator().manual_seed(args.seed)
    params = CNN.init_params(cfg, gen, dev) if is_cnn \
        else T.init_params(cfg, gen, dev)
    opt = dataclasses.replace(ST.make_optimizer(cfg), lr=args.lr,
                              total=args.steps,
                              warmup=max(args.steps // 20, 1))
    opt_state = opt.init(params)
    if is_cnn:
        if args.impl != "xla":
            print(f"[train] --impl {args.impl} ignored for CNN arch "
                  "(kernel choice comes from the plan)")
        pipe = Pipeline(SyntheticImages(cfg.img, cfg.num_classes,
                                        args.batch, seed=args.seed))
        plan = None
        if args.plan != "none":
            # the plan covers the whole training step, not just forward
            plan, _ = CNN.plan_cnn(cfg, args.batch,
                                   concurrent=args.plan == "concurrent",
                                   train=True)
            bwd = plan.context["backward"]
            print(f"[train] plan: modes={plan.mode_counts()} "
                  f"modeled_makespan={plan.makespan * 1e3:.3f} ms "
                  f"(TPU planner profile)")
            print(f"[train] backward plan: modes={bwd.mode_counts()} "
                  f"modeled_makespan={bwd.makespan * 1e3:.3f} ms")
        step_fn = ST.make_cnn_train_step(cfg, opt, plan=plan, device=dev)
    else:
        if args.plan != "none":
            print(f"[train] --plan {args.plan} ignored for non-CNN arch")
        pipe = Pipeline(SyntheticLM(cfg.vocab, args.seq, args.batch,
                                    seed=args.seed))
        step_fn = ST.make_train_step(cfg, opt, impl=args.impl, remat=False,
                                     device=dev)

    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        params, opt_state, metrics = step_fn(params, opt_state, next(pipe))
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / args.log_every
            print(f"step {step + 1:5d} loss={losses[-1]:.4f} "
                  f"lr={metrics['lr']:.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f} ms/step", flush=True)
            t0 = time.perf_counter()
    first = np.mean(losses[:10]) if len(losses) >= 10 else losses[0]
    last = np.mean(losses[-10:])
    print(f"[train] done. loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
