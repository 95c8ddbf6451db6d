"""CNN trainer: GoogLeNet trained through the execution plan.

The counterpart of the CNN branch of ``repro/launch/train.py``:

    python -m repro_torch.launch.train --arch googlenet --steps 4 \\
        --batch 8 --plan concurrent
    python -m repro_torch.launch.train --arch googlenet --reduced \\
        --steps 2 --batch 2 --plan concurrent --device cpu

``--plan concurrent`` lowers the scheduler's co-execution groups packed
at forward+backward cost (``models.cnn.plan_cnn(train=True)``); the
grouped launches differentiate through their autograd Functions, so the
plan covers the backward half too (its mirrored backward plan is
printed).  ``--plan none`` is the plain torch forward with torch
autograd.  ``--plan serial`` (the paper's serial baseline: singleton
groups, per-op-fastest algorithms) reaches algorithm-zoo kernels the
port does not have yet and raises.  Data is the reference's seeded
synthetic image stream, so both packages see the same batches.
Checkpointing and resume are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import Pipeline, SyntheticImages
from repro_torch.kernels.runtime import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import cnn as CNN


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan", default="none",
                    choices=["none", "serial", "concurrent"],
                    help="execution plan: the co-execution plan "
                         "(concurrent) or the plain forward (none)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    args = ap.parse_args(argv)
    if args.plan == "serial":
        raise NotImplementedError(
            "--plan serial: the serial baseline's per-op-fastest algorithms "
            "reach kernels not ported yet (split-K K8, stacked K9); see "
            "ROADMAP queue 1, '--plan serial with the zoo kernels it needs'")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: N={cfg.param_count() / 1e6:.2f}M params, "
          f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}")

    params = CNN.init_params(cfg, torch.Generator().manual_seed(args.seed),
                             dev)
    opt = dataclasses.replace(ST.make_optimizer(cfg), lr=args.lr,
                              total=args.steps,
                              warmup=max(args.steps // 20, 1))
    opt_state = opt.init(params)
    pipe = Pipeline(SyntheticImages(cfg.img, cfg.num_classes, args.batch,
                                    seed=args.seed))
    plan = None
    if args.plan == "concurrent":
        plan, _ = CNN.plan_cnn(cfg, args.batch, train=True)
        bwd = plan.context["backward"]
        print(f"[train] plan: modes={plan.mode_counts()} "
              f"modeled_makespan={plan.makespan * 1e3:.3f} ms "
              f"(TPU planner profile)")
        print(f"[train] backward plan: modes={bwd.mode_counts()} "
              f"modeled_makespan={bwd.makespan * 1e3:.3f} ms")
    step_fn = ST.make_cnn_train_step(cfg, opt, plan=plan, device=dev)

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
