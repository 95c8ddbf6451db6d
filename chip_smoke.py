#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # only: where a warm dispatch's
                                       # time goes, per serving bucket,
                                       # a warm training step's (the
                                       # concurrent, serial and stacked
                                       # plans) and a warm grouped MoE
                                       # step's

Phases, each failing loudly (no caught failure, no exit 0 after one):

  1. device   require CUDA; print the card's name and power limit; turn
              TF32 off for matmuls and cuDNN convolutions (f32 references).
  2. build    compile the CUDA kernels from ``src/repro_torch/csrc``
              (one nvcc per source, in parallel) and print the seconds.
  3. kernels  capture every kernel wrapper's arguments from the main
              paths: K1, K2, K3 and K6 from one planned full-width
              GoogLeNet forward at bucket 1 and one at bucket 2 (serving),
              K1-K5 from one planned full-width training step (forward +
              backward, batch 8), K9 from one stacked-plan training step
              (``plan_cnn(fuse_pool=False, train=True)``: its 3 forward
              and 6 backward calls), K11 and K12 from one grouped-engine
              training step of full-width granite-moe-1b-a400m (every
              one of its 24 layers; the phase 5b model and batch); then
              hold each kernel against its plain
              torch version on the same inputs, each output tensor on its
              own (a branch's columns of a joint output, K5's dx, dw
              and db, K9's branches, K11's y and in/gate pre-activations,
              K12's dx, dW_in, dW_gate and dW_out, apart): max abs error
              <= 1e-3 * max|ref| + 1e-9.
              Time the wrapper (CUDA events around the whole call, fills
              and per-phase host gaps included), its kernels' own device
              time (``torch.profiler``), the plain version and a torch
              library yardstick (``torch.bmm`` for K9; for K11/K12: the
              capacity-padded einsum engine's expert GEMMs of the same
              layer).  K11 and K12 are
              also held, untimed, at every block size bm 8..128 on small
              synthetic packings (``check_expert_block_sizes``).
  4. logits   the planned forward with kernels at buckets 1, 2 and 4
              (bucket 4 also ragged, 3 real images) against the port's
              plain ``forward`` on the card.
  5. training full-width GoogLeNet, batch 8, seed 0: 4 AdamW steps of
              the planned path (``plan_cnn(train=True)``, f32 kernels),
              of the plain path (plain ``forward``, torch autograd) with
              float64 forward/backward (AdamW computes in f32 and rounds
              the parameters to f32 each step) and of the plain path in
              f32 (no TF32), from the same init and batches.  Held to
              the float64 run: losses per step within 1e-3 relative; at
              every step the gradients taken on the float64 run's
              parameters within 1e-3 * max|ref| + 1e-6 per parameter.
              The free-running parameters after step 4 are printed, not
              checked (see ``check_training``).  Launch counters are set
              to 0 just before the planned steps and read just after;
              every planned step must launch K1 9, K2 9, K3 2, K4 6, K5
              18 and K6 0 times.  Prints the step time (median of steps
              2-4) and images/s.
              Then the paper's two baselines, 4 AdamW steps each from the
              same init and batches, counters set to 0 just before and
              read just after: the serial plan (``plan_cnn(concurrent=
              False, train=True)``: K3 51 and K4 119 launches per step)
              and the stacked plan (``plan_cnn(fuse_pool=False,
              train=True)``: K1 9, K2 6, K3 2, K4 6, K5 15, K9 9), each
              count also derived from the plan.  Held: losses within 1e-3
              relative of the float64 run; at every step the gradients
              within 1e-3 * max|ref| + 1e-6 of a float64 reference on the
              planned forward's own pieces (``pieces_grads64``: the plain
              forward in float64 with each ReLU taken on the planned f32
              forward's on/off pattern and each max-pool at the element
              it chose), so the check measures rounding, not which side
              of a kink a value of 1e-8 fell on.  Printed beside it, not
              held: both paths against the plain float64 run and the
              ReLU and pool-choice flips between the planned f32 and the
              plain float64 forward.  Prints every plan's step time,
              images/s and peak memory.
  5b. moe training  full-width granite-moe-1b-a400m (24 layers, 32
              experts top-8), batch 4 x seq 512, ``SyntheticLM`` seed 0,
              parameters from ``torch.Generator().manual_seed(0)``, f32
              with TF32 off.  At step 1, on equal parameters: every
              gradient of the grouped engine (K11/K12) and of the plain
              einsum engine finite; printed, not held, each parameter's
              gradient error against the einsum engine over 1e-3 *
              max|ref| + 1e-6, and the (token, layer) pairs whose expert
              set differs between the two runs (kernel rounding can flip
              a near-tie in a later layer's top-8).  Then 3 AdamW steps of
              ``make_train_step(..., moe_impl="grouped")`` (no remat, as
              the trainer runs) with launch counters set to 0 just before
              and read just after, and 3 of the einsum engine, from the
              same init and batches.  Held: losses within 1e-3 relative at
              every step, finite gradient norms, and exactly 24 K11 and 24
              K12 wrapper calls (two CUDA launches each) and no K1-K6
              launch per grouped step.  Prints step time (median of steps
              2-3), tokens/s and peak memory for both engines.
  6. serving  ``serve_cnn_metrics(full googlenet, max_images=4,
              requests=12, seed=SERVE_SEED)`` with every launch counter
              set to 0 just before and read just after: hit rate 1.0,
              every image served, the measured stream (not only its
              warmup) dispatches at every bucket of the ladder, and each
              of the four kernels launches in it.  Launches per dispatch
              are printed per bucket, warmup and measured apart.
  7. report   one JSON line of kernels (launches of K1-K3 and K6 from the
              serving run, of K4 and K5 from the planned training steps,
              of K9 from the stacked-plan training steps, of K11 and K12
              from the grouped MoE training steps),
              the card line again, and last the ``{"ok": true, ...}``
              line.

It imports nothing of the JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# kernel vs plain, each output tensor (a branch's columns, dx, dw and db)
# on its own: max abs err <= TOL * max|ref| + FLOOR
TOL, FLOOR = 1e-3, 1e-9
LOGIT_RTOL = 1e-3      # logits: max abs err <= LOGIT_RTOL * max|ref| + 1e-6
PEAK_F32 = 67e12       # H100 SXM, f32 outside the tensor cores (FLOP/s)
PEAK_BW = 3.35e12      # H100 SXM HBM3 (B/s)
# The seeded 12-request stream (1..5 images each, max_images=4) admits
# into dispatches at all of buckets 1, 2 and 4 with this seed, so the
# measured stream runs every plan of the ladder; seed 0's does not reach
# bucket 1, the only bucket whose plan launches K1, K2 and K3.
SERVE_SEED = 17
REPLACES = {
    "grouped_matmul_concat":
        "src/repro/kernels/grouped_matmul.py:211 (_gmm_kernel)",
    "grouped_matmul_pooled":
        "src/repro/kernels/grouped_matmul.py:749 (_gmm_pooled_kernel)",
    "conv2d_direct": "src/repro/kernels/conv2d.py:99 (_direct_kernel)",
    "grouped_matmul_chained":
        "src/repro/kernels/grouped_matmul.py:1657 (_gmm_chained_kernel)",
    "matmul": "src/repro/kernels/matmul.py:31 (_mm_kernel)",
    "grouped_matmul_bwd":
        "src/repro/kernels/grouped_matmul.py:1292 (_gmm_bwd_kernel)",
    "grouped_matmul_experts":
        "src/repro/kernels/grouped_matmul.py:2203 (_gmm_experts_kernel)",
    "grouped_matmul_experts_bwd":
        "src/repro/kernels/grouped_matmul.py:2422 (_gmm_experts_bwd_kernel)",
    "branch_matmul": "src/repro/kernels/branch_matmul.py:23 (_bmm_kernel)",
}
# the CUDA function each wrapper launches, as the profiler names it
KERNEL_FUNCS = {
    "grouped_matmul_concat": "gmm_kernel",
    "grouped_matmul_pooled": "gmm_kernel",
    "conv2d_direct": "conv2d_direct_kernel",
    "grouped_matmul_chained": "gmm_chained_kernel",
    "matmul": "matmul_kernel",
    "grouped_matmul_bwd": "gmm_bwd_kernel",
    # two stages each: experts_h/experts_y, experts_dh/experts_dxw
    "grouped_matmul_experts": "experts_",
    "grouped_matmul_experts_bwd": "experts_",
    "branch_matmul": "bmm_kernel",
}
SOURCES = {
    "grouped_matmul_concat": "src/repro_torch/csrc/grouped_matmul.cu",
    "grouped_matmul_pooled": "src/repro_torch/csrc/grouped_matmul.cu",
    "conv2d_direct": "src/repro_torch/csrc/conv2d.cu",
    "grouped_matmul_chained":
        "src/repro_torch/csrc/grouped_matmul_chained.cu",
    "matmul": "src/repro_torch/csrc/matmul.cu",
    "grouped_matmul_bwd": "src/repro_torch/csrc/grouped_matmul_bwd.cu",
    "grouped_matmul_experts": "src/repro_torch/csrc/grouped_matmul_experts.cu",
    "grouped_matmul_experts_bwd":
        "src/repro_torch/csrc/grouped_matmul_experts_bwd.cu",
    "branch_matmul": "src/repro_torch/csrc/branch_matmul.cu",
}
SERVE_KERNELS = ("grouped_matmul_concat", "grouped_matmul_pooled",
                 "conv2d_direct", "grouped_matmul_chained")
TRAIN_KERNELS = ("matmul", "grouped_matmul_bwd")
MOE_KERNELS = ("grouped_matmul_experts", "grouped_matmul_experts_bwd")
# the training phase: full googlenet, batch 8, seed 0, 4 AdamW steps
TRAIN_BATCH, TRAIN_STEPS, TRAIN_SEED, TRAIN_LR = 8, 4, 0, 1e-3
LOSS_RTOL = 1e-3       # planned vs plain loss per step, relative
# a ReLU sign or max-pool choice that the planned f32 forward took apart
# from the float64 forward must sit within PIECE_RTOL of its kink: the
# ReLU input |z| <= PIECE_RTOL * max|z| of its conv, the chosen element
# short of the window's maximum by <= PIECE_RTOL * max|x| of the pool's
# input, both on the float64 forward's values (``flip_shares``)
PIECE_RTOL = 1e-5
# launches per planned training step (unchained plan, batch 8)
TRAIN_LAUNCHES = {"grouped_matmul_concat": 9, "grouped_matmul_pooled": 9,
                  "conv2d_direct": 2, "grouped_matmul_chained": 0,
                  "matmul": 6, "grouped_matmul_bwd": 18,
                  "grouped_matmul_experts": 0,
                  "grouped_matmul_experts_bwd": 0, "branch_matmul": 0}
# the paper's two baselines at the same batch: plan_cnn keywords and
# launches per step (also derived from each plan by ``plan_launches``)
BASELINES = {
    "serial": ({"concurrent": False},
               dict(TRAIN_LAUNCHES, grouped_matmul_concat=0,
                    grouped_matmul_pooled=0, conv2d_direct=51, matmul=119,
                    grouped_matmul_bwd=0)),
    "stacked": ({"fuse_pool": False},
                dict(TRAIN_LAUNCHES, grouped_matmul_pooled=6,
                     grouped_matmul_bwd=15, branch_matmul=9)),
}
# the MoE training phase: full granite-moe-1b-a400m, batch 4 x seq 512,
# seed 0, 3 AdamW steps
LM_ARCH = "granite-moe-1b-a400m"
LM_BATCH, LM_SEQ, LM_STEPS, LM_SEED, LM_LR = 4, 512, 3, 0, 1e-3
# wrapper calls per grouped step: one K11 and one K12 per MoE layer
LM_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
LM_LAUNCHES.update({"grouped_matmul_experts": 24,
                    "grouped_matmul_experts_bwd": 24})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around it."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_device_ms(fn, func: str, reps: int = 5):
    """Device time per call of the CUDA function ``func`` alone, from
    ``torch.profiler`` over ``reps`` calls; None when the profiler sees
    no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and func in e.key:
            us += getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0.0)
    return us / 1e3 / reps if us > 0 else None


# ---------------------------------------------------------------------------
# phase 3: capture each wrapper's main-path arguments
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def recording(targets):
    """Wrap each ``(module, wrapper name)`` so that its calls append their
    (args, kwargs) to the yielded {name: [calls]}; restores them after."""
    calls: dict = {name: [] for _, name in targets}
    saved = {}
    for mod, name in targets:
        real = getattr(mod, name)
        saved[(mod, name)] = real

        def rec(*a, _real=real, _name=name, **k):
            calls[_name].append((a, k))
            return _real(*a, **k)
        setattr(mod, name, rec)
    try:
        yield calls
    finally:
        for (mod, name), real in saved.items():
            setattr(mod, name, real)


def capture_calls(params, cfg, dev, buckets=(1, 2)):
    """Run one planned forward per bucket with every serving kernel's
    wrapper recording its (args, kwargs); returns {name: [calls]}."""
    import torch
    from repro_torch.core import plan_cache
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.models import cnn

    with recording([(kg, "grouped_matmul_concat"),
                    (kg, "grouped_matmul_pooled"),
                    (kc, "conv2d_direct"),
                    (kg, "grouped_matmul_chained")]) as calls:
        g = torch.Generator().manual_seed(1)
        for b in buckets:
            plan = plan_cache.cached_cnn_plan(cfg, b, chain_modules=True).plan
            x = torch.randn((b,) + cfg.img, generator=g).to(dev)
            with torch.no_grad():
                cnn.forward_plan(params, cfg, x, plan, valid_images=b)
    return calls


def capture_train_calls(params, cfg, dev):
    """Run one planned training step's forward + backward (batch
    ``TRAIN_BATCH``) with the wrappers of every kernel it launches (K1-K5)
    recording their (args, kwargs); returns {name: [calls]}."""
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    from repro_torch.launch import steps
    from repro_torch.models import cnn

    plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True)
    batch = SyntheticImages(cfg.img, cfg.num_classes, TRAIN_BATCH,
                            seed=TRAIN_SEED).batch_at(0)
    with recording([(km, "matmul"), (kg, "grouped_matmul_bwd"),
                    (kg, "grouped_matmul_concat"),
                    (kg, "grouped_matmul_pooled"),
                    (kc, "conv2d_direct")]) as calls:
        steps.cnn_loss_and_grads(params, cfg,
                                 steps.to_device_batch(batch, dev),
                                 plan=plan)
    return calls


def _bmm_role(args) -> str:
    """Which GEMM of a stacked group a K9 call is: the backward's dW reads
    the lhs transposed (xᵀ @ g), its dx the rhs (g @ yᵀ)."""
    x, y = args
    if x.stride(1) == 1 and x.shape[2] > 1:
        return "dW"
    if y.stride(1) == 1 and y.shape[2] > 1:
        return "dx"
    return "fwd"


def capture_stacked_calls(params, cfg, dev):
    """Run one stacked-plan training step's forward + backward (batch
    ``TRAIN_BATCH``, ``plan_cnn(fuse_pool=False, train=True)``) with the
    K9 wrapper recording its (args, kwargs); returns {"branch_matmul":
    [("stacked fwd" | "stacked dx" | "stacked dW", args, kwargs)]}."""
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.launch import steps
    from repro_torch.models import cnn

    plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True,
                           **BASELINES["stacked"][0])
    batch = SyntheticImages(cfg.img, cfg.num_classes, TRAIN_BATCH,
                            seed=TRAIN_SEED).batch_at(0)
    with recording([(kb, "branch_matmul")]) as calls:
        steps.cnn_loss_and_grads(params, cfg,
                                 steps.to_device_batch(batch, dev),
                                 plan=plan)
    cases = [(f"stacked {_bmm_role(a)}", a, k)
             for a, k in calls["branch_matmul"]]
    roles = [c[0] for c in cases]
    n = len(plan.groups_of_mode("stacked"))
    if sorted(roles) != sorted(["stacked fwd", "stacked dx",
                                "stacked dW"] * n):
        raise RuntimeError(f"one stacked-plan step made K9 calls {roles}, "
                           f"expected a forward, a dx and a dW for each of "
                           f"its {n} stacked groups")
    return {"branch_matmul": cases}


def lm_setup(dev):
    """(config, parameters) of the MoE phases: full-width
    granite-moe-1b-a400m, parameters from ``LM_SEED``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(LM_ARCH)
    return cfg, transformer.init_params(
        cfg, torch.Generator().manual_seed(LM_SEED), dev)


def lm_batches(cfg):
    from repro_torch.data import SyntheticLM
    src = SyntheticLM(cfg.vocab, LM_SEQ, LM_BATCH, seed=LM_SEED)
    return [src.batch_at(i) for i in range(LM_STEPS)]


def capture_moe_calls(params, cfg, dev):
    """Run one grouped-engine training step's forward + backward of the
    MoE phase with the K11 and K12 wrappers recording their (args,
    kwargs); returns {name: [(layer label, args, kwargs)]}."""
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    batch = steps.to_device_batch(lm_batches(cfg)[0], dev)
    with recording([(kg, n) for n in MOE_KERNELS]) as calls:
        steps.loss_and_grads(transformer.loss_fn, params, cfg, batch,
                             moe_impl="grouped", remat=False)
    n = cfg.n_layers
    for name, c in calls.items():
        if len(c) != n:
            raise RuntimeError(f"one grouped step made {len(c)} {name} "
                               f"calls, expected {n}")
    # the forward runs layers 0..n-1, the backward n-1..0
    return {"grouped_matmul_experts": [
                (f"layer {i}",) + c for i, c in
                enumerate(calls["grouped_matmul_experts"])],
            "grouped_matmul_experts_bwd": [
                (f"layer {n - 1 - i}",) + c for i, c in
                enumerate(calls["grouped_matmul_experts_bwd"])]}


def _moe_counts(name, args):
    return args[5] if name == "grouped_matmul_experts" else args[7]


def describe(name, args, kw) -> str:
    """The shapes of one captured call, for the log."""
    if name in MOE_KERNELS:
        xp, w_in = args[0], args[2]
        e, d, f = w_in.shape
        return (f"rows {xp.shape[0]} (live {int(_moe_counts(name, args).sum())}"
                f", bm {kw['bm']}) E {e} D {d} F {f} gated "
                f"{args[4] is not None}")
    if name == "branch_matmul":
        x, y = args
        t = ["T" if v.stride(1) == 1 and v.shape[2] > 1 else ""
             for v in (x, y)]
        return (f"G={x.shape[0]} ({'x'.join(map(str, x.shape[1:]))}){t[0]} "
                f"@ ({'x'.join(map(str, y.shape[1:]))}){t[1]}")
    if name == "matmul":
        x, y = args
        t = ["T" if v.dim() == 2 and v.stride(0) == 1 and v.shape[1] > 1
             else "" for v in (x, y)]
        return (f"({'x'.join(map(str, x.shape))}){t[0]} @ "
                f"({'x'.join(map(str, y.shape))}){t[1]}")
    if name == "grouped_matmul_bwd":
        xs, ws = args[:2]
        mask = args[3] if len(args) > 3 else kw.get("mask")
        return (f"M={xs[0].shape[0]} (K,N)="
                f"{[tuple(w.shape) for w in ws]} mask={mask is not None}")
    if name == "conv2d_direct":
        x, w = args
        return (f"x {tuple(x.shape)} w {tuple(w.shape)} "
                f"stride {kw.get('stride', 1)}")
    if name == "grouped_matmul_chained":
        return f"m={kw['m']} m_valid={kw.get('m_valid')}"
    xs, ws = args[:2]
    taps = [len(x) if isinstance(x, (list, tuple)) else 1 for x in xs]
    x0 = xs[0][0] if isinstance(xs[0], (list, tuple)) else xs[0]
    return (f"M={x0.shape[0]} (K,N)={[tuple(w.shape) for w in ws]} "
            f"taps={taps} m_valid={kw.get('m_valid')}")


def _nz_rows(w) -> int:
    return int((w != 0).any(dim=1).sum())


def work_of(name, args, kw):
    """(FLOPs, bytes) the call needs on this run's data: true rows (up to
    m_valid; the routed rows of an expert call), true depths, each input
    read once and each output written once, 4 bytes per f32."""
    if name in MOE_KERNELS:
        xp, w_in = args[0], args[2]
        e, d, f = w_in.shape
        nw = 2 if args[4] is not None else 1
        n = float(_moe_counts(name, args).sum())
        r = xp.shape[0]
        wts = e * (1 + nw) * d * f
        if name == "grouped_matmul_experts":
            # in (+ gate) and out GEMMs; read x, sw, weights; write y and,
            # in train mode, the pre-activations
            res = nw * r * f if kw.get("train") else 0
            return (2.0 * n * d * f * (1 + nw),
                    4.0 * (n * d + n + wts + r * d + res))
        # dH, dX (per weight), dW_out, dW_in (+ dW_gate); read x, dYs,
        # the pre-activations and the weights, write dx and every dW
        return (2.0 * n * d * f * (2 + 2 * nw),
                4.0 * (2 * n * d + nw * n * f + 2 * wts + r * d))
    if name == "matmul":
        x, y = args
        m, k = x.shape
        n = y.shape[1]
        return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
    if name == "branch_matmul":
        x, y = args
        g, m, k = x.shape
        n = y.shape[2]
        return 2.0 * g * m * k * n, 4.0 * g * (m * k + k * n + m * n)
    if name == "grouped_matmul_bwd":
        xs, ws, dys = args[:3]
        mask = args[3] if len(args) > 3 else kw.get("mask")
        flops, byts = 0.0, 0.0
        for x, w in zip(xs, ws):
            m, k = x.shape
            n = w.shape[1]
            # dx and dw GEMMs, db row sum; read x, w, dy (and the mask),
            # write dx, dw, db
            flops += 4.0 * m * k * n + m * n
            byts += 4.0 * (2 * m * k + 2 * k * n + m * n + n
                           + (m * n if mask is not None else 0))
        return flops, byts
    if name == "conv2d_direct":
        x, w = args
        n, h, wd, c = x.shape
        kh, kw_, _, k = w.shape
        s = kw.get("stride", 1)
        oh, ow = -(-h // s), -(-wd // s)
        flops = 2.0 * n * oh * ow * kh * kw_ * c * k
        return flops, 4.0 * (x.numel() + w.numel() + n * oh * ow * k)
    if name == "grouped_matmul_chained":
        phases = args[0]
        m = kw["m"]
        rows = kw.get("m_valid") or m
        flops, byts = 0.0, 0.0
        for phase in phases:
            for br in phase:
                flops += 2.0 * rows * _nz_rows(br["w"]) * br["n"]
                byts += 4.0 * (_nz_rows(br["w"]) * br["n"] + br["n"]
                               + rows * br["n"])
                if br["src"][0] == "x":
                    byts += sum(4.0 * rows * a.shape[1]
                                for a in br["src"][1])
        byts += sum(4.0 * rows * p.shape[1] for p in kw.get("panels", ()))
        return flops, byts
    xs, ws = args[0], args[1]
    rows = kw.get("m_valid")
    flops, byts = 0.0, 0.0
    for x, w in zip(xs, ws):
        taps = list(x) if isinstance(x, (list, tuple)) else [x]
        m = taps[0].shape[0]
        r = m if rows is None else rows
        k, n = w.shape
        flops += 2.0 * r * k * n + (len(taps) - 1) * r * k
        byts += 4.0 * (len(taps) * r * k + k * n + n + r * n)
    return flops, byts


def _outputs(name, got, ref, args, kw):
    """Each output tensor of one call as (label, got, ref), on the rows and
    columns the contract defines, a branch's columns of a joint output
    apart; and whether the columns no branch owns are exactly zero."""
    import torch
    from repro_torch.kernels import grouped_matmul as kg
    if name == "grouped_matmul_chained":
        rows = kw.get("m_valid") or kw["m"]
        parts, pad_ok = [], True
        for i, (p, cb, nbb, n) in enumerate(kg.chained_layout(args[0])):
            c0 = cb * 128
            parts.append((f"phase {p} branch {i}", got[p][:rows, c0:c0 + n],
                          ref[p][:rows, c0:c0 + n]))
            pad_ok &= bool((got[p][:rows, c0 + n:(cb + nbb) * 128] == 0)
                           .all())
        return parts, pad_ok
    if name == "grouped_matmul_concat":
        ocols, width, _ = kg._concat_layout(name, args[1], kw["offsets"],
                                            kw["total"],
                                            kw.get("compact", True))
        owned = torch.zeros(width, dtype=torch.bool, device=got.device)
        parts = []
        for g, (oc, w) in enumerate(zip(ocols, args[1])):
            n = w.shape[1]
            parts.append((f"branch {g}", got[:, oc:oc + n], ref[:, oc:oc + n]))
            owned[oc:oc + n] = True
        return parts, bool((got[:, ~owned] == 0).all())
    if name in MOE_KERNELS:
        labels = (("y", "hin", "gate") if name == "grouped_matmul_experts"
                  else ("dx", "dW_in", "dW_gate", "dW_out"))
        return [(lab, t, r) for lab, t, r in zip(labels, got, ref)
                if r is not None], True
    if name == "grouped_matmul_bwd":
        return [(f"{kind}{g}", t, r)
                for kind, ts, rs in zip(("dx", "dw", "db"), got, ref)
                for g, (t, r) in enumerate(zip(ts, rs))], True
    if isinstance(got, (list, tuple)) or name == "branch_matmul":
        return [(f"branch {g}", t, r)
                for g, (t, r) in enumerate(zip(got, ref))], True
    return [("out", got, ref)], True


def check_outputs(tag, parts, pad_ok):
    """Hold each output tensor on its own to max abs error <= TOL *
    max|ref| + FLOOR (a NaN fails); raises past it.  Returns the largest
    abs error over the tensors."""
    worst_err, worst_ratio, worst_label = 0.0, 0.0, ""
    for label, g, r in parts:
        if g.shape != r.shape:
            raise RuntimeError(f"{tag} {label}: shape {tuple(g.shape)}, "
                               f"plain version {tuple(r.shape)}")
        err = float((g - r).abs().max()) if g.numel() else 0.0
        lim = TOL * (float(r.abs().max()) if r.numel() else 0.0) + FLOOR
        if not err <= lim:
            raise RuntimeError(f"{tag} {label}: kernel disagrees with its "
                               f"plain version (max abs err {err:.3e}, "
                               f"limit {lim:.3e})")
        worst_err = max(worst_err, err)
        if err / lim >= worst_ratio:
            worst_ratio, worst_label = err / lim, label
    print(f"[kernels] {tag}: max_abs_err {worst_err:.3e}, worst err/limit "
          f"{worst_ratio:.3e} ({worst_label}; {len(parts)} output tensors "
          f"held apart), pad_zero {pad_ok}")
    if not pad_ok:
        raise RuntimeError(f"{tag}: columns no branch owns are not zero")
    return worst_err


def library_call(name, args, kw):
    """A torch library yardstick on the same inputs: ``F.conv2d`` for the
    direct conv, ``torch.bmm`` for the stacked GEMMs, one ``torch.matmul``
    per GEMM at the same shapes for the grouped launches.  The port never
    calls these."""
    import torch
    import torch.nn.functional as F
    if name in MOE_KERNELS:
        return einsum_engine_call(name, args)
    if name == "matmul":
        x, y = args
        return lambda: torch.matmul(x, y)
    if name == "branch_matmul":
        x, y = args
        return lambda: torch.bmm(x, y)
    if name == "grouped_matmul_bwd":
        xs, ws, dys = args[:3]
        return lambda: [(torch.matmul(dy, w.t()), torch.matmul(x.t(), dy))
                        for x, w, dy in zip(xs, ws, dys)]
    if name == "conv2d_direct":
        x, w = args
        kh = w.shape[0]
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = w.permute(3, 2, 0, 1).contiguous()
        s = kw.get("stride", 1)
        return lambda: F.conv2d(xc, wc, stride=s, padding=kh // 2)
    if name == "grouped_matmul_chained":
        m = kw["m"]
        pairs = [(torch.empty((m, br["w"].shape[0]), device=br["w"].device),
                  br["w"]) for phase in args[0] for br in phase]
    else:
        pairs = []
        for x, w in zip(args[0], args[1]):
            x0 = x[0] if isinstance(x, (list, tuple)) else x
            pairs.append((x0, w))
    return lambda: [torch.matmul(a, b) for a, b in pairs]


def einsum_engine_call(name, args):
    """The capacity-padded einsum engine's expert GEMMs
    (``models/moe.py::_moe_apply_core``) for the layer of an expert call,
    on (B, E, C, D) slots at the MoE phase's batch and capacity: the
    forward (in/gate GEMMs, activation, out GEMM), or the GEMMs of its
    backward (dH, dX, dW_out, dW_in, dW_gate).  Timing only: the slots
    hold random values."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    w_in, w_out, w_gate = args[2], args[3], args[4]
    e, d, f = w_in.shape
    mo = get_config(LM_ARCH).moe
    cap = moe.moe_capacity(LM_SEQ * mo.top_k, mo.capacity_factor, e)
    g = torch.Generator(device=w_in.device).manual_seed(5)
    rnd = lambda *shape: torch.randn(shape, generator=g,
                                     device=w_in.device)
    xe = rnd(LM_BATCH, e, cap, d)
    if name == "grouped_matmul_experts":
        def fwd():
            h = torch.einsum("becd,edf->becf", xe, w_in)
            if w_gate is not None:
                h = F.silu(torch.einsum("becd,edf->becf", xe, w_gate)) * h
            return torch.einsum("becf,efd->becd", h, w_out)
        return fwd
    dye, h, dpre = rnd(LM_BATCH, e, cap, d), rnd(LM_BATCH, e, cap, f), \
        rnd(LM_BATCH, e, cap, f)

    def bwd():
        out = [torch.einsum("becd,efd->becf", dye, w_out),
               torch.einsum("becf,becd->efd", h, dye),
               torch.einsum("becf,edf->becd", dpre, w_in),
               torch.einsum("becd,becf->edf", xe, dpre)]
        if w_gate is not None:
            out += [torch.einsum("becf,edf->becd", dpre, w_gate),
                    torch.einsum("becd,becf->edf", xe, dpre)]
        return out
    return bwd


def check_kernels(calls):
    """Hold each captured call's kernel against its plain version; returns
    {name: row of the kernels line (launches filled in later)}."""
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    import torch
    fns = {
        "branch_matmul": (kb.branch_matmul, kb.branch_matmul_ref),
        "grouped_matmul_experts": (kg.grouped_matmul_experts,
                                   kg.grouped_matmul_experts_ref),
        "grouped_matmul_experts_bwd": (kg.grouped_matmul_experts_bwd,
                                       kg.grouped_matmul_experts_bwd_ref),
        "matmul": (km.matmul, km.matmul_ref),
        "grouped_matmul_bwd": (kg.grouped_matmul_bwd,
                               kg.grouped_matmul_bwd_ref),
        "grouped_matmul_concat": (kg.grouped_matmul_concat,
                                  kg.grouped_matmul_concat_ref),
        "grouped_matmul_pooled": (kg.grouped_matmul_pooled,
                                  kg.grouped_matmul_pooled_ref),
        "grouped_matmul_chained": (kg.grouped_matmul_chained,
                                   kg.grouped_matmul_chained_ref),
        "conv2d_direct": (kc.conv2d_direct, kc.conv2d_direct_ref),
    }
    rows = {}
    for name, cases in calls.items():
        kern, plain = fns[name]
        cases = list(cases)
        if not cases:
            raise RuntimeError(f"main path made no {name} call")
        if name == "grouped_matmul_chained":
            # the stem chain (bucket 2) and the inc0 module chain (bucket 2),
            # dense and ragged (one real image of two)
            b2 = [c for c in cases if c[2]["m"] % 2 == 0
                  and c[2]["m"] // (c[2]["h"] * c[2]["w"]) == 2][:2]
            cases = []
            for path, a, k in b2:
                cases.append((path, a, dict(k, m_valid=None)))
                cases.append((path, a, dict(k, m_valid=k["m"] // 2)))
        worst, ms, plain_ms, lib_ms, bound, top = 0.0, 0.0, 0.0, 0.0, \
            0.0, (0.0, "")
        dev_ms: float | None = 0.0
        per_path: dict = {}
        for path, a, k in cases:
            with torch.no_grad():
                got = kern(*a, **k)
                ref = plain(*a, **k)
                torch.cuda.synchronize()
            tag = f"{name} {path} {describe(name, a, k)}"
            worst = max(worst, check_outputs(
                tag, *_outputs(name, got, ref, a, k)))
            del got, ref
            with torch.no_grad():
                t_k = time_ms(lambda: kern(*a, **k))
                t_p = time_ms(lambda: plain(*a, **k))
                t_l = time_ms(library_call(name, a, k))
                t_d = kernel_device_ms(lambda: kern(*a, **k),
                                       KERNEL_FUNCS[name])
            flops, byts = work_of(name, a, k)
            t_c, t_b = flops / PEAK_F32 * 1e3, byts / PEAK_BW * 1e3
            by = "bytes" if t_b > t_c else "operations"
            t_ds = "not measured" if t_d is None else f"{t_d:.4f} ms"
            print(f"[kernels] {tag}: wrapper {t_k:.4f} ms, kernel device "
                  f"time {t_ds}, plain {t_p:.4f} ms, library {t_l:.4f} ms, "
                  f"bound {max(t_c, t_b):.4f} ms ({by}; {flops:.3e} FLOP, "
                  f"{byts:.3e} B)")
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            dev_ms = None if dev_ms is None or t_d is None else dev_ms + t_d
            bound += max(t_c, t_b)
            top = max(top, (max(t_c, t_b), by))
            acc = per_path.setdefault(path, [0, 0.0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((1, t_k, t_d or math.nan, t_p, t_l,
                                   max(t_c, t_b))):
                acc[i] += v
        for path, (n, *sums) in per_path.items():
            if n < 2:
                continue
            print(f"[kernels] {name} {path}: {n} cases, sums: wrapper "
                  f"{sums[0]:.4f} ms, kernel device {sums[1]:.4f} ms, plain "
                  f"{sums[2]:.4f} ms, library {sums[3]:.4f} ms, bound "
                  f"{sums[4]:.4f} ms")
        if name == "matmul":
            # large_tile (128 x 128 tiles) is off the main path: check it
            # once, on the first captured call, untimed
            _, a, k = cases[0]
            with torch.no_grad():
                check_outputs(f"matmul large_tile {describe(name, a, k)}",
                              *_outputs(name, kern(*a, algorithm="large_tile"),
                                        plain(*a), a, k))
        print(f"[kernels] {name}: {len(cases)} cases, sums: wrapper "
              f"{ms:.4f} ms, kernel device {dev_ms} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms:.4f} ms, bound {bound:.4f} ms")
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": worst, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": top[1], "library_ms": lib_ms,
                      "kernel_device_ms": dev_ms, "cases": len(cases)}
    return rows


def check_expert_block_sizes(dev):
    """K11 and K12 at every M-block size the dispatch can pick (bm 8 to
    128), gated silu and ungated gelu, on packed synthetic tokens with a
    zero-token expert, a partial last block per expert and dead tail
    blocks, D and F not multiples of the 64-wide tiles: each output
    tensor against its plain version, untimed (the main path at full
    width runs bm 128 only)."""
    import torch
    from repro_torch.kernels import grouped_matmul as kg
    g = torch.Generator().manual_seed(7)
    e, d, f = 8, 96, 80
    for bm in (8, 16, 32, 64, 128):
        for gated, act in ((True, "silu"), (False, "gelu")):
            n = 3 * e * bm
            w = torch.rand(e, generator=g)
            w[1] = 0
            counts = torch.floor(w / w.sum() * n * 0.9).to(torch.int32)
            rows = kg.moe_static_blocks(n, e, bm) * bm
            offs = kg.expert_row_offsets(counts, bm).tolist()
            xp, swp = torch.zeros(rows, d), torch.zeros(rows)
            for a, c in zip(offs, counts.tolist()):
                xp[a:a + c] = torch.randn(c, d, generator=g)
                swp[a:a + c] = torch.rand(c, generator=g)
            w_in = torch.randn(e, d, f, generator=g) * d ** -0.5
            w_gate = torch.randn(e, d, f, generator=g) * d ** -0.5 \
                if gated else None
            w_out = torch.randn(e, f, d, generator=g) * f ** -0.5
            dyp = torch.randn(rows, d, generator=g)
            on = [None if t is None else t.to(dev)
                  for t in (xp, swp, w_in, w_out, w_gate, counts, dyp)]
            xp, swp, w_in, w_out, w_gate, counts, dyp = on
            tag = f"bm {bm} gated {gated} {act}"
            with torch.no_grad():
                kw = dict(activation=act, bm=bm)
                fwd = (xp, swp, w_in, w_out, w_gate, counts)
                got = kg.grouped_matmul_experts(*fwd, train=True, **kw)
                ref = kg.grouped_matmul_experts_ref(*fwd, train=True, **kw)
                check_outputs(f"grouped_matmul_experts {tag}", *_outputs(
                    "grouped_matmul_experts", got, ref, fwd, kw))
                bwd = (xp, dyp, w_in, w_out, w_gate, got[1], got[2], counts)
                gb = kg.grouped_matmul_experts_bwd(*bwd, **kw)
                rb = kg.grouped_matmul_experts_bwd_ref(*bwd, **kw)
                check_outputs(f"grouped_matmul_experts_bwd {tag}", *_outputs(
                    "grouped_matmul_experts_bwd", gb, rb, bwd, kw))
            if not all(bool((t[1] == 0).all()) for t in gb[1:] if t is not None):
                raise RuntimeError(f"{tag}: the zero-token expert's dW is "
                                   f"not exactly zero")


# ---------------------------------------------------------------------------
# phase 4: full-width logits against the plain forward
# ---------------------------------------------------------------------------

def check_logits(params, cfg, dev):
    import torch
    from repro_torch.core import plan_cache
    from repro_torch.models import cnn
    g = torch.Generator().manual_seed(2)
    for bucket, valid in ((1, 1), (2, 2), (4, 4), (4, 3)):
        plan = plan_cache.cached_cnn_plan(cfg, bucket,
                                          chain_modules=True).plan
        x = torch.randn((bucket,) + cfg.img, generator=g).to(dev)
        with torch.no_grad():
            got = cnn.forward_plan(params, cfg, x, plan, valid_images=valid)
            ref = cnn.forward(params, cfg, x)
        torch.cuda.synchronize()
        if got.shape != (bucket, cfg.num_classes) \
                or not bool(torch.isfinite(got[:valid]).all()):
            raise RuntimeError(f"bucket {bucket}: logits {tuple(got.shape)} "
                               f"not finite / wrong shape")
        err = float((got[:valid] - ref[:valid]).abs().max())
        lim = LOGIT_RTOL * float(ref[:valid].abs().max()) + 1e-6
        print(f"[logits] bucket {bucket} valid {valid} "
              f"({plan.mode_counts()}): max_abs_err {err:.3e} "
              f"(limit {lim:.3e}, max|ref| "
              f"{float(ref[:valid].abs().max()):.3e})")
        if not err <= lim:
            raise RuntimeError(f"bucket {bucket}: planned logits disagree "
                               f"with the plain forward")


# ---------------------------------------------------------------------------
# phase 5: full-width training, planned against plain
# ---------------------------------------------------------------------------

def _tree_ratio(got, ref):
    """Worst per-parameter max abs error of ``got`` against ``ref`` over
    the limit LOGIT_RTOL * max|ref| + 1e-6."""
    from repro_torch.optim import tree_leaves
    worst = 0.0
    for g, r in zip(tree_leaves(got), tree_leaves(ref)):
        r = r.to(g.dtype)
        lim = LOGIT_RTOL * float(r.abs().max()) + 1e-6
        worst = max(worst, float((g - r).abs().max()) / lim)
    return worst


def _tree_check(tag, got, ref):
    """Per-parameter max abs error of two trees against
    LOGIT_RTOL * max|ref| + 1e-6; raises past it, returns the worst
    err / limit."""
    from repro_torch.optim import tree_leaves
    for i, (g, r) in enumerate(zip(tree_leaves(got), tree_leaves(ref))):
        r = r.to(g.dtype)
        err = float((g - r).abs().max())
        lim = LOGIT_RTOL * float(r.abs().max()) + 1e-6
        if not err <= lim:
            raise RuntimeError(f"{tag}: parameter {i} {tuple(r.shape)} "
                               f"max_abs_err {err:.3e} over {lim:.3e}")
    return _tree_ratio(got, ref)


def train_setup(cfg, dev):
    """(params, batches, planned step, plain step, optimizer, plan) of the
    training phase, from ``TRAIN_SEED``."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticImages
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True)
    opt = dataclasses.replace(steps.make_optimizer(cfg), lr=TRAIN_LR,
                              total=TRAIN_STEPS,
                              warmup=max(TRAIN_STEPS // 20, 1))
    params = cnn.init_params(cfg, torch.Generator().manual_seed(TRAIN_SEED),
                             dev)
    src = SyntheticImages(cfg.img, cfg.num_classes, TRAIN_BATCH,
                          seed=TRAIN_SEED)
    batches = [src.batch_at(i) for i in range(TRAIN_STEPS)]
    planned = steps.make_cnn_train_step(cfg, opt, plan=plan, device=dev)
    plain = steps.make_cnn_train_step(cfg, opt, device=dev)
    return params, batches, planned, plain, opt, plan


def _f64(batch, dev):
    from repro_torch.launch import steps
    b = steps.to_device_batch(batch, dev)
    return {"images": b["images"].double(), "labels": b["labels"]}


def make_plain64_step(cfg, opt, dev):
    """The plain path with float64 forward/backward (the AdamW update
    computes in f32 and rounds the parameters to f32): the yardstick both
    f32 paths are measured against."""
    from repro_torch.launch import steps

    def step(params, st, batch):
        loss, grads = steps.cnn_loss_and_grads(params, cfg, _f64(batch, dev))
        new_p, new_st, info = opt.update(grads, st, params)
        return new_p, new_st, {"loss": loss, **info}
    return step


def _run_steps(step, params, opt, batches):
    """Run ``step`` over ``batches`` from ``params``; returns (final
    params, losses, ms per step, launches per step, params before each
    step)."""
    import torch
    from repro_torch.kernels import runtime
    st = opt.init(params)
    losses, times, per_step, before_each = [], [], [], []
    for b in batches:
        before_each.append(params)
        before = dict(runtime.KERNEL_LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, st, met = step(params, st, b)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append({k: runtime.KERNEL_LAUNCHES[k] - before[k]
                         for k in before})
    return params, losses, times, per_step, before_each


def check_training(cfg, dev):
    """Phase 5, the concurrent plan; returns the launch counts of the
    planned steps and what the baseline runs share with it (init,
    batches, optimizer, the float64 run's parameters before each step
    and losses, the step times and peak memory).

    The planned path (f32 kernels) is held to the plain path run with
    float64 forward/backward (its AdamW computes in f32).  Gradients are
    compared at every step on the float64 run's parameters (the planned
    gradient taken at their f32 cast), so each step checks arithmetic,
    not the drift of two runs.  The free-running parameters after the
    last step are printed but not checked: AdamW's normalised update
    turns f32 rounding noise in near-zero gradient elements into lr-sized
    steps, so the plain f32 path lands far outside the per-parameter
    bound as well, and a wrong gradient moves each element by about lr
    too (PERF.md, section 6)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.optim import tree_map
    params, batches, planned, plain, opt, plan = train_setup(cfg, dev)
    p64 = tree_map(lambda t: t.double(), params)
    print(f"[train] {cfg.name} batch {TRAIN_BATCH}, plan "
          f"{plan.mode_counts()}, backward plan "
          f"{plan.context['backward'].mode_counts()}")
    # the training main path: counters set to 0 just before, read after
    runtime.reset_launch_counts()
    p_plan, l_plan, t_plan, per_step, _ = _run_steps(planned, params, opt,
                                                     batches)
    launches = dict(runtime.KERNEL_LAUNCHES)
    p_64, l_64, _, s64, traj64 = _run_steps(
        make_plain64_step(cfg, opt, dev), p64, opt, batches)
    p_plain, l_plain, t_plain, s32, _ = _run_steps(plain, params, opt,
                                                   batches)
    for i, (a, b, c, ta, tb, ls) in enumerate(zip(
            l_plan, l_64, l_plain, t_plan, t_plain, per_step)):
        print(f"[train] step {i + 1}: loss planned {a:.8f} float64 {b:.8f} "
              f"plain f32 {c:.8f}; ms planned {ta:.3f} plain f32 {tb:.3f}; "
              f"launches " + ", ".join(f"{k} {v}" for k, v in ls.items()))
        if not abs(a - b) <= LOSS_RTOL * abs(b):
            raise RuntimeError(f"step {i + 1}: planned loss {a} vs float64 "
                               f"{b} beyond {LOSS_RTOL} relative")
        if ls != TRAIN_LAUNCHES:
            raise RuntimeError(f"step {i + 1}: launches {ls}, expected "
                               f"{TRAIN_LAUNCHES}")
    if any(sum(s.values()) for s in s64 + s32):
        raise RuntimeError(f"the plain path launched port kernels: "
                           f"{s64 + s32}")
    if not all(math.isfinite(v) for v in l_plan):
        raise RuntimeError(f"planned losses not finite: {l_plan}")
    # gradients at every step, on the float64 run's parameters
    for i, (p_i, b) in enumerate(zip(traj64, batches)):
        p32 = tree_map(lambda t: t.float(), p_i)
        b32 = steps.to_device_batch(b, dev)
        _, gp = steps.cnn_loss_and_grads(p32, cfg, b32, plan=plan)
        _, gr = steps.cnn_loss_and_grads(p32, cfg, b32)
        _, g64 = steps.cnn_loss_and_grads(p_i, cfg, _f64(b, dev))
        worst = _tree_check(f"step {i + 1} gradients, planned vs float64",
                            gp, g64)
        print(f"[train] step {i + 1} gradients on the float64 run's "
              f"parameters: worst err/limit against float64: planned "
              f"{worst:.3e}, plain f32 {_tree_ratio(gr, g64):.3e}")
        del gp, gr, g64
    r_plan = _tree_ratio(p_plan, p_64)
    r_plain = _tree_ratio(p_plain, p_64)
    print(f"[train] free-running parameters after step {TRAIN_STEPS} "
          f"(printed, not checked): worst err/limit against float64: "
          f"planned {r_plan:.3e}, plain f32 {r_plain:.3e}")
    med = statistics.median(t_plan[1:])
    med_plain = statistics.median(t_plain[1:])
    print(f"[train] step time (median of steps 2-{TRAIN_STEPS}, host clock "
          f"to synchronize): planned {med:.3f} ms "
          f"({TRAIN_BATCH / med * 1e3:.3f} images/s), plain f32 "
          f"{med_plain:.3f} ms ({TRAIN_BATCH / med_plain * 1e3:.3f} "
          f"images/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[train] launches over the {TRAIN_STEPS} planned steps: "
          f"{launches}")
    # the step-time summary's peak for this plan, measured as the
    # baselines' are, from a reset just before its planned steps (the
    # peak printed above covers the whole script so far): a second run
    # of the same steps, after the launch counts were read
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _run_steps(planned, params, opt, batches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return launches, {"params": params, "batches": batches, "opt": opt,
                      "traj64": traj64, "l_64": l_64, "t_plain": t_plain,
                      "times": {"concurrent": t_plan},
                      "peaks": {"concurrent": peak}}


def plan_launches(plan) -> dict:
    """Kernel launches one training step of ``plan`` makes, derived from
    its groups: a ``direct`` conv one K3, an ``im2col_gemm`` conv one K4,
    and each serial conv's GEMM-view backward two K4 (dX and dW; one for
    a conv of the network's input, which needs no dX); a grouped or
    pooled group one K2 and one K5, a concat group one K1 and one K5, a
    stacked group one K9 forward and two backward; pools and joins run
    plain torch."""
    graph = plan.context["graph"]
    out = {k: 0 for k in TRAIN_LAUNCHES}
    for g in plan.groups:
        if g.mode == "serial":
            for n in g.ops:
                alg = g.algorithms.get(n)
                if graph.ops[n].kind != "conv2d":
                    continue
                out["conv2d_direct" if alg == "direct" else "matmul"] += 1
                out["matmul"] += 1 if graph.pred[n] == {"input"} else 2
        elif g.mode in ("grouped", "grouped_pooled"):
            out["grouped_matmul_pooled"] += 1
            out["grouped_matmul_bwd"] += 1
        elif g.mode == "grouped_concat":
            out["grouped_matmul_concat"] += 1
            out["grouped_matmul_bwd"] += 1
        elif g.mode == "stacked":
            out["branch_matmul"] += 3
        else:
            raise ValueError(f"plan_launches: no count for {g.mode}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the float64 reference on the planned forward's own pieces
# ---------------------------------------------------------------------------

def _pool_choices(x, chain, planes=None):
    """(output, the window element each stage chose) of a max-pool chain
    on NHWC ``x``; each stage's choices are flat indices into its padded
    (H, W) plane, as ``F.max_pool2d`` returns them.  Each stage's padded
    NCHW input is appended to ``planes`` when it is given."""
    import torch.nn.functional as F
    from repro_torch.models import cnn
    idx = []
    for k, s in chain:
        xp = cnn._pool_pad(x, k, s)
        y, i = F.max_pool2d(xp, k, s, return_indices=True)
        idx.append(i)
        if planes is not None:
            planes.append(xp)
        x = y.permute(0, 2, 3, 1)
    return x, idx


def _conv_block(params, name):
    """The {"w", "b"} of the conv op ``name`` (``stem<i>`` or
    ``inc<i>/<branch>``)."""
    if name.startswith("stem"):
        return params["stem"][int(name[4:])]
    mod, br = name.split("/")
    return params["modules"][int(mod[3:])][
        {"1x1": "b1", "3x3": "b3", "5x5": "b5"}.get(br, br)]


def planned_pieces(params, cfg, images, plan):
    """The pieces of the piecewise-linear network that the planned f32
    forward took: each conv's ReLU pattern (value > 0; for a conv whose
    output landed in a ``grouped_concat`` join, its channel slice of the
    join) and the window element each standalone max-pool chose on its
    f32 input.  The forward runs through ``core.plan.run_plan`` directly,
    so its op-to-value env is kept.  Returns (masks, choices) by op."""
    import torch
    from repro_torch.core import plan as planlib
    from repro_torch.models import cnn
    impls, _ = cnn._plan_impls(params, cfg)
    env = {"input": images}
    masks, choices = {}, {}
    with torch.no_grad():
        planlib.run_plan(impls, env, plan)
        for g in plan.groups:
            if g.pools or g.mode == "grouped_chained":
                raise ValueError(f"{g.mode} group {g.ops} absorbs its pools: "
                                 f"their choices never reach the env")
            for n in g.ops:
                impl = impls.get(n)
                if impl is None:
                    continue
                if impl.pool_chain is not None:
                    out, choices[n] = _pool_choices(env[impl.deps[0]],
                                                    impl.pool_chain)
                    if not torch.equal(out, env[n]):
                        raise RuntimeError(f"{n}: the recorded pool "
                                           f"choices do not give the planned "
                                           f"forward's output")
                elif impl.gemm_w is not None:
                    if n in env:
                        v = env[n]
                    else:
                        off = 0
                        for d in impls[g.join].deps:
                            if d == n:
                                break
                            off += impls[d].gemm_w.shape[1]
                        v = env[g.join][..., off:off + impl.gemm_w.shape[1]]
                    masks[n] = v > 0
    return masks, choices


def pieces_forward64(params, cfg, images, labels, pieces=None, seen=None):
    """The plain forward, in the op graph's order and the dtype of its
    inputs (float64 here): each conv ``relu(conv(x, w) + b)``, each
    max-pool chain, each join a concatenate, then the head and the plain
    path's loss.  With ``pieces`` = (masks, choices) of a planned f32
    forward (``planned_pieces``), ``relu(z)`` becomes ``z * mask`` and
    each max-pool a gather at the element the planned forward chose: the
    same piecewise-linear function, on the pieces that forward took.
    Without ``pieces``, ``seen`` (a dict, when given) gets each conv's
    ReLU input and each pool's padded stage inputs, for ``flip_shares``.
    Returns (loss, the pieces this forward took)."""
    import torch
    from repro_torch.kernels.ref import conv2d_ref
    from repro_torch.models import cnn
    from repro_torch.models import layers as L
    impls, out_name = cnn._plan_impls(params, cfg)
    val = {"input": images}
    masks, choices = {}, {}
    for n, impl in impls.items():
        xs = [val[d] for d in impl.deps]
        if impl.pool_chain is not None:
            x = xs[0]
            if pieces is None:
                planes = seen.setdefault(n, []) if seen is not None else None
                x, choices[n] = _pool_choices(x, impl.pool_chain, planes)
            else:
                for (k, s), i in zip(impl.pool_chain, pieces[1][n]):
                    x = cnn._pool_pad(x, k, s).flatten(2).gather(
                        2, i.flatten(2)).reshape(i.shape).permute(0, 2, 3, 1)
            val[n] = x
        elif impl.gemm_w is not None:
            pb = _conv_block(params, n)
            z = conv2d_ref(xs[0], pb["w"], stride=impl.chain_geom[2]) \
                + pb["b"]
            if pieces is None:
                masks[n] = z > 0
                val[n] = torch.relu(z)
                if seen is not None:
                    seen[n] = z
            else:
                val[n] = z * pieces[0][n].to(z.dtype)
        else:
            val[n] = torch.cat(xs, dim=-1)
    logits = val[out_name].mean(dim=(1, 2)) @ params["head"]["w"] \
        + params["head"]["b"]
    return L.cross_entropy(logits, labels), (masks, choices)


def pieces_grads64(params, cfg, batch, pieces):
    """(loss, gradients) of ``pieces_forward64`` on ``pieces``, by autograd
    in float64, at ``params`` cast to float64: the derivative of the
    planned forward's own piecewise-linear function, so a planned f32
    gradient differs from it by rounding only."""
    import torch
    from repro_torch.optim import tree_leaves, tree_map
    leaves = [p.detach().double().requires_grad_(True)
              for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, _ = pieces_forward64(live, cfg, batch["images"],
                                   batch["labels"], pieces)
        grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def piece_flips(a, b):
    """(ReLU elements, pool outputs) on which the pieces ``a`` and ``b``
    differ, and the totals of each."""
    relu = sum(int((a[0][n] != b[0][n]).sum()) for n in a[0])
    pool = sum(int((x != y).sum()) for n in a[1]
               for x, y in zip(a[1][n], b[1][n]))
    return (relu, sum(m.numel() for m in a[0].values()), pool,
            sum(i.numel() for n in a[1] for i in a[1][n]))


def flip_shares(a, b, seen):
    """How far from its kink each flip between the pieces ``a`` (a planned
    f32 forward's) and ``b`` (the float64 forward's that filled ``seen``)
    lies, as a share of its scale in the float64 forward: a flipped
    ReLU's |z| over max|z| of its conv; a flipped pool choice's shortfall
    (the window maximum ``b`` chose less the element ``a`` chose) over
    max|x| of that stage's finite input.  Rounding puts a flip near f32's
    epsilon of its scale; a forward that zeroes or moves activations puts
    it near 1.  Returns {op (pool stage ``op[j]``): worst share} of the
    ops with a flip, worst first; a share that is not a number counts as
    past any bound."""
    out = {}
    for n, m in a[0].items():
        flip = m != b[0][n]
        if flip.any():
            z = seen[n].abs()
            out[n] = float(z[flip].max() / z.max())
    for n, stages in a[1].items():
        for j, (ia, ib, plane) in enumerate(zip(stages, b[1][n], seen[n])):
            flip = ia != ib
            if flip.any():
                p = plane.flatten(2)
                va = p.gather(2, ia.flatten(2)).reshape(ia.shape)
                vb = p.gather(2, ib.flatten(2)).reshape(ib.shape)
                scale = p[p.isfinite()].abs().max()
                out[f"{n}[{j}]"] = float((vb - va)[flip].max() / scale)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]
                       if kv[1] == kv[1] else -math.inf))


def check_baseline_training(cfg, dev, shared, name):
    """Phase 5, one of the paper's baselines (``BASELINES[name]``); returns
    the launch counts of its planned steps.

    The planned steps start from the concurrent run's init and batches.
    Losses are held to the float64 run's (the plain path, which does not
    depend on the plan).  At every step, on the float64 run's parameters,
    the planned gradients are held to ``pieces_grads64`` on the pieces
    the planned f32 forward took at those parameters and that batch, and
    every ReLU sign and pool choice on which those pieces differ from
    the plain float64 forward's must lie within ``PIECE_RTOL`` of its
    kink (``flip_shares``), so the pieces differ by rounding only and a
    forward that zeroes or moves activations fails here.  The planned
    gradients' error against the plain float64 run and the plain f32
    path's are printed, not held, with the number of flips."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    from repro_torch.optim import tree_map
    kw, expected = BASELINES[name]
    params, batches, opt = shared["params"], shared["batches"], \
        shared["opt"]
    plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True, **kw)
    implied = plan_launches(plan)
    print(f"[train] {name} ({kw}): {cfg.name} batch {TRAIN_BATCH}, plan "
          f"{plan.mode_counts()}, backward plan "
          f"{plan.context['backward'].mode_counts()}; launches per step "
          f"derived from the plan: " + ", ".join(
              f"{k} {v}" for k, v in implied.items() if v))
    if implied != expected:
        raise RuntimeError(f"{name}: the plan implies {implied} launches "
                           f"per step, expected {expected}")
    planned = steps.make_cnn_train_step(cfg, opt, plan=plan, device=dev)
    # this plan's main path: counters set to 0 just before, read after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtime.reset_launch_counts()
    _, l_plan, t_plan, per_step, _ = _run_steps(planned, params, opt,
                                                batches)
    launches = dict(runtime.KERNEL_LAUNCHES)
    shared["peaks"][name] = torch.cuda.max_memory_allocated() / 2**30
    shared["times"][name] = t_plan
    for i, (a, b, ta, ls) in enumerate(zip(l_plan, shared["l_64"], t_plan,
                                           per_step)):
        print(f"[train] {name} step {i + 1}: loss planned {a:.8f} float64 "
              f"{b:.8f}; ms planned {ta:.3f}; launches " + ", ".join(
                  f"{k} {v}" for k, v in ls.items()))
        if not abs(a - b) <= LOSS_RTOL * abs(b):
            raise RuntimeError(f"{name} step {i + 1}: planned loss {a} vs "
                               f"float64 {b} beyond {LOSS_RTOL} relative")
        if ls != expected:
            raise RuntimeError(f"{name} step {i + 1}: launches {ls}, "
                               f"expected {expected}")
    if not all(math.isfinite(v) for v in l_plan):
        raise RuntimeError(f"{name}: planned losses not finite: {l_plan}")
    for i, (p_i, b) in enumerate(zip(shared["traj64"], batches)):
        p32 = tree_map(lambda t: t.float(), p_i)
        b32, b64 = steps.to_device_batch(b, dev), _f64(b, dev)
        _, gp = steps.cnn_loss_and_grads(p32, cfg, b32, plan=plan)
        pieces = planned_pieces(p32, cfg, b32["images"], plan)
        _, gm = pieces_grads64(p_i, cfg, b64, pieces)
        worst = _tree_check(f"{name} step {i + 1} gradients, planned vs "
                            f"float64 on the planned pieces", gp, gm)
        _, gr = steps.cnn_loss_and_grads(p32, cfg, b32)
        _, g64 = steps.cnn_loss_and_grads(p_i, cfg, b64)
        seen = {}
        with torch.no_grad():
            _, nat = pieces_forward64(p_i, cfg, b64["images"],
                                      b64["labels"], seen=seen)
        rf, rn, pf, pn = piece_flips(pieces, nat)
        shares = flip_shares(pieces, nat, seen)
        worst_op, worst_share = next(iter(shares.items()), ("none", 0.0))
        print(f"[train] {name} step {i + 1} gradients on the float64 run's "
              f"parameters: worst err/limit against float64 on the planned "
              f"pieces (held): planned {worst:.3e}; against the plain "
              f"float64 run (printed): planned {_tree_ratio(gp, g64):.3e}, "
              f"plain f32 {_tree_ratio(gr, g64):.3e}; planned f32 vs plain "
              f"float64 forward: {rf} of {rn} ReLU signs and {pf} of {pn} "
              f"pool choices differ, the worst {worst_share:.3e} of its "
              f"scale from its kink ({worst_op}; held at {PIECE_RTOL})")
        bad = {k: v for k, v in shares.items() if not v <= PIECE_RTOL}
        if bad:
            raise RuntimeError(f"{name} step {i + 1}: the planned f32 "
                               f"forward took pieces the float64 forward "
                               f"did not, beyond rounding ({PIECE_RTOL} of "
                               f"the scale): {bad}")
        del gp, gm, gr, g64, pieces, nat, seen
    print(f"[train] {name} launches over the {TRAIN_STEPS} planned steps: "
          f"{launches}")
    return launches


def print_step_times(shared, card):
    """The median host-clock step time of steps 2-4 of every plan and of
    the plain f32 path, with images/s and each plan's peak memory."""
    def fmt(t):
        med = statistics.median(t[1:])
        return f"{med:.3f} ms ({TRAIN_BATCH / med * 1e3:.3f} images/s)"
    parts = [f"{k} {fmt(t)}, peak {shared['peaks'][k]:.2f} GiB"
             for k, t in shared["times"].items()]
    print(f"[train] step time (median of steps 2-{TRAIN_STEPS}, host clock "
          f"to synchronize; {card}): " + "; ".join(parts)
          + f"; plain f32 {fmt(shared['t_plain'])}")


# ---------------------------------------------------------------------------
# phase 5b: full-width MoE training, grouped engine against einsum engine
# ---------------------------------------------------------------------------

def _leaf_names(tree, prefix=""):
    """Dotted names of a parameter tree's leaves, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


@contextlib.contextmanager
def routes_recorded():
    """Record each MoE layer's expert set per token (the router's top-k
    ids, sorted) while the block is active; yields the list."""
    import torch
    from repro_torch.models import moe
    real, out = moe._route, []

    def rec(params, x, **kw):
        r = real(params, x, **kw)
        b, s = x.shape[:2]
        out.append(torch.sort(r[1].reshape(b, s, kw["top_k"]), dim=-1)
                   .values)
        return r
    moe._route = rec
    try:
        yield out
    finally:
        moe._route = real


def check_moe_training(cfg, params, dev):
    """Phase 5b; returns the launch counts of the grouped steps."""
    import dataclasses
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import tree_leaves
    batches = lm_batches(cfg)
    tokens = LM_BATCH * LM_SEQ
    print(f"[moe] {cfg.name}: {cfg.param_count() / 1e6:.1f}M parameters, "
          f"batch {LM_BATCH} x seq {LM_SEQ}, {cfg.moe.n_experts} experts "
          f"top-{cfg.moe.top_k}, capacity factor {cfg.moe.capacity_factor}")
    # step 1 on equal parameters: gradients and routing of both engines
    grads, routes = {}, {}
    b0 = steps.to_device_batch(batches[0], dev)
    for impl in ("grouped", "einsum"):
        with routes_recorded() as r:
            _, _, g = steps.loss_and_grads(transformer.loss_fn, params, cfg,
                                           b0, moe_impl=impl, remat=False)
        bad = [n for n, t in zip(_leaf_names(g), tree_leaves(g))
               if not bool(torch.isfinite(t).all())]
        if bad:
            raise RuntimeError(f"{impl} engine: gradients not finite: {bad}")
        grads[impl], routes[impl] = g, r
    worst = 0.0
    for n, a, b in zip(_leaf_names(params), tree_leaves(grads["grouped"]),
                       tree_leaves(grads["einsum"])):
        lim = LOGIT_RTOL * float(b.abs().max()) + 1e-6
        ratio = float((a - b).abs().max()) / lim
        worst = max(worst, ratio)
        print(f"[moe] step 1 gradient {n} {tuple(a.shape)}: err/limit "
              f"{ratio:.3e} against the einsum engine (printed, not held)")
    flips = sum(int((a != b).any(-1).sum())
                for a, b in zip(routes["grouped"], routes["einsum"]))
    pairs = sum(a.shape[0] * a.shape[1] for a in routes["einsum"])
    print(f"[moe] step 1: all gradients finite on both engines; worst "
          f"gradient err/limit {worst:.3e}; (token, layer) pairs with a "
          f"different expert set {flips} of {pairs} (printed, not held)")
    del grads, routes, b0

    opt = dataclasses.replace(steps.make_optimizer(cfg), lr=LM_LR,
                              total=LM_STEPS,
                              warmup=max(LM_STEPS // 20, 1))
    res = {}
    launches = cuda = None
    for impl in ("grouped", "einsum"):
        step = steps.make_train_step(cfg, opt, remat=False, moe_impl=impl,
                                     device=dev)
        p, st = params, opt.init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, gnorms, times, per_step, cuda_step = [], [], [], [], []
        if impl == "grouped":
            # the MoE main path: counters set to 0 just before, read after
            runtime.reset_launch_counts()
        for b in batches:
            before = dict(runtime.KERNEL_LAUNCHES)
            before_c = dict(runtime.CUDA_LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, st, met = step(p, st, b)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: runtime.KERNEL_LAUNCHES[k] - before[k]
                             for k in before})
            cuda_step.append({k: runtime.CUDA_LAUNCHES[k] - before_c[k]
                              for k in before_c})
        if impl == "grouped":
            launches = dict(runtime.KERNEL_LAUNCHES)
            cuda = dict(runtime.CUDA_LAUNCHES)
        res[impl] = (losses, gnorms, times, per_step, cuda_step,
                     torch.cuda.max_memory_allocated() / 2**30)
        del p, st, step
    lg, gg, tg, sg, cg, mg = res["grouped"]
    le, ge, te, se, _, me = res["einsum"]
    for i in range(LM_STEPS):
        per_call = {k: cg[i][k] / sg[i][k] for k in MOE_KERNELS if sg[i][k]}
        print(f"[moe] step {i + 1}: loss grouped {lg[i]:.8f} einsum "
              f"{le[i]:.8f}; grad norm grouped {gg[i]:.6f} einsum "
              f"{ge[i]:.6f}; ms grouped {tg[i]:.3f} einsum {te[i]:.3f}; "
              f"grouped launches " + ", ".join(
                  f"{k} {v}" for k, v in sg[i].items() if v)
              + f"; CUDA launches per wrapper call {per_call}")
        if not abs(lg[i] - le[i]) <= LOSS_RTOL * abs(le[i]):
            raise RuntimeError(f"step {i + 1}: grouped loss {lg[i]} vs "
                               f"einsum {le[i]} beyond {LOSS_RTOL} relative")
        if not (math.isfinite(gg[i]) and math.isfinite(ge[i])):
            raise RuntimeError(f"step {i + 1}: gradient norm not finite")
        if sg[i] != LM_LAUNCHES:
            raise RuntimeError(f"step {i + 1}: grouped launches {sg[i]}, "
                               f"expected {LM_LAUNCHES}")
    if any(sum(x.values()) for x in se):
        raise RuntimeError(f"the einsum engine launched port kernels: {se}")
    mg_t, me_t = statistics.median(tg[1:]), statistics.median(te[1:])
    print(f"[moe] step time (median of steps 2-{LM_STEPS}, host clock to "
          f"synchronize): grouped {mg_t:.3f} ms ({tokens / mg_t * 1e3:.1f} "
          f"tokens/s), einsum {me_t:.3f} ms ({tokens / me_t * 1e3:.1f} "
          f"tokens/s); peak memory grouped {mg:.2f} GiB, einsum "
          f"{me:.2f} GiB")
    print(f"[moe] launches over the {LM_STEPS} grouped steps: {launches}; "
          f"CUDA launches of the expert wrappers {cuda}")
    return launches


def profile_moe_step(cfg, params, dev):
    """Where one warm grouped-engine MoE training step's time goes."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    opt = dataclasses.replace(steps.make_optimizer(cfg), lr=LM_LR,
                              total=LM_STEPS, warmup=1)
    step = steps.make_train_step(cfg, opt, remat=False, moe_impl="grouped",
                                 device=dev)
    batches = lm_batches(cfg)
    st = opt.init(params)
    p, st, _ = step(params, st, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, st, met = step(p, st, batches[1])
        float(met["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile(f"moe step ({cfg.name}, batch {LM_BATCH} x seq "
                   f"{LM_SEQ}, grouped engine)", prof, wall_ms, top=12)


def profile_train_step(cfg, dev, name="concurrent"):
    """Where one warm planned training step's time goes (the concurrent
    plan, or the baseline ``BASELINES[name]``): host wall against the
    device time ``torch.profiler`` attributes to kernels, the idle share,
    and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    params, batches, planned, _, opt, _ = train_setup(cfg, dev)
    if name != "concurrent":
        plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True,
                               **BASELINES[name][0])
        planned = steps.make_cnn_train_step(cfg, opt, plan=plan, device=dev)
    st = opt.init(params)
    params, st, _ = planned(params, st, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, st, met = planned(params, st, batches[1])
        float(met["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile(f"train step {name} (batch {TRAIN_BATCH})", prof,
                   wall_ms)


def _print_profile(tag, prof, wall_ms, top=8):
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        # kernel rows only: an operator row repeats its kernels' time
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    dev_ms = sum(r[0] for r in rows)
    if dev_ms == 0:
        print(f"[profile] {tag}: wall {wall_ms:.3f} ms (host clock, "
              f"profiler on); device time not measured")
        return
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms (host clock, profiler "
          f"on), device busy {dev_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {key[:90]}")


def profile_dispatches(params, cfg):
    """Where one warm dispatch's time goes, per bucket: host wall against
    the device time ``torch.profiler`` attributes to kernels, the idle
    share that leaves, and the kernels that take most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan_cache
    from repro_torch.launch.steps import make_cnn_serve_step
    g = torch.Generator().manual_seed(3)
    for bucket in (1, 2, 4):
        step = make_cnn_serve_step(
            cfg, plan_cache.cached_cnn_plan(cfg, bucket,
                                            chain_modules=True).plan)
        x = torch.randn((bucket,) + cfg.img, generator=g).cuda()
        for _ in range(2):
            step(params, x, bucket)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, x, bucket)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _print_profile(f"bucket {bucket}", prof, wall_ms)


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.googlenet import CONFIG
    from repro_torch.core import plan_cache
    from repro_torch.kernels import build, runtime
    from repro_torch.launch.serve import serve_cnn_metrics
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    # 1. device
    card = card_line()
    print(f"[device] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    build.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_SECONDS['last']:.1f} s)")

    params = cnn.init_params(CONFIG, torch.Generator().manual_seed(0), dev)
    if argv == ["--profile"]:
        profile_dispatches(params, CONFIG)
        for name in ("concurrent",) + tuple(BASELINES):
            profile_train_step(CONFIG, dev, name)
        del params
        profile_moe_step(*lm_setup(dev), dev)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    # 3. kernels against their plain versions at main-path shapes
    serve = capture_calls(params, CONFIG, dev)
    train = capture_train_calls(params, CONFIG, dev)
    calls = {n: [("serve",) + c for c in serve.get(n, [])]
             + [("train",) + c for c in train.get(n, [])]
             for n in SERVE_KERNELS + TRAIN_KERNELS}
    del serve, train
    print("[kernels] captured calls: " + ", ".join(
        f"{k} {len(v)} ({sum(c[0] == 'train' for c in v)} from training)"
        for k, v in calls.items()))
    rows = check_kernels(calls)
    del calls
    # K9 at the shapes of the stacked plan's training step
    calls = capture_stacked_calls(params, CONFIG, dev)
    print(f"[kernels] captured calls: branch_matmul "
          f"{len(calls['branch_matmul'])} (one stacked-plan training step)")
    rows.update(check_kernels(calls))
    del calls
    # K11 and K12 at the shapes of full-width granite-moe-1b-a400m
    t0 = time.perf_counter()
    lm_cfg, lm_params = lm_setup(dev)
    print(f"[kernels] {lm_cfg.name} parameters made in "
          f"{time.perf_counter() - t0:.1f} s")
    calls = capture_moe_calls(lm_params, lm_cfg, dev)
    print("[kernels] captured calls: " + ", ".join(
        f"{k} {len(v)} (one MoE training step)" for k, v in calls.items()))
    rows.update(check_kernels(calls))
    del calls
    check_expert_block_sizes(dev)
    torch.cuda.empty_cache()

    # 4. full-width logits
    check_logits(params, CONFIG, dev)
    plan_cache.reset(clear_entries=True)

    # 5. training: the training main path, counters zeroed just before;
    # then the serial and stacked baselines, each zeroed just before
    train_launches, shared = check_training(CONFIG, dev)
    for name in TRAIN_KERNELS:
        rows[name]["launches"] = train_launches[name]
    for name in BASELINES:
        launches = check_baseline_training(CONFIG, dev, shared, name)
        if name == "stacked":
            rows["branch_matmul"]["launches"] = launches["branch_matmul"]
    print_step_times(shared, card)
    del shared
    torch.cuda.empty_cache()

    # 5b. MoE training: the grouped engine's main path, counters zeroed
    # just before
    moe_launches = check_moe_training(lm_cfg, lm_params, dev)
    for name in MOE_KERNELS:
        rows[name]["launches"] = moe_launches[name]
    del lm_params
    torch.cuda.empty_cache()

    # 6. serving: the main path, counters zeroed just before
    runtime.reset_launch_counts()
    m = serve_cnn_metrics(CONFIG, max_images=4, num_requests=12,
                          seed=SERVE_SEED, device="cuda")
    launches = dict(runtime.KERNEL_LAUNCHES)
    chained_calls = runtime.CHAINED_CALLS
    print(f"[serve] {m['requests']} requests, {m['images']} images "
          f"(submitted {m['images_submitted']}) in {m['dispatches']} "
          f"dispatches, buckets {m['buckets']}")
    print(f"[serve] qps {m['qps']:.3f}, images/s {m['images_per_s']:.3f}, "
          f"request p50 {m['p50_ms']:.3f} ms p99 {m['p99_ms']:.3f} ms, "
          f"dispatch p50 {m['dispatch_p50_ms']:.3f} ms p99 "
          f"{m['dispatch_p99_ms']:.3f} ms, padded-M waste "
          f"x{m['padded_m_factor_mean']:.4f}, plan cache {m['plan_cache']}")
    if m["plan_cache"]["hit_rate"] != 1.0 \
            or m["images"] != m["images_submitted"]:
        raise RuntimeError(f"serving run failed its checks: {m}")
    # 7. launch counts: the whole run, then per bucket and dispatch
    print(f"[launches] {launches}; chained wrapper calls {chained_calls} "
          f"(one launch each on the TPU, one per phase here: "
          f"{launches['grouped_matmul_chained']})")
    for stage in ("warmup", "measured"):
        for b, row in sorted(m["launches"][stage].items()):
            nd = row["dispatches"]
            per = ", ".join(f"{k} {row[k] / nd:g}" for k in SERVE_KERNELS)
            print(f"[launches] {stage} bucket {b}: {nd} dispatches; per "
                  f"dispatch {per}")
    measured = m["launches"]["measured"]
    if sorted(measured) != sorted(m["buckets"]):
        raise RuntimeError(f"measured stream dispatched at buckets "
                           f"{sorted(measured)}, not at every bucket of "
                           f"{m['buckets']}")
    for name in SERVE_KERNELS:
        if launches[name] <= 0 \
                or sum(r[name] for r in measured.values()) <= 0:
            raise RuntimeError(f"{name} never launched in the measured "
                               f"stream of the main path")
        rows[name]["launches"] = launches[name]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows[n] for n in REPLACES]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({e})", file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1:]))
