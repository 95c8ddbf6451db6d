#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # only: where a warm dispatch's
                                       # time goes, per serving bucket,
                                       # a warm training step's (the
                                       # concurrent, serial and stacked
                                       # plans), a warm grouped MoE
                                       # step's, a warm mamba2 prefill's
                                       # and decode step's and a granite
                                       # decode step's

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
              one of its 24 layers; the phase 5b model and batch), K14
              from one ``impl="pallas"`` prefill of full-width
              mamba2-370m (all 48 layers; the phase 6b model, prompts
              and batch), K13 from one ``impl="pallas"`` forward of
              full-width llama3-8b (all 32 layers) and of full-width
              gemma2-27b cut to 2 layers (the phase 4b models and batch;
              run after phase 6b, on a card the other phases have left
              empty), and K10, K8 and K7 from phase 3b's paths (K10 the
              fused plan's call at full width and the reference's
              kernel-test cases; K8 the GEMM zoo's 512x1024x512 and the
              training step's 6 captured K4 calls, dW GEMMs with K up to
              100352, each printed with its split count and workspace;
              K7 the training step's 18 captured K5 calls); then
              hold each kernel against its plain
              torch version on the same inputs, each output tensor on its
              own (a branch's columns of a joint output, K5's dx, dw
              and db, K9's branches, K11's y and in/gate pre-activations,
              K12's dx, dW_in, dW_gate and dW_out, K14's y_diag, states
              and cum, apart): max abs error <= 1e-3 * max|ref| + 1e-9,
              K13 also <= 1.5e-4 * max|ref| + 1e-9 (``FLASH_TOL``) and
              K14 also <= 1e-4 * max|ref| + 1e-9 (``SSD_TOL``): 3xTF32's
              accuracy, which one-pass TF32 misses.  K13's and K14's
              bounds are 3xTF32's (three TF32 products per f32 product
              at 495 TFLOP/s), the f32 bound printed beside them.
              Time the wrapper (CUDA events around the whole call, fills
              and per-phase host gaps included), its kernels' own device
              time (``torch.profiler``), the plain version and a torch
              library yardstick (``torch.bmm`` for K9; ``torch.matmul``
              for K4 and K8, then the silu-sum for K10, per branch with
              the db sum for K7; for K11/K12: the
              capacity-padded einsum engine's expert GEMMs of the same
              layer; none for K14, which no one torch call computes;
              ``F.scaled_dot_product_attention`` with ``enable_gqa``
              for K13, none with a softcap, which no one torch call
              computes; K13 3 timed calls per case, its plain version
              materialising the (Hq, Sq, Skv) f32 scores; K13's device
              time is that of its 34 launches in phase 4b's two
              profiled forwards, since few-call profiler windows this
              late in the script lose its records).  K13 is also held, untimed, at the
              reference's kernel-test cases and three more
              (``FLASH_CASES``), and K14 at ragged and grouped shapes
              (``SSD_SHAPES``).
              K11 and K12 are
              also held, untimed, at every block size bm 8..128 on small
              synthetic packings, and at D and F not multiples of 4
              (``check_expert_block_sizes``).  Each
              K1, K2, K4 and K5 line prints the call's split count of its
              long contraction and its CTAs, and a second call on the
              same inputs must be bitwise equal.  K6 is held, timed and
              bitwise-repeated on every chain of both captured forwards
              (8 at bucket 1, 10 at bucket 2) and on the stem and inc0
              chains of bucket 2 again with one real image of two; each
              line prints the launch's work items, output tiles, splits
              per phase, waves of CTAs and the multiply-adds it issues
              over those the chain needs (``chained_launch``), and the
              sums of each bucket's chains and of the ragged pair are
              printed apart.  K6's library yardstick multiplies each
              branch's live depth: an (m_valid, live rows) lhs against
              the weight's live rows, the work the kernel does.  K2's
              lines name each branch's lhs (dense, or its tap views read
              in place); its
              bound counts the distinct elements its views cover, and its
              library yardstick multiplies one tap, copied to (M, K)
              before the timing (it pools nothing).  K2 is also timed on
              the training step's calls with every pooled lhs folded
              beforehand, their sums printed apart as ``train
              unpooled``.  K3 and K4 are also held, timed and
              bitwise-repeated on all 51 and 119 calls of one
              serial-plan training step (``plan_cnn(concurrent=False,
              train=True)``), their sums printed as ``conv2d_direct
              serial`` and ``matmul serial``, and K9 on Winograd's call
              of phase 3b's conv zoo (``zoo winograd``).  Each K3 and
              K9 line prints its launch plan (k-steps, tiles, splits,
              CTAs), and a second call on the same inputs must be
              bitwise equal; K3 is also held, untimed, at
              ``DIRECT_CASES`` and K9 at ``BMM_CASES`` in all four
              operand layouts.
  3b. zoo     co-execution and the zoo, at full width.  The fused pair
              of the reference's benchmark (a 2048^3 f32 GEMM beside a
              65536 x 128 silu-sum, numpy seed 0, 84 MB): ``schedule``
              then ``lower`` give one fused group; ``run_plan``, forward
              and backward, with counters set to 0 just before and read
              just after, makes exactly 1 K10 launch and nothing else;
              its outputs and gradients (dx, dw, dz) held against plain
              torch; the serial plan of the same graph with the GEMM on
              K4 (``large_tile`` and ``mxu128``) and on K8 (``ksplit``),
              one launch each, held to the same values; the warm forward
              time of each and of the plain pair, and the device time of
              the fused plan against the serial plan on K4 (every kernel
              of a call, in turns), printed, not held (the paper's
              co-location question).  The GEMM zoo at
              512x1024x512 and paper Table 1's inception-3a convs
              (28x28, 96->128 3x3 and 16->32 5x5, batch 4): every
              supported algorithm through ``ops.matmul`` / ``ops.conv2d``
              held to ``torch.matmul`` / ``F.conv2d`` (TF32 off), ksplit
              exactly one K8 launch, Winograd exactly one K9 launch and
              refused on the 5x5 as ``conv2d_supported`` says; time and
              workspace bytes per algorithm.  ``ops.grouped_matmul_dw``
              on the training step's 18 captured K5 calls: exactly one
              K7 launch each, dw and db bitwise equal to K5's on the
              same call.  K8 and K7 are also held, untimed, at
              ``KSPLIT_SHAPES`` (both operand layouts) and ``DW_SETS``
              (with and without the mask; K7 also bitwise against K5).
              In phase 3 every K10 capture's c is bitwise equal to K4
              ``mxu128``'s on the same operands, and K10's and K7's
              captures repeat bit for bit.
  4. logits   the planned forward with kernels at buckets 1, 2 and 4
              (bucket 4 also ragged, 3 real images) against the port's
              plain ``forward`` on the card.
  4b. attention LMs  full-width llama3-8b (32 layers, 8.03B parameters
              drawn on the card from seed 0) and full-width gemma2-27b
              cut to 2 of its 46 layers (window 4096 and global,
              softcaps 50 and 30), batch 1 x seq 8192, ``SyntheticLM``
              seed 0, f32 with TF32 off, each made after the one before
              is freed (run after phase 6b): the ``impl="pallas"``
              forward (K13 on every layer) against ``impl="xla"``,
              logits within 1e-3 * max|logit| + 1e-6 and ``loss_fn``'s
              value within 1e-3 relative, both under ``torch.no_grad()``;
              counters set to 0 just before each forward and read just
              after: exactly 32 (llama3) and 2 (gemma2) K13 launches and
              nothing else per pallas forward, none per xla one.  Prints
              each impl's warm forward ms (host clock, median of 3),
              tokens/s and peak memory, and where one warm pallas
              forward's device time goes (``torch.profiler``).
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
              are printed per bucket, warmup and measured apart; K6's
              launches equal the chained wrapper's calls (one launch a
              chain), and a measured dispatch launches K6 once per
              ``grouped_chained`` group of its bucket's plan (8, 10, 10
              at buckets 1, 2, 4).
  6b. LM serving  full-width mamba2-370m (48 layers, 368.08M
              parameters from ``torch.Generator().manual_seed(0)``),
              batch 4, prompt 2048 (16 chunks of 128) from
              ``np.random.default_rng(0)``, TF32 off.  With the serving
              default's caches (bf16 conv tail, f32 SSM state), then with
              f32 caches: the ``impl="pallas"`` prefill (counters set to 0
              just before and read just after: exactly 48 K14 launches
              and nothing else) against the plain ``impl="xla"`` prefill:
              logits within 1e-3 * max|logit| + 1e-6, the SSM state per
              layer within 1e-3 * max|ref| + 1e-9, the conv tail per layer
              within that or (bf16) one bf16 spacing of each element;
              then 32 decode steps on each path's cache, teacher-forced
              with the plain path's greedy tokens, no kernel launched:
              the logits at every step held within 1e-3 * max|logit| +
              1e-6 on the f32 caches.  On the bf16 caches a conv entry
              rounded to the other bf16 neighbour moves a later step
              past that bound, so plain prefills at chunks 64 and 256
              (the same function in another rounding order) are held
              and decoded the same way as controls, and each pallas
              step is held within 2x the most a control drifted (or the
              bound); the tokens whose argmax differs and the top-2
              margin there.  Then the serving CLI's path
              (``launch.serve._serve_transformer``) with counters zeroed
              just before: mamba2-370m with ``impl="pallas"`` (exactly 48
              K14 launches, finite logits) and granite-moe-1b-a400m at
              batch 4, prompt 512, 16 tokens in plain torch (no launch,
              finite logits, the KV cache's shape); prefill ms, decode
              ms/token, tokens/s and peak memory of each.
  7. report   one JSON line of kernels (launches of K1-K3 and K6 from the
              serving run, of K4 and K5 from the planned training steps,
              of K9 from the stacked-plan training steps, of K11 and K12
              from the grouped MoE training steps, of K14 from the mamba2
              serving CLI run, of K13 from the llama3-8b pallas
              forward, of K10, K8 and K7 from phase 3b's paths), the
              card line again, and last the ``{"ok": true, ...}`` line.
              Every GoogLeNet, MoE and LM path (phases 4b, 5, 5b, 6 and
              6b) must launch K10, K8 and K7 0 times.

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
# K13 is also held, beside TOL, to FLASH_TOL * max|ref| + FLOOR: 3xTF32
# keeps f32's accuracy (at most 9.5e-5 relative on the card, at the
# deepest captured llama3-8b layers; about 1e-6 at FLASH_CASES), where a
# kernel that drops both small parts' products (one-pass TF32) or either
# of them misses it at some FLASH_CASES entry (bench_flash.py --variants)
FLASH_TOL = 1.5e-4
# K14 is also held, beside TOL, to SSD_TOL * max|ref| + FLOOR, y_diag,
# states and cum each on its own: 3xTF32 keeps f32's accuracy (at most
# 3.1e-5 relative on the card, at the captured mamba2-370m calls; about
# 3e-6 at SSD_SHAPES), where a kernel that drops both small parts'
# products (one-pass TF32) or either of them misses it at the captured
# calls and at some SSD_SHAPES entry (bench_ssd.py --variants)
SSD_TOL = 1e-4
LOGIT_RTOL = 1e-3      # logits: max abs err <= LOGIT_RTOL * max|ref| + 1e-6
PEAK_F32 = 67e12       # H100 SXM, f32 outside the tensor cores (FLOP/s)
PEAK_TF32 = 495e12     # H100 SXM, dense TF32 on the tensor cores (FLOP/s)
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
    "ssd_chunked": "src/repro/kernels/ssd.py:30 (_ssd_chunk_kernel)",
    "flash_attention":
        "src/repro/kernels/flash_attention.py:29 (_flash_kernel)",
    "fused_gemm_reduce":
        "src/repro/kernels/fused_branches.py:33 (_fused_kernel)",
    "matmul_ksplit": "src/repro/kernels/matmul.py:69 (_ksplit_kernel)",
    "grouped_matmul_dw":
        "src/repro/kernels/grouped_matmul.py:1115 (_gmm_dw_kernel)",
}
# the CUDA function each wrapper launches, as the profiler names it
KERNEL_FUNCS = {
    "grouped_matmul_concat": "gmm_kernel",
    "grouped_matmul_pooled": "gmm_kernel",
    "conv2d_direct": "conv2d_direct_kernel",
    "grouped_matmul_chained": "gmm_chained_kernel",
    "matmul": "matmul_kernel",
    "grouped_matmul_bwd": "gmm_bwd_kernel",
    # two stages each: moe_fwd_in/moe_fwd_out, experts_dh/experts_dxw
    "grouped_matmul_experts": "moe_fwd_",
    "grouped_matmul_experts_bwd": "experts_",
    "branch_matmul": "bmm_kernel",
    "ssd_chunked": "ssd_chunk_kernel",
    "flash_attention": "flash_fwd_kernel",
    "fused_gemm_reduce": "fused_kernel",
    "matmul_ksplit": "ksplit_kernel",
    "grouped_matmul_dw": "gmm_dw_kernel",
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
    "ssd_chunked": "src/repro_torch/csrc/ssd_chunk.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "fused_gemm_reduce": "src/repro_torch/csrc/fused_branches.cu",
    "matmul_ksplit": "src/repro_torch/csrc/matmul_ksplit.cu",
    "grouped_matmul_dw": "src/repro_torch/csrc/grouped_matmul_bwd.cu",
}
SERVE_KERNELS = ("grouped_matmul_concat", "grouped_matmul_pooled",
                 "conv2d_direct", "grouped_matmul_chained")
TRAIN_KERNELS = ("matmul", "grouped_matmul_bwd")
# kernels whose captures must repeat bit for bit on a second call (their
# split-K reductions sum in split order, whichever CTA finishes last; K13
# and K14 sum nothing across CTAs)
REPEAT_KERNELS = TRAIN_KERNELS + ("grouped_matmul_concat",
                                  "grouped_matmul_pooled",
                                  "grouped_matmul_chained", "conv2d_direct",
                                  "branch_matmul", "fused_gemm_reduce",
                                  "grouped_matmul_dw", "matmul_ksplit",
                                  "grouped_matmul_experts",
                                  "flash_attention", "ssd_chunked")
MOE_KERNELS = ("grouped_matmul_experts", "grouped_matmul_experts_bwd")
ZOO_KERNELS = ("fused_gemm_reduce", "matmul_ksplit", "grouped_matmul_dw")
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
                  "grouped_matmul_experts_bwd": 0, "branch_matmul": 0,
                  "ssd_chunked": 0, "flash_attention": 0,
                  "fused_gemm_reduce": 0, "matmul_ksplit": 0,
                  "grouped_matmul_dw": 0}
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
# the LM serving phase: full-width mamba2-370m, batch 4, prompt 2048 (16
# chunks of 128), 32 greedy decode steps, seed 0; the prefill takes
# impl="pallas" and launches K14 once per layer
SSM_ARCH = "mamba2-370m"
SSM_BATCH, SSM_PROMPT, SSM_GEN, SSM_SEED = 4, 2048, 32, 0
SSM_LAUNCHES = {k: 0 for k in TRAIN_LAUNCHES}
SSM_LAUNCHES["ssd_chunked"] = 48
# the yardstick for the bf16 caches: plain prefills at these chunks differ
# from the plain one at the model's chunk only in f32 rounding order; the
# K14 path's teacher-forced decode on bf16 caches may drift from plain by
# up to CONTROL_MARGIN times the most these controls drift (or the bound)
SSM_CONTROL_CHUNKS = (64, 256)
CONTROL_MARGIN = 2.0
# then full-width granite-moe-1b-a400m served in plain torch: batch 4,
# prompt 512, 16 decode steps
LMS_BATCH, LMS_PROMPT, LMS_GEN = 4, 512, 16
# the attention LMs (K13 in phase 3, the slice end to end in phase 4b):
# full-width llama3-8b uncut and full-width gemma2-27b cut to 2 of its
# 46 layers (one local, window 4096, and one global), batch 1 x seq 8192
# (llama3's context length), ``SyntheticLM`` seed 0, parameters drawn on
# the card from seed 0, f32 with TF32 off; the impl="pallas" forward
# launches K13 once per attention layer and nothing else
ATTN_ARCHS = {"llama3-8b": None, "gemma2-27b": 2}   # arch: layers kept
ATTN_BATCH, ATTN_SEQ, ATTN_SEED, ATTN_REPS = 1, 8192, 0, 3
# the reference's kernel-test cases (its tests/test_kernels_attention.py):
# (b, sq, skv, hq, hkv, d, causal, window, softcap)
FLASH_REF_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (1, 100, 100, 8, 8, 64, True, None, None),
    (1, 1, 256, 4, 1, 64, True, None, None),
    (2, 128, 128, 4, 4, 64, True, 32, None),
    (1, 96, 96, 2, 2, 64, True, None, 30.0),
    (1, 64, 64, 2, 2, 64, False, None, None),
    (1, 1, 300, 8, 2, 128, True, 64, 50.0),
    (2, 256, 256, 8, 2, 128, True, None, None),
]
# K13 is held untimed at these and three more: a window with a softcap
# at GQA group 4 and Sq 300, more queries than keys (the first rows see
# no key and come out as 0), and a non-causal window at head dim 32
# (the card tests and the CPU tests take their cases from here too)
FLASH_CASES = FLASH_REF_CASES + [
    (2, 300, 300, 8, 2, 32, True, 64, 50.0),
    (1, 200, 130, 4, 2, 128, True, None, None),
    (3, 70, 70, 6, 3, 32, False, 20, None),
]
# K14 is held untimed at these (the card tests and the CPU tests take
# their cases from here too): (batch, chunks, L, H, P, G, N), ragged L
# (7, 100, 40) and P (8, 20), d_state 16 to 128, G > 1, two cells of the
# full-width mamba2-370m layer, and a grouped case whose CTAs take fewer
# heads than a group has (``ssd_launch``: 2 of 24 on 132 SMs)
SSD_SHAPES = [(1, 2, 7, 2, 8, 1, 16), (2, 3, 32, 8, 32, 2, 32),
              (1, 2, 100, 4, 20, 4, 72), (1, 2, 128, 32, 64, 1, 128),
              (2, 4, 40, 48, 64, 2, 128)]
# co-execution and the zoo (phase 3b): the reference benchmark's fused
# pair (benchmarks/branch_parallel_bench.py), a 2048^3 f32 GEMM beside a
# 65536 x 128 silu-sum reduction, seed 0, (M, K, N, R, C)
FUSED_PAIR = (2048, 2048, 2048, 65536, 128)
ZOO_SEED = 0
# K10 is also held at the reference's kernel-test cases (its
# tests/test_kernels_fused.py) and four more: R = 1 beside 4 CTAs, M, K
# and N that no tile divides with R = 7 beside 9 CTAs (CTAs with no z
# rows), and C past 256 (300, and 1024: four columns a thread),
# (M, K, N, R, C).  These lists of cases, one per kernel, are the ones
# the card tests and the CPU tests take too
FUSED_REF_CASES = [(256, 256, 256, 1000, 64), (128, 384, 256, 77, 128),
                   (256, 128, 128, 4096, 32), (128, 128, 128, 7, 8)]
FUSED_CASES = FUSED_REF_CASES + [
    (256, 128, 256, 1, 8), (300, 70, 260, 7, 64),
    (200, 96, 72, 3000, 300), (64, 1000, 64, 5000, 1024)]
# K8, held untimed in both operand layouts: the reference's GEMM-zoo
# shapes (its tests/test_kernels_matmul.py) and a ragged K whose last
# split is short, (M, K, N)
KSPLIT_SHAPES = [(128, 128, 128), (256, 384, 512), (64, 200, 72),
                 (8, 1024, 16), (512, 128, 384), (100, 100, 100),
                 (70, 1000, 33)]
# K7, held untimed with and without the mask at M = 777: the reference's
# ragged branch sets (its tests/test_grouped_matmul.py), (K_g, N_g)
DW_SETS = [[(128, 128), (128, 128)], [(100, 60), (300, 129), (64, 16)],
           [(256, 128), (128, 128), (128, 128), (128, 128)],
           [(64, 384), (192, 32)], [(130, 250)],
           [(64, 96), (64, 16), (576, 208), (400, 48)]]
DW_M = 777
# K3, held untimed (and bitwise repeated) beside its captures: C in {3,
# 5, 24, 32} (4-byte and 16-byte lhs copies, k-steps cut at a tap's last
# channel), K in {16, 48, 64, 130} (half tiles, a ragged column tile),
# taps 1/3/5/7, stride 2 (asymmetric SAME pad), VALID, and bucket 1's
# inc8 3x3, its depth split over the SMs: (x shape, w shape, stride,
# padding).  The card tests and the CPU tests take their cases from here
DIRECT_CASES = [((2, 9, 9, 3), (7, 7, 3, 16), 2, "SAME"),
                ((1, 8, 8, 5), (3, 3, 5, 48), 1, "SAME"),
                ((2, 7, 6, 24), (5, 5, 24, 130), 1, "SAME"),
                ((1, 10, 10, 24), (1, 1, 24, 48), 1, "SAME"),
                ((2, 8, 8, 24), (3, 3, 24, 16), 2, "SAME"),
                ((1, 9, 11, 5), (3, 3, 5, 130), 1, "VALID"),
                ((3, 6, 6, 3), (5, 5, 3, 48), 2, "VALID"),
                ((1, 12, 12, 32), (3, 3, 32, 64), 1, "SAME"),
                ((1, 14, 14, 192), (3, 3, 192, 384), 1, "SAME")]
# K9, held the same way in all four operand layouts: G = 16 (Winograd's),
# M, K and N off multiples of 4, 16 and 128, a short K split over many
# CTAs, and the stacked step's inc1 dW contraction, (G, M, K, N)
BMM_CASES = [(16, 130, 37, 70), (4, 257, 515, 131), (2, 5, 3000, 9),
             (4, 256, 25088, 128)]
# the GEMM zoo's shape (the reference's benchmarks/paper_tables.py) and
# paper Table 1's two inception-3a convs at batch 4: (n, h, w, c, k, k_out)
ZOO_GEMM = (512, 1024, 512)
ZOO_CONVS = [(4, 28, 28, 96, 3, 128), (4, 28, 28, 16, 5, 32)]
# (timed calls, warmup calls, profiled calls) per K13 case: a full-width
# call takes tens of ms and its plain version materialises the whole
# (Hq, Sq, Skv) f32 score tensor.  No profiled calls: this late in the
# script a profiler window of a few K13 calls mostly keeps none of its
# records and now and then only some (a per-call time from it reads
# low); K13's device time comes from phase 4b's profiled forwards
FLASH_REPS = (3, 1, 0)


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
    """Device time per call of the CUDA function ``func`` alone (``""``:
    of every kernel, copy and fill ``fn`` runs), from ``torch.profiler``
    over ``reps`` calls; None when the profiler sees no such kernel in
    three tries (it drops a window's kernel records now and then)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
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
        if us > 0:
            return us / 1e3 / reps
    return None


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


def capture_serial_calls(params, cfg, dev):
    """Run one serial-plan training step's forward + backward (batch
    ``TRAIN_BATCH``, ``plan_cnn(concurrent=False, train=True)``) with the
    K3 and K4 wrappers recording their (args, kwargs): every conv but
    stem0 of the paper's serial baseline on K3 (51 calls) and every conv's
    dX and dW GEMM on K4 (119 calls); returns {"conv2d_direct": [("serial",
    args, kwargs), ...], "matmul": [...]}."""
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul as km
    from repro_torch.launch import steps
    from repro_torch.models import cnn

    plan, _ = cnn.plan_cnn(cfg, TRAIN_BATCH, train=True,
                           **BASELINES["serial"][0])
    batch = SyntheticImages(cfg.img, cfg.num_classes, TRAIN_BATCH,
                            seed=TRAIN_SEED).batch_at(0)
    with recording([(kc, "conv2d_direct"), (km, "matmul")]) as calls:
        steps.cnn_loss_and_grads(params, cfg,
                                 steps.to_device_batch(batch, dev),
                                 plan=plan)
    for name, got in calls.items():
        want = BASELINES["serial"][1][name]
        if len(got) != want:
            raise RuntimeError(f"serial step made {len(got)} {name} calls, "
                               f"expected {want}")
    return {name: [("serial",) + c for c in got]
            for name, got in calls.items()}


def unpooled_cases(cases):
    """The training step's K2 calls with each pooled branch's taps folded
    into a dense (M, K) lhs before the call."""
    from repro_torch.kernels import grouped_matmul as kg
    return [("train unpooled",
             ([kg._fold_rows(tuple(x)) if isinstance(x, (list, tuple))
               else x for x in a[0]],) + tuple(a[1:]), k)
            for path, a, k in cases if path == "train"]


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


def ssm_setup(dev):
    """(config, parameters, prompts) of the LM serving phase: full-width
    mamba2-370m, parameters from ``torch.Generator().manual_seed(
    SSM_SEED)``, prompts (SSM_BATCH, SSM_PROMPT) from
    ``np.random.default_rng(SSM_SEED)``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(SSM_ARCH)
    params = transformer.init_params(
        cfg, torch.Generator().manual_seed(SSM_SEED), dev)
    tokens = torch.from_numpy(np.random.default_rng(SSM_SEED).integers(
        0, cfg.vocab, (SSM_BATCH, SSM_PROMPT))).to(dev)
    return cfg, params, tokens


def capture_ssd_calls(params, cfg, tokens, dev):
    """Run one ``impl="pallas"`` prefill of the LM serving phase with the
    K14 wrapper recording its (args, kwargs); returns {"ssd_chunked":
    [(layer label, args, kwargs)]}, one call per layer."""
    from repro_torch.kernels import ssd as kssd
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, SSM_BATCH, SSM_PROMPT + SSM_GEN,
                                   device=dev)
    with recording([(kssd, "ssd_chunk")]) as calls:
        steps.make_prefill_step(cfg, impl="pallas")(params, tokens, cache)
    c = calls["ssd_chunk"]
    if len(c) != cfg.n_layers:
        raise RuntimeError(f"one prefill made {len(c)} K14 calls, expected "
                           f"{cfg.n_layers}")
    return {"ssd_chunked": [(f"layer {i}",) + x for i, x in enumerate(c)]}


def attn_setup(arch, dev):
    """(config, parameters, batch) of the attention-LM phase: the full
    width of ``arch`` with the layers ``ATTN_ARCHS`` keeps, parameters
    drawn on ``dev`` from ``ATTN_SEED`` (a CPU draw of llama3-8b's 8.0B
    values would take minutes), one ``SyntheticLM`` batch (ATTN_BATCH,
    ATTN_SEQ) on ``dev``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = get_config(arch)
    keep = ATTN_ARCHS[arch]
    if keep is not None:
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name} ({keep} of {cfg.n_layers} layers)",
            n_layers=keep)
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(ATTN_SEED), dev)
    batch = SyntheticLM(cfg.vocab, ATTN_SEQ, ATTN_BATCH,
                        seed=ATTN_SEED).batch_at(0)
    return cfg, params, steps.to_device_batch(batch, dev)


def capture_flash_calls(params, cfg, tokens):
    """Run one ``impl="pallas"`` forward of the attention-LM phase with
    the K13 wrapper recording its (args, kwargs); returns {
    "flash_attention": [(model label, args, kwargs)]}, one call per
    layer."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import transformer
    with recording([(kfa, "flash_attention")]) as calls, torch.no_grad():
        transformer.forward(params, cfg, tokens, impl="pallas")
    c = calls["flash_attention"]
    if len(c) != cfg.n_layers:
        raise RuntimeError(f"one {cfg.name} forward made {len(c)} K13 "
                           f"calls, expected {cfg.n_layers}")
    return {"flash_attention": [(cfg.name.split()[0],) + x for x in c]}


def flash_case_inputs(dev):
    """(case, q, k, v, kwargs) at each ``FLASH_CASES`` entry, seeded."""
    import torch
    g = torch.Generator().manual_seed(11)
    for case in FLASH_CASES:
        b, sq, skv, hq, hkv, d, causal, window, softcap = case
        q, k, v = (torch.randn(shape, generator=g).to(dev)
                   for shape in ((b, sq, hq, d), (b, skv, hkv, d),
                                 (b, skv, hkv, d)))
        yield case, q, k, v, dict(causal=causal, window=window,
                                  softcap=softcap)


def ssd_case_inputs(shape, dev):
    """K14's x, a, b, c at one ``SSD_SHAPES`` entry, seeded by the shape:
    x and b, c (scaled by N^-1/2) standard normal, a uniform in (-0.5,
    0]."""
    import torch
    b, nc, l, h, p, g, n = shape
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn((b, nc, l, h, p), generator=gen)
    a = -torch.rand((b, nc, l, h), generator=gen) * 0.5
    bb = torch.randn((b, nc, l, g, n), generator=gen) * n ** -0.5
    cc = torch.randn((b, nc, l, g, n), generator=gen) * n ** -0.5
    return [t.to(dev) for t in (x, a, bb, cc)]


def check_flash_precision(tag, got, ref):
    """K13's output within FLASH_TOL * max|ref| + FLOOR of its plain
    version (3xTF32's accuracy; one-pass TF32 misses it); raises past
    it."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    lim = FLASH_TOL * (float(ref.abs().max()) if ref.numel() else 0.0) \
        + FLOOR
    if not err <= lim:
        raise RuntimeError(f"{tag}: K13 outside 3xTF32's accuracy (max abs "
                           f"err {err:.3e}, limit {lim:.3e} at FLASH_TOL "
                           f"{FLASH_TOL:g})")
    print(f"[kernels] {tag}: err/limit {err / lim:.3e} at FLASH_TOL "
          f"{FLASH_TOL:g}")


def check_ssd_precision(tag, parts):
    """K14's outputs (y_diag, states, cum), each within SSD_TOL * max|ref|
    + FLOOR of its plain version (3xTF32's accuracy; one-pass TF32 misses
    it); raises past it."""
    worst, label = 0.0, ""
    for lab, got, ref in parts:
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        lim = SSD_TOL * (float(ref.abs().max()) if ref.numel() else 0.0) \
            + FLOOR
        if not err <= lim:
            raise RuntimeError(f"{tag} {lab}: K14 outside 3xTF32's accuracy "
                               f"(max abs err {err:.3e}, limit {lim:.3e} at "
                               f"SSD_TOL {SSD_TOL:g})")
        if err / lim >= worst:
            worst, label = err / lim, lab
    print(f"[kernels] {tag}: worst err/limit {worst:.3e} at SSD_TOL "
          f"{SSD_TOL:g} ({label})")


def check_ssd_cases(dev):
    """K14 against its plain version, untimed, at ``SSD_SHAPES``: ragged
    chunks and head dims, d_state 16 to 128, G > 1 and CTAs that take
    fewer heads than a group has; within TOL and SSD_TOL."""
    import torch
    from repro_torch.kernels import ssd as kssd
    for shape in SSD_SHAPES:
        args = ssd_case_inputs(shape, dev)
        with torch.no_grad():
            got = kssd.ssd_chunk(*args)
            ref = kssd.ssd_chunk_ref(*args)
        torch.cuda.synchronize()
        tag = f"ssd_chunked case {shape} {describe('ssd_chunked', args, {})}"
        parts, pad_ok = _outputs("ssd_chunked", got, ref, args, {})
        check_outputs(tag, parts, pad_ok)
        check_ssd_precision(tag, parts)


def check_flash_cases(dev):
    """K13 against its plain version, untimed, at ``FLASH_CASES``: the
    reference's kernel-test shapes (non-causal, a single query against
    256 and 300 keys, Sq 100 and 96, which no tile divides) and three of
    the port's own; within TOL and FLASH_TOL."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    for case, q, k, v, kw in flash_case_inputs(dev):
        with torch.no_grad():
            got = kfa.flash_attention(q, k, v, **kw)
            ref = kfa.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"flash_attention case {case}"
        check_outputs(tag, [("out", got, ref)], True)
        check_flash_precision(tag, got, ref)
        with torch.no_grad():
            check_repeats(tag, got, kfa.flash_attention(q, k, v, **kw))


def _moe_counts(name, args):
    return args[5] if name == "grouped_matmul_experts" else args[7]


def describe(name, args, kw) -> str:
    """The shapes of one captured call, for the log."""
    if name == "flash_attention":
        from repro_torch.kernels import flash_attention as kfa
        q, k, _ = args
        b, sq, hq, d = q.shape
        causal, window = kw.get("causal", True), kw.get("window")
        la = kfa.flash_launch(b, sq, k.shape[1], hq, k.shape[2], d, causal,
                              window)
        return (f"B {b} Sq {sq} Skv {k.shape[1]} Hq {hq} Hkv {k.shape[2]} "
                f"D {d} causal {causal} window {window} softcap "
                f"{kw.get('softcap')}: grid {la['grid']} (rows "
                f"{kfa.FLASH_ROWS} a CTA) tile D {la['dp']} keys a block "
                f"{la['bk']}, key blocks a head {la['blocks']} of which "
                f"masked {la['masked']}, shared memory {la['smem_bytes']} B")
    if name == "ssd_chunked":
        from repro_torch.kernels import runtime
        from repro_torch.kernels import ssd as kssd
        x, _, b, _ = args
        bsz, nc, l, h, p = x.shape
        la = kssd.ssd_launch(bsz, nc, l, h, p, b.shape[3], b.shape[4],
                             runtime.sm_count(x.device))
        return (f"B {bsz} chunks {nc} L {l} H {h} P {p} G {b.shape[3]} "
                f"N {b.shape[4]}: grid {la['grid']}, heads a CTA "
                f"{la['hb']}, warps {la['nw']}, tile P {la['pp']}, shared "
                f"memory {la['smem_bytes']} B")
    if name in MOE_KERNELS:
        from repro_torch.kernels import grouped_matmul as kg
        xp, w_in = args[0], args[2]
        e, d, f = w_in.shape
        out = (f"rows {xp.shape[0]} (live {int(_moe_counts(name, args).sum())}"
               f", bm {kw['bm']}) E {e} D {d} F {f} gated "
               f"{args[4] is not None}")
        if name == "grouped_matmul_experts":
            la = kg.experts_launch(xp.shape[0] // kw["bm"], kw["bm"], d, f,
                                   args[4] is not None)
            out += (f" CTAs {la['in_grid']} + {la['out_grid']} (F columns "
                    f"a stage-A CTA {la['f_cols']})")
        else:
            la = kg.experts_bwd_launch(xp.shape[0] // kw["bm"], kw["bm"], d,
                                       f, e, args[4] is not None)
            out += (f" CTAs {la['dh_grid'][0]} + {len(la['dw_tiles'])} dW "
                    f"+ {len(la['dx_tiles'])} dX")
        return out
    if name == "branch_matmul":
        x, y = args
        t = ["T" if v.stride(1) == 1 and v.shape[2] > 1 else ""
             for v in (x, y)]
        from repro_torch.kernels import branch_matmul as kb
        from repro_torch.kernels import runtime
        la = kb.bmm_launch(x.shape[0], x.shape[1], y.shape[2], x.shape[2],
                           runtime.sm_count(x.device))
        return (f"G={x.shape[0]} ({'x'.join(map(str, x.shape[1:]))}){t[0]} "
                f"@ ({'x'.join(map(str, y.shape[1:]))}){t[1]} splits "
                f"{la['splits']} (depth {la['kper']}) CTAs {la['ctas']}")
    if name == "fused_gemm_reduce":
        from repro_torch.kernels import fused_branches as kf
        from repro_torch.kernels import runtime
        x, y, z = args
        la = kf.fused_launch(x.shape[0], y.shape[1], x.shape[1],
                             *z.shape, runtime.sm_count(x.device))
        return (f"({'x'.join(map(str, x.shape))}) @ "
                f"({'x'.join(map(str, y.shape))}) beside z "
                f"({'x'.join(map(str, z.shape))}): GEMM CTAs "
                f"{la['gemm_ctas']} ({la['splits']} splits), CTAs "
                f"{la['ctas']}, z rows a CTA {la['share']}")
    if name in ("matmul", "matmul_ksplit"):
        from repro_torch.kernels import matmul as km
        x, y = args
        t = ["T" if v.dim() == 2 and v.stride(0) == 1 and v.shape[1] > 1
             else "" for v in (x, y)]
        out = (f"({'x'.join(map(str, x.shape))}){t[0]} @ "
               f"({'x'.join(map(str, y.shape))}){t[1]}")
        m, k = x.shape
        from repro_torch.kernels import runtime
        if name == "matmul_ksplit":
            la = km.ksplit_launch(m, y.shape[1], k,
                                  runtime.sm_count(x.device))
            out += (f" splits {la['splits']} (depth {la['kref']}) inner "
                    f"{la['inner']} (depth {la['kper_in']}) CTAs "
                    f"{len(la['ctas'])} workspace {la['ws_bytes']} B")
        else:
            la = km.matmul_launch(m, y.shape[1], k,
                                  kw.get("algorithm", "mxu128"),
                                  runtime.sm_count(x.device))
            out += (f" splits {la['splits']} (depth {la['kper']}) CTAs "
                    f"{la['ctas']}")
        return out
    if name == "grouped_matmul_dw":
        from repro_torch.kernels import grouped_matmul as kg
        from repro_torch.kernels import runtime
        xs, dys, mask = args
        la = kg.dw_launch(xs[0].shape[0], [x.shape[1] for x in xs],
                          [dy.shape[1] for dy in dys],
                          runtime.sm_count(xs[0].device))
        return (f"M={xs[0].shape[0]} (K,N)="
                f"{[(x.shape[1], dy.shape[1]) for x, dy in zip(xs, dys)]} "
                f"mask={mask is not None} splits {la['splits']} (depth "
                f"{la['kper']}) CTAs {la['ctas']}")
    if name == "grouped_matmul_bwd":
        from repro_torch.kernels import grouped_matmul as kg
        from repro_torch.kernels import runtime
        xs, ws = args[:2]
        mask = args[3] if len(args) > 3 else kw.get("mask")
        la = kg.bwd_launch(xs[0].shape[0], [w.shape[0] for w in ws],
                           [w.shape[1] for w in ws],
                           runtime.sm_count(xs[0].device))
        return (f"M={xs[0].shape[0]} (K,N)="
                f"{[tuple(w.shape) for w in ws]} mask={mask is not None} "
                f"dw tiles {la['dw_tiles']} splits {la['splits']} (depth "
                f"{la['kper']}) dx tiles {la['dx_tiles']} CTAs "
                f"{la['ctas']}")
    if name == "conv2d_direct":
        from repro_torch.kernels import conv2d as kc
        from repro_torch.kernels import runtime
        x, w = args
        la = kc.direct_launch(x.shape, w.shape, kw.get("stride", 1),
                              kw.get("padding", "SAME"),
                              runtime.sm_count(x.device))
        return (f"x {tuple(x.shape)} w {tuple(w.shape)} "
                f"stride {kw.get('stride', 1)} k-steps {len(la['steps'])} "
                f"tiles {la['tiles']} splits {la['splits']} (k-steps "
                f"{la['kper']}) CTAs {la['ctas']}")
    if name == "grouped_matmul_chained":
        from repro_torch.kernels import grouped_matmul as kg
        from repro_torch.kernels import runtime
        la = kg.chained_plan(args[0], m=kw["m"], h=kw["h"], w=kw["w"],
                             panels=kw.get("panels", ()),
                             m_valid=kw.get("m_valid"),
                             sms=runtime.sm_count(args[0][0][0]["w"].device))
        issued = kg.chained_issued_macs(la)
        live = kg.chained_live_macs(la)
        return (f"m={kw['m']} m_valid={kw.get('m_valid')} phases "
                f"{la['phases']} items {la['n_items']} tiles {la['tiles']} "
                f"splits {la['splits']} waves {la['waves']} issued/live "
                f"multiply-adds {issued / max(live, 1):.3f} ({live:.4e} "
                f"live)")
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import runtime
    xs, ws = args[:2]
    m = kg._lhs_shape(name, xs[0])[0]
    forms = [f"{len(x)} {'views' if x[0].dim() == 4 else 'copies'}"
             if isinstance(x, (list, tuple)) else "dense" for x in xs]
    nstore = [w.shape[1] for w in ws] if name == "grouped_matmul_pooled" \
        else kg._concat_layout(name, ws, kw["offsets"], kw["total"],
                               kw.get("compact", True))[2]
    la = kg.fwd_launch(kw.get("m_valid") or m, [w.shape[0] for w in ws],
                       nstore, runtime.sm_count(ws[0].device))
    return (f"M={m} (K,N)={[tuple(w.shape) for w in ws]} lhs={forms} "
            f"m_valid={kw.get('m_valid')} tiles {la['tiles']} splits "
            f"{la['splits']} (depth {la['kper']}) CTAs {la['ctas']}")


def _nz_rows(w) -> int:
    return int((w != 0).any(dim=1).sum())


def work_of(name, args, kw):
    """(FLOPs, bytes) the call needs on this run's data: true rows (up to
    m_valid; the routed rows of an expert call), true depths, each input
    read once and each output written once, 4 bytes per f32."""
    if name == "flash_attention":
        # Q Kᵀ and P V on the visible (query head, key) pairs only
        q, k, v = args
        b, sq, hq, d = q.shape
        return (4.0 * b * hq * d * visible_pairs(
                    sq, k.shape[1], kw.get("causal", True), kw.get("window")),
                4.0 * (2 * q.numel() + k.numel() + v.numel()))
    if name == "ssd_chunked":
        # per cell: C Bᵀ on the causal triangle (T = L(L+1)/2 pairs) per
        # group; per head the decay (an exp and a product per pair), the
        # triangular y_diag contraction, the state contraction with its
        # decay weights, and the cumsum
        x, _, b, _ = args
        bsz, nc, l, h, p = x.shape
        g, n = b.shape[3], b.shape[4]
        tri = l * (l + 1) / 2
        per_cell = g * tri * 2 * n + h * (tri * (2 + 2 * p)
                                          + l * (2 * n * p + n + 1))
        ins = x.numel() + args[1].numel() + 2 * b.numel()
        outs = x.numel() + bsz * nc * h * n * p + args[1].numel()
        return bsz * nc * per_cell, 4.0 * (ins + outs)
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
    if name in ("matmul", "matmul_ksplit"):
        x, y = args
        m, k = x.shape
        n = y.shape[1]
        return 2.0 * m * k * n, 4.0 * (m * k + k * n + m * n)
    if name == "fused_gemm_reduce":
        # the GEMM, and per z element an exp, an add, a divide and the
        # sum's add; read x, y, z, write c and r
        x, y, z = args
        m, k = x.shape
        n = y.shape[1]
        r, c = z.shape
        return (2.0 * m * k * n + 4.0 * r * c,
                4.0 * (m * k + k * n + r * c + m * n + c))
    if name == "grouped_matmul_dw":
        xs, dys, mask = args
        flops, byts = 0.0, 0.0
        for x, dy in zip(xs, dys):
            m, k = x.shape
            n = dy.shape[1]
            # the dw GEMM and the db row sum; read x, dy (and the mask),
            # write dw and db
            flops += 2.0 * m * k * n + m * n
            byts += 4.0 * (m * k + m * n + k * n + n
                           + (m * n if mask is not None else 0))
        return flops, byts
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
    from repro_torch.kernels import grouped_matmul as kg
    xs, ws = args[0], args[1]
    rows = kw.get("m_valid")
    flops, byts = 0.0, 0.0
    for x, w in zip(xs, ws):
        taps = list(x) if isinstance(x, (list, tuple)) else [x]
        m = kg._lhs_shape(name, x)[0]
        r = m if rows is None else rows
        k, n = w.shape
        # views of one tensor (the plan's taps) read its elements once;
        # separate tap tensors each read their own
        one = len({t.untyped_storage().data_ptr() for t in taps}) == 1
        ins = _distinct_elems(taps, r) if one and len(taps) > 1 \
            else len(taps) * r * k
        flops += 2.0 * r * k * n + (len(taps) - 1) * r * k
        byts += 4.0 * (ins + k * n + n + r * n)
    return flops, byts


def _distinct_elems(taps, rows):
    """Elements of their one storage that the first ``rows`` rows of
    tap views cover (rows whole images of a (B, OH, OW, K) view)."""
    import torch
    t0 = taps[0]
    per = math.prod(t0.shape[1:-1])
    if rows % per:
        raise RuntimeError(f"{rows} rows of taps {tuple(t0.shape)} are not "
                           f"whole images")
    mask = torch.zeros(t0.untyped_storage().nbytes() // t0.element_size(),
                       dtype=torch.bool, device=t0.device)
    for t in taps:
        mask.as_strided(t.shape, t.stride(),
                        t.storage_offset())[:rows // per] = True
    return int(mask.sum())


# the kernels whose f32 products run as three TF32 products each on the
# tensor cores (3xTF32)
TC_KERNELS = ("flash_attention", "ssd_chunked")


def op_ms(name, flops) -> float:
    """The least time for a call's operations on the units its kernel
    runs them on: K13's and K14's f32 products as three TF32 products
    each on the tensor cores (3xTF32), every other kernel's as f32 FMA on
    the CUDA cores."""
    if name in TC_KERNELS:
        return 3 * flops / PEAK_TF32 * 1e3
    return flops / PEAK_F32 * 1e3


def f32_note(name, flops) -> str:
    """For K13 and K14, whose bound is 3xTF32's: the f32 CUDA-core bound
    beside it."""
    if name not in TC_KERNELS:
        return ""
    return f"; f32 on the CUDA cores {flops / PEAK_F32 * 1e3:.4f} ms"


def visible_pairs(sq, skv, causal, window) -> int:
    """(query, key) pairs K13's masks leave visible: query i at key
    position i + skv - sq sees keys (qp - window, qp] (causal) of [0,
    skv)."""
    n = 0
    for i in range(sq):
        qp = i + skv - sq
        hi = min(skv - 1, qp) if causal else skv - 1
        lo = max(0, qp - window + 1) if window is not None else 0
        n += max(0, hi - lo + 1)
    return n


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
    if name == "ssd_chunked":
        return [(lab, t, r) for lab, t, r in zip(("y_diag", "states", "cum"),
                                                 got, ref)], True
    if name in MOE_KERNELS:
        labels = (("y", "hin", "gate") if name == "grouped_matmul_experts"
                  else ("dx", "dW_in", "dW_gate", "dW_out"))
        return [(lab, t, r) for lab, t, r in zip(labels, got, ref)
                if r is not None], True
    if name == "grouped_matmul_bwd":
        return [(f"{kind}{g}", t, r)
                for kind, ts, rs in zip(("dx", "dw", "db"), got, ref)
                for g, (t, r) in enumerate(zip(ts, rs))], True
    if name == "grouped_matmul_dw":
        return [(f"{kind}{g}", t, r)
                for kind, ts, rs in zip(("dw", "db"), got, ref)
                for g, (t, r) in enumerate(zip(ts, rs))], True
    if name == "fused_gemm_reduce":
        return [("c", got[0], ref[0]), ("r", got[1], ref[1])], True
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


def written(name, out, kw):
    """The part of a call's outputs that its kernel writes: K6 leaves the
    rows of m-blocks wholly past m_valid unwritten (their contents are
    whatever the allocation held)."""
    if name != "grouped_matmul_chained":
        return out
    lim = kw["m"] if kw.get("m_valid") is None else kw["m_valid"]
    return [t[:-(-lim // 128) * 128] for t in out]


def check_repeats(tag, got, again):
    """Two calls of a kernel on the same inputs must be bitwise equal
    (K4's and K5's split-K reductions sum in split order, whichever CTA
    finishes last)."""
    import torch
    flat = lambda v: [t for x in v for t in flat(x)] \
        if isinstance(v, (list, tuple)) else [] if v is None else [v]
    got, again = flat(got), flat(again)
    torch.cuda.synchronize()
    same = len(got) == len(again) and all(
        torch.equal(a, b) for a, b in zip(got, again))
    if not same:
        raise RuntimeError(f"{tag}: two calls on the same inputs differ")
    print(f"[kernels] {tag}: a second call is bitwise equal "
          f"({len(got)} output tensors)")


def check_bitwise(tag, parts):
    """Each (label, got, want) must be bitwise equal: two kernels that run
    the same engine, tiles and split order on the same operands (K10's c
    and K4 ``mxu128``'s; K7's dw and db and K5's)."""
    import torch
    torch.cuda.synchronize()
    for label, a, b in parts:
        if a.shape != b.shape or not torch.equal(a, b):
            raise RuntimeError(f"{tag} {label}: not bitwise equal")
    print(f"[kernels] {tag}: bitwise equal ({len(parts)} output tensors)")


def k4_at(x, y, splits, kper):
    """K4 ``mxu128`` on x @ y with K cut into ``splits`` of ``kper``, as
    given (not K4's own split plan): ``rt_matmul`` called directly."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import runtime
    m, k = x.shape
    n = y.shape[1]
    a_t, lda = km._layout("k4_at", x)
    b_t, ldb = km._layout("k4_at", y)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    tiles = -(-m // 128) * -(-n // 128)
    ws = torch.empty(tiles * splits * 128 * 128, dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    counters = torch.zeros(tiles, dtype=torch.int32, device=x.device)
    rc = build.lib().rt_matmul(
        x.data_ptr(), y.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), counters.data_ptr(), m, n, k,
        lda, ldb, km._copy_layout(x, a_t, lda, along_k=0),
        km._copy_layout(y, b_t, ldb, along_k=1), 0, splits, kper,
        runtime.stream_handle(x.device))
    build.check(rc, "rt_matmul")
    return out


def check_ksplit_partials(tag, x, y):
    """K8's workspace slice ws[s] bitwise equal to K4 ``mxu128`` on that
    split's x[:, K_s] @ y[K_s] at K8's inner split (the same CTAs on the
    same operands), and its output bitwise equal to the slices summed in
    split order."""
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import runtime
    m, k = x.shape
    la = km.ksplit_launch(m, y.shape[1], k, runtime.sm_count(x.device))
    ws, out = km._ksplit_run(x, y)
    parts, total = [], ws[0]
    for s in range(la["splits"]):
        lo, hi = s * la["kref"], min(k, (s + 1) * la["kref"])
        parts.append((f"ws[{s}]", ws[s], k4_at(x[:, lo:hi], y[lo:hi],
                                               la["inner"], la["kper_in"])))
        if s:
            total = total + ws[s]
    check_bitwise(f"{tag} against K4 mxu128 at {la['inner']} inner "
                  f"splits", parts + [("out", out, total)])


def library_call(name, args, kw):
    """A torch library yardstick on the same inputs: ``F.conv2d`` for the
    direct conv, ``torch.bmm`` for the stacked GEMMs, one ``torch.matmul``
    per GEMM at the same shapes for the grouped launches and both
    matmuls (K4, K8), per branch plus the db sum for K7, and
    ``torch.matmul`` then the silu-sum, two calls, for K10.  The port never
    calls these.  None for K14: no one torch call computes the SSD chunk
    cell.  For K13 ``F.scaled_dot_product_attention`` on heads-first
    copies with ``enable_gqa`` (causal, or the visible-key mask for a
    window or Sq != Skv); None with a softcap, which no one torch call
    computes."""
    import torch
    import torch.nn.functional as F
    if name == "ssd_chunked":
        return None
    if name == "flash_attention":
        if kw.get("softcap") is not None:
            return None
        from repro_torch.kernels import flash_attention as kfa
        q, k, v = (t.transpose(1, 2).contiguous() for t in args)
        sq, skv = q.shape[2], k.shape[2]
        causal, window = kw.get("causal", True), kw.get("window")
        sdpa = dict(scale=kw.get("scale"), enable_gqa=True)
        if causal and window is None and sq == skv:
            sdpa["is_causal"] = True
        elif causal or window is not None:
            sdpa["attn_mask"] = kfa._masks(sq, skv, causal, window, q.device)
        return lambda: F.scaled_dot_product_attention(q, k, v, **sdpa)
    if name in MOE_KERNELS:
        return einsum_engine_call(name, args)
    if name in ("matmul", "matmul_ksplit"):
        x, y = args
        return lambda: torch.matmul(x, y)
    if name == "fused_gemm_reduce":
        x, y, z = args
        return lambda: (torch.matmul(x, y), F.silu(z).sum(0))
    if name == "grouped_matmul_dw":
        xs, dys, _ = args
        return lambda: [(torch.matmul(x.t(), dy), dy.sum(0))
                        for x, dy in zip(xs, dys)]
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
        # each branch's live depth: the weight's rows that meet live lhs
        # columns (gathered here, outside the timed call) against an
        # (m_valid, live rows) lhs: the multiply-adds the kernel issues
        from repro_torch.kernels import grouped_matmul as kg
        spec, m_lim = kg._chain_check(args[0], kw["m"], kw["h"], kw["w"],
                                      kw.get("panels", ()), 128,
                                      kw.get("m_valid"))
        pairs = []
        for phase, pspec in zip(args[0], spec):
            for br, (_, _, steps) in zip(phase, pspec):
                rows = [s * 128 + c for s, st in enumerate(steps)
                        for c in range(st[-1])]
                wl = br["w"][torch.tensor(rows, device=br["w"].device)]
                pairs.append((torch.empty((m_lim, len(rows)),
                                          device=wl.device), wl))
    else:
        # one tap as each branch's lhs: the library pools nothing; a
        # view tap's (M, K) copy is made here, outside the timed call
        pairs = []
        for x, w in zip(args[0], args[1]):
            x0 = x[0] if isinstance(x, (list, tuple)) else x
            pairs.append((x0.reshape(-1, x0.shape[-1]), w))
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
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import fused_branches as kf
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ssd as kssd
    import torch
    fns = {
        "fused_gemm_reduce": (kf.fused_gemm_reduce, kf.fused_gemm_reduce_ref),
        "matmul_ksplit": (km.matmul_ksplit, km.matmul_ksplit_ref),
        "grouped_matmul_dw": (kg.grouped_matmul_dw, kg.grouped_matmul_dw_ref),
        "flash_attention": (kfa.flash_attention, kfa.flash_attention_ref),
        "ssd_chunked": (kssd.ssd_chunk, kssd.ssd_chunk_ref),
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
            # every chain of both forwards, summed per bucket, then the
            # stem and inc0 chains of bucket 2 with one real image of two
            bucket = lambda k: k["m"] // (k["h"] * k["w"])
            b2 = [c for c in cases if bucket(c[2]) == 2][:2]
            cases = [(f"{path} b{bucket(k)}", a, k) for path, a, k in cases]
            cases += [(f"{path} b2 ragged", a, dict(k, m_valid=k["m"] // 2))
                      for path, a, k in b2]
        reps, warm, prof = FLASH_REPS if name == "flash_attention" \
            else (20, 3, 5)
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
            if name == "flash_attention":
                check_flash_precision(tag, got, ref)
            if name == "ssd_chunked":
                check_ssd_precision(tag, _outputs(name, got, ref, a, k)[0])
            if name in REPEAT_KERNELS:
                check_repeats(tag, written(name, got, k),
                              written(name, kern(*a, **k), k))
            if name == "fused_gemm_reduce":
                with torch.no_grad():
                    check_bitwise(f"{tag} against K4 mxu128", [
                        ("c", got[0], km.matmul(a[0], a[1]))])
            if name == "matmul_ksplit":
                with torch.no_grad():
                    check_ksplit_partials(tag, *a)
            del got, ref
            with torch.no_grad():
                t_k = time_ms(lambda: kern(*a, **k), reps, warm)
                t_p = time_ms(lambda: plain(*a, **k), reps, warm)
                lib = library_call(name, a, k)
                t_l = None if lib is None else time_ms(lib, reps, warm)
                del lib
                t_d = kernel_device_ms(
                    lambda: kern(*a, **k), KERNEL_FUNCS[name], prof) \
                    if prof else None
            flops, byts = work_of(name, a, k)
            t_c, t_b = op_ms(name, flops), byts / PEAK_BW * 1e3
            by = "bytes" if t_b > t_c else "operations"
            t_ds = "not measured" if t_d is None else f"{t_d:.4f} ms"
            t_ls = "none (no one torch call)" if t_l is None \
                else f"{t_l:.4f} ms"
            print(f"[kernels] {tag}: wrapper {t_k:.4f} ms, kernel device "
                  f"time {t_ds}, plain {t_p:.4f} ms, library {t_ls}, "
                  f"bound {max(t_c, t_b):.4f} ms ({by}; {flops:.3e} FLOP, "
                  f"{byts:.3e} B{f32_note(name, flops)})")
            ms, plain_ms = ms + t_k, plain_ms + t_p
            lib_ms = None if lib_ms is None or t_l is None else lib_ms + t_l
            dev_ms = None if dev_ms is None or t_d is None else dev_ms + t_d
            bound += max(t_c, t_b)
            top = max(top, (max(t_c, t_b), by))
            acc = per_path.setdefault(path, [0, 0.0, 0.0, 0.0, 0.0, 0.0])
            for i, v in enumerate((1, t_k, t_d or math.nan, t_p,
                                   math.nan if t_l is None else t_l,
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
            # large_tile (256 x 128 tiles) is off the main path: check it
            # once, on the first captured call, untimed
            _, a, k = cases[0]
            with torch.no_grad():
                check_outputs(f"matmul large_tile {describe(name, a, k)}",
                              *_outputs(name, kern(*a, algorithm="large_tile"),
                                        plain(*a), a, k))
        print(f"[kernels] {name}: {len(cases)} cases, sums: wrapper "
              f"{ms:.4f} ms, kernel device {dev_ms} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms} ms, bound {bound:.4f} ms")
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": worst, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": top[1], "library_ms": lib_ms,
                      "kernel_device_ms": dev_ms, "cases": len(cases)}
    return rows


# ---------------------------------------------------------------------------
# phase 3b: co-execution and the zoo
# ---------------------------------------------------------------------------

def _pair_plans():
    """The fused pair's graph lowered four ways: ``schedule`` then
    ``lower`` (one fused group, the GEMM at ``large_tile``), and the
    serial plan of the same graph (``schedule(concurrent=False)``) with
    the GEMM on K4 (``large_tile``, what that schedule picks, and
    ``mxu128``) and on K8 (``ksplit``)."""
    import dataclasses
    from repro_torch.core import plan as cp
    from repro_torch.core.graph import Op, OpGraph
    from repro_torch.core.scheduler import Schedule, schedule
    m, k, n, r, c = FUSED_PAIR
    g = OpGraph()
    g.add(Op.make("gemm", "matmul", m=m, k=k, n=n))
    g.add(Op.make("red", "pointwise", elements=r * c))
    concurrent = schedule(g)
    serial = schedule(g, concurrent=False)

    def gemm_on(sched, alg):
        return cp.lower(g, Schedule([
            dataclasses.replace(cg, algorithms={
                o: alg if o == "gemm" else a
                for o, a in cg.algorithms.items()})
            for cg in sched.groups]))
    plans = {"fused": cp.lower(g, concurrent)}
    if plans["fused"].mode_counts() != {"fused": 1} \
            or concurrent.algorithms["gemm"] != "large_tile" \
            or serial.algorithms["gemm"] != "large_tile":
        raise RuntimeError(f"fused pair: plan "
                           f"{plans['fused'].mode_counts()}, schedules "
                           f"{concurrent.algorithms}, {serial.algorithms}")
    for alg in ("large_tile", "mxu128", "ksplit"):
        plans[f"serial {alg}"] = gemm_on(serial, alg)
    return plans


def _pair_impls(w):
    import torch.nn.functional as F
    from repro_torch.core import plan as cp
    from repro_torch.kernels import ops
    return {
        "gemm": cp.OpImpl(deps=("xin",), fn=lambda x, algorithm=None:
                          ops.matmul(x, w, algorithm=algorithm),
                          gemm_x=lambda x: x, gemm_w=w,
                          gemm_post=lambda y: y),
        "red": cp.OpImpl(deps=("zin",), fn=lambda z, algorithm=None:
                         F.silu(z).sum(0), stream_z=lambda z: z,
                         stream_post=lambda v: v),
    }


def _counted(fn):
    """(fn(), the launches it made), counters set to 0 just before."""
    import torch
    from repro_torch.kernels import runtime
    runtime.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in runtime.KERNEL_LAUNCHES.items() if v}


def check_fused_pair(dev):
    """The fused plan mode at the reference benchmark's co-execution shape
    (``FUSED_PAIR``); returns its captured K10 call and the launches of
    the mode's main path: the fused plan forward and backward (exactly 1
    K10 launch and nothing else), and the serial plan with the GEMM on K8
    (exactly 1 K8 launch).  Outputs and gradients (dx, dw, dz) are held
    against plain torch, the serial plans' outputs (K4 and K8) to the same
    values; then the warm times of all three and of the plain pair are
    printed, not held: the paper's co-location question on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.core import plan as cp
    from repro_torch.kernels import fused_branches as kf
    m, k, n, r, c = FUSED_PAIR
    rng = np.random.default_rng(ZOO_SEED)
    mk = lambda *sh, sc=1.0: torch.from_numpy(
        (rng.normal(size=sh) * sc).astype(np.float32)).to(dev)
    x, w, z = mk(m, k, sc=0.05), mk(k, n, sc=0.05), mk(r, c)
    dc, dr = mk(m, n), mk(c)
    plans = _pair_plans()
    print(f"[zoo] fused pair: GEMM {m}x{k}x{n} beside a {r}x{c} silu-sum "
          f"(f32, seed {ZOO_SEED}, "
          f"{4 * (m * k + k * n + r * c + m * n + c) / 1e6:.1f} MB); plans "
          + "; ".join(f"{nm} {[(g.mode, g.algorithms) for g in p.groups]}"
                      for nm, p in plans.items()))
    with torch.enable_grad():
        xr, wr, zr = (t.clone().requires_grad_() for t in (x, w, z))
        want = (xr @ wr, F.silu(zr).sum(0))
        wgrads = torch.autograd.grad(want, (xr, wr, zr), (dc, dr))
    want = tuple(t.detach() for t in want)
    launches = {}
    with recording([(kf, "fused_gemm_reduce")]) as calls:
        # the fused mode's main path: counters set to 0 just before
        xg, wg, zg = (t.clone().requires_grad_() for t in (x, w, z))

        def fwd_bwd():
            env = cp.run_plan(_pair_impls(wg), {"xin": xg, "zin": zg},
                              plans["fused"])
            got = (env["gemm"], env["red"])
            return got, torch.autograd.grad(got, (xg, wg, zg), (dc, dr))
        (got, grads), fl = _counted(fwd_bwd)
    if fl != {"fused_gemm_reduce": 1}:
        raise RuntimeError(f"fused plan launched {fl}, expected exactly one "
                           f"K10 launch")
    launches["fused_gemm_reduce"] = fl["fused_gemm_reduce"]
    check_outputs("fused plan (forward and gradients) against plain torch",
                  [("c", got[0].detach(), want[0]),
                   ("r", got[1].detach(), want[1])]
                  + [(f"d{v}", a, b)
                     for v, a, b in zip("xwz", grads, wgrads)], True)
    del got, grads, wgrads, xg, wg, zg, xr, wr, zr
    impls = _pair_impls(w)
    env0 = {"xin": x, "zin": z}
    for alg, kern in (("large_tile", "matmul"), ("mxu128", "matmul"),
                      ("ksplit", "matmul_ksplit")):
        with torch.no_grad():
            env, sl = _counted(lambda: cp.run_plan(
                impls, dict(env0), plans[f"serial {alg}"]))
        if sl != {kern: 1}:
            raise RuntimeError(f"serial plan ({alg}) launched {sl}, "
                               f"expected one {kern} launch")
        if kern == "matmul_ksplit":
            launches[kern] = sl[kern]
        check_outputs(f"serial plan, GEMM on {alg}, against plain torch",
                      [("c", env["gemm"], want[0]),
                       ("r", env["red"], want[1])], True)
    del env
    with torch.no_grad():
        ts = {nm: time_ms(lambda p=p: cp.run_plan(impls, dict(env0), p))
              for nm, p in plans.items()}
        ts["plain torch (torch.matmul, then the silu-sum)"] = time_ms(
            lambda: (torch.matmul(x, w), F.silu(z).sum(0)))
        ts["the silu-sum alone"] = time_ms(lambda: F.silu(z).sum(0))
    print("[zoo] fused pair, warm forward, median of 20 (CUDA events; "
          "printed, not held): " + ", ".join(f"{nm} {t:.4f} ms"
                                             for nm, t in ts.items()))
    # the paper's question on the device clock: the fused plan on K10
    # against the serial plan on K4 (its GEMM, then the silu-sum's
    # kernels), every kernel of a call summed, the plans in turns
    order = ["fused", "serial mxu128", "serial large_tile"]
    dev_ms = {nm: [] for nm in order}
    with torch.no_grad():
        for nm in order + order[::-1]:
            t_d = kernel_device_ms(
                lambda p=plans[nm]: cp.run_plan(impls, dict(env0), p), "", 5)
            dev_ms[nm].append(math.nan if t_d is None else t_d)
    means = {nm: statistics.fmean(v) for nm, v in dev_ms.items()}
    best = min(means, key=means.get)
    print("[zoo] fused pair, device time a call (torch.profiler, every "
          "kernel of the call, 5 calls a window, in turns; printed, not "
          "held): " + ", ".join(
              f"{nm} {' / '.join(f'{t:.4f}' for t in v)} ms"
              for nm, v in dev_ms.items())
          + f"; faster on the device: {best}")
    cases = [("plan",) + calls["fused_gemm_reduce"][0]]
    for case in FUSED_CASES:
        mm, kk, nn, rr, cc = case
        g = torch.Generator().manual_seed(sum(case))
        # a one-tile GEMM beside a tall z: z spread over the card
        path = "one-tile" if mm * nn <= 128 * 128 and rr * cc > 1 << 20 \
            else "case"
        cases.append((path, tuple(
            torch.randn(sh, generator=g).to(dev)
            for sh in ((mm, kk), (kk, nn), (rr, cc))), {}))
    return cases, launches


def check_zoo(dev, k4_calls, k5_calls):
    """Phase 3b: the fused pair (``check_fused_pair``), the GEMM zoo at
    ``ZOO_GEMM`` (every algorithm through ``ops.matmul``; ksplit exactly
    one K8 launch), the conv zoo on paper Table 1's inception-3a convs
    (every supported algorithm through ``ops.conv2d`` against
    ``F.conv2d``, Winograd exactly one K9 launch, the 5x5 refused by
    Winograd as ``conv2d_supported`` says) and ``ops.grouped_matmul_dw``
    on the training step's 18 captured K5 calls (exactly one K7 launch
    each, its dw and db bitwise equal to K5's).  Prints each algorithm's
    time and workspace.  Returns {name: captured calls} of K10, K8 and K7
    for phase 3 and of K9 (Winograd's one call), and the launches each of
    K10, K8 and K7 made on its path here."""
    import torch
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import conv2d_ref
    t0 = time.perf_counter()
    fused_cases, launches = check_fused_pair(dev)
    # the GEMM zoo
    m, k, n = ZOO_GEMM
    g = torch.Generator().manual_seed(ZOO_SEED)
    x = torch.randn((m, k), generator=g).to(dev)
    y = torch.randn((k, n), generator=g).to(dev)
    ref = torch.matmul(x, y)
    for alg in ops.MATMUL_ALGORITHMS:
        with torch.no_grad():
            out, ml = _counted(lambda: ops.matmul(x, y, algorithm=alg))
        kern = "matmul_ksplit" if alg == "ksplit" else "matmul"
        if ml != {kern: 1}:
            raise RuntimeError(f"ops.matmul({alg}) launched {ml}")
        if alg == "ksplit":
            launches[kern] += 1
        check_outputs(f"gemm zoo {m}x{k}x{n} {alg}", [("out", out, ref)],
                      True)
        ws = ops.matmul_workspace_bytes(alg, m, n, k,
                                        splits=km.ksplit_splits(k))
        print(f"[zoo] gemm {m}x{k}x{n} {alg}: "
              f"{time_ms(lambda: ops.matmul(x, y, algorithm=alg)):.4f} ms, "
              f"workspace {ws} B "
              f"(f32 partials), reference on-chip claim "
              f"{ops.matmul_vmem_bytes(alg)} B")
    print(f"[zoo] gemm {m}x{k}x{n} torch.matmul: "
          f"{time_ms(lambda: torch.matmul(x, y)):.4f} ms")
    # the conv zoo: paper Table 1's two inception-3a convs
    winograd = []
    for nb, h, wd, cin, kh, cout in ZOO_CONVS:
        g = torch.Generator().manual_seed(ZOO_SEED + kh)
        xc = torch.randn((nb, h, wd, cin), generator=g).to(dev)
        wc = (0.1 * torch.randn((kh, kh, cin, cout), generator=g)).to(dev)
        ref = conv2d_ref(xc, wc)
        tag = f"conv {nb}x{h}x{wd}x{cin} {kh}x{kh}->{cout}"
        for alg in ops.CONV2D_ALGORITHMS:
            ws = ops.conv2d_workspace_bytes(alg, xc.shape, wc.shape,
                                            bytes_per_el=4)
            if not ops.conv2d_supported(alg, kh, kh, 1):
                try:
                    ops.conv2d(xc, wc, algorithm=alg)
                except ValueError as e:
                    print(f"[zoo] {tag} {alg}: refused, as conv2d_supported "
                          f"says ({e})")
                    continue
                raise RuntimeError(f"{tag} {alg}: ran, though "
                                   f"conv2d_supported says it cannot")
            with torch.no_grad(), \
                    recording([(kb, "branch_matmul")]) as rec:
                out, cl = _counted(lambda: ops.conv2d(xc, wc, algorithm=alg))
            if alg == "winograd3x3":
                if cl != {"branch_matmul": 1}:
                    raise RuntimeError(f"{tag} winograd launched {cl}, "
                                       f"expected one K9 launch")
                winograd += [("zoo winograd",) + c
                             for c in rec["branch_matmul"]]
            check_outputs(f"{tag} {alg} against F.conv2d",
                          [("out", out, ref)], True)
            print(f"[zoo] {tag} {alg}: "
                  f"{time_ms(lambda: ops.conv2d(xc, wc, algorithm=alg)):.4f}"
                  f" ms, workspace {ws} B (f32), launches {cl}")
        print(f"[zoo] {tag} F.conv2d: "
              f"{time_ms(lambda: conv2d_ref(xc, wc)):.4f} ms")
    # K7's path, the library call, on the training step's K5 calls
    dw_cases = [(p, (a[0], a[2], a[3] if len(a) > 3 else kw.get("mask")),
                 {}) for p, a, kw in k5_calls]
    with torch.no_grad():
        outs, dl = _counted(lambda: [ops.grouped_matmul_dw(*a)
                                     for _, a, _ in dw_cases])
    if dl != {"grouped_matmul_dw": len(dw_cases)}:
        raise RuntimeError(f"ops.grouped_matmul_dw launched {dl} on "
                           f"{len(dw_cases)} calls")
    launches["grouped_matmul_dw"] = dl["grouped_matmul_dw"]
    for (_, a, kw), (dws, dbs) in zip(k5_calls, outs):
        with torch.no_grad():
            _, dw5, db5 = kg.grouped_matmul_bwd(*a, **kw)
        check_bitwise(
            f"grouped_matmul_dw against K5 "
            f"{describe('grouped_matmul_bwd', a, kw)}",
            [(f"dw{i}", t, r) for i, (t, r) in enumerate(zip(dws, dw5))]
            + [(f"db{i}", t, r) for i, (t, r) in enumerate(zip(dbs, db5))])
    del outs
    print(f"[zoo] K7 bitwise equal to K5's dw and db on {len(dw_cases)} "
          f"calls; phase 3b took {time.perf_counter() - t0:.1f} s")
    ksplit_cases = [("zoo", (x, y), {})] \
        + [(p, a, {}) for p, a, _ in k4_calls]
    return {"fused_gemm_reduce": fused_cases,
            "matmul_ksplit": ksplit_cases,
            "grouped_matmul_dw": dw_cases,
            "branch_matmul": winograd}, launches


def check_zoo_cases(dev):
    """K8 and K7 against their plain versions, untimed: K8 at
    ``KSPLIT_SHAPES`` with both operands row-major and both transposed
    views, K7 at ``DW_SETS`` with and without the mask, its dw and db
    also bitwise equal to K5's on the same operands."""
    import torch
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    g = torch.Generator().manual_seed(13)
    for m, k, n in KSPLIT_SHAPES:
        for transposed in (False, True):
            if transposed:
                x = torch.randn((k, m), generator=g).to(dev).t()
                y = torch.randn((n, k), generator=g).to(dev).t()
            else:
                x = torch.randn((m, k), generator=g).to(dev)
                y = torch.randn((k, n), generator=g).to(dev)
            got = km.matmul_ksplit(x, y)
            ref = km.matmul_ksplit_ref(x, y)
            torch.cuda.synchronize()
            check_outputs(f"matmul_ksplit case {(m, k, n)} transposed "
                          f"{transposed}", [("out", got, ref)], True)
    for shapes in DW_SETS:
        total = sum(n for _, n in shapes)
        offs = [sum(n for _, n in shapes[:i]) for i in range(len(shapes))]
        xs = [torch.randn((DW_M, k), generator=g).to(dev)
              for k, _ in shapes]
        ws = [torch.randn((k, n), generator=g).to(dev) for k, n in shapes]
        dy = torch.randn((DW_M, total), generator=g).to(dev)
        y = torch.relu(torch.randn((DW_M, total), generator=g)).to(dev)
        dys = [dy[:, o:o + n] for o, (_, n) in zip(offs, shapes)]
        for mask in (None, [y[:, o:o + n] for o, (_, n) in zip(offs, shapes)]):
            with torch.no_grad():
                dws, dbs = kg.grouped_matmul_dw(xs, dys, mask)
                rdw, rdb = kg.grouped_matmul_dw_ref(xs, dys, mask)
                _, dw5, db5 = kg.grouped_matmul_bwd(xs, ws, dys, mask)
            torch.cuda.synchronize()
            tag = f"grouped_matmul_dw case {shapes} masked {mask is not None}"
            outs = list(enumerate(zip(dws + dbs, rdw + rdb, dw5 + db5)))
            check_outputs(tag, [(f"out{i}", a, b) for i, (a, b, _) in outs],
                          True)
            check_bitwise(f"{tag} against K5",
                          [(f"out{i}", a, c) for i, (a, _, c) in outs])
    print(f"[kernels] matmul_ksplit held at {len(KSPLIT_SHAPES)} shapes x 2 "
          f"layouts, grouped_matmul_dw at {len(DW_SETS)} branch sets x 2, "
          f"untimed")


def check_direct_bmm_cases(dev):
    """K3 at ``DIRECT_CASES`` and K9 at ``BMM_CASES`` in all four operand
    layouts against their plain versions, untimed, each bitwise equal on
    a second call."""
    import torch
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import conv2d as kc
    g = torch.Generator().manual_seed(17)
    for xs, ws, stride, padding in DIRECT_CASES:
        x = torch.randn(xs, generator=g).to(dev)
        w = (0.2 * torch.randn(ws, generator=g)).to(dev)
        kw = dict(stride=stride, padding=padding)
        with torch.no_grad():
            got = kc.conv2d_direct(x, w, **kw)
            ref = kc.conv2d_direct_ref(x, w, **kw)
            again = kc.conv2d_direct(x, w, **kw)
        torch.cuda.synchronize()
        tag = f"conv2d_direct case {describe('conv2d_direct', (x, w), kw)}"
        check_outputs(tag, [("out", got, ref)], True)
        check_repeats(tag, got, again)
    for gb, m, k, n in BMM_CASES:
        for a_t in (False, True):
            for b_t in (False, True):
                x = torch.randn((gb, k, m) if a_t else (gb, m, k),
                                generator=g).to(dev)
                y = torch.randn((gb, n, k) if b_t else (gb, k, n),
                                generator=g).to(dev)
                x = x.transpose(1, 2) if a_t else x
                y = y.transpose(1, 2) if b_t else y
                with torch.no_grad():
                    got = kb.branch_matmul(x, y)
                    ref = kb.branch_matmul_ref(x, y)
                    again = kb.branch_matmul(x, y)
                torch.cuda.synchronize()
                tag = (f"branch_matmul case "
                       f"{describe('branch_matmul', (x, y), {})}")
                check_outputs(tag, *_outputs("branch_matmul", got, ref,
                                             (x, y), {}))
                check_repeats(tag, got, again)
    print(f"[kernels] conv2d_direct held at {len(DIRECT_CASES)} cases, "
          f"branch_matmul at {len(BMM_CASES)} shapes x 4 layouts, untimed")


#: check_expert_block_sizes' (D, F, M-block sizes): D and F off the
#: kernels' 128-wide tiles at every bm the dispatch can pick, then D and F
#: not multiples of 4 (K11's and K12's 4-byte copies and loads)
EXPERT_BLOCK_SHAPES = ((96, 80, (8, 16, 32, 64, 128)),
                       (90, 75, (16, 128)))


def check_expert_block_sizes(dev):
    """K11 and K12 at every M-block size the dispatch can pick (bm 8 to
    128), gated silu and ungated gelu, on packed synthetic tokens with a
    zero-token expert, a partial last block per expert and dead tail
    blocks, D and F not multiples of the kernels' tiles, and at D and F
    not multiples of 4 (``EXPERT_BLOCK_SHAPES``): each output tensor
    against its plain version, untimed, K11's rows past each block's
    valid count exactly zero (the main path at full width runs bm 128
    only, D and F multiples of 4)."""
    import torch
    from repro_torch.kernels import grouped_matmul as kg
    g = torch.Generator().manual_seed(7)
    e = 8
    for d, f, bm, gated, act in (
            (d, f, bm, gated, act) for d, f, bms in EXPERT_BLOCK_SHAPES
            for bm in bms
            for gated, act in ((True, "silu"), (False, "gelu"))):
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
        tag = f"D {d} F {f} bm {bm} gated {gated} {act}"
        with torch.no_grad():
            kw = dict(activation=act, bm=bm)
            fwd = (xp, swp, w_in, w_out, w_gate, counts)
            got = kg.grouped_matmul_experts(*fwd, train=True, **kw)
            ref = kg.grouped_matmul_experts_ref(*fwd, train=True, **kw)
            check_outputs(f"grouped_matmul_experts {tag}", *_outputs(
                "grouped_matmul_experts", got, ref, fwd, kw))
            live = torch.zeros(rows, dtype=torch.bool, device=dev)
            for a, c in zip(offs, counts.tolist()):
                live[a:a + c] = True
            if any(bool(t[~live].any()) for t in got if t is not None):
                raise RuntimeError(f"grouped_matmul_experts {tag}: rows "
                                   f"past a block's valid count are not "
                                   f"exactly zero")
            bwd = (xp, dyp, w_in, w_out, w_gate, got[1], got[2], counts)
            gb = kg.grouped_matmul_experts_bwd(*bwd, **kw)
            rb = kg.grouped_matmul_experts_bwd_ref(*bwd, **kw)
            check_outputs(f"grouped_matmul_experts_bwd {tag}", *_outputs(
                "grouped_matmul_experts_bwd", gb, rb, bwd, kw))
        if not all(bool((t[1] == 0).all()) for t in gb[1:] if t is not None):
            raise RuntimeError(f"{tag}: the zero-token expert's dW is "
                               f"not exactly zero")


def check_ssm_serving(cfg, params, tokens, dev):
    """Phase 6b, mamba2-370m: the ``impl="pallas"`` prefill (K14) against
    the plain ``impl="xla"`` one on the card, then SSM_GEN decode steps
    on each path's cache, teacher-forced with the plain path's greedy
    tokens; first with the serving default's caches (conv tail in bf16),
    then with f32 caches.  Every pallas prefill must launch K14 once per
    layer, no plain prefill and no decode step a kernel.  Held: the
    prefill logits and the SSM and conv caches, and every decode step's
    logits.  On f32 caches a decode step is held within the bound.  On
    bf16 caches a conv entry whose f32 value differs in the last bits
    may round to the other bf16 neighbour and move later steps past the
    bound, so the bf16 run also decodes plain prefills at the chunks of
    SSM_CONTROL_CHUNKS, which differ from plain only in rounding order:
    each step of the pallas path is held within CONTROL_MARGIN times the
    most any control drifted (or the bound, if that is larger)."""
    import dataclasses
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    s = cfg.ssm
    print(f"[ssm] {cfg.name}: {cfg.param_count() / 1e6:.2f}M parameters, "
          f"{cfg.n_layers} layers, d_inner {s.d_inner}, {s.n_heads} heads "
          f"x {s.head_dim}, d_state {s.d_state}, chunk {s.chunk}; batch "
          f"{SSM_BATCH}, prompt {SSM_PROMPT}, {SSM_GEN} decode steps")
    prefills = {impl: steps.make_prefill_step(cfg, impl=impl)
                for impl in ("pallas", "xla")}
    controls = {f"plain chunk {l}": steps.make_prefill_step(
        dataclasses.replace(cfg, ssm=dataclasses.replace(s, chunk=l)),
        impl="xla") for l in SSM_CONTROL_CHUNKS}
    decode = steps.make_decode_step(cfg)
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        bf16 = dtype == torch.bfloat16
        cache0 = transformer.init_cache(cfg, SSM_BATCH, SSM_PROMPT + SSM_GEN,
                                        dtype=dtype, device=dev)
        runs = {}
        for name, prefill in {**prefills, **(controls if bf16 else {})} \
                .items():
            if bf16:
                prefill(params, tokens, cache0)      # warm, before the count
            torch.cuda.synchronize()
            runtime.reset_launch_counts()
            t0 = time.perf_counter()
            logits, cache = prefill(params, tokens, cache0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            runs[name] = (logits, cache, ms, dict(runtime.KERNEL_LAUNCHES))
        del cache0
        lp, cp, ms_p, _ = runs["xla"]
        launches = runs["pallas"][3]
        print(f"[ssm] {tag} caches: prefill pallas {runs['pallas'][2]:.3f} "
              f"ms, plain {ms_p:.3f} ms (host clock to synchronize); K14 "
              f"launches pallas {launches['ssd_chunked']}, plain "
              f"{sum(runs['xla'][3].values())}")
        other = [n for n in runs if n != "pallas" and sum(runs[n][3].values())]
        if launches != SSM_LAUNCHES or other:
            raise RuntimeError(f"prefill launches {launches} (a plain run "
                               f"launched: {other}), expected {SSM_LAUNCHES}")
        lim = LOGIT_RTOL * float(lp.abs().max()) + 1e-6
        for name, (logits, cache, _, _) in runs.items():
            if name == "xla":
                continue
            if not bool(torch.isfinite(logits).all()):
                raise RuntimeError(f"{name} prefill logits are not finite")
            err = float((logits - lp).abs().max())
            print(f"[ssm] {tag} caches: {name} prefill logits against plain "
                  f"max_abs_err {err:.3e} (limit {lim:.3e})")
            if not err <= lim:
                raise RuntimeError(f"{name} prefill logits disagree with "
                                   f"plain")
            check_outputs(f"{name} ssm cache after prefill ({tag} caches)", [
                (f"layer {i}", cache[0]["ssm"][i], cp[0]["ssm"][i])
                for i in range(cfg.n_layers)], True)
            if bf16:
                check_conv_cache(name, cache[0]["conv"], cp[0]["conv"])
            else:
                check_outputs(f"{name} conv cache after prefill ({tag} "
                              f"caches)", [
                    (f"layer {i}", cache[0]["conv"][i], cp[0]["conv"][i])
                    for i in range(cfg.n_layers)], True)
        tok = lp.argmax(-1)[:, None]
        caches = {name: run[1] for name, run in runs.items()}
        del runs, lp, cp
        ratios = {name: [] for name in caches if name != "xla"}
        flips, dec_ms = [], []
        runtime.reset_launch_counts()
        for i in range(SSM_GEN):
            pos = SSM_PROMPT + i
            gp, caches["xla"] = decode(params, caches["xla"], tok, pos)
            lim = LOGIT_RTOL * float(gp.abs().max()) + 1e-6
            ap = gp[:, 0].argmax(-1)
            for name in ratios:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g, caches[name] = decode(params, caches[name], tok, pos)
                torch.cuda.synchronize()
                if name == "pallas":
                    dec_ms.append((time.perf_counter() - t0) * 1e3)
                    ak = g[:, 0].argmax(-1)
                    for r in torch.nonzero(ak != ap).flatten().tolist():
                        top2 = torch.topk(gp[r, 0], 2).values
                        flips.append((i, r, int(ak[r]), int(ap[r]),
                                      float(top2[0] - top2[1])))
                ratios[name].append(float((g - gp).abs().max()) / lim)
            if sum(runtime.KERNEL_LAUNCHES.values()):
                raise RuntimeError(f"a decode step launched a kernel: "
                                   f"{runtime.KERNEL_LAUNCHES}")
            tok = ap[:, None]
        drift = max((max(r) for n, r in ratios.items() if n != "pallas"),
                    default=0.0)
        allowed = max(1.0, CONTROL_MARGIN * drift)
        for name, r in ratios.items():
            print(f"[ssm] {tag} caches, {SSM_GEN} teacher-forced decode "
                  f"steps, {name} against plain: logit err/limit per step "
                  + " ".join(f"{v:.3g}" for v in r))
        if bf16:
            print(f"[ssm] {tag} caches: the controls' most drift "
                  f"{drift:.3g} of the bound; pallas held within "
                  f"{allowed:.3g}, its most {max(ratios['pallas']):.3g}")
        print(f"[ssm] {tag} caches: greedy tokens that differ (step, row, "
              f"pallas, plain, plain top-2 margin): {flips or 'none'}; "
              f"decode ms/step median {statistics.median(dec_ms):.3f}")
        worst = max(range(SSM_GEN), key=lambda i: ratios["pallas"][i])
        if not ratios["pallas"][worst] <= allowed:
            raise RuntimeError(
                f"decode step {worst} ({tag} caches): logits on the K14 "
                f"prefill's cache are {ratios['pallas'][worst]:.3g} of the "
                f"bound from plain, past {allowed:.3g}")
        del caches
        torch.cuda.empty_cache()


def check_conv_cache(name, got, ref):
    """The bf16 conv tails after a prefill against the plain path's, per
    layer: each element within TOL * max|ref| + FLOOR, or one bf16
    spacing of it (the two paths' f32 values differ by rounding from
    layer 1 on, and a value near a rounding boundary then rounds to the
    other bf16 neighbour; the controls of ``check_ssm_serving`` show how
    many such flips a change of rounding order alone makes).  Prints how
    many elements needed the second rule."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    n_flip, worst = 0, 0.0
    for i in range(g.shape[0]):
        lim = TOL * float(r[i].abs().max()) + FLOOR
        beyond = err[i] > lim
        flip_ok = err[i] <= r[i].abs() * 2.0 ** -7
        if bool((beyond & ~flip_ok).any()):
            raise RuntimeError(f"{name} conv cache layer {i}: max abs err "
                               f"{float(err[i].max()):.3e}, limit "
                               f"{lim:.3e}, not a bf16 rounding flip")
        n_flip += int(beyond.sum())
        worst = max(worst, float(err[i].max()) / lim)
    print(f"[ssm] {name} conv cache after prefill (bf16): "
          f"{int((err > 0).sum())} of {err.numel()} elements differ from "
          f"plain; {n_flip} beyond TOL * max|ref|, each one bf16 spacing; "
          f"worst err/limit {worst:.3e}")


def serve_lm(arch, batch, prompt, gen, impl="xla"):
    """The LM serving CLI's path (``launch.serve._serve_transformer``)
    with launch counters set to 0 just before and read just after;
    returns (figures, launches)."""
    from repro_torch.kernels import runtime
    from repro_torch.launch import serve
    args = serve.parser().parse_args(
        ["--arch", arch, "--batch", str(batch), "--prompt-len", str(prompt),
         "--gen", str(gen), "--seed", "0"])
    runtime.reset_launch_counts()
    m = serve._serve_transformer(args, impl=impl)
    launches = dict(runtime.KERNEL_LAUNCHES)
    print(f"[lm-serve] {m['arch']} impl {impl}: prefill {m['prefill_ms']:.3f}"
          f" ms ({m['prefill_tokens_per_s']:.1f} tokens/s), decode "
          f"{m['decode_ms_per_token']:.3f} ms/token "
          f"({m['decode_tokens_per_s']:.1f} tokens/s at batch {batch}), "
          f"peak memory {m['peak_gib']:.2f} GiB; launches {launches}")
    if not m["finite"]:
        raise RuntimeError(f"{arch}: served logits are not finite")
    return m, launches


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
# phase 4b: the attention LMs' impl="pallas" forward against impl="xla"
# ---------------------------------------------------------------------------

def _forward_counted(params, cfg, batch, impl, loss=False):
    """One forward (or ``loss_fn``) under ``torch.no_grad()`` with the
    launch counters set to 0 just before and read just after; returns
    (logits or loss, launches)."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.models import transformer
    with torch.no_grad():
        runtime.reset_launch_counts()
        if loss:
            out = transformer.loss_fn(params, cfg, batch, impl=impl)[0]
        else:
            out = transformer.forward(params, cfg, batch["tokens"],
                                      impl=impl)[0]
        torch.cuda.synchronize()
        return out, dict(runtime.KERNEL_LAUNCHES)


def check_attention_lm(cfg, params, batch, dev, flash_launches):
    """Phase 4b for one attention LM: the ``impl="pallas"`` forward (K13
    on every layer) against the ``impl="xla"`` one on the same
    parameters and tokens: logits within LOGIT_RTOL * max|logit| + 1e-6,
    ``loss_fn``'s value within LOSS_RTOL relative, exactly
    ``flash_launches`` K13 launches and nothing else per pallas forward,
    no launch per xla one.  Prints each impl's warm forward time (host
    clock, median of ATTN_REPS), tokens/s and peak memory; on the card
    also where one warm pallas forward's device time goes.  Returns the
    K13 launches counted in the pallas forward and K13's device time in
    the profiled one (None off the card, or if the profiler kept fewer
    K13 records than launches)."""
    import torch
    want = {k: 0 for k in TRAIN_LAUNCHES}
    n_tok = batch["tokens"].numel()
    out, times = {}, {}
    for impl in ("pallas", "xla"):
        expect = dict(want, flash_attention=flash_launches) \
            if impl == "pallas" else want
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        logits, launches = _forward_counted(params, cfg, batch, impl)
        loss, loss_launches = _forward_counted(params, cfg, batch, impl,
                                               loss=True)
        for what, got in (("forward", launches), ("loss_fn", loss_launches)):
            if got != expect:
                raise RuntimeError(f"{cfg.name} impl {impl} {what} launched "
                                   f"{got}, expected {expect}")
        if tuple(logits.shape) != (*batch["tokens"].shape, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()) \
                or not math.isfinite(float(loss)):
            raise RuntimeError(f"{cfg.name} impl {impl}: logits "
                               f"{tuple(logits.shape)} or loss not finite / "
                               f"wrong shape")
        ts = []
        for _ in range(ATTN_REPS):
            t0 = time.perf_counter()
            _forward_counted(params, cfg, batch, impl)
            ts.append((time.perf_counter() - t0) * 1e3)
        times[impl] = statistics.median(ts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
            if dev.type == "cuda" else math.nan
        print(f"[attn-lm] {cfg.name} impl {impl}: forward "
              f"{times[impl]:.3f} ms ({n_tok / times[impl] * 1e3:.1f} "
              f"tokens/s; warm, host clock, median of {ATTN_REPS}: "
              f"{', '.join(f'{t:.3f}' for t in ts)}), peak memory "
              f"{peak:.2f} GiB; launches {launches}")
        out[impl] = (logits, float(loss), launches)
        del logits
    (lp, loss_p, launched), (lx, loss_x, _) = out["pallas"], out["xla"]
    err = float((lp - lx).abs().max())
    lim = LOGIT_RTOL * float(lx.abs().max()) + 1e-6
    lerr = abs(loss_p - loss_x)
    print(f"[attn-lm] {cfg.name}: pallas against xla logits max_abs_err "
          f"{err:.3e} (limit {lim:.3e}, err/limit {err / lim:.3e}); loss "
          f"{loss_p:.6f} against {loss_x:.6f} (rel {lerr / abs(loss_x):.3e},"
          f" limit {LOSS_RTOL:g})")
    if not err <= lim:
        raise RuntimeError(f"{cfg.name}: impl='pallas' logits disagree with "
                           f"impl='xla'")
    if not lerr <= LOSS_RTOL * abs(loss_x):
        raise RuntimeError(f"{cfg.name}: impl='pallas' loss disagrees with "
                           f"impl='xla'")
    del out, lp, lx
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _forward_counted(params, cfg, batch, "pallas")
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = _print_profile(f"{cfg.name} impl pallas forward (batch "
                              f"{batch['tokens'].shape[0]} x seq "
                              f"{batch['tokens'].shape[1]})", prof,
                              wall_ms, top=8)
        k13 = [(ms, n) for ms, n, key in rows
               if KERNEL_FUNCS["flash_attention"] in key]
        if sum(n for _, n in k13) == flash_launches:
            return launched["flash_attention"], sum(ms for ms, _ in k13)
    return launched["flash_attention"], None


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


def profile_lm_serving(dev):
    """Where a warm full-width mamba2-370m prefill (impl="pallas"), one of
    its decode steps, and one granite-moe-1b-a400m decode step (batch
    LMS_BATCH at position LMS_PROMPT) spend their time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg, params, tokens = ssm_setup(dev)
    cache = transformer.init_cache(cfg, SSM_BATCH, SSM_PROMPT + SSM_GEN,
                                   device=dev)
    prefill = steps.make_prefill_step(cfg, impl="pallas")
    decode = steps.make_decode_step(cfg)
    work = [("prefill", lambda: prefill(params, tokens, cache))]
    logits, c1 = work[0][1]()
    tok = logits.argmax(-1)[:, None]
    work.append(("decode step", lambda: decode(params, c1, tok, SSM_PROMPT)))
    g = get_config(LM_ARCH)
    gp = transformer.init_params(g, torch.Generator().manual_seed(0), dev)
    gc = transformer.init_cache(g, LMS_BATCH, LMS_PROMPT + LMS_GEN,
                                device=dev)
    gdec = steps.make_decode_step(g)
    gtok = tok % g.vocab
    work.append((f"{g.name} decode step",
                 lambda: gdec(gp, gc, gtok, LMS_PROMPT)))
    for tag, fn in work:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        _print_profile(f"{tag} (batch {SSM_BATCH}, prompt {SSM_PROMPT})"
                       if "granite" not in tag else
                       f"{tag} (batch {LMS_BATCH}, position {LMS_PROMPT})",
                       prof, wall_ms, top=10)


def _print_profile(tag, prof, wall_ms, top=8):
    """Print the device busy time, idle share and ``top`` kernels of a
    profile; returns its kernel rows (ms, launches, name)."""
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
        return rows
    print(f"[profile] {tag}: wall {wall_ms:.3f} ms (host clock, profiler "
          f"on), device busy {dev_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - dev_ms / wall_ms):.3f}")
    for ms, n, key in sorted(rows, reverse=True)[:top]:
        print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return rows


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
    from repro_torch.configs import get_config
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
        torch.cuda.empty_cache()
        profile_lm_serving(dev)
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
    # K2 on the training step's launches again, each pooled branch's lhs
    # folded beforehand: what pooling inside the kernel costs, its sums
    # printed apart ("train unpooled"; not in the kernels line)
    check_kernels({"grouped_matmul_pooled": unpooled_cases(
        calls["grouped_matmul_pooled"])})
    # K3 and K4 at the shapes of the serial baseline's training step: all
    # of its 51 and 119 calls, timed, their sums printed apart
    # ("conv2d_direct serial", "matmul serial")
    check_kernels(capture_serial_calls(params, CONFIG, dev))
    # 3b. co-execution and the zoo: the fused plan, the GEMM and conv
    # zoos and K7's library call, each path's counters zeroed just before;
    # then K10, K8 and K7 against their plain versions on what they ran
    # (K8 also on the training step's 6 captured K4 calls)
    zoo, zoo_launches = check_zoo(
        dev, [c for c in calls["matmul"] if c[0] == "train"],
        calls["grouped_matmul_bwd"])
    del calls
    winograd = {"branch_matmul": zoo.pop("branch_matmul")}
    print("[kernels] captured calls: " + ", ".join(
        f"{k} {len(v)}" for k, v in zoo.items()))
    rows.update(check_kernels(zoo))
    for name in ZOO_KERNELS:
        rows[name]["launches"] = zoo_launches[name]
    del zoo
    check_zoo_cases(dev)
    # K9 at the shapes of the stacked plan's training step
    calls = capture_stacked_calls(params, CONFIG, dev)
    print(f"[kernels] captured calls: branch_matmul "
          f"{len(calls['branch_matmul'])} (one stacked-plan training step)")
    rows.update(check_kernels(calls))
    del calls
    # K9 at Winograd's call in the conv zoo, its sums printed apart ("zoo
    # winograd"; not in the kernels line); then K3 and K9, untimed, at
    # DIRECT_CASES and BMM_CASES
    check_kernels(winograd)
    del winograd
    check_direct_bmm_cases(dev)
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
    # K14 at the shapes of the full-width mamba2-370m prefill
    t0 = time.perf_counter()
    ssm_cfg, ssm_params, ssm_tokens = ssm_setup(dev)
    print(f"[kernels] {ssm_cfg.name} parameters made in "
          f"{time.perf_counter() - t0:.1f} s")
    calls = capture_ssd_calls(ssm_params, ssm_cfg, ssm_tokens, dev)
    print(f"[kernels] captured calls: ssd_chunked "
          f"{len(calls['ssd_chunked'])} (one impl='pallas' prefill)")
    rows.update(check_kernels(calls))
    del calls
    check_ssd_cases(dev)
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
          f"(one launch each, as on the TPU: "
          f"{launches['grouped_matmul_chained']})")
    if launches["grouped_matmul_chained"] != chained_calls:
        raise RuntimeError(f"K6 launched {launches['grouped_matmul_chained']}"
                           f" times for {chained_calls} chained calls")
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
    for b, row in sorted(measured.items()):
        chains = len(plan_cache.cached_cnn_plan(CONFIG, b, chain_modules=True)
                     .plan.groups_of_mode("grouped_chained"))
        per = row["grouped_matmul_chained"] / row["dispatches"]
        if per != chains:
            raise RuntimeError(f"bucket {b}: {per:g} K6 launches a measured "
                               f"dispatch, not one per each of the plan's "
                               f"{chains} chained groups")
    print("[launches] K6 once per chained group: " + ", ".join(
        f"bucket {b} {row['grouped_matmul_chained'] / row['dispatches']:g}"
        for b, row in sorted(measured.items())))
    for name in SERVE_KERNELS:
        if launches[name] <= 0 \
                or sum(r[name] for r in measured.values()) <= 0:
            raise RuntimeError(f"{name} never launched in the measured "
                               f"stream of the main path")
        rows[name]["launches"] = launches[name]
    if any(launches[name] for name in ZOO_KERNELS):
        raise RuntimeError(f"serving launched a zoo kernel: {launches}")

    # 6b. LM serving: mamba2-370m, the K14 prefill against the plain one
    # and teacher-forced decode on both caches; then the serving CLI's
    # path (counters zeroed just before) for mamba2-370m with
    # impl="pallas" and for granite-moe-1b-a400m in plain torch
    check_ssm_serving(ssm_cfg, ssm_params, ssm_tokens, dev)
    del ssm_params, ssm_tokens
    torch.cuda.empty_cache()
    m, launches = serve_lm(SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_GEN,
                           impl="pallas")
    if launches != SSM_LAUNCHES:
        raise RuntimeError(f"mamba2 serving launched {launches}, expected "
                           f"{SSM_LAUNCHES}")
    rows["ssd_chunked"]["launches"] = launches["ssd_chunked"]
    torch.cuda.empty_cache()
    m, launches = serve_lm(LM_ARCH, LMS_BATCH, LMS_PROMPT, LMS_GEN)
    g = get_config(LM_ARCH)
    want = [{"kv": (g.n_layers, 2, LMS_BATCH, LMS_PROMPT + LMS_GEN,
                    g.n_kv_heads, g.head_dim)}]
    if sum(launches.values()) or m["cache_shapes"] != want \
            or m["tokens"].shape != (LMS_BATCH, LMS_GEN):
        raise RuntimeError(f"granite serving: launches {launches}, cache "
                           f"{m['cache_shapes']} (expected {want}), tokens "
                           f"{m['tokens'].shape}")
    # 3 (K13) and 4b. the attention LMs, on a card the earlier phases have
    # left empty: per model, K13's calls captured from one impl="pallas"
    # forward, then the forward end to end against impl="xla" (counters
    # zeroed just before each forward); the model freed before the next
    # is made; then K13 held against its plain version on the captured
    # calls and at FLASH_CASES
    t_attn = time.perf_counter()
    calls = {"flash_attention": []}
    k13_device_ms: float | None = 0.0
    for arch in ATTN_ARCHS:
        t0 = time.perf_counter()
        cfg, params, batch = attn_setup(arch, dev)
        torch.cuda.synchronize()
        print(f"[attn-lm] {cfg.name}: {cfg.param_count() / 1e9:.3f}B "
              f"parameters made on the card in {time.perf_counter() - t0:.1f}"
              f" s")
        calls["flash_attention"] += capture_flash_calls(
            params, cfg, batch["tokens"])["flash_attention"]
        n, t_d = check_attention_lm(cfg, params, batch, dev, cfg.n_layers)
        if arch == "llama3-8b":
            rows_flash_launches = n
        k13_device_ms = None if k13_device_ms is None or t_d is None \
            else k13_device_ms + t_d
        del params, batch
        torch.cuda.empty_cache()
    print(f"[kernels] captured calls: flash_attention "
          f"{len(calls['flash_attention'])} (one impl='pallas' forward of "
          f"each attention LM)")
    rows.update(check_kernels(calls))
    del calls
    check_flash_cases(dev)
    rows["flash_attention"]["launches"] = rows_flash_launches
    # K13's few-call profiler windows in check_kernels mostly come back
    # without its records this late in the script; the profiled forwards
    # kept every one of its 34 launches, on the same calls' shapes
    rows["flash_attention"]["kernel_device_ms"] = k13_device_ms
    print(f"[kernels] flash_attention: kernel device {k13_device_ms} ms "
          f"over the {len(ATTN_ARCHS)} profiled pallas forwards of phase 4b")
    torch.cuda.empty_cache()
    print(f"[attn-lm] phases 3 (K13) and 4b took "
          f"{time.perf_counter() - t_attn:.1f} s")
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
