"""Serving: the CNN's continuous batching on the planned executor, and
language-model prefill and greedy decode with a cache.

The counterpart of ``repro/launch/serve.py``.  CNN path: requests are
split into chunks of at most ``max_images`` (an oversized request spans
several dispatches — no image is dropped), admitted deadline- and
size-aware (an EDF anchor plus a greedy fill that minimizes the
dispatch's ``cost_model.padded_m_factor``), padded up to an M-bucket from
``cost_model.serve_buckets``, and each bucket dispatches through ONE
cached plan, its kernel tables and its serve step
(``core.plan_cache``).  The grouped-family kernels mask the padded-M tail
(the chained launch does not run M-blocks past the last real image).
The loop warms every bucket once, resets the cache counters, and
asserts the measured stream runs at hit rate 1.0.  Latency is per
request (queue wait + dispatch wall, completion of the last chunk).
Kernel launches are kept per bucket, for the warmup and the measured
stream apart (``launches`` in the metrics).

    python -m repro_torch.launch.serve --arch googlenet --requests 12 \\
        --max-images 4
    python -m repro_torch.launch.serve --arch googlenet --reduced \\
        --device cpu      # the plain torch versions, on the CPU

The request stream comes from ``np.random.default_rng(seed)`` exactly as
in the reference serving loop, so both packages serve the same stream.

Language models (``_serve_transformer``, the reference's): random
prompts of ``--prompt-len`` tokens for ``--batch`` sequences, one
prefill into a cache of ``prompt_len + gen`` positions, then ``gen - 1``
greedy decode steps; prints the prefill time and the decode time per
token.  ``impl`` (a keyword, default ``"xla"`` as in the reference;
no flag) picks the prefill's mamba SSD: ``"pallas"`` runs K14.

    python -m repro_torch.launch.serve --arch mamba2-370m --batch 4 \\
        --prompt-len 2048 --gen 32
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m \\
        --reduced --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.runtime import (KERNEL_LAUNCHES, device_tables,
                                        resolve_device)


def _bucket_for(n: int, ladder: list[int]) -> int:
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


def _split_request(rid: int, imgs, deadline: float, max_images: int):
    """Chunk one request into admission units of <= max_images images.
    Every submitted image lands in exactly one chunk."""
    return [{"rid": rid, "imgs": imgs[o:o + max_images],
             "deadline": deadline}
            for o in range(0, imgs.shape[0], max_images)]


def _admit(pending, max_images: int, ladder, rows_per_image: int, pmf):
    """Pick the next co-batch from ``pending`` chunks (mutates it).

    EDF anchor: the earliest-deadline chunk always dispatches next.  Fill:
    among chunks that still fit under ``max_images``, greedily admit
    whichever minimizes the dispatch's padded-M factor, stopping when no
    candidate improves on the current factor.  Ties fall to the earlier
    deadline via the stable sort.
    """
    pending.sort(key=lambda c: c["deadline"])
    batch = [pending.pop(0)]
    total = batch[0]["imgs"].shape[0]

    def factor(n):
        return pmf(n * rows_per_image,
                   _bucket_for(n, ladder) * rows_per_image)

    while True:
        cands = [c for c in pending
                 if total + c["imgs"].shape[0] <= max_images]
        if not cands:
            break
        best = min(cands,
                   key=lambda c: factor(total + c["imgs"].shape[0]))
        if factor(total + best["imgs"].shape[0]) > factor(total):
            break
        # identity removal — list.remove would == -compare image arrays
        pending.pop(next(i for i, c in enumerate(pending) if c is best))
        batch.append(best)
        total += best["imgs"].shape[0]
    return batch, total


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_cnn_metrics(cfg, *, max_images: int = 4, num_requests: int = 12,
                      seed: int = 0, chain_modules: bool = True,
                      device=None) -> dict:
    """Run the continuous-batching loop on ``cfg`` and return metrics.

    ``device=None`` serves on the CUDA card (and raises without one);
    ``device="cpu"`` runs the kernels' plain torch versions.  Parameters
    are random, drawn from ``torch.Generator().manual_seed(seed)``.
    Warmup dispatches one batch per ladder bucket (populating the plan
    cache and the kernel tables); counters then reset and the measured
    stream must be all cache hits and build no table.  ``launches``
    holds, for ``"warmup"`` and ``"measured"`` apart, each bucket's
    dispatch count and kernel launches (``KERNEL_LAUNCHES`` deltas; all
    zero on the CPU, where no kernel launches).
    """
    from repro_torch.core import cost_model as CM
    from repro_torch.core import plan_cache
    from repro_torch.launch.steps import make_cnn_serve_step
    from repro_torch.models import cnn as CNN

    dev = resolve_device(device)
    h, w, c = cfg.img
    ladder = CM.serve_buckets(max_images, h * w)
    rng = np.random.default_rng(seed)
    params = CNN.init_params(cfg, torch.Generator().manual_seed(seed), dev)

    def entry_for(bucket: int):
        entry = plan_cache.cached_cnn_plan(cfg, bucket, backend=dev.type,
                                           chain_modules=chain_modules)
        if entry.executable is None:
            entry.executable = make_cnn_serve_step(cfg, entry.plan)
        return entry

    launches: dict = {"warmup": {}, "measured": {}}

    def dispatch(arrs, stage="measured"):
        n = sum(r.shape[0] for r in arrs)
        bucket = _bucket_for(n, ladder)
        entry = entry_for(bucket)
        imgs = np.zeros((bucket, h, w, c), np.float32)
        off = 0
        for r in arrs:
            imgs[off:off + r.shape[0]] = r
            off += r.shape[0]
        before = dict(KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        logits = entry.executable(params, torch.from_numpy(imgs).to(dev), n)
        _sync(dev)
        lat = time.perf_counter() - t0
        row = launches[stage].setdefault(
            bucket, {"dispatches": 0, **{k: 0 for k in KERNEL_LAUNCHES}})
        row["dispatches"] += 1
        for k, v in KERNEL_LAUNCHES.items():
            row[k] += v - before[k]
        return logits, lat, bucket, n

    # request stream: image counts in [1, max_images + 1] — the +1 makes
    # oversized requests (must split, never truncate) part of every run
    sizes = rng.integers(1, max_images + 2, size=num_requests)
    deadlines = rng.uniform(0.05, 0.5, size=num_requests)
    requests = [rng.normal(size=(int(s), h, w, c)).astype(np.float32)
                for s in sizes]

    for b in ladder:
        dispatch([np.zeros((b, h, w, c), np.float32)], "warmup")
    plan_cache.reset()          # counters only; entries stay warm
    tables_before = device_tables.builds

    pending = []
    for rid, (r, dl) in enumerate(zip(requests, deadlines)):
        pending.extend(_split_request(rid, r, float(dl), max_images))
    chunks_left = {rid: sum(1 for c_ in pending if c_["rid"] == rid)
                   for rid in range(num_requests)}
    submitted_images = int(sum(sizes))

    dispatch_s, waste = [], []
    done_at: dict[int, float] = {}
    served_images = 0
    finite = True
    t_start = time.perf_counter()
    while pending:
        batch, total = _admit(pending, max_images, ladder, h * w,
                              CM.padded_m_factor)
        logits, lat, bucket, n = dispatch([c_["imgs"] for c_ in batch])
        t_end = time.perf_counter()
        finite &= bool(torch.isfinite(logits[:n]).all())
        dispatch_s.append(lat)
        served_images += n
        waste.append(CM.padded_m_factor(n * h * w, bucket * h * w))
        for c_ in batch:
            chunks_left[c_["rid"]] -= 1
            if chunks_left[c_["rid"]] == 0:
                done_at[c_["rid"]] = t_end
    wall = time.perf_counter() - t_start

    if len(done_at) != num_requests or served_images != submitted_images:
        raise RuntimeError("a submitted image never reached a launch")
    stats = plan_cache.stats()
    if stats["misses"] != 0 or stats["hit_rate"] != 1.0:
        raise RuntimeError(f"warm serving path re-lowered a plan: {stats}")
    if device_tables.builds != tables_before:
        raise RuntimeError("warm serving path rebuilt a kernel table")
    if not finite:
        raise RuntimeError("served logits are not finite")
    req_ms = np.asarray([done_at[r] - t_start
                         for r in range(num_requests)]) * 1e3
    disp_ms = np.asarray(dispatch_s) * 1e3
    return {
        "arch": cfg.name,
        "device": str(dev),
        "buckets": ladder,
        "requests": int(num_requests),
        "dispatches": len(dispatch_s),
        "images": int(served_images),
        "images_submitted": submitted_images,
        "qps": float(num_requests / wall),
        "images_per_s": float(served_images / wall),
        "p50_ms": float(np.percentile(req_ms, 50)),
        "p99_ms": float(np.percentile(req_ms, 99)),
        "latency_samples": int(req_ms.size),
        "dispatch_p50_ms": float(np.percentile(disp_ms, 50)),
        "dispatch_p99_ms": float(np.percentile(disp_ms, 99)),
        "padded_m_factor_mean": float(np.mean(waste)),
        "plan_cache": stats,
        "tables": len(device_tables),
        "launches": launches,
    }


def _serve_transformer(args, *, impl: str = "xla") -> dict:
    """Prefill ``args.batch`` random prompts of ``args.prompt_len``
    tokens (``np.random.default_rng(args.seed)``; parameters from
    ``torch.Generator().manual_seed(args.seed)``) and decode
    ``args.gen - 1`` greedy tokens; prints the reference's two lines and
    returns the figures: prefill ms, decode ms per token, tokens/s of
    each, peak device memory (None on the CPU), whether every logit was
    finite, the cache's leaf shapes and the tokens (B, gen)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dev = resolve_device(args.device)
    params = T.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           dev)
    b, steps = args.batch, max(args.gen - 1, 1)
    prompts = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (b, args.prompt_len))).to(dev)
    cache = T.init_cache(cfg, b, args.prompt_len + args.gen, device=dev)
    prefill = make_prefill_step(cfg, impl=impl)
    decode = make_decode_step(cfg, impl=impl)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cache)
    tok = logits.argmax(-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = decode(params, cache, tok, args.prompt_len + i)
        finite = finite & torch.isfinite(logits).all()
        tok = logits[:, 0].argmax(-1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks = torch.cat(out, dim=1).cpu().numpy()
    print(f"[serve] {cfg.name} on {dev}: prefill {args.prompt_len} tok in "
          f"{t_prefill * 1e3:.0f} ms; {args.gen - 1} decode steps at "
          f"{t_decode / steps * 1e3:.1f} ms/tok (batch {b})")
    print("[serve] sample:", toks[0, :16].tolist())
    if toks.shape != (b, args.gen) or (toks < 0).any() \
            or (toks >= cfg.vocab).any():
        raise RuntimeError(f"decoded tokens out of range: {toks.shape}")
    return {
        "arch": cfg.name, "device": str(dev), "impl": impl, "batch": b,
        "prompt_len": args.prompt_len, "gen": args.gen,
        "prefill_ms": t_prefill * 1e3,
        "prefill_tokens_per_s": b * args.prompt_len / t_prefill,
        "decode_ms_per_token": t_decode / steps * 1e3,
        "decode_tokens_per_s": b * (args.gen - 1) / t_decode
        if args.gen > 1 else 0.0,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if dev.type == "cuda" else None,
        "finite": bool(finite),
        "cache_shapes": [{k: tuple(v.shape) for k, v in c.items()}
                         for c in cache],
        "tokens": toks,
    }


def parser() -> argparse.ArgumentParser:
    """The command line: the reference's flags and ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=12,
                    help="CNN path: synthetic request count")
    ap.add_argument("--max-images", type=int, default=4,
                    help="CNN path: max images per request chunk / co-batch")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain torch versions)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family != "cnn":
        _serve_transformer(args)
        return 0
    m = serve_cnn_metrics(cfg, max_images=args.max_images,
                          num_requests=args.requests, seed=args.seed,
                          device=args.device)
    print(f"[serve] {m['arch']} on {m['device']}: {m['requests']} requests "
          f"({m['images']} images) in {m['dispatches']} dispatches, "
          f"buckets {m['buckets']}")
    print(f"[serve] qps {m['qps']:.2f} ({m['images_per_s']:.2f} img/s), "
          f"request p50 {m['p50_ms']:.1f} ms / p99 {m['p99_ms']:.1f} ms "
          f"(n={m['latency_samples']}), dispatch p50 "
          f"{m['dispatch_p50_ms']:.1f} ms, padded-M waste "
          f"x{m['padded_m_factor_mean']:.2f}")
    print(f"[serve] plan cache: {m['plan_cache']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
