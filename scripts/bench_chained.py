#!/usr/bin/env python3
"""Time the chained grouped launch (K6) on every chain of a planned
full-width GoogLeNet serving forward, per bucket, and profile one warm
serving dispatch per bucket, for the port found under ``--src``.

    python3 scripts/bench_chained.py [--src DIR] [--buckets 1 2 4]
        [--variant MIN_DEPTH SPLIT_CTAS LAG ...]

``--src`` is the ``src`` directory of a checkout (this one by default),
so one call on the card can time two checkouts in turns (parent,
change, change, parent) on the same card.  It uses only what every
version of the port has: the wrapper ``grouped_matmul_chained``, the
plan cache, ``cnn.forward_plan`` and ``launch.steps.make_cnn_serve_step``.

Per chain it prints: the wrapper's time (CUDA events around the whole
call, median of 20 after 3 warm-up calls), the kernel's own device time
(``torch.profiler``, the CUDA function ``gmm_chained_kernel``, over 5
calls), the launches a call makes, one ``torch.matmul`` per branch on its
live depth (an (m_valid, live rows) lhs against the weight's nonzero rows,
the work the chain needs), and the bound: the chain's FLOPs over 67
TFLOP/s or its bytes over 3.35 TB/s (nonzero weight rows, true widths,
the rows below m_valid; each input read once, each output written once).
Per bucket it prints the sums, then one warm dispatch's host wall, the
device busy time ``torch.profiler`` attributes to kernels and the idle
share that leaves.  Each ``--variant`` (a checkout whose
``kernels/grouped_matmul.py`` has ``CHAIN_SPLIT_MIN_DEPTH``,
``CHAIN_SPLIT_CTAS`` and ``CHAIN_LAG``) times the same captured chains
again under that split depth floor, split rule and ticket lag, and
prints per bucket the sums of wrapper and device time.  Weights are random (seed 0), images from seed 1 (the
capture) and 3 (the dispatch profile); TF32 is off.  It needs a CUDA
device and exits 2 without one.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

PEAK_F32, PEAK_BW = 67e12, 3.35e12


def time_ms(fn, reps=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def device_ms(fn, func="gmm_chained_kernel", reps=5):
    """Device time per call of CUDA functions named ``func``; None when
    the profiler keeps no such record in three tries."""
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
        us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and func in e.key)
        if us > 0:
            return us / 1e3 / reps
    return None


def live_rows(w):
    import torch
    return torch.nonzero((w != 0).any(dim=1)).flatten()


def work(phases, kw):
    rows = kw.get("m_valid") or kw["m"]
    flops = byts = 0.0
    for phase in phases:
        for br in phase:
            nz = int((br["w"] != 0).any(dim=1).sum())
            flops += 2.0 * rows * nz * br["n"]
            byts += 4.0 * (nz * br["n"] + br["n"] + rows * br["n"])
            if br["src"][0] == "x":
                byts += sum(4.0 * rows * a.shape[1] for a in br["src"][1])
    byts += sum(4.0 * rows * p.shape[1] for p in kw.get("panels", ()))
    return flops, byts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--variant", type=int, nargs=3, action="append",
                    default=[], metavar=("MIN_DEPTH", "SPLIT_CTAS", "LAG"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("bench_chained: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import repro_torch
    from repro_torch.configs.googlenet import CONFIG
    from repro_torch.core import plan_cache
    from repro_torch.kernels import build, runtime
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.launch.steps import make_cnn_serve_step
    from repro_torch.models import cnn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[bench] {card}; port {Path(repro_torch.__file__).parent}")
    build.lib()
    dev = torch.device("cuda")
    params = cnn.init_params(CONFIG, torch.Generator().manual_seed(0), dev)
    real = kg.grouped_matmul_chained
    gen = torch.Generator().manual_seed(1)
    captured = {}
    for b in args.buckets:
        calls = captured[b] = []

        def rec(*a, _calls=calls, **k):
            _calls.append((a, k))
            return real(*a, **k)
        plan = plan_cache.cached_cnn_plan(CONFIG, b, chain_modules=True).plan
        x = torch.randn((b,) + CONFIG.img, generator=gen).to(dev)
        kg.grouped_matmul_chained = rec
        try:
            with torch.no_grad():
                cnn.forward_plan(params, CONFIG, x, plan, valid_images=b)
        finally:
            kg.grouped_matmul_chained = real
    for b, calls in captured.items():
        sums = [0.0] * 5
        for c, (a, k) in enumerate(calls):
            with torch.no_grad():
                runtime.reset_launch_counts()
                real(*a, **k)
                torch.cuda.synchronize()
                n_launch = runtime.KERNEL_LAUNCHES["grouped_matmul_chained"]
                fn = lambda: real(*a, **k)
                t_w = time_ms(fn)
                t_d = device_ms(fn)
                rows = k.get("m_valid") or k["m"]
                pairs = []
                for phase in a[0]:
                    for br in phase:
                        wl = br["w"][live_rows(br["w"])]
                        pairs.append((torch.empty((rows, wl.shape[0]),
                                                  device=dev), wl))
                t_l = time_ms(lambda: [torch.matmul(p, q) for p, q in pairs])
                del pairs
            flops, byts = work(a[0], k)
            bound = max(flops / PEAK_F32, byts / PEAK_BW) * 1e3
            extra = ""
            if hasattr(kg, "chained_plan"):
                la = kg.chained_plan(a[0], m=k["m"], h=k["h"], w=k["w"],
                                     panels=k.get("panels", ()),
                                     m_valid=k.get("m_valid"),
                                     sms=runtime.sm_count(dev))
                extra = (f" items {la['n_items']} splits {la['splits']} "
                         f"waves {la['waves']}")
            print(f"[bench] bucket {b} chain {c}: m={k['m']} {k['h']}x"
                  f"{k['w']} phases {len(a[0])} launches {n_launch}{extra}: "
                  f"wrapper {t_w:.4f} ms, device "
                  f"{'not measured' if t_d is None else f'{t_d:.4f} ms'}, "
                  f"library {t_l:.4f} ms, bound {bound:.4f} ms "
                  f"({flops:.4e} FLOP)")
            for i, v in enumerate((t_w, t_d or float("nan"), t_l, bound,
                                   flops)):
                sums[i] += v
        print(f"[bench] bucket {b}: {len(calls)} chains, sums: wrapper "
              f"{sums[0]:.4f} ms, device {sums[1]:.4f} ms, library "
              f"{sums[2]:.4f} ms, bound {sums[3]:.4f} ms ({sums[4]:.4e} "
              f"FLOP)")
    knobs = ("CHAIN_SPLIT_MIN_DEPTH", "CHAIN_SPLIT_CTAS", "CHAIN_LAG")
    default = [getattr(kg, n, None) for n in knobs]
    for variant in args.variant:
        for n, v in zip(knobs, variant):
            setattr(kg, n, v)
        min_depth, split_ctas, lag = variant
        for b, calls in captured.items():
            t_w = t_d = 0.0
            items, per = 0, []
            with torch.no_grad():
                for a, k in calls:
                    fn = lambda: real(*a, **k)
                    t_w += time_ms(fn)
                    per.append(device_ms(fn) or float("nan"))
                    t_d += per[-1]
                    items += kg.chained_plan(
                        a[0], m=k["m"], h=k["h"], w=k["w"],
                        panels=k.get("panels", ()), m_valid=k.get("m_valid"),
                        sms=runtime.sm_count(dev))["n_items"]
            print(f"[bench] variant min_depth {min_depth} split_ctas "
                  f"{split_ctas} lag {lag} bucket "
                  f"{b}: {len(calls)} chains, {items} items, sums: wrapper "
                  f"{t_w:.4f} ms, device {t_d:.4f} ms; device per chain "
                  f"{' '.join(f'{v:.4f}' for v in per)}")
    for n, v in zip(knobs, default):
        setattr(kg, n, v)
    del captured
    g = torch.Generator().manual_seed(3)
    for b in args.buckets:
        step = make_cnn_serve_step(
            CONFIG, plan_cache.cached_cnn_plan(CONFIG, b,
                                               chain_modules=True).plan)
        x = torch.randn((b,) + CONFIG.img, generator=g).to(dev)
        for _ in range(2):
            step(params, x, b)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, x, b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count,
                 e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(r[0] for r in rows)
        k6 = sum(r[0] for r in rows if "gmm_chained_kernel" in r[2])
        n6 = sum(r[1] for r in rows if "gmm_chained_kernel" in r[2])
        print(f"[bench] dispatch bucket {b}: wall {wall:.3f} ms (host "
              f"clock, profiler on), device busy {busy:.3f} ms, idle share "
              f"{max(0.0, 1 - busy / wall):.3f}; K6 {k6:.3f} ms in {n6} "
              f"launches")
        for ms, n, key in sorted(rows, reverse=True)[:5]:
            print(f"[bench]   {ms:9.3f} ms  x{n:<4d} {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
