#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run below
    python3 chip_smoke.py --profile    # only: where a warm dispatch's
                                       # time goes, per serving bucket

Phases, each failing loudly (no caught failure, no exit 0 after one):

  1. device   require CUDA; print the card's name and power limit; turn
              TF32 off for matmuls and cuDNN convolutions (f32 references).
  2. build    compile the CUDA kernels from ``src/repro_torch/csrc``
              (one nvcc per source, in parallel) and print the seconds.
  3. kernels  capture every kernel wrapper's arguments from one planned
              full-width GoogLeNet forward at bucket 1 and one at bucket 2,
              then hold each kernel against its plain torch version on the
              same inputs (max abs error <= 1e-3 * max(1, max |ref|)) and
              time the wrapper (CUDA events around the whole call, fills
              and per-phase host gaps included), its kernels' own device
              time (``torch.profiler``), the plain version and a torch
              library yardstick.
  4. logits   the planned forward with kernels at buckets 1, 2 and 4
              (bucket 4 also ragged, 3 real images) against the port's
              plain ``forward`` on the card.
  5. serving  ``serve_cnn_metrics(full googlenet, max_images=4,
              requests=12, seed=SERVE_SEED)`` with every launch counter
              set to 0 just before and read just after: hit rate 1.0,
              every image served, the measured stream (not only its
              warmup) dispatches at every bucket of the ladder, and each
              of the four kernels launches in it.  Launches per dispatch
              are printed per bucket, warmup and measured apart.
  6. report   one JSON line of kernels, the card line again, and last the
              ``{"ok": true, ...}`` line.

It imports nothing of the JAX package.  Without a CUDA device, or
without the repository's ``src/`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TOL = 1e-3             # kernel vs plain: max abs err <= TOL * max(1, |ref|)
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
}
# the CUDA function each wrapper launches, as the profiler names it
KERNEL_FUNCS = {
    "grouped_matmul_concat": "gmm_kernel",
    "grouped_matmul_pooled": "gmm_kernel",
    "conv2d_direct": "conv2d_direct_kernel",
    "grouped_matmul_chained": "gmm_chained_kernel",
}
SOURCES = {
    "grouped_matmul_concat": "src/repro_torch/csrc/grouped_matmul.cu",
    "grouped_matmul_pooled": "src/repro_torch/csrc/grouped_matmul.cu",
    "conv2d_direct": "src/repro_torch/csrc/conv2d.cu",
    "grouped_matmul_chained":
        "src/repro_torch/csrc/grouped_matmul_chained.cu",
}


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

def capture_calls(params, cfg, dev, buckets=(1, 2)):
    """Run one planned forward per bucket with every kernel wrapper
    wrapped to record its (args, kwargs); returns {name: [calls]}."""
    import torch
    from repro_torch.core import plan_cache
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.models import cnn

    calls: dict = {n: [] for n in REPLACES}
    saved = {}
    targets = [(kg, "grouped_matmul_concat"), (kg, "grouped_matmul_pooled"),
               (kg, "grouped_matmul_chained"), (kc, "conv2d_direct")]
    for mod, name in targets:
        real = getattr(mod, name)
        saved[(mod, name)] = real

        def rec(*a, _real=real, _name=name, **k):
            calls[_name].append((a, k))
            return _real(*a, **k)
        setattr(mod, name, rec)
    try:
        g = torch.Generator().manual_seed(1)
        for b in buckets:
            plan = plan_cache.cached_cnn_plan(cfg, b, chain_modules=True).plan
            x = torch.randn((b,) + cfg.img, generator=g).to(dev)
            with torch.no_grad():
                cnn.forward_plan(params, cfg, x, plan, valid_images=b)
    finally:
        for (mod, name), real in saved.items():
            setattr(mod, name, real)
    return calls


def _nz_rows(w) -> int:
    return int((w != 0).any(dim=1).sum())


def work_of(name, args, kw):
    """(FLOPs, bytes) the call needs on this run's data: true rows (up to
    m_valid), true depths, each input read once and each output written
    once, 4 bytes per f32."""
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


def _rows_cols_check(name, got, ref, args, kw):
    """Max abs error on the rows and columns the contract defines, and
    whether the chained padding columns are exactly zero."""
    import torch
    if name == "grouped_matmul_chained":
        m = kw["m"]
        rows = kw.get("m_valid") or m
        err, scale, pad_ok = 0.0, 1.0, True
        from repro_torch.kernels.grouped_matmul import chained_layout
        lay = chained_layout(args[0])
        for p, (g, r) in enumerate(zip(got, ref)):
            err = max(err, float((g[:rows] - r[:rows]).abs().max()))
            scale = max(scale, float(r[:rows].abs().max()))
            for (pp, cb, nbb, n) in lay:
                if pp == p:
                    pad = g[:rows, cb * 128 + n:(cb + nbb) * 128]
                    pad_ok &= bool((pad == 0).all())
        return err, scale, pad_ok
    if isinstance(got, (list, tuple)):
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        scale = max(1.0, max(float(r.abs().max()) for r in ref))
        return err, scale, True
    err = float((got - ref).abs().max())
    return err, max(1.0, float(ref.abs().max())), bool(torch.isfinite(got).all())


def library_call(name, args, kw):
    """A torch library yardstick on the same inputs: ``F.conv2d`` for the
    direct conv, one ``torch.matmul`` per GEMM at the same shapes for the
    grouped launches.  The port never calls these."""
    import torch
    import torch.nn.functional as F
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


def check_kernels(calls):
    """Hold each captured call's kernel against its plain version; returns
    {name: row of the kernels line (launches filled in later)}."""
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import grouped_matmul as kg
    import torch
    fns = {
        "grouped_matmul_concat": (kg.grouped_matmul_concat,
                                  kg.grouped_matmul_concat_ref),
        "grouped_matmul_pooled": (kg.grouped_matmul_pooled,
                                  kg.grouped_matmul_pooled_ref),
        "grouped_matmul_chained": (kg.grouped_matmul_chained,
                                   kg.grouped_matmul_chained_ref),
        "conv2d_direct": (kc.conv2d_direct, kc.conv2d_direct_ref),
    }
    rows = {}
    for name, (kern, plain) in fns.items():
        cases = list(calls[name])
        if not cases:
            raise RuntimeError(f"main path made no {name} call")
        if name == "grouped_matmul_chained":
            # the stem chain (bucket 2) and the inc0 module chain (bucket 2),
            # dense and ragged (one real image of two)
            b2 = [c for c in cases if c[1]["m"] % 2 == 0
                  and c[1]["m"] // (c[1]["h"] * c[1]["w"]) == 2][:2]
            cases = []
            for a, k in b2:
                cases.append((a, dict(k, m_valid=None)))
                cases.append((a, dict(k, m_valid=k["m"] // 2)))
        worst, ms, plain_ms, lib_ms, bound, bound_by = 0.0, 0.0, 0.0, 0.0, \
            0.0, ""
        dev_ms: float | None = 0.0
        for a, k in cases:
            with torch.no_grad():
                got = kern(*a, **k)
                ref = plain(*a, **k)
                torch.cuda.synchronize()
            err, scale, pad_ok = _rows_cols_check(name, got, ref, a, k)
            tag = (f"{name} m_valid={k.get('m_valid')} "
                   f"m={k.get('m', '')}")
            print(f"[kernels] {tag}: max_abs_err {err:.3e} "
                  f"(limit {TOL * scale:.3e}) pad_zero {pad_ok}")
            if not (err <= TOL * scale) or not pad_ok:
                raise RuntimeError(f"{tag}: kernel disagrees with its plain "
                                   f"version (err {err}, pad_zero {pad_ok})")
            worst = max(worst, err)
            with torch.no_grad():
                t_k = time_ms(lambda: kern(*a, **k))
                t_p = time_ms(lambda: plain(*a, **k))
                t_l = time_ms(library_call(name, a, k))
                t_d = kernel_device_ms(lambda: kern(*a, **k),
                                       KERNEL_FUNCS[name])
            flops, byts = work_of(name, a, k)
            t_c, t_b = flops / PEAK_F32 * 1e3, byts / PEAK_BW * 1e3
            t_ds = "not measured" if t_d is None else f"{t_d:.4f} ms"
            print(f"[kernels] {tag}: wrapper {t_k:.4f} ms, kernel device "
                  f"time {t_ds}, plain "
                  f"{t_p:.4f} ms, library {t_l:.4f} ms, bound "
                  f"{max(t_c, t_b):.4f} ms ({'bytes' if t_b > t_c else 'operations'}"
                  f"; {flops:.3e} FLOP, {byts:.3e} B)")
            ms, plain_ms, lib_ms = ms + t_k, plain_ms + t_p, lib_ms + t_l
            dev_ms = None if dev_ms is None or t_d is None else dev_ms + t_d
            bound += max(t_c, t_b)
            bound_by = "bytes" if t_b > t_c else "operations"
        rows[name] = {"name": name, "route": "cuda",
                      "source": SOURCES[name], "replaces": REPLACES[name],
                      "launches": 0, "max_abs_err": worst, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": lib_ms,
                      "kernel_device_ms": dev_ms, "cases": len(cases)}
    return rows


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
            print(f"[profile] bucket {bucket}: wall {wall_ms:.3f} ms "
                  f"(host clock, profiler on); device time not measured")
            continue
        print(f"[profile] bucket {bucket}: wall {wall_ms:.3f} ms (host "
              f"clock, profiler on), device busy {dev_ms:.3f} ms, idle "
              f"share {max(0.0, 1 - dev_ms / wall_ms):.3f}")
        for ms, n, key in sorted(rows, reverse=True)[:8]:
            print(f"[profile]   {ms:9.3f} ms  x{n:<4d} {key[:90]}")


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
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    # 3. kernels against their plain versions at main-path shapes
    calls = capture_calls(params, CONFIG, dev)
    print("[kernels] captured calls: "
          + ", ".join(f"{k} {len(v)}" for k, v in calls.items()))
    rows = check_kernels(calls)

    # 4. full-width logits
    check_logits(params, CONFIG, dev)
    plan_cache.reset(clear_entries=True)

    # 5. serving: the main path, counters zeroed just before
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
    # 6. launch counts: the whole run, then per bucket and dispatch
    print(f"[launches] {launches}; chained wrapper calls {chained_calls} "
          f"(one launch each on the TPU, one per phase here: "
          f"{launches['grouped_matmul_chained']})")
    for stage in ("warmup", "measured"):
        for b, row in sorted(m["launches"][stage].items()):
            nd = row["dispatches"]
            per = ", ".join(f"{k} {row[k] / nd:g}" for k in REPLACES)
            print(f"[launches] {stage} bucket {b}: {nd} dispatches; per "
                  f"dispatch {per}")
    measured = m["launches"]["measured"]
    if sorted(measured) != sorted(m["buckets"]):
        raise RuntimeError(f"measured stream dispatched at buckets "
                           f"{sorted(measured)}, not at every bucket of "
                           f"{m['buckets']}")
    for name in REPLACES:
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
