#!/usr/bin/env python3
"""Time the SSD chunk kernel (K14) for the port found under ``--src``, on
the calls of the full-width mamba2-370m ``impl="pallas"`` prefill.

    python3 scripts/bench_ssd.py [--src DIR]

``--src`` is the ``src`` directory of a checkout (this one by default).
Run it once per checkout, each run a fresh process, in turns (parent,
change, change, parent) in one call on the card to compare two
checkouts.  It uses only what every version of the port has: the wrapper
``ssd_chunk``, its plain version, and the set-up, capture, timing and
accounting helpers of that checkout's ``chip_smoke.py``.

The calls: the 48 K14 calls of one prefill of full-width mamba2-370m
(batch 4 x prompt 2048, 16 chunks of 128, H 32, P 64, G 1, N 128;
parameters and prompts from seed 0, as ``chip_smoke.py`` phase 6b makes
them), and layer 0 of them on its own.  After 2 s of the 48 calls (the
card's clocks up), device time first, from ``torch.profiler`` (K14's own kernel: 5 calls of layer
0, the 48 calls once each in one window); then the wrapper's time (CUDA
events around the whole call, median of 20 after 3 warm-up calls) and
the plain version's on layer 0.  Bounds: the bytes over 3.35 TB/s
against the FLOPs (``chip_smoke.work_of``) over 67 TFLOP/s of f32 on the
CUDA cores, and against three TF32 products per f32 product over 495
TFLOP/s of dense TF32 (3xTF32 on the tensor cores).  Then the prefill
end to end, ``impl="pallas"`` against ``impl="xla"`` (plain torch): host
clock (to a synchronize, median of 5 after one warm-up) and device busy
time (every kernel's device time in one profiled prefill), with K14's
share of the pallas one.

    python3 scripts/bench_ssd.py --variants

builds K14's source of the checkout as it is and with each edit of
``bench_flash.VARIANTS`` applied to the 3xTF32 helpers it includes
(``csrc/mma_tf32.cuh``), each into a library of its own with ``nvcc``.
It holds each against ``ssd_chunk_ref`` at ``chip_smoke.SSD_SHAPES``
(the inputs ``chip_smoke.py`` makes) and at the 48 captured calls,
y_diag, states and cum each on its own, printing its error as a share of
the card's two K14 limits, ``TOL`` and ``SSD_TOL`` (times max|ref|), and
times each on layer 0 (CUDA events around the C entry, median of 20, in
two rounds).  It times, on layer 0 and on the 48 calls, each edit of
``ABLATIONS``, which leaves a part of the work out (timing only: where
the time goes), and the source as it is at each number of heads a CTA
(the divisors of H / G up to 8), to set against ``ssd_launch``'s
choice.  It exits 1 if an edit does not
apply or a build fails, if the source as it is misses ``SSD_TOL``
anywhere, or if a variant of ``LESS_PRECISE`` (one or both of the small
parts' products dropped) stays within it everywhere: the check must tell
3xTF32 from them.  It needs a CUDA device and exits 2 without one.
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import bench_flash  # noqa: E402  (its variant builds and chip_smoke loader)

REPS, WARM, PROF = 20, 3, 5
WARM_SECONDS = 2.0
HOST_REPS = 5
# edits of csrc/ssd_chunk.cu that leave a part of the work out, timed
# only (their outputs are wrong): where a call's time goes
ABLATIONS = {
    "no y_diag product": [("    if (smax >= 0) {\n      float acc[NPT][4];",
                           "    if (smax >= 0 && p.L < 0) {\n"
                           "      float acc[NPT][4];")],
    "no state product": [("    for (int m = warp; m < mts; m += NW) {",
                          "    for (int m = warp; m < mts && p.L < 0; "
                          "m += NW) {")],
    "no y_diag or state": [
        ("    if (smax >= 0) {\n      float acc[NPT][4];",
         "    if (smax >= 0 && p.L < 0) {\n      float acc[NPT][4];"),
        ("    for (int m = warp; m < mts; m += NW) {",
         "    for (int m = warp; m < mts && p.L < 0; m += NW) {")],
    "no stores": [("    if (r >= rows) continue;",
                   "    if (r >= rows || rows > 0) continue;")],
}


def capture(cs, dev):
    """(config, parameters, prompts, the 48 captured (args, kwargs))."""
    cfg, params, tokens = cs.ssm_setup(dev)
    calls = [(a, k) for _, a, k in cs.capture_ssd_calls(
        params, cfg, tokens, dev)["ssd_chunked"]]
    return cfg, params, tokens, calls


def bounds(cs, cases):
    """(f32 CUDA-core, 3xTF32 tensor-core, bytes) bounds in ms, summed."""
    f32 = tf32 = byts = 0.0
    for a, k in cases:
        flops, b = cs.work_of("ssd_chunked", a, k)
        f32 += flops / cs.PEAK_F32 * 1e3
        tf32 += 3 * flops / cs.PEAK_TF32 * 1e3
        byts += b / cs.PEAK_BW * 1e3
    return f32, tf32, byts


def warm_up(fn, seconds=WARM_SECONDS):
    """Run ``fn`` for ``seconds`` of host clock, so that the card's
    clocks have risen before anything is timed."""
    import torch
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()


def _run(fn, cases):
    def go():
        for a, k in cases:
            fn(*a, **k)
    return go


def prefill_times(cs, cfg, params, tokens, dev):
    """Host clock and device busy ms of one prefill, pallas and plain,
    and K14's device ms in the pallas one."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cache = transformer.init_cache(cfg, cs.SSM_BATCH, cs.SSM_PROMPT
                                   + cs.SSM_GEN, device=dev)
    for impl in ("pallas", "xla"):
        step = steps.make_prefill_step(cfg, impl=impl)

        def go():
            step(params, tokens, cache)
        busy = cs.kernel_device_ms(go, "", 1)
        k14 = cs.kernel_device_ms(go, cs.KERNEL_FUNCS["ssd_chunked"], 1) \
            if impl == "pallas" else None
        go()
        torch.cuda.synchronize()
        wall = []
        for _ in range(HOST_REPS):
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        note = "" if k14 is None else \
            f", K14 {k14:.4f} ms ({k14 / busy:.3f} of busy)"
        print(f"[bench] prefill impl={impl}: host clock "
              f"{statistics.median(wall):.3f} ms (median of {HOST_REPS}; "
              f"{min(wall):.3f}-{max(wall):.3f}), device busy "
              f"{math.nan if busy is None else busy:.3f} ms{note}")


def run_timing(cs, src: Path) -> int:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd as kssd
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] src {src.resolve()} ({kssd.__file__})")
    print(f"[bench] {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    build.lib()
    print(f"[bench] build {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    cfg, params, tokens, calls = capture(cs, dev)
    groups = {"layer 0": calls[:1], f"all {len(calls)}": calls}
    func = cs.KERNEL_FUNCS["ssd_chunked"]
    with torch.no_grad():
        warm_up(_run(kssd.ssd_chunk, calls))
        device = {tag: cs.kernel_device_ms(_run(kssd.ssd_chunk, cases),
                                           func, PROF if len(cases) == 1
                                           else 1)
                  for tag, cases in groups.items()}
        for tag, cases in groups.items():
            t_w = cs.time_ms(_run(kssd.ssd_chunk, cases), REPS, WARM)
            t_p = cs.time_ms(_run(kssd.ssd_chunk_ref, cases), REPS, WARM) \
                if len(cases) == 1 else None
            t_d = device[tag]
            f32, tf32, byts = bounds(cs, cases)
            a, k = cases[0]
            plain = "" if t_p is None else f", plain {t_p:.4f} ms"
            print(f"[bench] {tag}: {len(cases)} calls of "
                  f"{cs.describe('ssd_chunked', a, k)}: wrapper {t_w:.4f} "
                  f"ms, device {math.nan if t_d is None else t_d:.4f} ms"
                  f"{plain}, bound 3xTF32 {max(tf32, byts):.4f} ms "
                  f"(operations {tf32:.4f}, bytes {byts:.4f}), f32 "
                  f"{max(f32, byts):.4f} ms (operations {f32:.4f})")
        prefill_times(cs, cfg, params, tokens, dev)
    return 0


def _launch(fn, args, hb, out, stream):
    """One launch of a variant's C entry ``rt_ssd_chunk`` with ``hb``
    heads a CTA, into ``out`` (y, st, cum)."""
    from repro_torch.kernels import build
    x, a, b, c = args
    bsz, nc, l, h, p = x.shape
    rc = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            *(t.data_ptr() for t in out), bsz * nc, l, h, p, b.shape[3],
            b.shape[4], hb, stream)
    build.check(rc, "rt_ssd_chunk")


def _outs(args):
    import torch
    x, _, b, _ = args
    bsz, nc, l, h, p = x.shape
    return (torch.empty_like(x),
            torch.empty((bsz, nc, h, b.shape[4], p), device=x.device),
            torch.empty((bsz, nc, l, h), device=x.device))


def run_variants(cs) -> int:
    """K14's source as it is and with each edit of ``VARIANTS``, held to
    ``TOL`` and ``SSD_TOL`` at ``SSD_SHAPES`` and the captured calls and
    timed on layer 0; then the source as it is at each heads-a-CTA
    count.  Returns 1 if the source as it is misses ``SSD_TOL`` or a
    ``LESS_PRECISE`` variant meets it everywhere, else 0."""
    import torch
    from repro_torch.kernels import runtime
    from repro_torch.kernels import ssd as kssd
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = bench_flash.build_variants("ssd_chunk.cu", "rt_ssd_chunk",
                                     ABLATIONS)
    ablated = {n: fns.pop(n) for n in ABLATIONS}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = runtime.sm_count(dev)
    worst = dict.fromkeys(fns, 0.0)   # err / SSD_TOL's limit, the most

    def heads(args):
        x, _, b, _ = args
        return kssd.ssd_launch(*x.shape, b.shape[3], b.shape[4], sms)["hb"]

    def held(name, out, ref) -> str:
        msg = []
        for lab, o, r in zip(("y_diag", "states", "cum"), out, ref):
            err, top = float((o - r).abs().max()), float(r.abs().max())
            share = err / (cs.SSD_TOL * top + cs.FLOOR)
            worst[name] = max(worst[name], share)
            msg.append(f"{lab} {err / (cs.TOL * top + cs.FLOOR):.3e} of "
                       f"TOL, {share:.3e} of SSD_TOL")
        return "; ".join(msg)

    cases = [(f"case {s}", cs.ssd_case_inputs(s, dev))
             for s in cs.SSD_SHAPES]
    _, _, _, calls = capture(cs, dev)
    cases += [(f"layer {i}", a) for i, (a, _) in enumerate(calls)]
    with torch.no_grad():
        for tag, args in cases:
            ref = kssd.ssd_chunk_ref(*args)
            out = _outs(args)
            for name, fn in fns.items():
                _launch(fn, args, heads(args), out, stream)
                torch.cuda.synchronize()
                print(f"[variants] {tag} {name}: {held(name, out, ref)}")
            del ref, out
        args = calls[0][0]
        out = _outs(args)
        for rnd in range(2):
            for name, fn in fns.items():
                ms = cs.time_ms(lambda: _launch(fn, args, heads(args), out,
                                                stream), REPS, WARM)
                print(f"[variants] layer 0 round {rnd} {name}: {ms:.4f} ms")
        groups = (("layer 0", calls[:1]), (f"all {len(calls)}", calls))

        def time_group(fn, group, hb=None):
            outs = [_outs(a) for a, _ in group]

            def go():
                for (a, _), o in zip(group, outs):
                    _launch(fn, a, hb or heads(a), o, stream)
            return cs.time_ms(go, REPS if len(group) == 1 else 5, WARM)
        for name, fn in ablated.items():
            for tag, group in groups:
                print(f"[ablate] {tag} {name}: "
                      f"{time_group(fn, group):.4f} ms")
        x, _, b, _ = args
        ctas = x.shape[0] * x.shape[1] * x.shape[3]
        for hb in (d for d in range(1, kssd.SSD_HEADS_MAX + 1)
                   if (x.shape[3] // b.shape[3]) % d == 0):
            mark = ", ssd_launch" if hb == heads(args) else ""
            for tag, group in groups:
                print(f"[heads] {tag}: {hb} heads a CTA ({ctas // hb} "
                      f"CTAs{mark}): "
                      f"{time_group(fns['as is'], group, hb):.4f} ms")
    for name, w in worst.items():
        print(f"[variants] {name}: worst error {w:.3e} of SSD_TOL's limit, "
              f"{'within' if w <= 1 else 'outside'} it")
    missed = [n for n in bench_flash.LESS_PRECISE if worst[n] <= 1]
    if worst["as is"] > 1 or missed:
        print(f"[variants] SSD_TOL does not tell 3xTF32 from "
              f"{missed or 'itself'}", file=sys.stderr)
        return 1
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    cs = bench_flash.load_chip_smoke(Path(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_ssd: no CUDA device", file=sys.stderr)
        return 2
    if args.variants:
        print(f"[bench] {cs.card_line()}")
        return run_variants(cs)
    return run_timing(cs, Path(args.src))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
