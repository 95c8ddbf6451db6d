#!/usr/bin/env python3
"""Time the grouped backward-weight kernel (K7) and the fused pair's
kernel (K10) for the port found under ``--src``.

    python3 scripts/bench_fused_dw.py [--src DIR] [--variant ROWS_FLOOR ...]

``--src`` is the ``src`` directory of a checkout (this one by default),
so one call on the card can time two checkouts in turns (parent,
change, change, parent) on the same card.  It uses only what every
version of the port has: the wrappers ``grouped_matmul_dw``,
``grouped_matmul_bwd``, ``fused_gemm_reduce`` and ``matmul``, and the
capture, plan, timing and accounting helpers of that checkout's
``chip_smoke.py``.

The calls, each group's sums printed apart: K7 on the dw and db of the
18 K5 calls of a full-width GoogLeNet training step (batch 8; the K5
calls' own inputs, as ``chip_smoke.py`` phase 3b hands them to
``ops.grouped_matmul_dw``); K10 on the fused pair of the reference's
benchmark (a 2048^3 GEMM beside a 65536 x 128 silu-sum), on the one-tile
GEMM beside a 5000 x 1024 z, and on ``FUSED_CASES``.  Per call: the
wrapper's time (CUDA events around the whole call, median of 20 after 3
warm-up calls), the kernel's own device time and that of every kernel
the call runs (``torch.profiler`` over 5 calls: a wrapper that sums a
workspace after its kernel runs a second one), one torch library call on
the same inputs (``torch.matmul`` per branch with the db sum; the GEMM,
then the silu-sum) and the bound (FLOPs over 67 TFLOP/s or bytes over
3.35 TB/s, each input read once and each output written once).  Beside
the pair and the one-tile case, K4 ``mxu128`` on their GEMMs alone (the
yardstick: K10's c is K4's), and the fused plan on K10 against the
serial plan on K4 (``mxu128`` and ``large_tile``, then the silu-sum),
device time of every kernel of a call, in turns.  Each ``--variant``
(a checkout whose ``kernels/fused_branches.py`` has
``FUSED_ROWS_FLOOR``) times K10's calls again with that floor of z rows
a CTA.  Inputs are seeded; TF32 is off.  It needs a CUDA device and
exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import math
import statistics
import sys
from pathlib import Path


def load_chip_smoke(src: Path):
    """The checkout's ``chip_smoke.py`` as a module (it puts the
    checkout's ``src`` first on ``sys.path``)."""
    path = src.resolve().parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_bench_chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def capture(cs, dev):
    """{group: [(wrapper name, args, kwargs)]}."""
    import torch
    from repro_torch.configs.googlenet import CONFIG
    from repro_torch.models import cnn
    params = cnn.init_params(CONFIG, torch.Generator().manual_seed(0), dev)
    k5 = cs.capture_train_calls(params, CONFIG, dev)["grouped_matmul_bwd"]
    out = {"K7 step": [
        ("grouped_matmul_dw",
         (a[0], a[2], a[3] if len(a) > 3 else kw.get("mask")), {})
        for a, kw in k5]}
    del params
    g = torch.Generator().manual_seed(cs.ZOO_SEED)

    def case(m, k, n, r, c):
        return ("fused_gemm_reduce", tuple(
            torch.randn(sh, generator=g).to(dev)
            for sh in ((m, k), (k, n), (r, c))), {})
    out["K10 pair"] = [case(*cs.FUSED_PAIR)]
    one_tile = (64, 1000, 64, 5000, 1024)
    out["K10 one-tile"] = [case(*one_tile)]
    out["K10 cases"] = [case(*c) for c in cs.FUSED_CASES if c != one_tile]
    return out


_WRAPPERS = {}


def call(name, a, k):
    return _WRAPPERS[name](*a, **k)


def time_group(cs, tag, cases, verbose=True):
    """Per call and summed: wrapper ms, kernel device ms, every kernel of
    the call's device ms, library ms, bound ms."""
    import torch
    sums = [0.0] * 5
    for name, a, k in cases:
        with torch.no_grad():
            t_w = cs.time_ms(lambda: call(name, a, k))
            t_d = cs.kernel_device_ms(lambda: call(name, a, k),
                                      cs.KERNEL_FUNCS[name], 5)
            t_a = cs.kernel_device_ms(lambda: call(name, a, k), "", 5)
            t_l = cs.time_ms(cs.library_call(name, a, k))
        flops, byts = cs.work_of(name, a, k)
        bound = max(flops / cs.PEAK_F32, byts / cs.PEAK_BW) * 1e3
        t_d = math.nan if t_d is None else t_d
        t_a = math.nan if t_a is None else t_a
        for i, v in enumerate((t_w, t_d, t_a, t_l, bound)):
            sums[i] += v
        if verbose:
            print(f"[bench] {tag} {cs.describe(name, a, k)}: wrapper "
                  f"{t_w:.4f} ms, device {t_d:.4f} ms, all kernels "
                  f"{t_a:.4f} ms, library {t_l:.4f} ms, bound "
                  f"{bound:.4f} ms")
    print(f"[bench] {tag}: {len(cases)} calls, sums: wrapper {sums[0]:.4f} "
          f"ms, device {sums[1]:.4f} ms, all kernels {sums[2]:.4f} ms, "
          f"library {sums[3]:.4f} ms, bound {sums[4]:.4f} ms")
    return sums


def plans_in_turns(cs, dev):
    """The fused pair's fused plan (K10) against its serial plans on K4,
    device time of every kernel of a call, in turns."""
    import torch
    from repro_torch.core import plan as cp
    m, k, n, r, c = cs.FUSED_PAIR
    g = torch.Generator().manual_seed(cs.ZOO_SEED)
    x = (torch.randn((m, k), generator=g) * 0.05).to(dev)
    w = (torch.randn((k, n), generator=g) * 0.05).to(dev)
    z = torch.randn((r, c), generator=g).to(dev)
    plans = cs._pair_plans()
    impls = cs._pair_impls(w)
    order = ["fused", "serial mxu128", "serial large_tile"]
    dev_ms = {nm: [] for nm in order}
    with torch.no_grad():
        for nm in order + order[::-1] + order:
            t_d = cs.kernel_device_ms(
                lambda p=plans[nm]: cp.run_plan(impls, {"xin": x, "zin": z},
                                                p), "", 5)
            dev_ms[nm].append(math.nan if t_d is None else t_d)
    print("[bench] fused pair plans, device time a call (every kernel, in "
          "turns): " + ", ".join(
              f"{nm} {' / '.join(f'{t:.4f}' for t in v)} ms (mean "
              f"{statistics.fmean(v):.4f})" for nm, v in dev_ms.items()))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--variant", type=int, action="append", default=[],
                    metavar="ROWS_FLOOR")
    args = ap.parse_args(argv)
    cs = load_chip_smoke(Path(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_fused_dw: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_branches as kf
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] src {Path(args.src).resolve()} ({kf.__file__})")
    print(f"[bench] {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.lib()
    _WRAPPERS.update(grouped_matmul_dw=kg.grouped_matmul_dw,
                     fused_gemm_reduce=kf.fused_gemm_reduce,
                     matmul=km.matmul)
    dev = torch.device("cuda")
    groups = capture(cs, dev)
    for tag, cases in groups.items():
        time_group(cs, tag, cases)
    for tag in ("pair", "one-tile"):
        x, y, _ = groups[f"K10 {tag}"][0][1]
        time_group(cs, f"K4 mxu128 on the {tag}'s GEMM",
                   [("matmul", (x, y), {"algorithm": "mxu128"})])
    plans_in_turns(cs, dev)
    for floor in args.variant:
        kf.FUSED_ROWS_FLOOR = floor
        dev_sum = [0.0, 0.0]
        for tag, cases in groups.items():
            if tag.startswith("K10"):
                s = time_group(cs, f"variant {floor} {tag}", cases,
                               verbose=False)
                dev_sum = [dev_sum[0] + s[1], dev_sum[1] + s[0]]
        print(f"[bench] variant rows_floor {floor}: K10 device sum "
              f"{dev_sum[0]:.4f} ms, wrapper sum {dev_sum[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
