#!/usr/bin/env python3
"""Time the split-K GEMM (K8), the expert MLP forward (K11) and its
backward (K12) for the port found under ``--src``.

    python3 scripts/bench_ksplit_experts.py [--src DIR] [--kernels K8 K11 K12]

``--src`` is the ``src`` directory of a checkout (this one by default),
so one call on the card can time two checkouts in turns (parent,
change, change, parent) on the same card.  It uses only what every
version of the port has: the wrappers ``matmul_ksplit``, ``matmul`` and
``grouped_matmul_experts`` and ``grouped_matmul_experts_bwd``, and the
capture, timing and accounting helpers of that checkout's
``chip_smoke.py``.

The calls, each group's sums printed apart: K8 on the GEMM zoo's
512 x 1024 x 512 and on the 6 K4 calls of a full-width GoogLeNet
training step (batch 8; their own operands, transposed views among
them, as ``chip_smoke.py`` phase 3b hands them to K8), K4 ``mxu128`` on
the same 6 (the yardstick: K8 runs K4's CTAs on each split's slice),
and K11 and K12 each on layer 0 and on all 24 calls of a full-width
granite-moe-1b-a400m training step (batch 4 x seq 512).  Per call: the
wrapper's time (CUDA events around the whole call, median of 20 after 3
warm-up calls), the kernel's own device time and that of every kernel
the call runs (``torch.profiler`` over 5 calls; for K11 and K12 also
each of the call's two launches), one torch library call
on the same inputs (``torch.matmul``; the einsum engine's cuBLAS GEMMs
on the same routing for K11 and K12) and the bound (FLOPs over 67
TFLOP/s or bytes over 3.35 TB/s, each input read once and each output
written once).  Inputs are seeded; TF32 is off.  It needs a CUDA device and
exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import math
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


def capture(cs, dev, kernels):
    """{group: [(wrapper name, args, kwargs)]} of the groups of
    ``kernels`` (K8 with K4 ``mxu128``, K11, K12)."""
    import torch
    out = {}
    if "K8" in kernels:
        from repro_torch.configs.googlenet import CONFIG
        from repro_torch.models import cnn
        params = cnn.init_params(CONFIG, torch.Generator().manual_seed(0),
                                 dev)
        k4 = cs.capture_train_calls(params, CONFIG, dev)["matmul"]
        del params
        m, k, n = cs.ZOO_GEMM
        g = torch.Generator().manual_seed(cs.ZOO_SEED)
        zoo = (torch.randn((m, k), generator=g).to(dev),
               torch.randn((k, n), generator=g).to(dev))
        out = {"K8 zoo": [("matmul_ksplit", zoo, {})],
               "K8 step": [("matmul_ksplit", a[:2], {}) for a, _ in k4],
               "K4 mxu128 step": [("matmul", a[:2], {"algorithm": "mxu128"})
                                  for a, _ in k4]}
    if "K11" not in kernels and "K12" not in kernels:
        return out
    cfg, lm_params = cs.lm_setup(dev)
    moe = cs.capture_moe_calls(lm_params, cfg, dev)
    del lm_params
    torch.cuda.empty_cache()
    for tag, name in (("K11", "grouped_matmul_experts"),
                      ("K12", "grouped_matmul_experts_bwd")):
        if tag not in kernels:
            continue
        calls = [(name, a, k) for _, a, k in moe[name]]
        # the backward's calls run from the last layer to the first
        out[f"{tag} layer 0"] = [calls[0 if tag == "K11" else -1]]
        out[f"{tag} step"] = calls
    return out


_WRAPPERS = {}


def call(name, a, k):
    return _WRAPPERS[name](*a, **k)


# the two launches of K11 and of K12, by their CUDA functions' names (the
# same in every version of the port since K11's redesign)
STAGES = {"grouped_matmul_experts": ("moe_fwd_in", "moe_fwd_out"),
          "grouped_matmul_experts_bwd": ("experts_dh", "experts_dxw")}


def time_group(cs, tag, cases):
    """Per call and summed: wrapper ms, kernel device ms, every kernel of
    the call's device ms, library ms, bound ms; for K11 and K12 also
    each launch's device ms."""
    import torch
    sums = [0.0] * 5
    stage_sums: dict = {}
    for name, a, k in cases:
        with torch.no_grad():
            t_w = cs.time_ms(lambda: call(name, a, k))
            t_d = cs.kernel_device_ms(lambda: call(name, a, k),
                                      cs.KERNEL_FUNCS[name], 5)
            t_a = cs.kernel_device_ms(lambda: call(name, a, k), "", 5)
            t_l = cs.time_ms(cs.library_call(name, a, k))
            for func in STAGES.get(name, ()):
                t_s = cs.kernel_device_ms(lambda: call(name, a, k), func, 5)
                stage_sums[func] = stage_sums.get(func, 0.0) \
                    + (math.nan if t_s is None else t_s)
        flops, byts = cs.work_of(name, a, k)
        bound = max(flops / cs.PEAK_F32, byts / cs.PEAK_BW) * 1e3
        t_d = math.nan if t_d is None else t_d
        t_a = math.nan if t_a is None else t_a
        for i, v in enumerate((t_w, t_d, t_a, t_l, bound)):
            sums[i] += v
        print(f"[bench] {tag} {cs.describe(name, a, k)}: wrapper "
              f"{t_w:.4f} ms, device {t_d:.4f} ms, all kernels "
              f"{t_a:.4f} ms, library {t_l:.4f} ms, bound {bound:.4f} ms")
    stages = "".join(f", {func} {v:.4f} ms" for func, v in stage_sums.items())
    print(f"[bench] {tag}: {len(cases)} calls, sums: wrapper {sums[0]:.4f} "
          f"ms, device {sums[1]:.4f} ms, all kernels {sums[2]:.4f} ms, "
          f"library {sums[3]:.4f} ms, bound {sums[4]:.4f} ms{stages}")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--kernels", nargs="+", default=["K8", "K11", "K12"],
                    choices=["K8", "K11", "K12"],
                    help="the kernels to time (K8 brings K4 mxu128)")
    args = ap.parse_args(argv)
    cs = load_chip_smoke(Path(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_ksplit_experts: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as kg
    from repro_torch.kernels import matmul as km
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] src {Path(args.src).resolve()} ({km.__file__})")
    print(f"[bench] {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.lib()
    _WRAPPERS.update(matmul_ksplit=km.matmul_ksplit, matmul=km.matmul,
                     grouped_matmul_experts=kg.grouped_matmul_experts,
                     grouped_matmul_experts_bwd=kg.grouped_matmul_experts_bwd)
    dev = torch.device("cuda")
    groups = capture(cs, dev, set(args.kernels))
    for tag, cases in groups.items():
        time_group(cs, tag, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
