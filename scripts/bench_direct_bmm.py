#!/usr/bin/env python3
"""Time the direct conv (K3) and the stacked GEMMs (K9) on the calls a
full-width GoogLeNet makes, for the port found under ``--src``.

    python3 scripts/bench_direct_bmm.py [--src DIR] [--profile]
        [--variant MIN_DEPTH SPLIT_CTAS ...]

``--src`` is the ``src`` directory of a checkout (this one by default),
so one call on the card can time two checkouts in turns (parent,
change, change, parent) on the same card.  It uses only what every
version of the port has: the wrappers ``conv2d_direct``,
``branch_matmul`` and ``matmul``, ``ops.conv2d``, and the capture,
timing and accounting helpers of that checkout's ``chip_smoke.py``.

The calls, each group's sums printed apart: K3 on bucket-1 serving's two
convs (inc8 3x3 and 5x5, one planned forward), on the concurrent
training step's stem1 and stem2 (batch 8), and on all 51 convs of a
serial-plan training step; K9 on the 9 calls of a stacked-plan training
step (per role: forward, dx, dW) and on Winograd's call for paper Table
1's inception-3a 3x3 conv (batch 4, 28 x 28, 96 -> 128).  Per call: the
wrapper's time (CUDA events around the whole call, median of 20 after 3
warm-up calls), the kernel's own device time (``torch.profiler`` over 5
calls), one torch library call on the same inputs (``F.conv2d``,
``torch.bmm``) and the bound (FLOPs over 67 TFLOP/s or bytes over 3.35
TB/s, each input read once and each output written once).  Then a
SHA-256 over the outputs of the serial step's 119 K4 calls on seeded
inputs at their captured shapes, strides and offsets, so that two
checkouts' K4 results can be compared bit for bit.  Each ``--variant``
(a checkout whose ``kernels/conv2d.py`` has ``DIRECT_SPLIT_MIN_DEPTH``
and ``DIRECT_SPLIT_CTAS``) times K3's calls again under that split depth
floor and split rule.  ``--profile`` also profiles one warm serial and
one warm stacked training step (host wall, device busy time, idle
share).  Weights are random (seed 0), images from seed 1 (serving) and
the training phase's seed; TF32 is off.  It needs a CUDA device and
exits 2 without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
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


def capture(cs, params, cfg, dev):
    """{group: [(wrapper name, args, kwargs)]} and the serial step's K4
    calls."""
    import torch
    from repro_torch.data import SyntheticImages
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul as km
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import cnn
    out = {}
    serve = cs.capture_calls(params, cfg, dev, buckets=(1,))
    out["K3 serve b1"] = [("conv2d_direct",) + c
                          for c in serve["conv2d_direct"]]
    train = cs.capture_train_calls(params, cfg, dev)
    out["K3 train stem"] = [("conv2d_direct",) + c
                            for c in train["conv2d_direct"]]
    del serve, train
    plan, _ = cnn.plan_cnn(cfg, cs.TRAIN_BATCH, train=True,
                           **cs.BASELINES["serial"][0])
    batch = SyntheticImages(cfg.img, cfg.num_classes, cs.TRAIN_BATCH,
                            seed=cs.TRAIN_SEED).batch_at(0)
    with cs.recording([(kc, "conv2d_direct"), (km, "matmul")]) as calls:
        steps.cnn_loss_and_grads(params, cfg,
                                 steps.to_device_batch(batch, dev),
                                 plan=plan)
    out["K3 serial"] = [("conv2d_direct",) + c
                        for c in calls["conv2d_direct"]]
    k4 = calls["matmul"]
    for path, a, k in cs.capture_stacked_calls(
            params, cfg, dev)["branch_matmul"]:
        out.setdefault(f"K9 {path}", []).append(("branch_matmul", a, k))
    nb, h, wd, cin, kh, cout = cs.ZOO_CONVS[0]
    g = torch.Generator().manual_seed(cs.ZOO_SEED + kh)
    xc = torch.randn((nb, h, wd, cin), generator=g).to(dev)
    wc = (0.1 * torch.randn((kh, kh, cin, cout), generator=g)).to(dev)
    with torch.no_grad(), cs.recording([(kb, "branch_matmul")]) as calls:
        ops.conv2d(xc, wc, algorithm="winograd3x3")
    out["K9 zoo winograd"] = [("branch_matmul",) + c
                              for c in calls["branch_matmul"]]
    return out, k4


def time_group(cs, tag, cases, verbose=True):
    """Per call and summed: wrapper ms, kernel device ms, library ms,
    bound ms."""
    import torch
    sums = [0.0, 0.0, 0.0, 0.0]
    for name, a, k in cases:
        with torch.no_grad():
            t_w = cs.time_ms(lambda: cs_call(name, a, k))
            t_d = cs.kernel_device_ms(lambda: cs_call(name, a, k),
                                      cs.KERNEL_FUNCS[name], 5)
            lib = cs.library_call(name, a, k)
            t_l = cs.time_ms(lib)
        flops, byts = cs.work_of(name, a, k)
        bound = max(flops / cs.PEAK_F32, byts / cs.PEAK_BW) * 1e3
        t_d = float("nan") if t_d is None else t_d
        for i, v in enumerate((t_w, t_d, t_l, bound)):
            sums[i] += v
        if verbose:
            print(f"[bench] {tag} {cs.describe(name, a, k)}: wrapper "
                  f"{t_w:.4f} ms, device {t_d:.4f} ms, library {t_l:.4f} "
                  f"ms, bound {bound:.4f} ms")
    print(f"[bench] {tag}: {len(cases)} calls, sums: wrapper {sums[0]:.4f} "
          f"ms, device {sums[1]:.4f} ms, library {sums[2]:.4f} ms, bound "
          f"{sums[3]:.4f} ms")
    return sums


def k4_digest(calls, matmul) -> str:
    """SHA-256 over K4's outputs at the captured calls, each operand's
    storage first refilled from one seeded generator in call order: the
    captured values depend on the checkout's other kernels (K3 runs the
    serial forward), the shapes, strides and offsets do not."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    filled = set()
    h = hashlib.sha256()
    with torch.no_grad():
        for a, k in calls:
            for t in a:
                st = t.untyped_storage()
                if st.data_ptr() in filled:
                    continue
                filled.add(st.data_ptr())
                flat = torch.empty(0, dtype=t.dtype, device=t.device).set_(st)
                flat.copy_(torch.randn(flat.shape, generator=gen,
                                       device=t.device))
        for a, k in calls:
            h.update(matmul(*a, **k).cpu().numpy().tobytes())
    return h.hexdigest()


_WRAPPERS = {}


def cs_call(name, a, k):
    return _WRAPPERS[name](*a, **k)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--variant", nargs=2, type=int, action="append",
                    default=[], metavar=("MIN_DEPTH", "SPLIT_CTAS"))
    args = ap.parse_args(argv)
    cs = load_chip_smoke(Path(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_direct_bmm: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.googlenet import CONFIG
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import build
    from repro_torch.kernels import conv2d as kc
    from repro_torch.kernels import matmul as km
    from repro_torch.models import cnn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] src {Path(args.src).resolve()} ({kc.__file__})")
    print(f"[bench] {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.lib()
    _WRAPPERS.update(conv2d_direct=kc.conv2d_direct,
                     branch_matmul=kb.branch_matmul)
    dev = torch.device("cuda")
    params = cnn.init_params(CONFIG, torch.Generator().manual_seed(0), dev)
    groups, k4 = capture(cs, params, CONFIG, dev)
    totals = {}
    for tag, cases in groups.items():
        totals[tag] = time_group(cs, tag, cases)
    k9 = [v for t, v in totals.items() if t.startswith("K9 stacked")]
    print(f"[bench] K9 stacked step: 9 calls, sums: wrapper "
          f"{sum(v[0] for v in k9):.4f} ms, device "
          f"{sum(v[1] for v in k9):.4f} ms, library "
          f"{sum(v[2] for v in k9):.4f} ms, bound "
          f"{sum(v[3] for v in k9):.4f} ms")
    print(f"[bench] K4 serial step: {len(k4)} calls, outputs sha256 "
          f"{k4_digest(k4, km.matmul)}")
    kept = (getattr(kc, "DIRECT_SPLIT_MIN_DEPTH", None),
            getattr(kc, "DIRECT_SPLIT_CTAS", None))
    for min_depth, split_ctas in args.variant:
        kc.DIRECT_SPLIT_MIN_DEPTH, kc.DIRECT_SPLIT_CTAS = min_depth, \
            split_ctas
        dev_sum = 0.0
        for tag, cases in groups.items():
            if tag.startswith("K3"):
                dev_sum += time_group(
                    cs, f"variant {min_depth} {split_ctas} {tag}", cases,
                    verbose=False)[1]
        print(f"[bench] variant min_depth {min_depth} split_ctas "
              f"{split_ctas}: K3 device sum {dev_sum:.4f} ms")
    if args.variant:
        kc.DIRECT_SPLIT_MIN_DEPTH, kc.DIRECT_SPLIT_CTAS = kept
    del groups, k4, params
    torch.cuda.empty_cache()
    if args.profile:
        for name in cs.BASELINES:
            cs.profile_train_step(CONFIG, dev, name)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
