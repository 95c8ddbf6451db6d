#!/usr/bin/env python3
"""Time the flash-attention kernel (K13) for the port found under
``--src``, on the calls of the attention LMs' ``impl="pallas"``
forwards.

    python3 scripts/bench_flash.py [--src DIR]

``--src`` is the ``src`` directory of a checkout (this one by default).
Run it once per checkout, each run a fresh process, in turns (parent,
change, change, parent) in one call on the card to compare two
checkouts.  It uses only what every version of the port has: the wrapper
``flash_attention`` and the capture, timing and accounting helpers of
that checkout's ``chip_smoke.py``.

The calls: the 32 K13 calls of one full-width llama3-8b forward (batch 1
x 8192, parameters and tokens from seed 0, as ``chip_smoke.py`` phase 4b
makes them), layer 0 of them on its own, and the two calls of
gemma2-27b cut to 2 layers (the local layer, window 4096, and the global
one, both softcap 50).  Device time first, right after the capture, from
``torch.profiler`` (K13's own kernel: 5 calls a layer, the 32 llama3
calls once each in one window); then the wrapper's time (CUDA events
around the whole call, median of 10 after 2 warm-up calls), and one
library call on the same inputs (``F.scaled_dot_product_attention`` with
``enable_gqa`` on heads-first copies, TF32 off; none with a softcap).
Bounds: the bytes over 3.35 TB/s against the FLOPs (4 D per visible
(query head, key) pair) over 67 TFLOP/s of f32 on the CUDA cores, and
against three TF32 products per f32 product over 495 TFLOP/s of dense
TF32 (3xTF32 on the tensor cores).

    python3 scripts/bench_flash.py --variants [--mma-rate]

builds K13's source of the checkout as it is and with each edit of
``VARIANTS`` applied to the 3xTF32 helpers it includes
(``csrc/mma_tf32.cuh``), each into a library of its own with ``nvcc``, and
times each on seeded random q, k, v at the three layer shapes (CUDA
events around the C entry, median of 7, in two rounds).  It holds each
against ``flash_attention_ref`` there and at ``chip_smoke.FLASH_CASES``
(the inputs ``chip_smoke.py`` makes), printing its error as a share of
the card's two K13 limits, ``TOL`` and ``FLASH_TOL`` (times max|ref|).
It exits 1 if an edit does not apply or a build fails, if the source as
it is misses ``FLASH_TOL`` anywhere, or if a variant of
``LESS_PRECISE`` (one or both of the small parts' products dropped)
stays within it everywhere: the check must tell 3xTF32 from them.
``--mma-rate`` measures what ``mma.sync.m16n8k8`` TF32 products alone
reach on the card (independent products, 4 to 32 warps an SM).  It
needs a CUDA device and exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib.util
import math
import sys
from pathlib import Path

PEAK_TF32 = 495e12     # H100 SXM, dense TF32 on the tensor cores (FLOP/s)
REPS, WARM, PROF = 10, 2, 5
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared")
# edits of csrc/mma_tf32.cuh, (old text, new text) each: the PTX
# cvt.rna.tf32.f32 in place of the two integer operations, the small
# part left unrounded (the mma reads its top 19 bits), one-pass TF32
# (big.big only), and each of the two small parts' products dropped
VARIANTS = {
    "ptx-cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 '  unsigned r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : '
                 '"=r"(r) : "f"(x));\n  return r;')],
    "small-unrounded": [("  small = tf32(x - __uint_as_float(big));",
                         "  small = __float_as_uint(x - __uint_as_float(big));")],
    "one-pass": [("  mma(c, a.small, bb);\n  mma(c, a.big, bs);\n", "")],
    "no small.big": [("  mma(c, a.small, bb);\n", "")],
    "no big.small": [("  mma(c, a.big, bs);\n", "")],
}
# the variants less precise than 3xTF32, which FLASH_TOL must refuse
LESS_PRECISE = ("one-pass", "no small.big", "no big.small")
# (Hkv, window, softcap) at 1 x 8192, Hq 32, D 128, causal
LAYERS = {"llama3": (8, None, None), "gemma2 local": (16, 4096, 50.0),
          "gemma2 global": (16, None, 50.0)}
MMA_RATE_CU = r"""
#include <cuda_runtime.h>
template <int ACC>
__global__ void rate(float* out, int iters) {
  float c[ACC][4] = {};
  const unsigned a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < ACC; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                     "r"(b[1]));
  float s = 0.f;
  for (int i = 0; i < ACC; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
// milliseconds of the second of two launches
extern "C" float mma_rate(int acc, int warps, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, sizeof(float) * blocks * warps * 32);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(a);
    if (acc == 4) rate<4><<<blocks, warps * 32>>>(out, iters);
    else if (acc == 8) rate<8><<<blocks, warps * 32>>>(out, iters);
    else rate<16><<<blocks, warps * 32>>>(out, iters);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
  }
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  cudaFree(out);
  return ms;
}
"""


def load_chip_smoke(src: Path):
    """The checkout's ``chip_smoke.py`` as a module (it puts the
    checkout's ``src`` first on ``sys.path``)."""
    path = src.resolve().parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_bench_chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def capture(cs, dev):
    """{group: [(args, kwargs)]}: llama3's 32 calls, its layer 0, and
    gemma2's local and global calls."""
    import torch
    out = {}
    for arch in cs.ATTN_ARCHS:
        cfg, params, batch = cs.attn_setup(arch, dev)
        calls = [(a, k) for _, a, k in cs.capture_flash_calls(
            params, cfg, batch["tokens"])["flash_attention"]]
        del params, batch
        torch.cuda.empty_cache()
        if arch == "llama3-8b":
            out["llama3 layer 0"] = calls[:1]
            out["llama3 all 32"] = calls
        else:
            for a, k in calls:
                tag = "local" if k.get("window") else "global"
                out[f"gemma2 {tag}"] = [(a, k)]
    return out


def bounds(cs, cases):
    """(f32 CUDA-core, 3xTF32 tensor-core, bytes) bounds in ms, summed."""
    f32 = tf32 = byts = 0.0
    for a, k in cases:
        flops, b = cs.work_of("flash_attention", a, k)
        f32 += flops / cs.PEAK_F32 * 1e3
        tf32 += 3 * flops / PEAK_TF32 * 1e3
        byts += b / cs.PEAK_BW * 1e3
    return f32, tf32, byts


def _nvcc(src: Path, lib: Path):
    """Start ``nvcc`` on one source into a shared library."""
    import subprocess
    from repro_torch.kernels import build
    return subprocess.Popen(
        [build._nvcc(), *build.ARCH_FLAGS, *NVCC_FLAGS, "-I", str(build.CSRC),
         "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _built(procs):
    """{name: loaded library} of the builds {name: (process, library)};
    raises if one failed."""
    import ctypes
    libs = {}
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: build failed\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def _variant_dir() -> Path:
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    return out


def _edited(text: str, edits, what: str) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{what}: its edit does not apply")
        text = text.replace(old, new)
    return text


def build_variants(source: str, entry: str, source_edits=None) -> dict:
    """{variant: the C entry ``entry``} of ``csrc/<source>`` built as it
    is ("as is"), with each edit of ``VARIANTS`` applied to
    ``csrc/mma_tf32.cuh``, and with each of ``source_edits`` ({name:
    [(old, new)]}) applied to the source: each variant's source and
    header in a directory of their own (the header found beside the
    source first), all ``nvcc`` runs started together."""
    import ctypes
    from repro_torch.kernels import build
    out = _variant_dir() / Path(source).stem
    hdr = (build.CSRC / "mma_tf32.cuh").read_text()
    src = (build.CSRC / source).read_text()
    texts = {"as is": (hdr, src)}
    for name, edits in VARIANTS.items():
        texts[name] = (_edited(hdr, edits, f"variant {name}"), src)
    for name, edits in (source_edits or {}).items():
        texts[name] = (hdr, _edited(src, edits, f"variant {name}"))
    procs = {}
    for i, (name, (h, c)) in enumerate(texts.items()):
        d = out / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "mma_tf32.cuh").write_text(h)
        (d / source).write_text(c)
        procs[name] = (_nvcc(d / source, d / "lib.so"), d / "lib.so")
    fns = {}
    for name, lib in _built(procs).items():
        fn = getattr(lib, entry)
        fn.argtypes = build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run_variants(cs) -> int:
    """K13's source as it is and with each edit of ``VARIANTS``, timed on
    seeded random inputs at ``LAYERS`` and held to ``TOL`` and
    ``FLASH_TOL`` there and at ``FLASH_CASES``.  Returns 1 if the source
    as it is misses ``FLASH_TOL`` or a ``LESS_PRECISE`` variant meets it
    everywhere, else 0."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    fns = build_variants("flash_attention.cu", "rt_flash_attention")
    stream = torch.cuda.current_stream().cuda_stream
    worst = dict.fromkeys(fns, 0.0)   # err / FLASH_TOL's limit, the most

    def launch(name, q, k, v, o, kw):
        b, sq, hq, d = q.shape
        rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), b, sq, k.shape[1], hq, k.shape[2], d,
                       int(kw["causal"]), kw["window"] or 0, d ** -0.5,
                       kw["softcap"] or 0.0, stream)
        build.check(rc, name)

    def held(name, o, ref) -> str:
        err, top = float((o - ref).abs().max()), float(ref.abs().max())
        share = err / (cs.FLASH_TOL * top + cs.FLOOR)
        worst[name] = max(worst[name], share)
        return (f"error {err / (cs.TOL * top + cs.FLOOR):.3e} of TOL, "
                f"{share:.3e} of FLASH_TOL")

    for case, q, k, v, kw in cs.flash_case_inputs(torch.device("cuda")):
        with torch.no_grad():
            ref = kfa.flash_attention_ref(q, k, v, **kw)
        o = torch.empty_like(q)
        for name in fns:
            launch(name, q, k, v, o, kw)
            torch.cuda.synchronize()
            print(f"[variants] case {case} {name}: {held(name, o, ref)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    for layer, (hkv, window, softcap) in LAYERS.items():
        q = torch.randn((1, 8192, 32, 128), device="cuda", generator=g)
        k, v = (torch.randn((1, 8192, hkv, 128), device="cuda", generator=g)
                for _ in range(2))
        kw = dict(causal=True, window=window, softcap=softcap)
        with torch.no_grad():
            ref = kfa.flash_attention_ref(q, k, v, **kw)
        o = torch.empty_like(q)
        for rnd in range(2):
            for name in fns:
                def call(name=name):
                    launch(name, q, k, v, o, kw)
                call()
                torch.cuda.synchronize()
                msg = held(name, o, ref)
                print(f"[variants] {layer} round {rnd} {name}: "
                      f"{cs.time_ms(call, 7, 1):.4f} ms, {msg}")
        del ref
    for name, w in worst.items():
        print(f"[variants] {name}: worst error {w:.3e} of FLASH_TOL's "
              f"limit, {'within' if w <= 1 else 'outside'} it")
    missed = [n for n in LESS_PRECISE if worst[n] <= 1]
    if worst["as is"] > 1 or missed:
        print(f"[variants] FLASH_TOL does not tell 3xTF32 from "
              f"{missed or 'itself'}", file=sys.stderr)
        return 1
    return 0


def run_mma_rate() -> None:
    """What independent mma.sync.m16n8k8 TF32 products reach, TFLOP/s."""
    import ctypes
    out = _variant_dir()
    (out / "mma_rate.cu").write_text(MMA_RATE_CU)
    lib = _built({"mma_rate": (_nvcc(out / "mma_rate.cu",
                                     out / "mma_rate.so"),
                               out / "mma_rate.so")})["mma_rate"]
    lib.mma_rate.restype = ctypes.c_float
    lib.mma_rate.argtypes = [ctypes.c_int] * 4
    iters = 4096
    for acc in (4, 8, 16):
        for warps, per_sm in ((4, 1), (8, 1), (8, 2), (8, 4)):
            blocks = 132 * per_sm
            ms = lib.mma_rate(acc, warps, blocks, iters)
            flops = 2 * 16 * 8 * 8 * acc * iters * warps * blocks
            print(f"[mma-rate] {acc} accumulators a warp, "
                  f"{warps * per_sm} warps an SM: "
                  f"{flops / ms / 1e9:.1f} TFLOP/s")


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--mma-rate", action="store_true")
    args = ap.parse_args(argv)
    cs = load_chip_smoke(Path(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_flash: no CUDA device", file=sys.stderr)
        return 2
    if args.variants or args.mma_rate:
        print(f"[bench] {cs.card_line()}")
        rc = run_variants(cs) if args.variants else 0
        if args.mma_rate:
            run_mma_rate()
        return rc
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[bench] src {Path(args.src).resolve()} ({kfa.__file__})")
    print(f"[bench] {cs.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.lib()
    dev = torch.device("cuda")
    groups = capture(cs, dev)
    kern = kfa.flash_attention
    func = cs.KERNEL_FUNCS["flash_attention"]

    def run(cases):
        def go():
            for a, k in cases:
                kern(*a, **k)
        return go

    with torch.no_grad():
        device = {tag: cs.kernel_device_ms(
            run(cases), func, PROF if len(cases) == 1 else 1)
            for tag, cases in groups.items()}
        for tag, cases in groups.items():
            t_w = cs.time_ms(run(cases), REPS, WARM)
            t_l = 0.0
            for a, k in cases:
                lib = cs.library_call("flash_attention", a, k)
                t_l = None if lib is None or t_l is None \
                    else t_l + cs.time_ms(lib, REPS, WARM)
                del lib
            t_d = device[tag]
            f32, tf32, byts = bounds(cs, cases)
            a, k = cases[0]
            print(f"[bench] {tag}: {len(cases)} calls of "
                  f"{cs.describe('flash_attention', a, k)}: wrapper "
                  f"{t_w:.4f} ms, device "
                  f"{math.nan if t_d is None else t_d:.4f} ms, library "
                  f"{'none' if t_l is None else f'{t_l:.4f} ms'}, bound "
                  f"f32 {f32:.4f} ms, 3xTF32 {tf32:.4f} ms, bytes "
                  f"{byts:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
