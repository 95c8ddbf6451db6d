"""The port's kernels on the card: the serial and the stacked baseline
plans launch their kernels (K3/K4, and K9 for the stacked groups)
through ``run_plan`` and agree with the plain forward; the SSD chunk
kernel (K14) agrees with its plain version on ragged and grouped shapes,
and the reduced mamba2 prefill with ``impl="pallas"`` launches it once
per layer and agrees with ``impl="xla"``; the flash-attention kernel
(K13) agrees with its plain version at the reference's kernel-test
cases, and the reduced llama3-8b and gemma2-27b forwards with
``impl="pallas"`` launch it once per layer and agree with
``impl="xla"``; the fused pair's kernel (K10), the split-K GEMM (K8)
and the grouped backward-weight kernel (K7) agree with their plain
versions, K10's c bit for bit with K4 ``mxu128``'s and K7's dw and db
with K5's (each the same CTAs on the same engine), both repeating bit
for bit, a fused plan runs as exactly one K10 launch, and a Winograd
conv as one K9 launch; K4 and K5 on the
pipelined engine agree with their plain versions, split over their long
contraction or not, on ragged shapes, both operand layouts and
unaligned operands, and two calls on the same inputs are bitwise equal;
so do K1 and K2 on the same engine at the training step's and serve
bucket 1's shapes, split and not, dense and ragged, K2's pooled taps
read in place as strided views (stride 1 and 2) or as contiguous
copies, a NaN tap among them, K1 with holes between its branches; K6
runs a whole chain in one launch, within TOL of its plain version and
bitwise repeatable, on rings of 5x5 and 3x3 taps, a previous chain's
panel with and without its blocks' true widths, stem0's K = 147 im2col,
ragged rows, a NaN lhs element and a chain of more items than one wave
of CTAs; K3 and K9 on the same engine agree with their plain versions
and repeat bit for bit, K3 at ``chip_smoke.DIRECT_CASES`` (split and
not, 16-byte and 4-byte copies), K9 at ``chip_smoke.BMM_CASES`` in all
four operand layouts (a split dW among them), and K9 at one branch
equals K4 bit for bit on K4's cases (the same engine, tile and split);
K8 on the same engine runs in one launch, repeats bit for bit, and each
slice ws[s] of its workspace equals K4 ``mxu128`` on that split's
operands at K8's inner split bit for bit (the same CTAs); K11 on the
same engine runs two CUDA launches a call, agrees with its plain version
with ``train=True`` at reduced widths and at granite's layer 0, gated
and not, stores exact zeros past each block's valid rows and repeats bit
for bit; K12, its backward, on the same engine runs two CUDA launches a
call with the grids of ``experts_bwd_launch``, agrees with its plain
version at K11's cases and at D and F not multiples of 4, reads nothing
past a block's valid rows, stores dX 0 there and a zero-token expert's
dW 0, and repeats bit for bit.

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a host
without them; there, skip ``tests/conftest.py`` (it imports JAX):

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card.py

Tolerance: logits within rtol 1e-3, atol 1e-5 of the plain forward (f32
kernels against cuDNN's f32 convolutions, TF32 off); K14's outputs each
within 1e-3 * max|ref| + 1e-9 of ``ssd_chunk_ref``, K13's of
``flash_attention_ref``, K10's, K8's and K7's of theirs; K13's also
within ``chip_smoke.FLASH_TOL`` (1.5e-4) * max|ref| + 1e-9, and K14's
within ``chip_smoke.SSD_TOL`` (1e-4) * max|ref| + 1e-9: the accuracy of
3xTF32 that one-pass TF32 misses.
"""
import math

import pytest
import torch

from repro_torch.configs.googlenet import reduced
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import cnn as t_cnn

# plan_cnn keywords and the kernels each plan's forward must launch
PLANS = {"serial": ({"concurrent": False}, ("conv2d_direct", "matmul")),
         "stacked": ({"fuse_pool": False}, ("branch_matmul",))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PLANS))
def test_baseline_plan_launches_its_kernels_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw, kernels = PLANS[name]
    cfg = reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, **kw)
    params = t_cnn.init_params(cfg, torch.Generator().manual_seed(4), "cuda")
    x = torch.randn((2,) + cfg.img,
                    generator=torch.Generator().manual_seed(5)).cuda()
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got = t_cnn.forward_plan(params, cfg, x, plan)
        want = t_cnn.forward(params, cfg, x)
    torch.cuda.synchronize()
    for k in kernels:
        assert t_rt.KERNEL_LAUNCHES[k] > 0, (k, t_rt.KERNEL_LAUNCHES)
    if name == "stacked":
        assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == \
            len(plan.groups_of_mode("stacked"))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module, ``sys.path`` left
    as it was: it holds the one list of cases each kernel is held at
    on the card."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_card", path)
    cs = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(cs)
    finally:
        sys.path[:] = saved
    return cs


_CS = _chip_smoke()
# (batch, chunks, L, H, P, G, N): ragged L and P, G > 1, the full width,
# CTAs that take fewer heads than a group has
SSD_SHAPES = _CS.SSD_SHAPES
# K14 beside the 1e-3 limit: 3xTF32's accuracy, which one-pass TF32 misses
SSD_TOL = _CS.SSD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ssd_chunk_kernel_equals_plain_on_the_card(shape):
    _need_card()
    from repro_torch.kernels import ssd as kssd
    args = _CS.ssd_case_inputs(shape, torch.device("cuda"))
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got = kssd.ssd_chunk(*args)
        ref = kssd.ssd_chunk_ref(*args)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == 1
    for gt, rt in zip(got, ref):
        assert gt.shape == rt.shape and gt.dtype == rt.dtype
        err = float((gt - rt).abs().max())
        assert err <= 1e-3 * float(rt.abs().max()) + 1e-9, err
        assert err <= SSD_TOL * float(rt.abs().max()) + 1e-9, err


@pytest.mark.cuda
def test_mamba2_pallas_prefill_launches_k14_per_layer_on_the_card():
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as t_tf
    cfg = get_reduced("mamba2-370m")
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(4), "cuda")
    tok = torch.randint(0, cfg.vocab, (2, 70),
                        generator=torch.Generator().manual_seed(5)).cuda()
    cache = t_tf.init_cache(cfg, 2, 72)
    t_rt.reset_launch_counts()
    got, gc = t_tf.prefill(params, cfg, tok, cache, impl="pallas")
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == cfg.n_layers
    want, wc = t_tf.prefill(params, cfg, tok, cache)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(gc[0]["ssm"], wc[0]["ssm"], rtol=1e-3,
                               atol=1e-5)


# K13: the reference's kernel-test cases and three of the port's own,
# (b, sq, skv, hq, hkv, d, causal, window, softcap)
FLASH_CASES = _CS.FLASH_CASES
# K13 beside the 1e-3 limit: 3xTF32's accuracy, which one-pass TF32 misses
FLASH_TOL = _CS.FLASH_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_equals_plain_on_the_card(case):
    _need_card()
    from repro_torch.kernels import flash_attention as kfa
    b, sq, skv, hq, hkv, d, causal, window, softcap = case
    gen = torch.Generator().manual_seed(sum(case[:6]))
    q = torch.randn((b, sq, hq, d), generator=gen).cuda()
    k = torch.randn((b, skv, hkv, d), generator=gen).cuda()
    v = torch.randn((b, skv, hkv, d), generator=gen).cuda()
    kw = dict(causal=causal, window=window, softcap=softcap)
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got = kfa.flash_attention(q, k, v, **kw)
        ref = kfa.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["flash_attention"] == 1
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()) + 1e-9, err
    assert err <= FLASH_TOL * float(ref.abs().max()) + 1e-9, err
    with torch.no_grad():   # no sum across CTAs: a repeat is bitwise equal
        assert torch.equal(kfa.flash_attention(q, k, v, **kw), got)
    with pytest.raises(NotImplementedError, match="K13"):
        kfa.flash_attention(q.requires_grad_(), k, v, **kw)


# K13 at its edges, (b, sq, skv, hq, hkv, d, causal, window, softcap,
# storage offset in floats): more queries than keys, so the first rows
# see no key (with a window and a softcap too); window edges that land
# mid-block at both tile widths (32 keys a block at D 128, 64 at D <= 64);
# a head dim no multiple of 4 and operands 4 bytes off a 16-byte boundary
# (4-byte copies and stores)
FLASH_EDGE_CASES = [(2, 150, 70, 8, 2, 128, True, None, None, 0),
                    (1, 100, 40, 4, 4, 64, True, 16, 30.0, 0),
                    (1, 333, 333, 8, 2, 128, True, 50, None, 0),
                    (2, 257, 257, 4, 1, 64, True, 100, 50.0, 0),
                    (1, 90, 90, 6, 2, 30, True, 37, None, 0),
                    (2, 130, 130, 4, 2, 128, True, 45, None, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_EDGE_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_kernel_at_its_edges_on_the_card(case):
    _need_card()
    from repro_torch.kernels import flash_attention as kfa
    b, sq, skv, hq, hkv, d, causal, window, softcap, offset = case
    gen = torch.Generator().manual_seed(sum(case[:6]))

    def tensor(shape):
        n = math.prod(shape)
        buf = torch.empty(n + offset, device="cuda")
        buf[offset:] = torch.randn(n, generator=gen).cuda()
        return buf[offset:].view(shape)
    q = tensor((b, sq, hq, d))
    k, v = tensor((b, skv, hkv, d)), tensor((b, skv, hkv, d))
    kw = dict(causal=causal, window=window, softcap=softcap)
    la = kfa.flash_launch(b, sq, skv, hq, hkv, d, causal, window)
    if window is not None:   # a CTA's first key inside a block: masked
        g, bk = hq // hkv, la["bk"]
        assert any(u0 > jb and (f0 // g + skv - sq - window + 1) % bk
                   for f0, _, jb, _, u0, _ in la["ctas"])
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got = kfa.flash_attention(q, k, v, **kw)
        ref = kfa.flash_attention_ref(q, k, v, **kw)
        again = kfa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["flash_attention"] == 2
    live = kfa._masks(sq, skv, causal, window, "cuda").any(-1)
    if skv < sq:
        assert not live[:sq - skv].any()
    assert not got[:, ~live].any()   # a row that sees no key is exactly 0
    err = float((got - ref).abs().max())
    assert err <= 1e-3 * float(ref.abs().max()) + 1e-9, err
    assert err <= FLASH_TOL * float(ref.abs().max()) + 1e-9, err
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_attention_pallas_forward_launches_k13_per_layer_on_the_card(arch):
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as t_tf
    cfg = get_reduced(arch)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(4), "cuda")
    tok = torch.randint(0, cfg.vocab, (2, 160),
                        generator=torch.Generator().manual_seed(5)).cuda()
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got, _ = t_tf.forward(params, cfg, tok, impl="pallas")
        assert t_rt.KERNEL_LAUNCHES["flash_attention"] == cfg.n_layers
        assert sum(t_rt.KERNEL_LAUNCHES.values()) == cfg.n_layers
        want, _ = t_tf.forward(params, cfg, tok)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)


def _close(got, ref):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    lim = 1e-3 * (float(ref.abs().max()) if ref.numel() else 0.0) + 1e-9
    assert err <= lim, (err, lim)


# K10: the reference benchmark's pair and the reference's kernel-test
# cases (M, K, N, R, C), R below and past the CTA count, edges no tile
# divides, C past 256 (4-byte z copies, up to four columns a thread), a
# one-tile GEMM beside a tall z (z spread over the card)
FUSED_CASES = _CS.FUSED_CASES


@pytest.mark.cuda
@pytest.mark.parametrize("case", [_CS.FUSED_PAIR] + FUSED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_gemm_reduce_kernel_equals_plain_on_the_card(case):
    """c bitwise equal to K4 ``mxu128``'s (the same CTAs on the same
    engine), r within tolerance of the plain version, and a second call
    bitwise equal."""
    _need_card()
    from repro_torch.kernels import fused_branches as kf
    from repro_torch.kernels import matmul as km
    m, k, n, r, c = case
    gen = torch.Generator().manual_seed(sum(case))
    x, y, z = (torch.randn(s, generator=gen).cuda()
               for s in ((m, k), (k, n), (r, c)))
    t_rt.reset_launch_counts()
    got = kf.fused_gemm_reduce(x, y, z)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["fused_gemm_reduce"] == 1
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 1
    again = kf.fused_gemm_reduce(x, y, z)
    ref = kf.fused_gemm_reduce_ref(x, y, z)
    k4 = km.matmul(x, y, algorithm="mxu128")
    torch.cuda.synchronize()
    for gt, rt in zip(got, ref):
        _close(gt, rt)
    assert torch.equal(got[0], k4)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# K8: the reference's GEMM-zoo shapes and ragged K with a short last
# split, each also with both operands transposed views, as the dW GEMMs
# hand them
KSPLIT_SHAPES = _CS.KSPLIT_SHAPES


def _ksplit_operands(shape, transposed):
    m, k, n = shape
    gen = torch.Generator().manual_seed(m * k + n)
    if transposed:
        return (torch.randn((k, m), generator=gen).cuda().t(),
                torch.randn((n, k), generator=gen).cuda().t())
    return (torch.randn((m, k), generator=gen).cuda(),
            torch.randn((k, n), generator=gen).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", KSPLIT_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_ksplit_kernel_equals_plain_on_the_card(shape, transposed):
    """K8 in one launch, within TOL of its plain version, and a second
    call bitwise equal."""
    _need_card()
    from repro_torch.kernels import matmul as km
    x, y = _ksplit_operands(shape, transposed)
    t_rt.reset_launch_counts()
    got = km.matmul(x, y, algorithm="ksplit")
    ref = km.matmul_ref(x, y, algorithm="ksplit")
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["matmul_ksplit"] == 1
    assert t_rt.KERNEL_LAUNCHES["matmul"] == 0
    _close(got, ref)
    assert torch.equal(got, km.matmul(x, y, algorithm="ksplit"))


@pytest.mark.cuda
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("shape", KSPLIT_SHAPES + [(576, 100352, 192),
                                                   (64, 100352, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_ksplit_partials_are_k4_bit_for_bit_on_the_card(shape,
                                                                transposed):
    """Each workspace slice ws[s] is K4 ``mxu128`` on x[:, K_s] @ y[K_s]
    at K8's inner split, bit for bit (the same CTAs), also through K4's
    own wrapper where its split plan for the slice is that inner split;
    the output is the slices summed in split order, bit for bit.  At
    stem2's dW (576 x 100352 x 192) the 40 (split, tile) units take 7
    inner splits of 3584."""
    _need_card()
    from repro_torch.kernels import matmul as km
    m, k, n = shape
    x, y = _ksplit_operands(shape, transposed)
    sms = t_rt.sm_count(torch.device("cuda"))
    la = km.ksplit_launch(m, n, k, sms)
    if shape == (576, 100352, 192) and sms == 132:
        assert (la["splits"], la["inner"], la["kper_in"]) == (4, 7, 3584)
    ws, out = km._ksplit_run(x, y)
    total = ws[0]
    for s in range(la["splits"]):
        lo, hi = s * la["kref"], min(k, (s + 1) * la["kref"])
        xs, ys = x[:, lo:hi], y[lo:hi]
        assert torch.equal(ws[s], _CS.k4_at(xs, ys, la["inner"],
                                            la["kper_in"]))
        k4 = km.matmul_launch(m, n, hi - lo, "mxu128", sms)
        if (k4["splits"], k4["kper"]) == (la["inner"], la["kper_in"]) \
                or k4["splits"] == la["inner"] == 1:
            assert torch.equal(ws[s], km.matmul(xs, ys))
        if s:
            total = total + ws[s]
    assert torch.equal(out, total)
    _close(out, km.matmul_ksplit_ref(x, y))


# K11: (E, D, F, bm, activation, routed slots): reduced widths at bm 8 to
# 32, D and F off the 128-wide tiles, a block of two row tiles (bm 256),
# and granite-moe-1b-a400m's layer 0 (4 x 512 tokens, top-8 of 32)
EXPERT_CASES = [(8, 128, 64, 8, "silu", 256), (8, 128, 64, 16, "gelu", 512),
                (8, 128, 64, 32, "silu", 1024), (8, 96, 80, 32, "gelu", 768),
                (4, 128, 64, 256, "silu", 2048),
                (32, 1024, 512, 128, "silu", 16384)]


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("case", EXPERT_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_grouped_matmul_experts_kernel_equals_plain_and_repeats_on_the_card(
        case, gated):
    """K11 in two CUDA launches a call: y and the pre-activations within
    TOL of the plain version with ``train=True``, exact zeros on every row
    past its block's valid count (those rows of x and sw hold noise, which
    the kernel must not read), a zero-token expert, and a second call
    bitwise equal."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    e, d, f, bm, act, n = case
    gen = torch.Generator().manual_seed(e + d + f + bm + n + gated)
    share = torch.rand(e, generator=gen)
    share[1] = 0
    counts = torch.floor(share / share.sum() * n * 0.85).to(torch.int32)
    rows = kg.moe_static_blocks(n, e, bm) * bm
    live = torch.zeros(rows, dtype=torch.bool)
    for a, c in zip(kg.expert_row_offsets(counts, bm).tolist(),
                    counts.tolist()):
        live[a:a + c] = True
    xp, swp = torch.randn(rows, d, generator=gen), torch.rand(rows,
                                                             generator=gen)
    w_in = torch.randn(e, d, f, generator=gen) * d ** -0.5
    w_gate = torch.randn(e, d, f, generator=gen) * d ** -0.5 \
        if gated else None
    w_out = torch.randn(e, f, d, generator=gen) * f ** -0.5
    fwd = [None if t is None else t.cuda()
           for t in (xp, swp, w_in, w_out, w_gate, counts)]
    kw = dict(activation=act, bm=bm, train=True)
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_experts(*fwd, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_experts"] == 1
    assert t_rt.CUDA_LAUNCHES["grouped_matmul_experts"] == 2
    again = kg.grouped_matmul_experts(*fwd, **kw)
    ref = kg.grouped_matmul_experts_ref(*fwd, **kw)
    torch.cuda.synchronize()
    dead = ~live.cuda()
    assert (got[2] is None) == (not gated)
    for g, a, r in zip(got, again, ref):
        if r is None:
            continue
        _close(g, r)
        assert not g[dead].any()
        assert torch.equal(g, a)


# K12: K11's cases and one with D and F not multiples of 4 (the dW
# tiles' 4-byte copies, the pre-activations' 4-byte loads)
EXPERT_BWD_CASES = EXPERT_CASES + [(8, 90, 75, 16, "gelu", 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("case", EXPERT_BWD_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_grouped_matmul_experts_bwd_kernel_equals_plain_and_repeats_on_the_card(
        case, gated):
    """K12 in one wrapper call of two CUDA launches, their grids those of
    ``experts_bwd_launch``: dX, dW_in, dW_gate and dW_out within TOL of
    the plain version (x, dYs and the pre-activations hold noise on every
    row past its block's valid count, which the kernel must not read),
    dX exactly zero on those rows, the zero-token expert's dW exactly
    zero, and a second call bitwise equal."""
    _need_card()
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as kg
    e, d, f, bm, act, n = case
    gen = torch.Generator().manual_seed(e + d + f + bm + n + gated + 1)
    share = torch.rand(e, generator=gen)
    share[1] = 0
    counts = torch.floor(share / share.sum() * n * 0.85).to(torch.int32)
    mbs = kg.moe_static_blocks(n, e, bm)
    rows = mbs * bm
    live = torch.zeros(rows, dtype=torch.bool)
    for a, c in zip(kg.expert_row_offsets(counts, bm).tolist(),
                    counts.tolist()):
        live[a:a + c] = True
    xp, dyp = (torch.randn(rows, d, generator=gen) for _ in range(2))
    hin = torch.randn(rows, f, generator=gen)
    gate = torch.randn(rows, f, generator=gen) if gated else None
    w_in = torch.randn(e, d, f, generator=gen) * d ** -0.5
    w_gate = torch.randn(e, d, f, generator=gen) * d ** -0.5 \
        if gated else None
    w_out = torch.randn(e, f, d, generator=gen) * f ** -0.5
    bwd = [None if t is None else t.cuda()
           for t in (xp, dyp, w_in, w_out, w_gate, hin, gate, counts)]
    kw = dict(activation=act, bm=bm)
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_experts_bwd(*bwd, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_experts_bwd"] == 1
    assert t_rt.CUDA_LAUNCHES["grouped_matmul_experts_bwd"] == 2
    la = kg.experts_bwd_launch(mbs, bm, d, f, e, gated)
    out = build.ints([0, 0, 0])
    assert build.lib().rt_experts_bwd_grids(d, f, e, bm, mbs, int(gated),
                                            out) == 0
    assert (out[0],) == la["dh_grid"]
    assert (out[1], out[2]) == (len(la["dw_tiles"]), len(la["dx_tiles"]))
    assert (out[1] + out[2],) == la["dxw_grid"]
    again = kg.grouped_matmul_experts_bwd(*bwd, **kw)
    ref = kg.grouped_matmul_experts_bwd_ref(*bwd, **kw)
    torch.cuda.synchronize()
    assert (got[2] is None) == (not gated)
    for g, a, r in zip(got, again, ref):
        if r is None:
            continue
        _close(g, r)
        assert torch.equal(g, a)
    assert not got[0][~live.cuda()].any()
    for dw in got[1:]:
        if dw is not None:
            assert not dw[1].any()


# K7: the reference's ragged branch sets (K_g, N_g)
DW_SETS = _CS.DW_SETS


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [_CS.DW_M, 25088])
@pytest.mark.parametrize("shapes", DW_SETS,
                         ids=lambda s: "-".join(f"{k}x{n}" for k, n in s))
def test_grouped_matmul_dw_kernel_equals_plain_and_k5_on_the_card(shapes, m,
                                                                  masked):
    """K7 on column slices of a joint cotangent and mask, its M split at
    25088: within tolerance of the plain version, bitwise equal to K5's dw
    and db (K5's dw entries alone) and to a second call."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    gen = torch.Generator().manual_seed(m + len(shapes) + 31 * masked)
    total = sum(n for _, n in shapes)
    xs = [torch.randn((m, k), generator=gen).cuda() for k, _ in shapes]
    ws = [torch.randn((k, n), generator=gen).cuda() for k, n in shapes]
    g = torch.randn((m, total), generator=gen).cuda()
    ymask = torch.relu(torch.randn((m, total), generator=gen)).cuda()
    offs = [sum(n for _, n in shapes[:i]) for i in range(len(shapes))]
    dys = [g[:, o:o + n] for o, (_, n) in zip(offs, shapes)]
    mask = [ymask[:, o:o + n] for o, (_, n) in zip(offs, shapes)] \
        if masked else None
    t_rt.reset_launch_counts()
    dws, dbs = kg.grouped_matmul_dw(xs, dys, mask)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_dw"] == 1
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 1
    adw, adb = kg.grouped_matmul_dw(xs, dys, mask)
    rdw, rdb = kg.grouped_matmul_dw_ref(xs, dys, mask)
    _, dw5, db5 = kg.grouped_matmul_bwd(xs, ws, dys, mask)
    torch.cuda.synchronize()
    for a, again, b, c5 in zip(dws + dbs, adw + adb, rdw + rdb, dw5 + db5):
        _close(a, b)
        assert torch.equal(a, c5)
        assert torch.equal(a, again)


@pytest.mark.cuda
def test_fused_plan_is_one_k10_launch_on_the_card():
    """A fused pair lowered by ``lower`` runs as exactly one K10 launch
    and nothing else; its outputs and gradients agree with plain torch."""
    _need_card()
    from repro_torch.core import plan as t_plan
    from repro_torch.core.graph import Op, OpGraph
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import ops as t_ops
    g = OpGraph()
    g.add(Op.make("gemm", "matmul", m=1024, k=2048, n=1024))
    g.add(Op.make("red", "pointwise", elements=1 << 22))
    plan = t_plan.lower(g, schedule(g))
    assert plan.mode_counts() == {"fused": 1}
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((1024, 2048), generator=gen) * 0.05).cuda()
    w = (torch.randn((2048, 1024), generator=gen) * 0.05).cuda()
    z = torch.randn((1 << 14, 256), generator=gen).cuda()
    impls = {
        "gemm": t_plan.OpImpl(deps=("xin",), fn=lambda a, algorithm=None:
                              t_ops.matmul(a, w, algorithm=algorithm),
                              gemm_x=lambda a: a, gemm_w=w,
                              gemm_post=lambda c: c),
        "red": t_plan.OpImpl(deps=("zin",), fn=None, stream_z=lambda a: a,
                             stream_post=lambda r: r),
    }
    xg, zg = x.clone().requires_grad_(), z.clone().requires_grad_()
    t_rt.reset_launch_counts()
    env = t_plan.run_plan(impls, {"xin": xg, "zin": zg}, plan)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["fused_gemm_reduce"] == 1
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 1
    _close(env["gemm"].detach(), x @ w)
    _close(env["red"].detach(), torch.nn.functional.silu(z).sum(0))
    dx, dz = torch.autograd.grad(env["gemm"].sum() + env["red"].sum(),
                                 (xg, zg))
    xr, zr = x.clone().requires_grad_(), z.clone().requires_grad_()
    rdx, rdz = torch.autograd.grad(
        (xr @ w).sum() + torch.nn.functional.silu(zr).sum(0).sum(), (xr, zr))
    _close(dx, rdx)
    _close(dz, rdz)


@pytest.mark.cuda
def test_winograd_conv_is_one_k9_launch_on_the_card():
    _need_card()
    from repro_torch.kernels import ops as t_ops
    from repro_torch.kernels.ref import conv2d_ref
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 15, 15, 16), generator=gen).cuda()
    w = (torch.randn((3, 3, 16, 24), generator=gen) * 0.1).cuda()
    t_rt.reset_launch_counts()
    got = t_ops.conv2d(x, w, algorithm="winograd3x3")
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == 1
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 1
    _close(got, conv2d_ref(x, w))


DIRECT_CASES = _CS.DIRECT_CASES
BMM_CASES = _CS.BMM_CASES


def _on_card(gen, shape, scale, offset):
    """A contiguous f32 tensor on the card, ``offset`` floats into its
    buffer (offset 1: not 16-byte aligned, so the kernel takes 4-byte
    copies)."""
    n = 1
    for d in shape:
        n *= d
    buf = (torch.randn(n + offset, generator=gen) * scale).cuda()
    return buf[offset:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("case", range(len(DIRECT_CASES)))
def test_conv2d_direct_kernel_equals_plain_and_repeats_on_the_card(case,
                                                                   offset):
    _need_card()
    from repro_torch.kernels import conv2d as kc
    xs, ws, stride, padding = DIRECT_CASES[case]
    gen = torch.Generator().manual_seed(100 + case)
    x = _on_card(gen, xs, 1.0, offset)
    w = _on_card(gen, ws, 0.2, offset)
    kw = dict(stride=stride, padding=padding)
    t_rt.reset_launch_counts()
    got = kc.conv2d_direct(x, w, **kw)
    again = kc.conv2d_direct(x, w, **kw)
    ref = kc.conv2d_direct_ref(x, w, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["conv2d_direct"] == 2
    _close(got, ref)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("case", BMM_CASES,
                         ids=lambda s: "x".join(map(str, s)))
def test_branch_matmul_kernel_equals_plain_and_repeats_on_the_card(case, a_t,
                                                                   b_t):
    _need_card()
    from repro_torch.kernels import branch_matmul as kb
    g, m, k, n = case
    gen = torch.Generator().manual_seed(m + 7 * k + n)
    x = torch.randn((g, k, m) if a_t else (g, m, k), generator=gen).cuda()
    y = torch.randn((g, n, k) if b_t else (g, k, n), generator=gen).cuda()
    x = x.transpose(1, 2) if a_t else x
    y = y.transpose(1, 2) if b_t else y
    t_rt.reset_launch_counts()
    got = kb.branch_matmul(x, y)
    again = kb.branch_matmul(x, y)
    ref = kb.branch_matmul_ref(x, y)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == 2
    for a, b in zip(got, ref):
        _close(a, b)
    assert torch.equal(got, again)


# K4 on the pipelined engine: the one-tile dW (64x100352)ᵀ@(100352x64)
# with the lhs a transposed column slice at lda = 147 (stem0's im2col
# stride), and ragged M/N/K, split or not, (M, K, N)
K4_SHAPES = [(64, 100352, 64), (1, 1, 1), (37, 5, 200), (129, 777, 130),
             (70, 5000, 33), (1000, 147, 64)]


def _operand(gen, rows, cols, transposed, offset):
    """A (rows, cols) f32 operand on the card: row-major, or the .t() view
    of a row-major (cols, rows) array; ``offset``: a view one column into
    a wider array, so its address is not 16-byte aligned and its leading
    dimension is odd."""
    shape = (cols, rows) if transposed else (rows, cols)
    full = torch.randn((shape[0], shape[1] + offset), generator=gen).cuda()
    v = full[:, offset:]
    return v.t() if transposed else v


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["mxu128", "large_tile"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("shape", K4_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_matmul_kernel_equals_plain_and_repeats_on_the_card(shape, a_t, b_t,
                                                            offset,
                                                            algorithm):
    _need_card()
    from repro_torch.kernels import matmul as km
    m, k, n = shape
    gen = torch.Generator().manual_seed(m + 7 * k + n)
    if shape == (64, 100352, 64) and a_t:
        # the dW lhs: 64 columns of a (100352, 147) patch matrix, .t()
        x = torch.randn((k, 147), generator=gen).cuda()[:, :64].t()
    else:
        x = _operand(gen, m, k, a_t, offset)
    y = _operand(gen, k, n, b_t, offset)
    t_rt.reset_launch_counts()
    got = km.matmul(x, y, algorithm=algorithm)
    again = km.matmul(x, y, algorithm=algorithm)
    ref = km.matmul_ref(x, y)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["matmul"] == 2
    _close(got, ref)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("m", [777, 25088])
@pytest.mark.parametrize("shapes", DW_SETS,
                         ids=lambda s: "-".join(f"{k}x{n}" for k, n in s))
def test_grouped_matmul_bwd_kernel_equals_plain_and_repeats_on_the_card(
        shapes, m, masked):
    """K5 on column slices of a joint cotangent and mask (aligned or not,
    as the set's widths fall), its dw half split over M at 25088."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    gen = torch.Generator().manual_seed(m + len(shapes) + 31 * masked)
    total = sum(n for _, n in shapes)
    xs = [torch.randn((m, k), generator=gen).cuda() for k, _ in shapes]
    ws = [(torch.randn((k, n), generator=gen) * 0.1).cuda()
          for k, n in shapes]
    g = torch.randn((m, total), generator=gen).cuda()
    ymask = torch.relu(torch.randn((m, total), generator=gen)).cuda()
    offs = [sum(n for _, n in shapes[:i]) for i in range(len(shapes))]
    dys = [g[:, o:o + n] for o, (_, n) in zip(offs, shapes)]
    mask = [ymask[:, o:o + n] for o, (_, n) in zip(offs, shapes)] \
        if masked else None
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_bwd(xs, ws, dys, mask)
    again = kg.grouped_matmul_bwd(xs, ws, dys, mask)
    ref = kg.grouped_matmul_bwd_ref(xs, ws, dys, mask)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_bwd"] == 2
    for a, b, c in zip(sum(got, []), sum(again, []), sum(ref, [])):
        _close(a, c)
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("shape", K4_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_branch_matmul_at_one_branch_is_k4_bit_for_bit_on_the_card(shape,
                                                                   a_t, b_t):
    """K9 with G = 1 and K4 (``mxu128``) run the same engine, tile and
    split plan on the same copy layouts, so they agree bit for bit."""
    _need_card()
    from repro_torch.kernels import branch_matmul as kb
    from repro_torch.kernels import matmul as km
    m, k, n = shape
    gen = torch.Generator().manual_seed(m + 3 * k + n)
    x = _operand(gen, m, k, a_t, 0)
    y = _operand(gen, k, n, b_t, 0)
    t_rt.reset_launch_counts()
    got = kb.branch_matmul(x[None], y[None])[0]
    want = km.matmul(x, y)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == 1
    assert t_rt.KERNEL_LAUNCHES["matmul"] == 1
    assert torch.equal(got, want)


def _equal_bits(a, b):
    """Bitwise equality, NaNs included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _close_nan(got, ref):
    """``_close`` on the values, the NaNs of both in the same places."""
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    _close(torch.where(nan, 0.0, got), torch.where(nan, 0.0, ref))


# K2 at the training step's and serve bucket 1's shapes: (batch, H, W, C)
# of the pooling stage's input, its chain, the tap form ("views": the
# strided (B, OH, OW, C) views the plan hands over; "copies": contiguous
# (M, C) tensors), the pooled branch's N, the dense branch's N, m_valid
# and a NaN in the input.  inc1 (stride 1, 25088 rows) and inc0 (stride 2
# from 112 x 112) of a step; inc7 at serve b1 (196 rows: 10 tiles, so the
# depth of 832 splits), dense and ragged; C = 30 and N = 45: the taps'
# 4-byte loads and the weights' 4-byte copies
POOLED_CASES = {
    "step-inc1": (8, 56, 56, 256, ((3, 1),), "views", 64, 288, None, False),
    "step-inc0-stride2": (8, 112, 112, 192, ((3, 2),), "views", 176, 32,
                          None, False),
    "serve-b1-inc7-split": (1, 28, 28, 832, ((3, 2),), "views", 448, 128,
                            None, False),
    "serve-b1-inc7-ragged": (1, 28, 28, 832, ((3, 2),), "views", 448, 128,
                             30, False),
    "copies": (2, 14, 14, 96, ((3, 1),), "copies", 64, 80, None, False),
    "nan-tap": (2, 14, 14, 96, ((3, 1),), "views", 64, 80, 300, True),
    "unaligned": (3, 9, 9, 30, ((3, 2),), "views", 45, 7, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(POOLED_CASES))
def test_grouped_matmul_pooled_kernel_equals_plain_and_repeats_on_the_card(
        case):
    """K2 with one pooled branch (taps read in place) and one dense one:
    within TOL of its plain version, one launch a call, and a second call
    bitwise equal."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    b, h, w, c, chain, form, n_pool, n_dense, m_valid, nan = \
        POOLED_CASES[case]
    gen = torch.Generator().manual_seed(b * h + c)
    x = torch.randn((b, h, w, c), generator=gen)
    if nan:
        x[1, 4, 5, 3] = float("nan")
    taps = kg.pool_tap_views(x.cuda(), chain)
    if form == "copies":
        taps = [t.reshape(-1, c).contiguous() for t in taps]
    m = taps[0].numel() // c
    dense = torch.randn((m, c), generator=gen).cuda()
    ws = [(torch.randn((c, n), generator=gen) * 0.1).cuda()
          for n in (n_pool, n_dense)]
    bs = [torch.randn((n,), generator=gen).cuda() for n in (n_pool, n_dense)]
    xs = [tuple(taps), dense]
    kw = dict(relu=True, m_valid=m_valid)
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_pooled(xs, ws, bs, **kw)
    again = kg.grouped_matmul_pooled(xs, ws, bs, **kw)
    ref = kg.grouped_matmul_pooled_ref(xs, ws, bs, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_pooled"] == 2
    for a, a2, r in zip(got, again, ref):
        _close_nan(a, r)
        assert _equal_bits(a, a2)
    if nan:
        assert torch.isnan(got[0]).any()


# K1 at the step's and serve bucket 1's shapes: (M, [(K, N, offset)],
# total, m_valid, compact): inc3's 3x3/5x5 pair of a step (offsets with
# the 1x1 and pool-proj columns left as holes), inc7's pair at serve b1
# (1440 and 800 deep over 4 tiles: split), dense and ragged; odd offsets
# and widths; the padded layout
CONCAT_CASES = {
    "step-inc3": (6272, [(864, 208, 192), (400, 48, 400)], 512, None, True),
    "serve-b1-inc7-split": (196, [(1440, 320, 256), (800, 128, 576)], 832,
                            None, True),
    "serve-b1-inc7-ragged": (196, [(1440, 320, 256), (800, 128, 576)], 832,
                             30, True),
    "odd-offsets": (300, [(27, 45, 3), (100, 17, 50), (5, 1, 70)], 77, 211,
                    True),
    "padded": (300, [(27, 45, 0), (100, 17, 45)], 62, 100, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CONCAT_CASES))
def test_grouped_matmul_concat_kernel_equals_plain_and_repeats_on_the_card(
        case):
    """K1: within TOL of its plain version, columns no branch owns left
    zero, one launch a call, and a second call bitwise equal."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    m, branches, total, m_valid, compact = CONCAT_CASES[case]
    gen = torch.Generator().manual_seed(m + len(branches))
    xs = [torch.randn((m, k), generator=gen).cuda() for k, _, _ in branches]
    ws = [(torch.randn((k, n), generator=gen) * 0.05).cuda()
          for k, n, _ in branches]
    bs = [torch.randn((n,), generator=gen).cuda() for _, n, _ in branches]
    kw = dict(offsets=[o for _, _, o in branches],
              total=total, relu=True,
              compact=compact, m_valid=m_valid)
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_concat(xs, ws, bs, **kw)
    again = kg.grouped_matmul_concat(xs, ws, bs, **kw)
    ref = kg.grouped_matmul_concat_ref(xs, ws, bs, **kw)
    torch.cuda.synchronize()
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_concat"] == 2
    _close(got, ref)
    assert torch.equal(got, again)


def _k6_chain(case):
    """Phases, panels, (m, h, w) and m_valid of a K6 card case: a 5x5 ring
    on a 16-wide producer; a 3x3 ring on a 96-wide one; a previous
    chain's panel as the source, with its blocks' true widths handed
    over and without; stem0's im2col x (K = 147: 4-byte copies) feeding
    a 1x1 and a 3x3 ring; image-aligned ragged m_valid (0, one image,
    all but one); a NaN in a live lhs element; and a chain of three
    phases over 98 m-blocks, more items than a wave of CTAs holds, so
    that consumers wait on producers still running."""
    from repro_torch.core import plan as t_plan
    gen = torch.Generator().manual_seed(sum(map(ord, case)))
    dense = lambda w: t_plan._pad_w_dense(w, 128)
    rnd = lambda *s: torch.randn(s, generator=gen)

    def ring(cin, kh, n, rcs=(0,), rw=None):
        nrc = len(rcs)
        return {"n": n, "w": t_plan._pack_w_ring(
                    rnd(cin * kh * kh, n) * (cin * kh * kh) ** -0.5, kh, kh,
                    cin, nrc, 128),
                "b": rnd(n), "src": ("ring", kh, kh, tuple(rcs)),
                "ring_write": rw}

    def xbr(x, n, rw=None):
        return {"n": n, "w": dense(rnd(x.shape[1], n) * x.shape[1] ** -0.5),
                "b": rnd(n), "src": ("x", [x]), "ring_write": rw}

    panels, m_valid = (), None
    if case in ("ring5x5-16", "ring3x3-96", "nan-lhs") \
            or case.startswith("ragged"):
        b, h, w = (4, 14, 14) if case.startswith("ragged") else (2, 28, 28)
        m = b * h * w
        x = rnd(m, 192)
        if case == "nan-lhs":
            x[300, 17] = float("nan")
        prod = 16 if case == "ring5x5-16" else 96
        kh = 5 if case == "ring5x5-16" else 3
        phases = [[xbr(x, prod, (0,)), xbr(x, 64)],
                  [ring(prod, kh, 32 if kh == 5 else 128)]]
        m_valid = {"ragged-0": 0, "ragged-one-image": h * w,
                   "ragged-all-but-one": 3 * h * w}.get(case)
    elif case.startswith("panel"):
        b, h, w = 2, 28, 28
        m = b * h * w
        panel = torch.zeros(m, 384)
        for c0, n in ((0, 64), (128, 128), (256, 32)):
            panel[:, c0:c0 + n] = torch.relu(rnd(m, n))
        ranges = [(0, 64), (64, 192), (192, 224)]
        pbr = {"n": 96, "w": t_plan._pack_w_blocks(rnd(224, 96) * 0.07,
                                                   ranges, 128),
               "b": rnd(96), "src": ("panel", [(0, 0), (0, 1), (0, 2)]),
               "ring_write": (0,)}
        if case == "panel-live":
            pbr["panel_live"] = (64, 128, 32)
        phases = [[pbr], [ring(96, 3, 48)]]
        panels = (panel,)
    elif case == "stem-x147":
        from repro_torch.models import cnn as t_cnn
        b, h, w = 2, 56, 56
        m = b * h * w
        x = t_cnn._im2col(rnd(b, 112, 112, 3), 7, 7, 2).reshape(m, 147)
        phases = [[xbr(x.contiguous(), 64, (0,))],
                  [ring(64, 1, 64, (0,), (1,))], [ring(64, 3, 192, (1,))]]
    else:   # "long-chain"
        b, h, w = 4, 56, 56
        m = b * h * w
        phases = [[xbr(rnd(m, 64), 64, (0,))],
                  [ring(64, 3, 128, (0,), (1,))], [ring(128, 3, 96, (1,))]]
    cuda = lambda br: {k: (v.cuda() if isinstance(v, torch.Tensor) else
                           ("x", [v[1][0].cuda()]) if k == "src"
                           and v[0] == "x" else v) for k, v in br.items()}
    return ([[cuda(br) for br in ph] for ph in phases],
            tuple(p.cuda() for p in panels), (m, h, w), m_valid)


CHAIN_CASES = ("ring5x5-16", "ring3x3-96", "panel-live", "panel-128",
               "stem-x147", "ragged-0", "ragged-one-image",
               "ragged-all-but-one", "nan-lhs", "long-chain")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHAIN_CASES)
def test_grouped_matmul_chained_kernel_equals_plain_and_repeats_on_the_card(
        case):
    """K6: every phase in one launch a call (none when no row is live),
    each panel within TOL of its plain version on the live rows, zeros at
    and past m_valid inside a run block and in the padding columns, and a
    second call bitwise equal on every row the launch writes."""
    _need_card()
    from repro_torch.kernels import grouped_matmul as kg
    phases, panels, (m, h, w), m_valid = _k6_chain(case)
    kw = dict(m=m, h=h, w=w, panels=panels, m_valid=m_valid)
    la = kg.chained_plan(phases, sms=t_rt.sm_count(torch.device("cuda")),
                         **kw)
    if case == "long-chain":
        assert la["n_items"] > 2 * t_rt.sm_count(torch.device("cuda"))
    t_rt.reset_launch_counts()
    got = kg.grouped_matmul_chained(phases, **kw)
    again = kg.grouped_matmul_chained(phases, **kw)
    ref = kg.grouped_matmul_chained_ref(phases, **kw)
    torch.cuda.synchronize()
    lim = m if m_valid is None else m_valid
    run = -(-lim // 128) * 128
    want = 2 if lim else 0
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_chained"] == want
    assert t_rt.CHAINED_CALLS == want
    for g, a, r in zip(got, again, ref):
        _close_nan(g[:lim], r[:lim])
        assert not g[lim:run].any()
        assert _equal_bits(g[:run], a[:run])
    for p, cb, nbb, n in kg.chained_layout(phases):
        assert not got[p][:run, cb * 128 + n:(cb + nbb) * 128].any()
    if case == "nan-lhs":
        assert torch.isnan(got[0]).any() and torch.isnan(got[1]).any()
