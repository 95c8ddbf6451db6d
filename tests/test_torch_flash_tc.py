"""K13's tensor-core design on the CPU: its launch table and a replay of
its arithmetic.

``kernels/flash_attention.py::flash_launch`` lists what
``csrc/flash_attention.cu`` computes on the card: each CTA's rows, the
key blocks it visits and which of them skip the per-element mask.  At
every ``chip_smoke.FLASH_CASES`` entry and at the llama3-8b and
gemma2-27b layer shapes (causal 8192, through the table only), every
visible (row, key) pair lies in exactly one listed block, no listed
block is wholly invisible, and every block that skips the mask is
wholly visible.

The replay redoes the kernel's arithmetic in torch from the table: S and
P V in 3xTF32 (each operand split into big = cvt.rna.tf32(x) and small =
cvt.rna.tf32(x - big), the products small.big + big.small + big.big in
f32), scores in base 2, the online softmax over the table's blocks with
masks only on masked blocks.  It is held against the reference's Pallas
kernel in interpret mode at ``FLASH_CASES`` (inputs made with numpy from
a seed), rtol/atol 1e-5 as in ``test_torch_flash.py``; a one-pass TF32
replay (big.big only) must miss the same check.  At ``chip_smoke.py``'s
own ``FLASH_CASES`` inputs, the card's K13 limit ``FLASH_TOL`` takes the
3xTF32 replay everywhere and refuses, at some entry, one-pass TF32 and
each replay that drops one of the small parts' products.

Size rule: every score tensor here is a (B, Hkv, 64, BK) block and every
interpret-mode run is at a ``FLASH_CASES`` size, a few MB at most.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import flash_attention as j_fa
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as t_fa

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)


def _load_chip_smoke(name):
    """The repository's ``chip_smoke.py`` as a module, ``sys.path`` left
    as it was."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location(name, path)
    cs = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(cs)
    finally:
        sys.path[:] = saved
    return cs


_CS = _load_chip_smoke("_chip_smoke_flash_tc")
# (b, sq, skv, hq, hkv, d, causal, window, softcap)
CASES = _CS.FLASH_CASES


def _layer_cases():
    """One layer of each attention LM that the card forwards at 1 x 8192:
    llama3-8b, and gemma2-27b's local (window 4096) and global layers,
    all with softcap where the config has one."""
    out = []
    for arch in ("llama3-8b", "gemma2-27b"):
        c = get_config(arch)
        for spec in c.pattern:
            out.append((1, 8192, 8192, c.n_heads, c.n_kv_heads, c.head_dim,
                        True, spec.window, c.attn_softcap))
    return out


LAYER_CASES = _layer_cases()
_ids = lambda c: "x".join(map(str, c))


def _visible(qp, skv, causal, window):
    """Per query position: the first and last key it sees (lo > hi: none)."""
    hi = np.minimum(skv - 1, qp) if causal else np.full_like(qp, skv - 1)
    lo = np.maximum(0, qp - window + 1) if window is not None \
        else np.zeros_like(qp)
    return lo, hi


@pytest.mark.parametrize("case", CASES + LAYER_CASES, ids=_ids)
def test_flash_launch_covers_each_visible_pair_once(case):
    b, sq, skv, hq, hkv, d, causal, window, _ = case
    la = t_fa.flash_launch(b, sq, skv, hq, hkv, d, causal, window)
    g, bk, rows = hq // hkv, la["bk"], sq * hq // hkv
    assert la["dp"] >= d and la["grid"] == (len(la["ctas"]), b * hkv)
    # the row blocks partition the rows, longest causal ranges first
    spans = sorted((f0, f1) for f0, f1, *_ in la["ctas"])
    assert spans[0][0] == 0 and spans[-1][1] == rows
    assert all(a[1] == c[0] for a, c in zip(spans, spans[1:]))
    assert [c[0] for c in la["ctas"]] == sorted(
        (c[0] for c in la["ctas"]), reverse=True)
    blocks = masked = 0
    for f0, f1, jbeg, jend, u0, u1 in la["ctas"]:
        assert f1 - f0 <= t_fa.FLASH_ROWS
        lo, hi = _visible(np.arange(f0, f1) // g + skv - sq, skv, causal,
                          window)
        live = lo <= hi
        # every visible pair lies in [jbeg * bk, jend * bk), whose blocks
        # are disjoint: each pair is covered exactly once
        assert (lo[live] >= jbeg * bk).all() and \
            (hi[live] < jend * bk).all()
        js = np.arange(jbeg, max(jend, jbeg))
        # no listed block is wholly invisible
        seen = live[None] & (lo[None] <= (js[:, None] + 1) * bk - 1) & \
            (hi[None] >= js[:, None] * bk)
        assert seen.any(axis=1).all()
        # every block that skips the mask is wholly visible to every row
        assert jbeg <= u0 <= u1 <= max(jend, jbeg)
        ju = np.arange(u0, u1)[:, None]
        assert ((lo[None] <= ju * bk) & (hi[None] >= (ju + 1) * bk - 1)
                ).all()
        blocks += len(js)
        masked += len(js) - (u1 - u0)
    assert (la["blocks"], la["masked"]) == (blocks, masked)
    # the mask runs only on the blocks that straddle the diagonal, the
    # window's edge or Skv: at most two a row block where the kernel has
    # a diagonal or a window edge, one where only Skv is ragged
    assert masked <= 2 * len(la["ctas"])


def test_flash_launch_masks_one_block_a_row_block_for_llama3():
    la = t_fa.flash_launch(*LAYER_CASES[0][:8])
    assert la["grid"] == (512, 8) and la["dp"] == 128 and la["bk"] == 32
    assert la["masked"] == 512 and la["blocks"] == 65792
    assert la["smem_bytes"] <= 227 * 1024 // 2   # two CTAs an SM


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero,
    in an f32 container."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


# the kernel's products: small.big, big.small, big.big (3xTF32, in that
# order); one-pass TF32 keeps big.big alone
TERMS3 = ("sb", "bs", "bb")
LESS_PRECISE = {"one-pass": ("bb",), "no small.big": ("bs", "bb"),
                "no big.small": ("sb", "bb")}


def _mm(a, b, terms):
    """a @ b as the kernel's ``mma.sync`` products form it, summing
    ``terms`` in order (``TERMS3``: small.big + big.small + big.big)."""
    ab, bb = _tf32(a), _tf32(b)
    prod = {"sb": lambda: _tf32(a - ab) @ bb,
            "bs": lambda: ab @ _tf32(b - bb), "bb": lambda: ab @ bb}
    out = prod[terms[0]]()
    for t in terms[1:]:
        out = out + prod[t]()
    return out


def replay(q, k, v, *, causal, window, softcap, scale=None, terms=TERMS3):
    """K13's arithmetic in torch over ``flash_launch``'s blocks."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    la = t_fa.flash_launch(b, sq, skv, hq, hkv, d, causal, window)
    bk = la["bk"]
    scale = torch.tensor(scale if scale is not None else d ** -0.5,
                         dtype=torch.float32)
    if softcap is not None:
        cap = torch.tensor(softcap, dtype=torch.float32)
        sc, cap = scale / cap, cap * LOG2E
    else:
        sc = scale * LOG2E
    # rows of a (batch, kv head) position-major; keys zero past Skv
    qr = q.reshape(b, sq, hkv, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, hkv, sq * g, d)
    pad = (0, 0, 0, -(-skv // bk) * bk - skv)
    kr = F.pad(k.permute(0, 2, 1, 3), pad)
    vr = F.pad(v.permute(0, 2, 1, 3), pad)
    out = torch.zeros_like(qr)
    ninf = torch.tensor(float("-inf"))
    for f0, f1, jbeg, jend, u0, u1 in la["ctas"]:
        qp = torch.arange(f0, f1) // g + skv - sq
        m = torch.full((b, hkv, f1 - f0), float("-inf"))
        l = torch.zeros((b, hkv, f1 - f0))
        acc = torch.zeros((b, hkv, f1 - f0, d))
        for j in range(jbeg, jend):
            keys = slice(j * bk, (j + 1) * bk)
            s = _mm(qr[:, :, f0:f1], kr[:, :, keys].transpose(-1, -2),
                    terms) * sc
            if softcap is not None:
                s = torch.tanh(s) * cap
            if not u0 <= j < u1:
                key = torch.arange(j * bk, (j + 1) * bk)[None]
                ok = key < skv
                if causal:
                    ok = ok & (key <= qp[:, None])
                if window is not None:
                    ok = ok & (key > qp[:, None] - window)
                s = torch.where(ok, s, ninf)
            mx = torch.maximum(m, s.amax(-1))
            base = torch.where(mx == float("-inf"), 0.0, mx)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s - base[..., None])
            l = l * alpha + p.sum(-1)
            m = mx
            acc = acc * alpha[..., None] + _mm(p, vr[:, :, keys], terms)
        inv = torch.where(l == 0, 0.0, 1.0 / torch.where(l == 0, 1.0, l))
        out[:, :, f0:f1] = acc * inv[..., None]
    return out.reshape(b, hkv, sq, g, d).permute(0, 2, 1, 3, 4).reshape(
        b, sq, hq, d)


def _qkv(case, seed=3):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed + sum(case[:6]))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(b, sq, hq, d), f(b, skv, hkv, d), f(b, skv, hkv, d)


def test_tf32_split_rounds_as_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, 2 ** 100 * (1 + 2 ** -11),
                      -0.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 4 * 2 ** -11,
                         -(1 + 2 ** -10), 1.0, 2 ** 100 * (1 + 2 ** -10),
                         -0.0])
    got = _tf32(x)
    assert torch.equal(got, want) and torch.equal(got.signbit(),
                                                  want.signbit())
    y = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big = _tf32(y)
    assert not (big.view(torch.int32) & 0x1fff).any()
    assert ((y - big).abs() <= y.abs() * 2 ** -11).all()
    small = _tf32(y - big)
    assert ((big + small - y).abs() <= y.abs() * 2 ** -21).all()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_replay_3xtf32_equals_reference_kernel(case):
    """The 3xTF32 replay agrees with the reference's Pallas kernel (in
    interpret mode) and with K13's plain version within TOL on the rows
    that see a key, and is exactly 0 on the others; one-pass TF32
    misses TOL."""
    b, sq, skv, hq, hkv, d, causal, window, softcap = case
    q, k, v = _qkv(case)
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = replay(tq, tk, tv, **kw).numpy()
    live = t_fa._masks(sq, skv, causal, window, "cpu").any(-1).numpy()
    assert not got[:, ~live].any()
    want = np.asarray(j_fa.flash_attention(
        *map(jnp.asarray, (q, k, v)), interpret=True, **kw))
    np.testing.assert_allclose(got[:, live], want[:, live], **TOL)
    np.testing.assert_allclose(
        got, t_fa.flash_attention_ref(tq, tk, tv, **kw).numpy(), **TOL)
    one = replay(tq, tk, tv, terms=("bb",), **kw).numpy()
    assert not np.allclose(one[:, live], want[:, live], **TOL)


def test_flash_replay_with_a_scale_and_rows_past_the_last_block():
    """A scale of the caller's and Sq * G no multiple of 64 rows: the
    last CTA's rows past the end are not part of the output."""
    case = (1, 37, 90, 6, 2, 48, True, 40, None)
    q, k, v = map(torch.from_numpy, _qkv(case))
    kw = dict(causal=True, window=40, softcap=None, scale=0.3)
    torch.testing.assert_close(replay(q, k, v, **kw),
                               t_fa.flash_attention_ref(q, k, v, **kw),
                               **TOL)


@pytest.mark.parametrize("variant", ["3xTF32", *LESS_PRECISE])
def test_flash_tol_tells_3xtf32_from_fewer_products(variant):
    """``chip_smoke.FLASH_TOL`` (the card's K13 limit beside ``TOL``) at
    ``chip_smoke.py``'s own ``FLASH_CASES`` inputs: the 3xTF32 replay
    meets it at every entry; one-pass TF32 and each replay that drops
    one small part's product miss it at some entry."""
    terms = TERMS3 if variant == "3xTF32" else LESS_PRECISE[variant]
    worst = 0.0
    for _, q, k, v, kw in _CS.flash_case_inputs(torch.device("cpu")):
        ref = t_fa.flash_attention_ref(q, k, v, **kw)
        err = float((replay(q, k, v, terms=terms, **kw) - ref).abs().max())
        worst = max(worst, err / (_CS.FLASH_TOL * float(ref.abs().max())
                                  + _CS.FLOOR))
    if variant == "3xTF32":
        assert worst <= 0.01, worst
    else:
        assert worst > 1, worst
