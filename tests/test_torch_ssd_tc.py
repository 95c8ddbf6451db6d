"""K14's tensor-core design on the CPU: its launch table and a replay of
its arithmetic.

``kernels/ssd.py::ssd_launch`` lists what ``csrc/ssd_chunk.cu`` computes
on the card: the heads each CTA takes, C Bᵀ formed once for them.  At
every ``chip_smoke.SSD_SHAPES`` entry, at the reduced mamba2 config's
calls and at the full-width mamba2-370m layer (through the table only),
on 132 SMs and on fewer, every (cell, head) lies in exactly one CTA, a
CTA's heads lie in one state group, and the CTA index decodes to its
entry as the kernel decodes it.

The replay redoes the kernel's arithmetic in torch from the table: per
CTA, S = C Bᵀ in 3xTF32 (each operand split into big = cvt.rna.tf32(x)
and small = cvt.rna.tf32(x - big), the products small.big + big.small +
big.big in f32) on the 8-column tiles of s at or left of each 16-row
tile's diagonal (the causal skip); per head of the CTA, cum by the
kernel's scan, P = S o 2^((cum[t] - cum[s]) log2 e) with the mask inside
the exponent, y = P x and the state Bᵀ (w o x) (w = 2^((cum[L-1] -
cum[s]) log2 e), taken onto B's values as the kernel takes it), both in
3xTF32.  It is held against the reference's Pallas kernel in interpret
mode (``repro.kernels.ssd.ssd_chunked(..., interpret=True)``, the replay
standing in for the port's cells; inputs made with numpy from a seed):
y and the final state within 1e-5 * max|ref| + 1e-7, and the cells'
outputs against the plain version ``ssd_chunk_ref`` the same way.  A
one-pass TF32 replay (big.big only) misses that check.  At the inputs of
``chip_smoke.py``'s own ``SSD_SHAPES`` (the card test's), the card's K14
limit ``SSD_TOL`` takes the 3xTF32 replay everywhere and refuses, at
some entry, one-pass TF32 and each replay that drops one of the small
parts' products.

Size rule: every case is a few MB at most; the largest ``SSD_SHAPES``
entry is held on the card and here only through the table.
"""
import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ssd as t_ssd

# the module (``repro.kernels`` exports a function of the same name)
j_ssd = importlib.import_module("repro.kernels.ssd")
torch.set_num_threads(2)
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
# replay against the reference and the plain version: max abs err <=
# RTOL * max|ref| + ATOL
RTOL, ATOL = 1e-5, 1e-7


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


_CS = _load_chip_smoke("_chip_smoke_ssd_tc")
SSD_SHAPES = _CS.SSD_SHAPES
# x, y_diag and states of a case past this many floats are held on the
# card only
_CPU_FLOATS = 1 << 20
CPU_SHAPES = [s for s in SSD_SHAPES if math.prod(s[:5]) <= _CPU_FLOATS]
_ids = lambda c: "x".join(map(str, c))


def _model_shapes():
    """(batch, chunks, L, H, P, G, N) of the mamba2 calls the card runs:
    the full-width prefill's (batch 4 x 2048) and the reduced card test's
    (batch 2 x 70)."""
    out = []
    for cfg, bsz, seq in ((get_config("mamba2-370m"), 4, 2048),
                          (get_reduced("mamba2-370m"), 2, 70)):
        s = cfg.ssm
        l = min(s.chunk, seq)
        out.append((bsz, -(-seq // l), l, s.n_heads, s.head_dim, s.n_groups,
                    s.d_state))
    return out


MODEL_SHAPES = _model_shapes()


@pytest.mark.parametrize("sms", [132, 16, 1])
@pytest.mark.parametrize("shape", SSD_SHAPES + MODEL_SHAPES, ids=_ids)
def test_ssd_launch_covers_each_head_once_in_one_group(shape, sms):
    b, nc, l, h, p, g, n = shape
    la = t_ssd.ssd_launch(b, nc, l, h, p, g, n, sms)
    hb, rep, cells = la["hb"], h // g, b * nc
    assert 1 <= hb <= t_ssd.SSD_HEADS_MAX and rep % hb == 0
    assert la["grid"] == (len(la["ctas"]),) == (cells * h // hb,)
    # the least waves x (heads + a CTA's own work), the most heads on a tie
    slots = la["per_sm"] * sms

    def cost(d):
        return math.ceil(cells * h / d / slots) * (d + t_ssd.SSD_CTA_HEADS)
    for d in range(1, min(rep, t_ssd.SSD_HEADS_MAX) + 1):
        if rep % d == 0:
            assert cost(hb) < cost(d) or (cost(hb) == cost(d) and hb >= d)
    seen = np.zeros((cells, h), dtype=int)
    blocks = h // hb
    for i, (cell, h0) in enumerate(la["ctas"]):
        # the kernel's decode of blockIdx.x
        assert (cell, h0) == (i // blocks, (i % blocks) * hb)
        # one group a CTA
        assert h0 // rep == (h0 + hb - 1) // rep
        seen[cell, h0:h0 + hb] += 1
    assert (seen == 1).all()
    assert la["nw"] == (4 if l <= 64 else 8) and la["lp"] >= l
    assert la["pp"] >= p and la["ldb"] % 16 == 8
    assert la["limit"] is None and la["smem_bytes"] <= 232448


def test_ssd_launch_full_width_takes_sixteen_heads_a_cta():
    la = t_ssd.ssd_launch(*MODEL_SHAPES[0], 132)
    assert MODEL_SHAPES[0] == (4, 16, 128, 32, 64, 1, 128)
    # one wave of 128 CTAs (16 heads each) before two of 256 (8 each)
    assert la["hb"] == 16 and la["grid"] == (128,) and la["nw"] == 8
    assert la["smem_bytes"] == 180736
    # half the cells: 8 heads a CTA fill the card once
    assert t_ssd.ssd_launch(2, 16, 128, 32, 64, 1, 128, 132)["hb"] == 8
    # the grouped card case: fewer heads a CTA than its group has
    b, nc, l, h, p, g, n = SSD_SHAPES[-1]
    assert g > 1 and 1 < t_ssd.ssd_launch(b, nc, l, h, p, g, n,
                                          132)["hb"] < h // g


@pytest.mark.parametrize("shape,what", [
    ((1, 1, 129, 2, 8, 1, 16), "chunk 129"),
    ((1, 1, 64, 2, 65, 1, 16), "head dim 65"),
    ((1, 1, 128, 2, 64, 1, 256), "d_state 256")])
def test_ssd_launch_names_what_the_kernel_cannot_take(shape, what):
    la = t_ssd.ssd_launch(*shape, 132)
    assert la["limit"] is not None and what in la["limit"]


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


def _scan(a, lp):
    """The kernel's cum over the last axis (length <= lp <= 128): 4 steps
    a lane, then the lanes' totals by a shuffle scan; past the chunk (a
    zero-filled) the cum stays at its last value, to rounding."""
    v = torch.nn.functional.pad(a, (0, 128 - a.shape[-1]))
    loc = torch.cumsum(v.reshape(*a.shape[:-1], 32, 4), dim=-1)
    run = loc[..., 3]
    tot = run
    for off in (1, 2, 4, 8, 16):
        tot = tot + torch.nn.functional.pad(tot, (off, 0))[..., :32]
    return ((tot - run)[..., None] + loc).reshape(*a.shape[:-1], 128)[
        ..., :lp]


def replay(x, a, b, c, *, sms=132, terms=TERMS3):
    """K14's arithmetic in torch over ``ssd_launch``'s CTAs."""
    bsz, nc, l, h, p = x.shape
    g, n = b.shape[3], b.shape[4]
    la = t_ssd.ssd_launch(bsz, nc, l, h, p, g, n, sms)
    lp, hb, rep = la["lp"], la["hb"], h // g
    cells = bsz * nc
    pad = lambda t, dims: torch.nn.functional.pad(t, dims)
    # rows past L and columns past P / N zero, as the zero-fill copies
    xs = pad(x.reshape(cells, l, h, p), (0, 0, 0, 0, 0, lp - l))
    bs = pad(b.reshape(cells, l, g, n), (0, 0, 0, 0, 0, lp - l))
    cs = pad(c.reshape(cells, l, g, n), (0, 0, 0, 0, 0, lp - l))
    cum = _scan(a.reshape(cells, l, h).transpose(1, 2), lp)   # (cells,H,LP)
    rows = torch.arange(lp)
    # the causal skip: 8-column tile j of a 16-row tile m is formed iff
    # j <= 2m + 1; the mask (inside the exponent) where s > t
    formed = (rows[None, :] // 8) <= 2 * (rows[:, None] // 16) + 1
    causal = rows[None, :] <= rows[:, None]
    y = torch.zeros((cells, lp, h, p))
    st = torch.empty((cells, h, n, p))
    for cell, h0 in la["ctas"]:
        grp = h0 // rep
        bg, cg = bs[cell, :, grp], cs[cell, :, grp]
        s_mat = torch.where(formed, _mm(cg, bg.T, terms), 0.0)
        for hh in range(h0, h0 + hb):
            cu = cum[cell, hh]
            d = torch.where(causal, cu[:, None] - cu[None, :],
                            torch.tensor(-1e30))
            pm = s_mat * torch.exp2(d * LOG2E)
            xh = xs[cell, :, hh]
            y[cell, :, hh] = _mm(pm, xh, terms)
            w = torch.exp2((cu[l - 1] - cu) * LOG2E)
            st[cell, hh] = _mm((bg * w[:, None]).T, xh, terms)
    return (y[:, :l].reshape(x.shape), st.reshape(bsz, nc, h, n, p),
            cum[:, :, :l].transpose(1, 2).reshape(a.shape))


def _np_inputs(shape, seed=5):
    """x, a, b, c (cells layout) from numpy, scaled as the model's."""
    b, nc, l, h, p, g, n = shape
    rng = np.random.default_rng(seed + sum(shape))
    x = (rng.normal(size=(b, nc, l, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, nc, l, h))) * 0.3).astype(np.float32)
    bb = (rng.normal(size=(b, nc, l, g, n)) * n ** -0.5).astype(np.float32)
    cc = (rng.normal(size=(b, nc, l, g, n)) * n ** -0.5).astype(np.float32)
    return x, a, bb, cc


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    return err <= RTOL * float(np.abs(ref).max()) + ATOL, err


def _against_reference(shape, terms, sms):
    """(ok, worst error) of the replay's cells, then y and the final state
    through the chunked SSD, against the plain version and the
    reference's Pallas kernel in interpret mode."""
    b, nc, l, h, p, g, n = shape
    x, a, bb, cc = _np_inputs(shape)
    tx, ta, tb, tc = map(torch.from_numpy, (x, a, bb, cc))
    checks = [_close(got, ref) for got, ref in zip(
        replay(tx, ta, tb, tc, sms=sms, terms=terms),
        t_ssd.ssd_chunk_ref(tx, ta, tb, tc))]
    seq = (b, nc * l)
    flat = lambda v: v.reshape(*seq, *v.shape[3:])
    yj, fj = j_ssd.ssd_chunked(*(jnp.asarray(flat(v)) for v in (x, a, bb, cc)),
                               chunk=l, return_final_state=True,
                               interpret=True)
    real = t_ssd.ssd_chunk
    t_ssd.ssd_chunk = lambda *v: replay(*v, sms=sms, terms=terms)
    try:
        yt, ft = t_ssd.ssd_chunked(*(torch.from_numpy(flat(v))
                                     for v in (x, a, bb, cc)),
                                   chunk=l, return_final_state=True)
    finally:
        t_ssd.ssd_chunk = real
    checks += [_close(yt, yj), _close(ft, fj)]
    return all(ok for ok, _ in checks), max(e for _, e in checks)


def test_tf32_split_rounds_as_cvt_rna():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -11 - 2 ** -23, -0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 4 * 2 ** -11,
                         -(1 + 2 ** -10), 1.0, -0.0])
    got = _tf32(x)
    assert torch.equal(got, want) and torch.equal(got.signbit(),
                                                  want.signbit())


def test_scan_equals_cumsum():
    a = -torch.rand((3, 5, 100), generator=torch.Generator().manual_seed(0))
    got = _scan(a, 112)
    torch.testing.assert_close(got[..., :100], torch.cumsum(a, -1),
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[..., 100:],
                               got[..., 99:100].expand(3, 5, 12),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("shape", CPU_SHAPES + MODEL_SHAPES[1:], ids=_ids)
def test_ssd_replay_3xtf32_equals_reference_kernel(shape, sms):
    """The 3xTF32 replay, at the table's heads a CTA on 132 SMs and on one
    (up to 8 heads a CTA), agrees with the plain version and with the
    reference's Pallas kernel (interpret mode) through the chunked SSD;
    one-pass TF32 does not."""
    ok, err = _against_reference(shape, TERMS3, sms)
    assert ok, err
    if sms == 1:
        ok, err = _against_reference(shape, ("bb",), sms)
        assert not ok, err


@pytest.mark.parametrize("variant", ["3xTF32", *LESS_PRECISE])
def test_ssd_tol_tells_3xtf32_from_fewer_products(variant):
    """``chip_smoke.SSD_TOL`` (the card's K14 limit beside ``TOL``) at
    ``chip_smoke.py``'s own ``SSD_SHAPES`` inputs (the card test's),
    y_diag and states each on its own: the 3xTF32 replay meets it at
    every entry held here; one-pass TF32 and each replay that drops one
    small part's product miss it at some entry."""
    terms = TERMS3 if variant == "3xTF32" else LESS_PRECISE[variant]
    worst = 0.0
    for shape in CPU_SHAPES:
        args = _CS.ssd_case_inputs(shape, torch.device("cpu"))
        for got, ref in zip(replay(*args, terms=terms)[:2],
                            t_ssd.ssd_chunk_ref(*args)[:2]):
            err = float((got - ref).abs().max())
            worst = max(worst, err / (_CS.SSD_TOL * float(ref.abs().max())
                                      + _CS.FLOOR))
    if variant == "3xTF32":
        assert worst <= 0.25, worst
    else:
        assert worst > 1, worst
