"""The launch tables of the split-K GEMM (K8) and the expert MLP forward
(K11) on the CPU, and their arithmetic replayed in plain torch against
the JAX reference's kernels in interpret mode.

K8 runs each of the reference's K splits as K4's ``mxu128`` CTAs over
that split's K range, cut again into inner splits where the (split,
tile) units do not cover the SMs (``matmul.ksplit_launch``): its split
count must be the reference's, its workspace the reference's
(splits, M, N) accounting, and each split's CTAs of a tile must cover
the split's K range once and in order.  K11 runs two launches of
128-row tiles (``grouped_matmul.experts_launch``): its tiles must cover
(rows x F) and (rows x D) once, and none may cross an M-block.  The
replays sum as the kernels do: K8's inner partials in split order into
the split's workspace slice, then the slices in split order; K11's
pre-activations per (row tile, F tile) on the tile's live rows, then
(h W_out) * sw per (row tile, D tile), zeros past the live rows.  They
are held to the reference's ``matmul_ksplit`` (through its algorithm
registry) and ``grouped_matmul_experts`` run with ``interpret=True``,
and at ragged K, which the reference does not take, to
``matmul_ksplit_ref``.

Inputs are made with numpy from a seed and handed to both packages, at
a few hundred rows and columns (every test here allocates a few MB).
Tolerance: rtol = atol = 1e-5 (float32; operands scaled so that each
product is of order 1).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import matmul as t_mm

# the modules, not the functions ``repro.kernels`` exports under their names
j_gmm = importlib.import_module("repro.kernels.grouped_matmul")
j_mm = importlib.import_module("repro.kernels.matmul")

torch.set_num_threads(2)

SMS = 132          # an H100 SXM's SMs
TOL = dict(rtol=1e-5, atol=1e-5)


def _load_chip_smoke(name):
    """The repository's ``chip_smoke.py`` as a module, ``sys.path`` left
    as it was (its import puts ``src/`` first)."""
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


_CS = _load_chip_smoke("_chip_smoke_ksplit_experts")

# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

# (M, K, N): the shapes the card holds K8 at, the GEMM zoo's, stem2's and
# stem1's one-tile dW and stem0's forward of a full-width training step
TABLE_SHAPES = list(_CS.KSPLIT_SHAPES) + [
    _CS.ZOO_GEMM, (576, 100352, 192), (64, 100352, 64), (100352, 147, 64),
    (147, 100352, 64)]


def test_stem2_dw_takes_seven_inner_splits_of_3584():
    la = t_mm.ksplit_launch(576, 192, 100352, SMS)
    assert (la["splits"], la["kref"], la["tiles"]) == (4, 25088, 10)
    assert (la["inner"], la["kper_in"], len(la["ctas"])) == (7, 3584, 280)


@pytest.mark.parametrize("sms", [SMS, 8])
@pytest.mark.parametrize("shape", TABLE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ksplit_table_covers_each_split_once_in_order(shape, sms):
    """The reference's split count and workspace; CTAs in launch order
    (m-block fastest, then n-block, split, inner split); each tile's
    inner CTAs of split s cut [s * kref, min(K, (s + 1) * kref)) in
    order; inner partials and counters sized for the launch."""
    m, k, n = shape
    la = t_mm.ksplit_launch(m, n, k, sms)
    splits, kref, inner = la["splits"], la["kref"], la["inner"]
    assert splits == t_mm.ksplit_splits(k)
    assert la["ws_bytes"] == j_mm.matmul_workspace_bytes("ksplit", m, n, k,
                                                         splits)
    if k % 128 == 0:
        # the reference's rule on whole 128-deep blocks
        assert (k // 128) % splits == 0 and kref == k // splits
    mb, nb = -(-m // 128), -(-n // 128)
    assert la["tiles"] == mb * nb
    want_inner = t_mm.split_plan(splits * mb * nb, kref, sms)
    assert (inner, la["kper_in"]) == want_inner
    ctas = la["ctas"]
    assert len(ctas) == splits * inner * mb * nb
    for idx, (s, mi, ni, i, lo, hi) in enumerate(ctas):
        assert idx == ((s * inner + i) * nb + ni) * mb + mi
        assert lo <= hi
    for s in range(splits):
        for mi in range(mb):
            for ni in range(nb):
                got = [ctas[((s * inner + i) * nb + ni) * mb + mi][4:]
                       for i in range(inner)]
                edge = s * kref
                for lo, hi in got:
                    assert lo == edge
                    edge = hi
                assert edge == min(k, (s + 1) * kref)
    assert la["counters"] == (splits + 1) * mb * nb
    assert la["part_bytes"] == (splits * mb * nb * inner * 128 * 128 * 4
                                if inner > 1 else 0)


def _ksplit_replay(x, y, sms):
    """K8's arithmetic from its table: per (split, tile) the inner
    partials summed in split order into ws[s], then ws summed in split
    order."""
    m, k = x.shape
    n = y.shape[1]
    la = t_mm.ksplit_launch(m, n, k, sms)
    ws = torch.zeros((la["splits"], m, n))
    acc: dict = {}
    for s, mi, ni, _, lo, hi in la["ctas"]:
        r = slice(mi * 128, (mi + 1) * 128)
        c = slice(ni * 128, (ni + 1) * 128)
        part = x[r, lo:hi] @ y[lo:hi, c]
        key = (s, mi, ni)
        acc[key] = part if key not in acc else acc[key] + part
        ws[s, r, c] = acc[key]
    out = ws[0]
    for s in range(1, la["splits"]):
        out = out + ws[s]
    return out


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * k ** -0.5).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    return x, y


# (M, K, N) with K a multiple of 128 x splits: 4 splits of one block,
# 4 of three, 3 of one, 1 of seven, 4 of eight (two inner splits of 512
# on an H100), and 4 of sixteen on an 8-SM card (four inner splits)
REF_CASES = [((128, 512, 128), SMS), ((256, 1536, 128), SMS),
             ((128, 384, 256), SMS), ((128, 896, 128), SMS),
             ((128, 4096, 256), SMS), ((128, 8192, 128), 8)]


@pytest.mark.parametrize("shape,sms", REF_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_ksplit_replay_equals_reference_kernel(shape, sms):
    m, k, n = shape
    x, y = _operands(m + k + n, m, k, n)
    if shape == (128, 4096, 256):
        assert t_mm.ksplit_launch(m, n, k, sms)["inner"] == 2
    if sms == 8:
        assert t_mm.ksplit_launch(m, n, k, sms)["inner"] == 4
    ref = j_mm.MATMUL_ALGORITHMS["ksplit"](jnp.asarray(x), jnp.asarray(y),
                                            interpret=True)
    got = _ksplit_replay(torch.from_numpy(x), torch.from_numpy(y), sms)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("sms", [SMS, 8])
@pytest.mark.parametrize("shape", [(70, 1000, 33), (100, 100, 100),
                                   (64, 200, 72), (130, 1300, 260)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ksplit_replay_at_ragged_k_equals_plain(shape, sms):
    """At ragged K (the last split short) and edges no tile divides,
    which the reference's kernel does not take."""
    m, k, n = shape
    x, y = (torch.from_numpy(a) for a in _operands(m * k + n, m, k, n))
    np.testing.assert_allclose(_ksplit_replay(x, y, sms).numpy(),
                               t_mm.matmul_ksplit_ref(x, y).numpy(), **TOL)


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------

# (MBS, bm, D, F, gated): reduced widths at bm 8 to 32, F off the tile,
# a block of two row tiles, and granite-moe-1b-a400m's layer 0 (16384
# slots over 32 experts at bm 128: 160 blocks)
LAUNCH_CASES = [(11, 8, 128, 64, True), (11, 16, 128, 64, False),
                (7, 32, 96, 80, True), (3, 256, 128, 200, False),
                (160, 128, 1024, 512, True), (160, 128, 1024, 512, False)]


@pytest.mark.parametrize("case", LAUNCH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_experts_tiles_cover_once_within_blocks(case):
    mbs, bm, d, f, gated = case
    la = t_gmm.experts_launch(mbs, bm, d, f, gated)
    rows = mbs * bm
    assert la["f_cols"] == (64 if gated else 128)
    for tiles, width, grid in ((la["in_tiles"], f, la["in_grid"]),
                               (la["out_tiles"], d, la["out_grid"])):
        assert len(tiles) == grid[0] * grid[1]
        assert grid[0] == len(la["row_tiles"]) == mbs * -(-bm // 128)
        cover = np.zeros((rows, width), np.int8)
        for b, r0, nr, c0, nc in tiles:
            assert 0 < nr <= 128 and 0 < nc
            assert b * bm <= r0 and r0 + nr <= (b + 1) * bm
            cover[r0:r0 + nr, c0:c0 + nc] += 1
        assert (cover == 1).all()
        # launch order: row tile fastest, then the column tile
        assert [t[:3] for t in tiles[:grid[0]]] == list(la["row_tiles"])
    assert la["ctas"] == len(la["in_tiles"]) + len(la["out_tiles"])


def _experts_replay(xp, swp, w_in, w_out, w_gate, counts, *, activation,
                    bm, train):
    """K11's arithmetic from its table: stage A per (row tile, F tile) on
    the tile's live rows (the rest exact zeros), stage B per (row tile,
    D tile), scaled by sw, zeros past the live rows."""
    e, d, f = w_in.shape
    rows = xp.shape[0]
    mbs = rows // bm
    la = t_gmm.experts_launch(mbs, bm, d, f, w_gate is not None)
    eid, valid = t_gmm._expert_block_meta(counts, mbs, bm).tolist()
    act = t_gmm._moe_act(activation)

    def live_rows(b, r0, nr):
        return max(0, min(nr, valid[b] - (r0 - b * bm)))

    hpost, hin = torch.zeros(rows, f), torch.zeros(rows, f)
    gate = torch.zeros(rows, f) if w_gate is not None else None
    for b, r0, nr, c0, nc in la["in_tiles"]:
        n = live_rows(b, r0, nr)
        x = xp[r0:r0 + n]
        pi = x @ w_in[eid[b]][:, c0:c0 + nc]
        hin[r0:r0 + n, c0:c0 + nc] = pi
        if gate is None:
            hpost[r0:r0 + n, c0:c0 + nc] = act(pi)
        else:
            pg = x @ w_gate[eid[b]][:, c0:c0 + nc]
            gate[r0:r0 + n, c0:c0 + nc] = pg
            hpost[r0:r0 + n, c0:c0 + nc] = act(pg) * pi
    y = torch.zeros(rows, d)
    for b, r0, nr, c0, nc in la["out_tiles"]:
        n = live_rows(b, r0, nr)
        y[r0:r0 + n, c0:c0 + nc] = (hpost[r0:r0 + n]
                                    @ w_out[eid[b]][:, c0:c0 + nc]) \
            * swp[r0:r0 + n, None]
    return (y, hin, gate) if train else y


def _packed(seed, *, e, d, f, bm, gated):
    """Tokens packed into block-aligned per-expert segments (zeros
    elsewhere, as the dispatch packs them): expert 1 gets no token, the
    others a partial last block, and dead tail blocks follow."""
    rng = np.random.default_rng(seed)
    n = 3 * e * bm
    share = rng.uniform(0.2, 1.0, size=e)
    share[1] = 0
    counts = np.floor(share / share.sum() * n * 0.9).astype(np.int32)
    mbs = t_gmm.moe_static_blocks(n, e, bm)
    offs = t_gmm.expert_row_offsets(torch.from_numpy(counts), bm).numpy()
    xp = np.zeros((mbs * bm, d), np.float32)
    swp = np.zeros((mbs * bm,), np.float32)
    for a, c in zip(offs, counts):
        xp[a:a + c] = rng.normal(size=(c, d))
        swp[a:a + c] = rng.uniform(0.1, 1.0, size=c)
    w_in = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    w_gate = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32) \
        if gated else None
    w_out = (rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32)
    return [xp, swp, w_in, w_out, w_gate, counts]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("bm", [8, 16, 32])
def test_experts_replay_equals_reference_kernel(bm, gated, act, train):
    """E 8, D 128, F 64: one 64-column F tile gated (W_in beside
    W_gate), a 128-column one ungated, at M-blocks of 8 to 32 rows."""
    args = _packed(bm + 3 * gated + train, e=8, d=128, f=64, bm=bm,
                   gated=gated)
    assert args[5][1] == 0
    ref = j_gmm.grouped_matmul_experts(
        *(None if a is None else jnp.asarray(a) for a in args),
        activation=act, train=train, bm=bm, interpret=True)
    got = _experts_replay(
        *(None if a is None else torch.from_numpy(a) for a in args),
        activation=act, bm=bm, train=train)
    if not train:
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
