"""The launch plans of the grouped backward-weight kernel (K7) and the
fused pair's kernel (K10) on the CPU, and their arithmetic replayed in
plain torch against the JAX reference's kernels in interpret mode.

K7 runs K5's dw entries alone: its table (``grouped_matmul._dw_tiles``)
must be the prefix of K5's (``_bwd_tiles``) at every branch set the
card holds it at and at a full-width training step's 18 K5 launches,
each dw tile's M ranges cutting [0, M) in split order.  K10 runs K4's
``mxu128`` launch of its GEMM beside z spread over the card
(``fused_branches.fused_launch``): its GEMM CTAs and splits must be K4's,
its z shares must cut [0, R) once in CTA order, and a one-tile GEMM must
spread z over more than 100 CTAs.  The replays sum as the kernels do —
K10's r per share, then the shares in CTA order; its c per split in
split order; K7's dw and db per table entry, the splits in split order
— and are held to the reference's ``fused_gemm_reduce`` and
``grouped_matmul_dw`` run with ``interpret=True``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance of the replays: rtol = atol = 2e-3 (float32 sums over up to
25088 rows, in another order than the reference's).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as j_ops
from repro_torch.configs.googlenet import CONFIG as T_FULL
from repro_torch.kernels import fused_branches as t_fused
from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import matmul as t_mm

# the module, not the function ``repro.kernels`` exports under its name
j_gmm = importlib.import_module("repro.kernels.grouped_matmul")

torch.set_num_threads(2)

SMS = 132          # an H100 SXM's SMs
REPLAY = dict(rtol=2e-3, atol=2e-3)


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


_CS = _load_chip_smoke("_chip_smoke_fused_dw")
# K10: the reference benchmark's pair and the cases the card holds K10 at,
# (M, K, N, R, C)
PAIR = _CS.FUSED_PAIR
FUSED_CASES = _CS.FUSED_CASES
ONE_TILE = (64, 1000, 64, 5000, 1024)
# K7: the reference's ragged branch sets, (K_g, N_g)
DW_SETS = _CS.DW_SETS


def _step_k5_launches(cfg, batch):
    """(M, K per branch, N per branch) of each K5 launch of a planned
    GoogLeNet training step: the backward of each module's pooled quad
    (the 1x1/r3/r5 bucket and the pool-proj, both over the module's
    input channels) and of its 3x3/5x5 pair (im2col depths)."""
    h, c = cfg.img[0], cfg.img[2]
    for _, out, stride in cfg.stem:
        h, c = -(-h // stride), out
    launches = []
    for i, mod in enumerate(cfg.modules):
        if i in cfg.pool_between:
            h = -(-h // 2)
        m = batch * h * h
        launches.append((m, (c, c), (mod.n1 + mod.r3 + mod.r5, mod.pp)))
        launches.append((m, (9 * mod.r3, 25 * mod.r5), (mod.n3, mod.n5)))
        c = mod.out
    return launches


STEP_K5 = _step_k5_launches(T_FULL, 8)
DW_LAUNCHES = [(m, tuple(k for k, _ in s), tuple(n for _, n in s))
               for s in DW_SETS for m in (_CS.DW_M, 25088)] + STEP_K5


def test_the_step_makes_18_k5_launches_up_to_25088_rows():
    assert len(STEP_K5) == 18
    assert max(m for m, _, _ in STEP_K5) == 25088
    assert {t_gmm.dw_launch(m, ks, ns, SMS)["splits"] > 1
            for m, ks, ns in STEP_K5} == {True}


@pytest.mark.parametrize("launch", DW_LAUNCHES,
                         ids=lambda v: f"{v[0]}-{v[1]}-{v[2]}")
def test_dw_table_is_k5_tables_dw_prefix(launch):
    """K7's table equals K5's dw entries entry for entry, with K5's
    split of M (``dw_launch`` is ``bwd_launch``'s dw half), and each dw
    tile's S entries cut [0, M) in split order."""
    m, ks, ns = launch
    dw = np.array(t_gmm._dw_tiles(m, ks, ns, SMS)).reshape(-1, 8)
    bwd = np.array(t_gmm._bwd_tiles(m, ks, ns, SMS)).reshape(-1, 8)
    plan, full = t_gmm.dw_launch(m, ks, ns, SMS), \
        t_gmm.bwd_launch(m, ks, ns, SMS)
    assert len(dw) == plan["ctas"] == plan["dw_tiles"] * plan["splits"]
    assert (bwd[:len(dw)] == dw).all() and (bwd[len(dw):, 0] == 0).all()
    assert (dw[:, 0] == 1).all()
    for key in ("dw_tiles", "splits", "kper", "ws_bytes"):
        assert full[key] == plan[key]
    assert full["ctas"] == plan["ctas"] + full["dx_tiles"]
    splits = plan["splits"]
    for e0 in range(0, len(dw), splits):
        tile = dw[e0:e0 + splits]
        assert (tile[:, 1:4] == tile[0, 1:4]).all()
        assert list(tile[:, 4]) == list(range(splits))
        assert (tile[:, 5] == splits).all()
        assert tile[0, 6] == 0 and tile[-1, 7] == m
        assert (tile[1:, 6] == tile[:-1, 7]).all()
    assert len({tuple(r) for r in dw[:, 1:4]}) == plan["dw_tiles"]


@pytest.mark.parametrize("case", [PAIR] + FUSED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_launch_is_k4s_gemm_beside_z_shares(case):
    """K10's GEMM CTAs and splits are K4 ``mxu128``'s; the shares cut
    [0, R) once in CTA order; P <= max(T, 2 x SMs); the workspace (K4's
    split partials, then P x C column sums) stays under the split cap."""
    m, k, n, r, c = case
    plan = t_fused.fused_launch(m, n, k, r, c, SMS)
    k4 = t_mm.matmul_launch(m, n, k, "mxu128", SMS)
    assert (plan["tiles"], plan["splits"], plan["kper"], plan["gemm_ctas"]) \
        == (k4["tiles"], k4["splits"], k4["kper"], k4["ctas"])
    p, t = plan["ctas"], plan["gemm_ctas"]
    assert t <= p <= max(t, t_fused.FUSED_Z_CTAS * SMS)
    shares = plan["shares"]
    assert len(shares) == p and shares[0][0] == 0 and shares[-1][1] == r
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert all(0 <= hi - lo <= plan["share"] for lo, hi in shares)
    assert plan["ws_bytes"] == k4["ws_bytes"] + p * c * 4
    assert plan["ws_bytes"] <= t_mm.SPLIT_WS_CAP


def test_fused_launch_spreads_a_tall_z_beside_one_tile():
    """The one-tile GEMM (split in two) beside a 5000 x 1024 z: z over
    more than 100 CTAs, all but the two GEMM CTAs streaming z alone;
    at the pair the 256 GEMM CTAs take z with 8 more."""
    m, k, n, r, c = ONE_TILE
    plan = t_fused.fused_launch(m, n, k, r, c, SMS)
    assert plan["gemm_ctas"] == 2 and plan["ctas"] > 100
    assert plan["ctas"] == min(2 * SMS, -(-r // t_fused.FUSED_ROWS_FLOOR))
    m, k, n, r, c = PAIR
    pair = t_fused.fused_launch(m, n, k, r, c, SMS)
    assert pair["gemm_ctas"] == 256 and pair["ctas"] == 2 * SMS


@pytest.mark.parametrize("r", [0, 1, 7])
def test_fused_launch_with_few_z_rows_adds_no_cta(r):
    plan = t_fused.fused_launch(300, 260, 70, r, 64, SMS)
    assert plan["ctas"] == plan["gemm_ctas"] == 9
    assert sum(hi - lo for lo, hi in plan["shares"]) == r


def _replay_fused(x, y, z, sms=SMS):
    """K10's arithmetic from its plan: c as K4's split partials summed in
    split order; r as each share's silu column sums (f32), the shares
    summed in CTA order."""
    m, k = x.shape
    n, (r, cz) = y.shape[1], z.shape
    plan = t_fused.fused_launch(m, n, k, r, cz, sms)
    xt, yt, zt = (torch.from_numpy(v) for v in (x, y, z))
    c = torch.zeros((m, n))
    for s in range(plan["splits"]):
        lo, hi = s * plan["kper"], min(k, (s + 1) * plan["kper"])
        c += xt[:, lo:hi] @ yt[lo:hi]
    out = torch.zeros(cz)
    for lo, hi in plan["shares"]:
        out += F.silu(zt[lo:hi]).sum(0)
    return c.numpy(), out.numpy()


@pytest.mark.parametrize("case", [(256, 256, 256, 8192, 128)] + FUSED_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_fused_replay_equals_reference_kernel(case):
    """The pair shrunk to 256^3 beside 8192 x 128 (z over 264 CTAs, as at
    the pair) and the card's cases, against the reference's Pallas
    kernel in interpret mode."""
    m, k, n, r, c = case
    rng = np.random.default_rng(sum(case))
    x, y, z = (rng.normal(size=s).astype(np.float32)
               for s in ((m, k), (k, n), (r, c)))
    if case[3:] == (8192, 128):
        assert t_fused.fused_launch(m, n, k, r, c, SMS)["ctas"] == 2 * SMS
    wc, wr = j_ops.fused_gemm_reduce(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(z), interpret=True)
    gc, gr = _replay_fused(x, y, z)
    np.testing.assert_allclose(gc, np.asarray(wc), **REPLAY)
    np.testing.assert_allclose(gr, np.asarray(wr), **REPLAY)


def _replay_dw(xs, dys, mask, sms=SMS):
    """K7's arithmetic from its table: dy masked (NaN masks to 0), each
    entry's dw^T tile and (k-block 0) db over its M range, the splits
    added in split order."""
    m = xs[0].shape[0]
    ks = [x.shape[1] for x in xs]
    ns = [dy.shape[1] for dy in dys]
    dym = [np.where(mk > 0, dy, 0).astype(np.float32) if mask is not None
           else dy for dy, mk in zip(dys, mask or dys)]
    dw = [np.zeros((k, n), np.float32) for k, n in zip(ks, ns)]
    db = [np.zeros((n,), np.float32) for n in ns]
    t = 128
    for _, g, i, j, _, _, lo, hi in \
            np.array(t_gmm._dw_tiles(m, ks, ns, sms)).reshape(-1, 8):
        rows, cols = slice(j * t, (j + 1) * t), slice(i * t, (i + 1) * t)
        dw[g][cols, rows] += xs[g][lo:hi, cols].T @ dym[g][lo:hi, rows]
        if i == 0:
            db[g][rows] += dym[g][lo:hi, rows].sum(0)
    return dw, db


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shapes", DW_SETS[:4] + [[(40, 16), (72, 130),
                                                     (9, 20)]],
                         ids=lambda s: "-".join(f"{k}x{n}" for k, n in s))
def test_dw_replay_equals_reference_kernel(shapes, masked):
    """At 1300 rows (M cut in 3 splits), masked by forward ReLU outputs
    with exact zeros and a NaN, against the reference's K7 in interpret
    mode."""
    m = 1300
    rng = np.random.default_rng(len(shapes) + 7 * masked)
    xs = [rng.normal(size=(m, k)).astype(np.float32) for k, _ in shapes]
    dys = [rng.normal(size=(m, n)).astype(np.float32) for _, n in shapes]
    ys = [np.maximum(rng.normal(size=(m, n)), 0).astype(np.float32)
          for _, n in shapes]
    ys[0][3, 5] = np.nan
    mask = ys if masked else None
    assert t_gmm.dw_launch(m, [k for k, _ in shapes],
                           [n for _, n in shapes], SMS)["splits"] == 3
    jdw, jdb = j_gmm.grouped_matmul_dw(
        [jnp.asarray(v) for v in xs], [jnp.asarray(v) for v in dys],
        None if mask is None else [jnp.asarray(v) for v in mask],
        interpret=True)
    dw, db = _replay_dw(xs, dys, mask)
    for got, want in zip(dw + db, list(jdw) + list(jdb)):
        np.testing.assert_allclose(got, np.asarray(want), **REPLAY)
