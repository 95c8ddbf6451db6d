"""The PyTorch port's training path on the CPU against the JAX reference:
K4's and K5's plain versions (what the wrappers take for CPU tensors),
the pool cotangent scatter, each autograd Function's gradients against
``jax.vjp`` of the reference's custom VJP, the train-time plans, the
data stream, one AdamW update, and reduced GoogLeNet's planned loss,
gradients and 3-step loss curve against ``jax.value_and_grad`` of the
reference (Pallas in interpret mode on this host), plus the trainer's
command line end to end.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32, rtol = atol = 1e-4 unless a test says otherwise —
the two sides sum in different orders.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.googlenet import CONFIG as J_FULL
from repro.configs.googlenet import reduced as j_reduced
from repro.data import Pipeline as JPipeline
from repro.data import SyntheticImages as JSyntheticImages
from repro.kernels import ops as j_ops
from repro.launch import steps as j_steps
from repro.models import cnn as j_cnn
from repro.optim import AdamW as JAdamW
from repro_torch.configs.googlenet import CONFIG as T_FULL
from repro_torch.configs.googlenet import reduced as t_reduced
from repro_torch.data import Pipeline as TPipeline
from repro_torch.data import SyntheticImages as TSyntheticImages
from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import cnn as t_cnn
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim import tree_leaves

j_gmm = importlib.import_module("repro.kernels.grouped_matmul")

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    j_ops.reset_launch_counts()
    t_rt.reset_launch_counts()


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .requires_grad_(grad)


def _np(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# K4: tiled GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a_t,b_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("m,k,n", [(100, 147, 64), (37, 5, 200),
                                   (64, 300, 1)])
def test_matmul_equals_reference(m, k, n, a_t, b_t):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    # a transposed operand is the .t() view of a row-major array
    tx = _t(x.T).t() if a_t else _t(x)
    ty = _t(y.T).t() if b_t else _t(y)
    assert t_mm._layout("matmul", tx) == (int(a_t), m if a_t else k) \
        or min(tx.shape) == 1
    want = _np(j_ops.matmul(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(t_mm.matmul(tx, ty).numpy(), want, **TOL)
    np.testing.assert_allclose(
        t_mm.matmul(tx, ty, algorithm="large_tile").numpy(),
        _np(j_ops.matmul(jnp.asarray(x), jnp.asarray(y),
                         algorithm="large_tile")), **TOL)


def test_matmul_rejects_ksplit_and_strided_operands():
    """ksplit (K8) is ported: its plain version equals the reference's
    ``ksplit`` on a ragged-K GEMM; an operand that is neither row-major
    nor transposed is still refused."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(70, 600)).astype(np.float32)
    y = rng.normal(size=(600, 33)).astype(np.float32)
    want = j_ops.matmul(jnp.asarray(x), jnp.asarray(y), algorithm="ksplit")
    got = t_mm.matmul(_t(x), _t(y), algorithm="ksplit")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    with pytest.raises(ValueError, match="row-major nor transposed"):
        t_mm._layout("matmul", torch.ones(8, 8)[::2, ::2])


# ---------------------------------------------------------------------------
# K5: combined backward launch
# ---------------------------------------------------------------------------

def _bwd_case(rng, m=70):
    ks, ns = (40, 72, 9), (16, 130, 20)
    xs = [rng.normal(size=(m, k)).astype(np.float32) for k in ks]
    ws = [rng.normal(size=(k, n)).astype(np.float32) * 0.2
          for k, n in zip(ks, ns)]
    dys = [rng.normal(size=(m, n)).astype(np.float32) for n in ns]
    # forward ReLU outputs: many exact zeros, one NaN
    ys = [np.maximum(rng.normal(size=(m, n)), 0).astype(np.float32)
          for n in ns]
    ys[1][3, 5] = np.nan
    return xs, ws, dys, ys


@pytest.mark.parametrize("masked", [False, True])
def test_grouped_matmul_bwd_ref_equals_reference(masked):
    xs, ws, dys, ys = _bwd_case(np.random.default_rng(11))
    mask = ys if masked else None
    jdx, jdw, jdb = j_gmm.grouped_matmul_bwd(
        [jnp.asarray(v) for v in xs], [jnp.asarray(v) for v in ws],
        [jnp.asarray(v) for v in dys],
        None if mask is None else [jnp.asarray(v) for v in mask],
        interpret=True)
    # cotangents and masks as column slices of joint buffers, read in place
    joint_dy = _t(np.concatenate(dys, axis=1))
    joint_y = _t(np.concatenate(ys, axis=1))
    offs = np.cumsum([0] + [d.shape[1] for d in dys])
    tdys = [joint_dy[:, o:o + d.shape[1]] for o, d in zip(offs, dys)]
    tmask = None if mask is None else \
        [joint_y[:, o:o + d.shape[1]] for o, d in zip(offs, dys)]
    tdx, tdw, tdb = t_gmm.grouped_matmul_bwd([_t(v) for v in xs],
                                             [_t(v) for v in ws], tdys,
                                             tmask)
    for got, want in zip(tdx + tdw + tdb, list(jdx) + list(jdw) + list(jdb)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_grouped_matmul_bwd_tile_table_covers_each_output_tile_once():
    """K5's table: the dw entries first, each dw tile's S consecutive
    entries cutting [0, M) into the ranges ``split_plan`` gives, in split
    order; every dx tile once, over all of M."""
    m, ks, ns, sms = 1300, (40, 200), (16, 65), 132
    rows = np.array(t_gmm._bwd_tiles(m, ks, ns, sms)).reshape(-1, 8)
    kinds = rows[:, 0]
    first_dx = int(np.argmax(kinds == 0))
    assert (kinds[:first_dx] == 1).all() and (kinds[first_dx:] == 0).all()
    t = 128
    dw_want = {(g, i, j) for g, (k, n) in enumerate(zip(ks, ns))
               for i in range(-(-k // t)) for j in range(-(-n // t))}
    dx_want = {(g, i, j) for g, k in enumerate(ks)
               for i in range(-(-m // t)) for j in range(-(-k // t))}
    splits, kper = t_mm.split_plan(len(dw_want), m, sms, tile_elems=t * t)
    assert splits == 3 and kper == 512
    dw = rows[:first_dx]
    assert len(dw) == len(dw_want) * splits
    seen = set()
    for e0 in range(0, len(dw), splits):
        tile = dw[e0:e0 + splits]
        key = tuple(tile[0, 1:4])
        assert (tile[:, 1:4] == key).all() and key not in seen
        seen.add(key)
        assert list(tile[:, 4]) == list(range(splits))
        assert (tile[:, 5] == splits).all()
        # the M ranges partition [0, M) in split order
        assert tile[0, 6] == 0 and tile[-1, 7] == m
        assert (tile[1:, 6] == tile[:-1, 7]).all()
        assert (tile[:-1, 7] - tile[:-1, 6] == kper).all()
    assert seen == dw_want
    dx = rows[first_dx:]
    assert {tuple(r[1:4]) for r in dx} == dx_want and len(dx) == len(dx_want)
    assert (dx[:, 4:] == [0, 1, 0, m]).all()
    launch = t_gmm.bwd_launch(m, ks, ns, sms)
    assert launch["ctas"] == len(rows) and launch["splits"] == splits
    # a deep enough group with few dw tiles is cut toward two waves
    big = np.array(t_gmm._bwd_tiles(25088, (864, 400), (128, 32), sms))
    big = big.reshape(-1, 8)
    assert t_gmm.bwd_launch(25088, (864, 400), (128, 32), sms)["splits"] \
        == big[0, 5] == 24
    assert int((big[:, 0] == 1).sum()) == 11 * 24 >= 2 * sms


# the six K4 calls of a full-width GoogLeNet training step (stem0's im2col
# forward, and the GEMM-view backward of stem0, stem1 and stem2), (M, N, K)
# and (splits, depth) at 132 SMs: the dX GEMMs and the forward have
# thousands of 128 x 128 tiles and take no split; the dW GEMMs contract
# over 8 x 112 x 112 rows into 1 to 10 tiles
STEM_CALLS = [((100352, 64, 147), (1, 147)),
              ((147, 64, 100352), (131, 768)),
              ((100352, 64, 64), (1, 64)),
              ((64, 64, 100352), (196, 512)),
              ((100352, 576, 192), (1, 192)),
              ((576, 192, 100352), (27, 3728))]


@pytest.mark.parametrize("shape,want", STEM_CALLS,
                         ids=lambda v: "x".join(map(str, v)))
def test_split_plan_at_the_stem_calls(shape, want):
    m, n, k = shape
    launch = t_mm.matmul_launch(m, n, k, "mxu128", 132)
    assert (launch["splits"], launch["kper"]) == want
    if launch["tiles"] >= 132:
        assert launch["splits"] == 1 and launch["ws_bytes"] == 0
    else:
        assert launch["ctas"] >= 132


@pytest.mark.parametrize("sms", [1, 16, 132])
@pytest.mark.parametrize("tile_elems", [128 * 128, 256 * 128, 1 << 22])
def test_split_plan_caps_hold(sms, tile_elems):
    """Over a grid of tile counts and depths: no split where the tiles
    cover the SMs or the depth is one minimum split; otherwise whole
    16-deep splits, none below the minimum depth (but the last), that
    cover the depth exactly, within the workspace cap, and reaching about
    two waves unless the minimum depth or the cap stops them."""
    for tiles in (1, 2, 7, 10, 64, 131, 132, 500):
        for depth in (0, 100, 512, 513, 2000, 25088, 100352, 10 ** 7):
            splits, kper = t_mm.split_plan(tiles, depth, sms,
                                           tile_elems=tile_elems)
            if tiles >= sms or depth <= t_mm.SPLIT_MIN_DEPTH:
                assert (splits, kper) == (1, depth)
                continue
            if splits == 1:
                assert kper == depth
                continue
            assert kper % t_mm.SPLIT_BK == 0
            assert kper >= t_mm.SPLIT_MIN_DEPTH
            assert (splits - 1) * kper < depth <= splits * kper
            assert splits * tiles * tile_elems * 4 <= t_mm.SPLIT_WS_CAP
            # the depth rounds up to whole k-steps: one split short of
            # two waves at most
            assert tiles * (splits + 1) >= t_mm.SPLIT_WAVES * sms \
                or kper == t_mm.SPLIT_MIN_DEPTH \
                or (splits + 1) * tiles * tile_elems * 4 \
                > t_mm.SPLIT_WS_CAP


def _split_matmul(x, y, sms):
    """The K4 kernel's arithmetic in plain numpy (f32): one partial per
    split of K from ``matmul_launch``, summed in split order."""
    m, k = x.shape
    plan = t_mm.matmul_launch(m, y.shape[1], k, "mxu128", sms)
    acc = np.zeros((m, y.shape[1]), np.float32)
    for s in range(plan["splits"]):
        a, b = s * plan["kper"], min(k, (s + 1) * plan["kper"])
        acc = acc + x[:, a:b] @ y[a:b]
    return plan["splits"], acc


@pytest.mark.parametrize("m,n,k", [(64, 64, 3000), (147, 64, 2100),
                                   (200, 70, 1000)])
def test_split_order_sum_equals_reference_matmul(m, n, k):
    rng = np.random.default_rng(m + n + k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    y = rng.normal(size=(k, n)).astype(np.float32)
    splits, got = _split_matmul(x, y, 132)
    assert splits > 1
    want = _np(j_ops.matmul(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def _split_gmm_bwd(xs, ws, dys, mask, sms):
    """The K5 kernel's arithmetic in plain numpy (f32) from its table:
    dy masked, dx per dx tile, dw and db per dw entry over its M range,
    the split partials summed in split order."""
    m = xs[0].shape[0]
    ks = [w.shape[0] for w in ws]
    ns = [w.shape[1] for w in ws]
    dym = [np.where(mk > 0, dy, 0).astype(np.float32) if mask is not None
           else dy for dy, mk in zip(dys, mask or dys)]
    dx = [np.zeros((m, k), np.float32) for k in ks]
    dw = [np.zeros((k, n), np.float32) for k, n in zip(ks, ns)]
    db = [np.zeros((n,), np.float32) for n in ns]
    t = 128
    for kind, g, i, j, s, _, lo, hi in \
            np.array(t_gmm._bwd_tiles(m, ks, ns, sms)).reshape(-1, 8):
        if kind == 0:
            dx[g][i * t:(i + 1) * t, j * t:(j + 1) * t] = \
                dym[g][i * t:(i + 1) * t] @ ws[g][j * t:(j + 1) * t].T
            continue
        rows, cols = slice(j * t, (j + 1) * t), slice(i * t, (i + 1) * t)
        dw[g][cols, rows] += xs[g][lo:hi, cols].T @ dym[g][lo:hi, rows]
        if i == 0:
            db[g][rows] += dym[g][lo:hi, rows].sum(0)
    return dx, dw, db


@pytest.mark.parametrize("masked", [False, True])
def test_split_order_sum_equals_reference_grouped_matmul_bwd(masked):
    xs, ws, dys, ys = _bwd_case(np.random.default_rng(13), m=1300)
    mask = ys if masked else None
    assert t_gmm.bwd_launch(1300, [w.shape[0] for w in ws],
                            [w.shape[1] for w in ws], 132)["splits"] == 3
    jdx, jdw, jdb = j_gmm.grouped_matmul_bwd(
        [jnp.asarray(v) for v in xs], [jnp.asarray(v) for v in ws],
        [jnp.asarray(v) for v in dys],
        None if mask is None else [jnp.asarray(v) for v in mask],
        interpret=True)
    got = _split_gmm_bwd(xs, ws, dys, mask, 132)
    for g_, w_ in zip(sum(got, []), list(jdx) + list(jdw) + list(jdb)):
        np.testing.assert_allclose(g_, _np(w_), rtol=2e-3, atol=2e-3)


def _step_launches(cfg, batch):
    """(wrapper, M, K per branch, N per branch) of each K2 and K1 launch
    of a planned GoogLeNet training step, from its config: per module the
    pooled quad (the 1x1/r3/r5 bucket, then the pool-proj) and the
    3x3/5x5 pair (im2col depths)."""
    h, c = cfg.img[0], cfg.img[2]
    for _, out, stride in cfg.stem:
        h, c = -(-h // stride), out
    launches = []
    for i, mod in enumerate(cfg.modules):
        if i in cfg.pool_between:
            h = -(-h // 2)
        m = batch * h * h
        launches.append(("grouped_matmul_pooled", m, (c, c),
                         (mod.n1 + mod.r3 + mod.r5, mod.pp)))
        launches.append(("grouped_matmul_concat", m,
                         (9 * mod.r3, 25 * mod.r5), (mod.n3, mod.n5)))
        c = mod.out
    return launches


def test_step_launches_are_the_planned_steps_launches():
    """``_step_launches`` names, in order, the K1 and K2 launches a
    reduced planned forward makes; the pooled branches of each quad
    reach K2 as 9 strided (B, OH, OW, K) views of one padded input."""
    cfg = t_reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True)
    params = t_cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn((2,) + cfg.img, generator=torch.Generator().manual_seed(1))
    seen, real = [], {}
    for name in ("grouped_matmul_pooled", "grouped_matmul_concat"):
        real[name] = getattr(t_gmm, name)

        def rec(*a, _name=name, **k):
            seen.append((_name, a))
            return real[_name](*a, **k)
        setattr(t_gmm, name, rec)
    try:
        t_cnn.forward_plan(params, cfg, x, plan)
    finally:
        for name, fn in real.items():
            setattr(t_gmm, name, fn)
    got = []
    for name, (xs, ws) in ((n, a[:2]) for n, a in seen):
        got.append((name, t_gmm._lhs_shape(name, xs[0])[0],
                    tuple(w.shape[0] for w in ws),
                    tuple(w.shape[1] for w in ws)))
        for taps in (x for x in xs if isinstance(x, tuple)):
            assert len(taps) == 9 and taps[0].dim() == 4
            assert len({t.untyped_storage().data_ptr() for t in taps}) == 1
            assert not taps[0].is_contiguous()
    assert got == _step_launches(cfg, 2)
    assert sum(isinstance(x, tuple) for n, a in seen for x in a[0]) == 2


FULL_STEP = _step_launches(T_FULL, 8)
SERVE_B1 = _step_launches(T_FULL, 1)


@pytest.mark.parametrize("launch", FULL_STEP + SERVE_B1 + [
    ("ragged", 196, (1440, 800), (320, 128), 30)],
    ids=lambda v: "-".join(map(str, v[1:])))
def test_fwd_tile_table_covers_each_output_tile_once(launch):
    """K1/K2's table at the full-width step's 18 launches and serve bucket
    1's: every (branch, m-block, n-block) of the rows below m_valid once,
    its S entries consecutive and in split order over depths that cut
    [0, K_g) in whole k-steps; a split only when the tiles do not cover
    the SMs; the workspace under ``SPLIT_WS_CAP``."""
    _, m, ks, ns, *mv = launch
    m_lim, sms, t = (mv[0] if mv else m), 132, 128
    rows = np.array(t_gmm._fwd_tiles(m_lim, ks, ns, sms)).reshape(-1, 7)
    plan = t_gmm.fwd_launch(m_lim, ks, ns, sms)
    want = {(g, i, j) for g, n in enumerate(ns)
            for i in range(-(-m_lim // t)) for j in range(-(-n // t))}
    assert plan["tiles"] == len(want) and plan["ctas"] == len(rows)
    seen = set()
    e = 0
    while e < len(rows):
        g, i, j, _, splits, _, _ = rows[e]
        tile = rows[e:e + splits]
        assert (tile[:, :3] == (g, i, j)).all() and (g, i, j) not in seen
        seen.add((g, i, j))
        assert list(tile[:, 3]) == list(range(splits))
        assert (tile[:, 4] == splits).all() and splits == plan["splits"][g]
        assert tile[0, 5] == 0 and tile[-1, 6] == ks[g]
        assert (tile[1:, 5] == tile[:-1, 6]).all()
        assert ((tile[:-1, 6] - tile[:-1, 5]) % t_mm.SPLIT_BK == 0).all()
        e += splits
    assert seen == want
    if plan["tiles"] >= sms:
        assert max(plan["splits"]) == 1 and plan["ws_bytes"] == 0
    assert plan["ws_bytes"] <= t_mm.SPLIT_WS_CAP
    if max(plan["splits"]) > 1:
        assert plan["ws_bytes"] == len(rows) * t * t * 4


def test_fwd_launch_splits_the_launches_of_few_tiles():
    """A training step splits only the 14 x 14 modules' launches (1568
    rows: 52-78 tiles, fewer than the 132 SMs); at serve bucket 1 every
    launch deeper than one split splits, inc7's quad 832 deep into 512 +
    320, its pair 1440 and 800 deep into 3 and 2."""
    def splits(launches):
        return {(m, ks): t_gmm.fwd_launch(m, ks, ns, 132)["splits"]
                for _, m, ks, ns in launches}
    step = splits(FULL_STEP)
    assert {k for k, v in step.items() if max(v) > 1} \
        == {k for k in step if k[0] == 1568}
    b1 = splits(SERVE_B1)
    assert all(max(v) > 1 for k, v in b1.items()
               if max(k[1]) > t_mm.SPLIT_MIN_DEPTH)
    assert b1[(196, (832, 832))] == (2, 2)
    assert b1[(196, (1440, 800))] == (3, 2)


def _split_gmm_fwd(lhs, ws, bs, m_valid, sms):
    """The K1/K2 kernel's arithmetic in plain numpy (f32) from its table:
    each pooled lhs folded, a partial per entry over its depth range,
    the partials of a tile summed in split order, then bias, ReLU and the
    row limit."""
    m = lhs[0].shape[0]
    ks = [w.shape[0] for w in ws]
    ns = [w.shape[1] for w in ws]
    m_lim = m if m_valid is None else m_valid
    outs = [np.zeros((m, n), np.float32) for n in ns]
    t = 128
    part = {}
    for g, i, j, s, _, lo, hi in \
            np.array(t_gmm._fwd_tiles(m_lim, ks, ns, sms)).reshape(-1, 7):
        r, c = slice(i * t, (i + 1) * t), slice(j * t, (j + 1) * t)
        p = lhs[g][r, lo:hi] @ ws[g][lo:hi, c]
        part[(g, i, j)] = p if s == 0 else part[(g, i, j)] + p
    for (g, i, j), acc in part.items():
        rr = np.arange(i * t, min((i + 1) * t, m))
        y = np.maximum(acc + bs[g][j * t:(j + 1) * t], 0)
        y[rr >= m_lim] = 0
        outs[g][i * t:(i + 1) * t, j * t:(j + 1) * t] = y
    return outs


@pytest.mark.parametrize("m_valid", [None, 25])
def test_split_order_sum_equals_reference_grouped_matmul_pooled(m_valid):
    """One M-block, a 9-tap pooled branch 1100 deep and a dense one 700
    deep: split in three and two at 132 SMs."""
    rng = np.random.default_rng(31)
    img = rng.normal(size=(1, 5, 8, 1100)).astype(np.float32)
    dense = rng.normal(size=(40, 700)).astype(np.float32)
    ws = [rng.normal(size=(1100, 70)).astype(np.float32) * 0.05,
          rng.normal(size=(700, 20)).astype(np.float32) * 0.05]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in (70, 20)]
    assert t_gmm.fwd_launch(40 if m_valid is None else m_valid, (1100, 700),
                            (70, 20), 132)["splits"] == (3, 2)
    jtaps = tuple(t.reshape(-1, 1100) for t in
                  j_ops.pool_tap_views(jnp.asarray(img), ((3, 1),)))
    jys = j_gmm.grouped_matmul_pooled(
        [jtaps, jnp.asarray(dense)], [jnp.asarray(v) for v in ws],
        [jnp.asarray(v) for v in bs], relu=True, m_valid=m_valid,
        interpret=True)
    ttaps = t_gmm.pool_tap_views(_t(img), ((3, 1),))
    pooled = t_gmm.pool_from_taps(ttaps).reshape(-1, 1100).numpy()
    got = _split_gmm_fwd([pooled, dense], ws, bs, m_valid, 132)
    rows = 40 if m_valid is None else m_valid
    for g_, w_ in zip(got, jys):
        np.testing.assert_allclose(g_[:rows], _np(w_)[:rows], rtol=2e-3,
                                   atol=2e-3)
        assert not g_[rows:].any()


def test_pooled_view_taps_gradients_equal_reference():
    """``ops.grouped_matmul_pooled`` on the plan's tap form — 9 strided
    (B, OH, OW, K) views of the padded input, saved as they are — against
    ``_pooled_vjp`` on (M, K) taps: outputs, and the gradients of the raw
    input (through the views), the weights and the biases."""
    rng = np.random.default_rng(41)
    img = rng.normal(size=(2, 7, 6, 12)).astype(np.float32)
    x1 = rng.normal(size=(2 * 4 * 3, 20)).astype(np.float32)
    ws = [rng.normal(size=(12, 24)).astype(np.float32) * 0.3,
          rng.normal(size=(20, 9)).astype(np.float32) * 0.3]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in (24, 9)]
    cts = [rng.normal(size=(24, n)).astype(np.float32) for n in (24, 9)]
    chain = ((3, 2),)

    def jf(img_, x1_, ws_, bs_):
        taps = tuple(t.reshape(-1, 12)
                     for t in j_ops.pool_tap_views(img_, chain))
        return j_ops.grouped_matmul_pooled([taps, x1_], ws_, bs_, relu=True)
    jys, vjp = jax.vjp(jf, jnp.asarray(img), jnp.asarray(x1),
                       [jnp.asarray(v) for v in ws],
                       [jnp.asarray(v) for v in bs])
    jg = vjp(tuple(jnp.asarray(c) for c in cts))

    timg, tx1 = _t(img, True), _t(x1, True)
    tws = [_t(v, True) for v in ws]
    tbs = [_t(v, True) for v in bs]
    taps = tuple(t_gmm.pool_tap_views(timg, chain))
    assert taps[0].shape == (2, 4, 3, 12) and not taps[0].is_contiguous()
    tys = t_ops.grouped_matmul_pooled([taps, tx1], tws, tbs, relu=True)
    for y, jy in zip(tys, jys):
        np.testing.assert_allclose(y.detach().numpy(), _np(jy), **TOL)
    tg = torch.autograd.grad(tys, [timg, tx1] + tws + tbs,
                             [_t(c) for c in cts])
    for g, w in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_pool_cotangent_taps_equals_reference_on_ties_and_nan():
    rng = np.random.default_rng(5)
    taps = [np.maximum(rng.normal(size=(30, 7)), 0).astype(np.float32)
            for _ in range(9)]                    # ReLU zeros: many ties
    taps[4][2, 3] = np.nan
    taps[0][5, :] = 0.0
    d = rng.normal(size=(30, 7)).astype(np.float32)
    jt = [jnp.asarray(v) for v in taps]
    jp = j_gmm.pool_from_taps(jt)
    want = j_gmm.pool_cotangent_taps(jt, jp, jnp.asarray(d))
    tt = [_t(v) for v in taps]
    tp = t_gmm.pool_from_taps(tt)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    got = t_gmm.pool_cotangent_taps(tt, tp, _t(d))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


# ---------------------------------------------------------------------------
# autograd Functions against jax.vjp of the reference custom VJPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pooled", [True, False])
def test_grouped_function_gradients_equal_reference(pooled):
    """``grouped_matmul_pooled`` (branch 0 pooled from 9 taps) against
    ``_pooled_vjp``, and ``grouped_matmul`` (no pooled branch) against
    ``_grouped_vjp``."""
    rng = np.random.default_rng(21)
    m, t = 48, 9 if pooled else 1
    taps = [np.maximum(rng.normal(size=(m, 12)), 0).astype(np.float32)
            for _ in range(t)]
    x1 = rng.normal(size=(m, 20)).astype(np.float32)
    ws = [rng.normal(size=(12, 24)).astype(np.float32) * 0.3,
          rng.normal(size=(20, 70)).astype(np.float32) * 0.3]
    bs = [rng.normal(size=(24,)).astype(np.float32),
          rng.normal(size=(70,)).astype(np.float32)]
    cts = [rng.normal(size=(m, 24)).astype(np.float32),
           rng.normal(size=(m, 70)).astype(np.float32)]
    j_fn = j_ops.grouped_matmul_pooled if pooled else j_ops.grouped_matmul
    t_fn = t_ops.grouped_matmul_pooled if pooled else t_ops.grouped_matmul

    def jf(taps_, x1_, ws_, bs_):
        x0 = tuple(taps_) if pooled else taps_[0]
        return j_fn([x0, x1_], ws_, bs_, relu=True)
    jys, vjp = jax.vjp(jf, [jnp.asarray(v) for v in taps], jnp.asarray(x1),
                       [jnp.asarray(v) for v in ws],
                       [jnp.asarray(v) for v in bs])
    jg = vjp(tuple(jnp.asarray(c) for c in cts))

    ttaps = [_t(v, True) for v in taps]
    tx1 = _t(x1, True)
    tws = [_t(v, True) for v in ws]
    tbs = [_t(v, True) for v in bs]
    tys = t_fn([tuple(ttaps) if pooled else ttaps[0], tx1], tws, tbs,
               relu=True)
    for y, jy in zip(tys, jys):
        np.testing.assert_allclose(y.detach().numpy(), _np(jy), **TOL)
    leaves = ttaps + [tx1] + tws + tbs
    tg = torch.autograd.grad(tys, leaves, [_t(c) for c in cts])
    for g, w in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_concat_function_gradients_equal_reference():
    rng = np.random.default_rng(23)
    m, ks, ns = 40, (30, 18), (24, 10)
    xs = [rng.normal(size=(m, k)).astype(np.float32) for k in ks]
    ws = [rng.normal(size=(k, n)).astype(np.float32) * 0.3
          for k, n in zip(ks, ns)]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in ns]
    pt = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)   # m = 2*4*5
    offsets, pt_off, total = [6, 30], 0, 40
    ct = rng.normal(size=(m, total)).astype(np.float32)

    def jf(xs_, ws_, bs_, pt_):
        y = j_ops.grouped_matmul_concat(xs_, ws_, bs_, offsets=offsets,
                                        total=total, relu=True)
        return y.at[:, pt_off:pt_off + 6].set(pt_.reshape(m, 6))
    jy, vjp = jax.vjp(jf, [jnp.asarray(v) for v in xs],
                      [jnp.asarray(v) for v in ws],
                      [jnp.asarray(v) for v in bs], jnp.asarray(pt))
    jg = vjp(jnp.asarray(ct))

    txs = [_t(v, True) for v in xs]
    tws = [_t(v, True) for v in ws]
    tbs = [_t(v, True) for v in bs]
    tpt = _t(pt, True)
    ty = t_ops.grouped_matmul_concat(txs, tws, tbs, offsets=offsets,
                                     total=total, relu=True,
                                     passthrough=[tpt], pt_offsets=[pt_off])
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **TOL)
    tg = torch.autograd.grad(ty, txs + tws + tbs + [tpt], _t(ct))
    for g, w in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


@pytest.mark.parametrize("alg,k,stride", [("direct", 3, 1), ("direct", 3, 2),
                                          ("im2col_gemm", 3, 1),
                                          ("im2col_gemm", 7, 2),
                                          ("direct", 1, 1),
                                          ("im2col_gemm", 1, 1)])
def test_conv_alg_gradients_equal_reference(alg, k, stride):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32) * 0.3
    b = rng.normal(size=(6,)).astype(np.float32) * 0.1
    oh = -(-9 // stride)
    ct = rng.normal(size=(2, oh, oh, 6)).astype(np.float32)
    jy, vjp = jax.vjp(
        lambda x_, w_, b_: j_cnn.conv(x_, w_, b_, stride=stride,
                                      algorithm=alg, interpret=True),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jdx, jdw, jdb = vjp(jnp.asarray(ct))
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    ty = t_cnn.conv(tx, tw, tb, stride=stride, algorithm=alg)
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), **TOL)
    dx, dw, db = torch.autograd.grad(ty, (tx, tw, tb), _t(ct))
    for g, want in ((dx, jdx), (dw, jdw), (db, jdb)):
        np.testing.assert_allclose(g.numpy(), _np(want), **TOL)
    # an input that needs no gradient (the network's images): dw only
    t_rt.reset_launch_counts()
    (dw2,) = torch.autograd.grad(
        t_cnn.conv(_t(x), tw, tb, stride=stride, algorithm=alg), (tw,),
        _t(ct))
    np.testing.assert_allclose(dw2.numpy(), _np(jdw), **TOL)


# ---------------------------------------------------------------------------
# train-time plans
# ---------------------------------------------------------------------------

CFGS = {"full": (J_FULL, T_FULL), "reduced": (j_reduced(), t_reduced())}


def _rows(plan):
    return [(g.mode, g.ops, g.algorithms, g.join, g.pools, g.chain, g.reason)
            for g in plan.groups]


@pytest.mark.parametrize("batch", [1, 2, 4, 8])
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_train_plan_equals_reference(which, batch):
    jcfg, tcfg = CFGS[which]
    jplan, jsch = j_cnn.plan_cnn(jcfg, batch, train=True)
    tplan, tsch = t_cnn.plan_cnn(tcfg, batch, train=True)
    assert _rows(tplan) == _rows(jplan)
    assert [(g.ops, g.algorithms, g.serialized) for g in tsch.groups] == \
        [(g.ops, g.algorithms, g.serialized) for g in jsch.groups]
    for tp, jp in ((tplan, jplan), (tplan.context["backward"],
                                    jplan.context["backward"])):
        for tg, jg in zip(tp.groups, jp.groups):
            assert tg.modeled_time == pytest.approx(jg.modeled_time,
                                                    rel=1e-9)
        assert tp.makespan == pytest.approx(jp.makespan, rel=1e-9)
    assert _rows(tplan.context["backward"]) == \
        _rows(jplan.context["backward"])
    for tg, jg in zip(tsch.groups, jsch.groups):
        assert tg.time == pytest.approx(jg.time, rel=1e-9)
    if which == "full" and batch == 1:
        # the train pricing packs inc8's 3x3/5x5 pair where serving does not
        assert _rows(tplan) != _rows(t_cnn.plan_cnn(tcfg, 1)[0])


def test_chained_serving_plan_carries_the_reference_backward_plan():
    jplan, _ = j_cnn.plan_cnn(J_FULL, 2, chain_modules=True)
    tplan, _ = t_cnn.plan_cnn(T_FULL, 2, chain_modules=True)
    jb, tb = jplan.context["backward"], tplan.context["backward"]
    assert _rows(tb) == _rows(jb)
    assert tb.makespan == pytest.approx(jb.makespan, rel=1e-9)


# ---------------------------------------------------------------------------
# data and optimizer
# ---------------------------------------------------------------------------

def test_synthetic_images_bit_equal_reference():
    js = JSyntheticImages((32, 32, 3), 10, 4, seed=3)
    ts = TSyntheticImages((32, 32, 3), 10, 4, seed=3)
    jp, tp = JPipeline(js), TPipeline(ts)
    for _ in range(3):
        jb, tb = next(jp), next(tp)
        for k in ("images", "labels"):
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(
        ts.batch_at(7, host_index=1, host_count=2)["images"],
        js.batch_at(7, host_index=1, host_count=2)["images"])


def test_adamw_updates_equal_reference():
    rng = np.random.default_rng(9)
    tree = {"a": [{"w": rng.normal(size=(5, 3)), "b": rng.normal(size=(3,))}],
            "z": {"w": rng.normal(size=(4,))}}
    grads = [jax.tree.map(lambda v: rng.normal(size=np.shape(v)) * 2, tree)
             for _ in range(2)]
    cast = lambda t, f: jax.tree.map(  # noqa: E731
        lambda v: f(np.asarray(v, np.float32)), t)
    jopt = JAdamW(lr=1e-2, warmup=2, total=10)
    topt = TAdamW(lr=1e-2, warmup=2, total=10)
    jparams, tparams = cast(tree, jnp.asarray), cast(tree, _t)
    jst, tst = jopt.init(jparams), topt.init(tparams)
    for g in grads:       # the second update exercises bias correction
        jparams, jst, jinfo = jopt.update(cast(g, jnp.asarray), jst, jparams)
        tparams, tst, tinfo = topt.update(cast(g, _t), tst, tparams)
        assert tinfo["lr"] == pytest.approx(float(jinfo["lr"]), rel=1e-6)
        assert float(tinfo["grad_norm"]) == pytest.approx(
            float(jinfo["grad_norm"]), rel=1e-6)
        for tv, jv in zip(tree_leaves([tparams, tst["m"], tst["v"]]),
                          jax.tree.leaves([jparams, jst["m"], jst["v"]])):
            np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6,
                                       atol=1e-6)
    assert tst["step"] == int(jst["step"]) == 2


# ---------------------------------------------------------------------------
# reduced googlenet, planned, against the reference
# ---------------------------------------------------------------------------

STEPS = 3


@pytest.fixture(scope="module")
def reference_run():
    """The reference's planned training, batch 2, seed 0: step-1 loss and
    gradients and the 3-step loss curve (one jitted step, compiled once),
    and the initial parameters as numpy."""
    cfg = j_reduced()
    params = j_cnn.init_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    plan, _ = j_cnn.plan_cnn(cfg, 2, train=True)
    opt = dataclasses.replace(j_steps.make_optimizer(cfg), lr=1e-3,
                              total=STEPS, warmup=1)

    def step(p, st, batch):
        (loss, _), grads = jax.value_and_grad(
            j_cnn.loss_fn, has_aux=True)(p, cfg, batch, plan=plan)
        new_p, new_st, _ = opt.update(grads, st, p)
        return new_p, new_st, loss, grads

    fn = jax.jit(step)
    st = opt.init(params)
    pipe = JPipeline(JSyntheticImages(cfg.img, cfg.num_classes, 2, seed=0))
    losses, grads0 = [], None
    for i in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in next(pipe).items()}
        params, st, loss, grads = fn(params, st, batch)
        losses.append(float(loss))
        if i == 0:
            grads0 = jax.tree.leaves(grads)
    return init, losses, grads0


def _port_setup(init):
    cfg = t_reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True)
    params = t_cnn.params_from_jax(init, device="cpu")
    return cfg, plan, params


def test_reduced_planned_loss_and_gradients_equal_reference(reference_run):
    init, losses, jgrads = reference_run
    cfg, plan, params = _port_setup(init)
    batch = TPipeline(TSyntheticImages(cfg.img, cfg.num_classes, 2,
                                       seed=0)).source.batch_at(0)
    loss, grads = t_steps.cnn_loss_and_grads(
        params, cfg, t_steps.to_device_batch(batch, "cpu"), plan=plan)
    assert float(loss) == pytest.approx(losses[0], rel=1e-4)
    tg = tree_leaves(grads)
    assert len(tg) == len(jgrads)
    for g, w in zip(tg, jgrads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_reduced_planned_loss_curve_tracks_reference(reference_run):
    init, losses, _ = reference_run
    cfg, plan, params = _port_setup(init)
    opt = dataclasses.replace(t_steps.make_optimizer(cfg), lr=1e-3,
                              total=STEPS, warmup=1)
    step = t_steps.make_cnn_train_step(cfg, opt, plan=plan, device="cpu")
    st = opt.init(params)
    pipe = TPipeline(TSyntheticImages(cfg.img, cfg.num_classes, 2, seed=0))
    got = []
    for _ in range(STEPS):
        params, st, metrics = step(params, st, next(pipe))
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, losses, rtol=1e-4)


def test_train_cli_runs_end_to_end_on_the_cpu(capsys):
    rc = t_train.main(["--arch", "googlenet", "--reduced", "--device", "cpu",
                       "--steps", "2", "--batch", "2", "--plan",
                       "concurrent", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[train] plan: modes={'serial': 2, 'grouped_pooled': 2, " \
        "'grouped_concat': 2}" in out
    assert out.count("ms/step") == 2 and "[train] done. loss" in out
