"""The PyTorch port's kernel wrappers on the CPU (where each takes its
plain torch version) against the JAX reference's kernels (Pallas in
interpret mode on this host): the chained launch (K6), the fused concat
launch (K1), the pooled launch (K2) and the direct conv (K3), plus the
pure-torch helpers they share.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32, rtol = atol = 1e-4 — the two sides sum in different
orders.  Rows compared are the valid rows; the reference's padding rows
are unspecified by its own contract, and the port's padding columns must
be exactly zero where the contract says so.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as j_plan
from repro.kernels import ops as j_ops
from repro.models import cnn as j_cnn
from repro_torch.core import plan as t_plan
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import cnn as t_cnn

# the module, not the package's function of the same name
j_conv = importlib.import_module("repro.kernels.conv2d")
j_gmm = importlib.import_module("repro.kernels.grouped_matmul")

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    j_ops.reset_launch_counts()
    t_rt.reset_launch_counts()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------------------
# K6: chained launch
# ---------------------------------------------------------------------------

def _chain_arrays(rng, b, h, w):
    m = b * h * w
    return {
        "x0": rng.normal(size=(m, 64)).astype(np.float32) * 0.3,
        "w0": rng.normal(size=(64, 48)).astype(np.float32) * 0.3,
        "b0": rng.normal(size=(48,)).astype(np.float32),
        "panel": np.pad(rng.normal(size=(m, 200)).astype(np.float32),
                        ((0, 0), (0, 56))),
        "wp": rng.normal(size=(200, 40)).astype(np.float32) * 0.1,
        "bp": rng.normal(size=(40,)).astype(np.float32),
        "wr": rng.normal(size=(48 * 9, 40)).astype(np.float32) * 0.1,
        "br": rng.normal(size=(40,)).astype(np.float32),
        "x1": rng.normal(size=(m, 200)).astype(np.float32) * 0.3,
        "w1": rng.normal(size=(200, 24)).astype(np.float32) * 0.1,
        "b1": rng.normal(size=(24,)).astype(np.float32),
    }


def _two_phase(arr, pk, asarr):
    """Phase 0: an x branch writing the ring and a panel-source branch;
    phase 1: a 3x3 ring conv over the x branch and a 2-block x branch."""
    a = {k: asarr(v) for k, v in arr.items()}
    ranges = [(0, 128), (128, 200)]
    return [
        [{"n": 48, "w": pk._pad_w_dense(a["w0"], 128), "b": a["b0"],
          "src": ("x", [a["x0"]]), "ring_write": (0,)},
         {"n": 40, "w": pk._pack_w_blocks(a["wp"], ranges, 128),
          "b": a["bp"], "src": ("panel", [(0, 0), (0, 1)]),
          "ring_write": None}],
        [{"n": 40, "w": pk._pack_w_ring(a["wr"], 3, 3, 48, 1, 128),
          "b": a["br"], "src": ("ring", 3, 3, (0,)), "ring_write": None},
         {"n": 24, "w": pk._pad_w_dense(a["w1"], 128), "b": a["b1"],
          "src": ("x", [a["x1"]]), "ring_write": None}],
    ], a["panel"]


def _stem_like(rng, b, asarr, pk, im2col):
    """Three phases like the stem chain: a strided 7x7/2 im2col x source
    (K=147, two k-blocks), a 1x1 ring conv, then a 3x3 ring conv."""
    img = rng.normal(size=(b, 16, 16, 3)).astype(np.float32)
    x0 = np.asarray(im2col(img), np.float32).reshape(-1, 147)
    ws = [rng.normal(size=s).astype(np.float32) * 0.2
          for s in ((147, 64), (64, 64), (64 * 9, 96))]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in (64, 64, 96)]
    ws, bs, x0 = [asarr(v) for v in ws], [asarr(v) for v in bs], asarr(x0)
    return [
        [{"n": 64, "w": pk._pad_w_dense(ws[0], 128), "b": bs[0],
          "src": ("x", [x0]), "ring_write": (0,)}],
        [{"n": 64, "w": pk._pack_w_ring(ws[1], 1, 1, 64, 1, 128),
          "b": bs[1], "src": ("ring", 1, 1, (0,)), "ring_write": (1,)}],
        [{"n": 96, "w": pk._pack_w_ring(ws[2], 3, 3, 64, 1, 128),
          "b": bs[2], "src": ("ring", 3, 3, (1,)), "ring_write": None}],
    ]


def _check_chain(jouts, touts, layout, rows):
    for p, (jo, to) in enumerate(zip(jouts, touts)):
        jo, to = _np(jo), to.numpy()
        assert to.shape == jo.shape
        for (pp, cb, nbb, n) in layout:
            if pp != p:
                continue
            np.testing.assert_allclose(to[:rows, cb * 128:cb * 128 + n],
                                       jo[:rows, cb * 128:cb * 128 + n],
                                       **TOL)
            assert not to[:rows, cb * 128 + n:(cb + nbb) * 128].any()


@pytest.mark.parametrize("m_valid", [None, 0, 64, 128, 192, 256])
def test_chained_two_phase_matches_reference(m_valid):
    b, h, w = 4, 8, 8
    m = b * h * w
    arr = _chain_arrays(np.random.default_rng(3), b, h, w)
    jph, jpanel = _two_phase(arr, j_plan, jnp.asarray)
    tph, tpanel = _two_phase(arr, t_plan, _t)
    jouts = j_ops.grouped_matmul_chained(jph, m=m, h=h, w=w,
                                         panels=(jpanel,), m_valid=m_valid)
    touts = t_gmm.grouped_matmul_chained(tph, m=m, h=h, w=w,
                                         panels=(tpanel,), m_valid=m_valid)
    rows = m if m_valid is None else m_valid
    _check_chain(jouts, touts, t_gmm.chained_layout(tph), rows)
    if m_valid is not None:
        for to in touts:
            assert not to[m_valid:m].numpy().any()   # tail rows store zeros


@pytest.mark.parametrize("m_valid", [None, 64, 128])
def test_chained_stem_like_three_phase_matches_reference(m_valid):
    b = 2
    h = w = 8
    m = b * h * w
    jph = _stem_like(np.random.default_rng(5), b, jnp.asarray, j_plan,
                     lambda x: j_cnn._im2col(jnp.asarray(x), 7, 7, 2))
    tph = _stem_like(np.random.default_rng(5), b, _t, t_plan,
                     lambda x: t_cnn._im2col(_t(x), 7, 7, 2))
    jouts = j_ops.grouped_matmul_chained(jph, m=m, h=h, w=w,
                                         m_valid=m_valid)
    touts = t_gmm.grouped_matmul_chained(tph, m=m, h=h, w=w,
                                         m_valid=m_valid)
    rows = m if m_valid is None else m_valid
    _check_chain(jouts, touts, t_gmm.chained_layout(tph), rows)


def test_chained_rejects_a_cutoff_inside_an_image():
    b, h, w = 4, 8, 8
    arr = _chain_arrays(np.random.default_rng(3), b, h, w)
    tph, tpanel = _two_phase(arr, t_plan, _t)
    with pytest.raises(ValueError, match="image-aligned"):
        t_gmm.grouped_matmul_chained(tph, m=b * h * w, h=h, w=w,
                                     panels=(tpanel,), m_valid=100)


def test_weight_packers_equal_reference():
    rng = np.random.default_rng(7)
    wm = rng.normal(size=(200, 24)).astype(np.float32)
    wr = rng.normal(size=(130 * 9, 16)).astype(np.float32)
    ranges = [(0, 100), (100, 200)]
    pairs = [
        (j_plan._pad_w_dense(jnp.asarray(wm), 128),
         t_plan._pad_w_dense(_t(wm), 128)),
        (j_plan._pack_w_blocks(jnp.asarray(wm), ranges, 128),
         t_plan._pack_w_blocks(_t(wm), ranges, 128)),
        (j_plan._pack_w_ring(jnp.asarray(wr), 3, 3, 130, 2, 128),
         t_plan._pack_w_ring(_t(wr), 3, 3, 130, 2, 128)),
    ]
    for j, t in pairs:
        np.testing.assert_array_equal(t.numpy(), _np(j))


# ---------------------------------------------------------------------------
# K1: fused epilogue-concat
# ---------------------------------------------------------------------------

def _concat_case(rng):
    m = 100
    ks, ns = (40, 72, 24), (16, 48, 20)
    xs = [rng.normal(size=(m, k)).astype(np.float32) for k in ks]
    ws = [rng.normal(size=(k, n)).astype(np.float32) * 0.2
          for k, n in zip(ks, ns)]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in ns]
    return xs, ws, bs, [8, 30, 90], 120      # holes: passthrough columns


@pytest.mark.parametrize("m_valid", [None, 37, 100])
def test_concat_matches_reference(m_valid):
    xs, ws, bs, offs, total = _concat_case(np.random.default_rng(11))
    jy = _np(j_ops.grouped_matmul_concat(
        [jnp.asarray(a) for a in xs], [jnp.asarray(a) for a in ws],
        [jnp.asarray(a) for a in bs], offsets=offs, total=total, relu=True,
        m_valid=m_valid))
    ty = t_gmm.grouped_matmul_concat(
        [_t(a) for a in xs], [_t(a) for a in ws], [_t(a) for a in bs],
        offsets=offs, total=total, relu=True, m_valid=m_valid).numpy()
    assert ty.shape == jy.shape == (100, total)
    rows = 100 if m_valid is None else m_valid
    for off, w in zip(offs, ws):
        np.testing.assert_allclose(ty[:rows, off:off + w.shape[1]],
                                   jy[:rows, off:off + w.shape[1]], **TOL)
        assert not ty[rows:, off:off + w.shape[1]].any()


def test_concat_padded_layout_matches_reference():
    xs, ws, bs, offs, total = _concat_case(np.random.default_rng(12))
    jy = _np(j_ops.grouped_matmul_concat(
        [jnp.asarray(a) for a in xs], [jnp.asarray(a) for a in ws],
        [jnp.asarray(a) for a in bs], offsets=offs, total=total, relu=True,
        compact=False, m_valid=60))
    ty = t_gmm.grouped_matmul_concat(
        [_t(a) for a in xs], [_t(a) for a in ws], [_t(a) for a in bs],
        offsets=offs, total=total, relu=True, compact=False,
        m_valid=60).numpy()
    assert ty.shape == jy.shape == (100, 3 * 128)
    np.testing.assert_allclose(ty[:60], jy[:60], **TOL)


# ---------------------------------------------------------------------------
# K2: pooled launch
# ---------------------------------------------------------------------------

def _pooled_case(rng, mod, asarr, nan):
    img = rng.normal(size=(2, 10, 10, 16)).astype(np.float32)
    if nan:
        img[1, 4, 5, 3] = np.nan
    plain = rng.normal(size=(50, 24)).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) * 0.2
          for s in ((16, 40), (16, 24), (24, 8))]
    bs = [rng.normal(size=(n,)).astype(np.float32) for n in (40, 24, 8)]
    x = asarr(img)
    taps9 = mod.pool_tap_views(x, ((3, 2),))
    taps81 = mod.pool_tap_views(x, ((3, 2), (3, 1)))
    xs = [tuple(t.reshape(-1, 16) for t in taps9),
          tuple(t.reshape(-1, 16) for t in taps81), asarr(plain)]
    return xs, [asarr(a) for a in ws], [asarr(a) for a in bs]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("m_valid", [None, 25])
def test_pooled_matches_reference(m_valid, nan):
    jxs, jws, jbs = _pooled_case(np.random.default_rng(13), j_ops,
                                 jnp.asarray, nan)
    txs, tws, tbs = _pooled_case(np.random.default_rng(13), t_gmm, _t, nan)
    txs = [tuple(t.contiguous() for t in x) if isinstance(x, tuple) else x
           for x in txs]
    assert len(jxs[0]) == 9 and len(jxs[1]) == 81
    jys = j_ops.grouped_matmul_pooled(jxs, jws, jbs, relu=True,
                                      m_valid=m_valid)
    tys = t_gmm.grouped_matmul_pooled(txs, tws, tbs, relu=True,
                                      m_valid=m_valid)
    rows = 50 if m_valid is None else m_valid
    for jy, ty in zip(jys, tys):
        jy, ty = _np(jy), ty.numpy()
        assert ty.shape == jy.shape
        np.testing.assert_allclose(ty[:rows], jy[:rows], equal_nan=True,
                                   **TOL)
        assert not ty[rows:].any()
    if nan and m_valid is None:
        assert np.isnan(tys[0].numpy()).any()   # a NaN tap poisons its rows


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("m_valid", [None, 25])
def test_pooled_view_taps_match_reference(m_valid, nan):
    """The tap form the plan hands over: strided (B, OH, OW, K) views of
    the padded input (the 81-tap chain over the limit, folded), through
    the wrapper's and the plain version's CPU path, against the
    reference's launch on (M, K) taps."""
    jxs, jws, jbs = _pooled_case(np.random.default_rng(29), j_ops,
                                 jnp.asarray, nan)
    txs, tws, tbs = _pooled_case(np.random.default_rng(29), t_gmm, _t, nan)
    # the case's image: the first draw of its generator
    x = _t(np.random.default_rng(29).normal(size=(2, 10, 10, 16))
           .astype(np.float32))
    if nan:
        x[1, 4, 5, 3] = float("nan")
    txs = [tuple(t_gmm.pool_tap_views(x, ((3, 2),))),
           tuple(t_gmm.pool_tap_views(x, ((3, 2), (3, 1)))), txs[2]]
    assert txs[0][0].shape == (2, 5, 5, 16) and not txs[0][0].is_contiguous()
    jys = j_ops.grouped_matmul_pooled(jxs, jws, jbs, relu=True,
                                      m_valid=m_valid)
    rows = 50 if m_valid is None else m_valid
    for fn in (t_gmm.grouped_matmul_pooled, t_gmm.grouped_matmul_pooled_ref):
        tys = fn(txs, tws, tbs, relu=True, m_valid=m_valid)
        for jy, ty in zip(jys, tys):
            jy, ty = _np(jy), ty.numpy()
            assert ty.shape == jy.shape
            np.testing.assert_allclose(ty[:rows], jy[:rows], equal_nan=True,
                                       **TOL)
            assert not ty[rows:].any()


@pytest.mark.parametrize("tap_limit", [1, 9])
def test_pooled_tap_limit_matches_reference(tap_limit):
    """A lowered ``tap_limit`` folds more chains before the launch (every
    pooled branch at 1; only the 81-tap one at 9): the same function."""
    jxs, jws, jbs = _pooled_case(np.random.default_rng(19), j_ops,
                                 jnp.asarray, False)
    txs, tws, tbs = _pooled_case(np.random.default_rng(19), t_gmm, _t,
                                 False)
    txs = [tuple(t.contiguous() for t in x) if isinstance(x, tuple) else x
           for x in txs]
    jys = j_gmm.grouped_matmul_pooled(jxs, jws, jbs, relu=True, m_valid=25,
                                      interpret=True, tap_limit=tap_limit)
    tys = t_gmm.grouped_matmul_pooled(txs, tws, tbs, relu=True, m_valid=25,
                                      tap_limit=tap_limit)
    for jy, ty in zip(jys, tys):
        np.testing.assert_allclose(ty.numpy()[:25], _np(jy)[:25], **TOL)
        assert not ty.numpy()[25:].any()


def test_pool_helpers_and_im2col_equal_reference():
    rng = np.random.default_rng(17)
    img = rng.normal(size=(2, 9, 8, 5)).astype(np.float32)
    img[0, 2, 3, 1] = np.nan
    for chain in (((3, 1),), ((3, 2),), ((3, 2), (3, 1))):
        jv = j_ops.pool_tap_views(jnp.asarray(img), chain)
        tv = t_gmm.pool_tap_views(_t(img), chain)
        assert len(jv) == len(tv)
        for a, b in zip(jv, tv):
            np.testing.assert_array_equal(b.numpy(), _np(a))
        np.testing.assert_array_equal(
            t_gmm.pool_from_taps(tv).numpy(), _np(j_ops.pool_from_taps(jv)))
    img = rng.normal(size=(2, 9, 8, 5)).astype(np.float32)
    for k, s in ((3, 1), (5, 1), (7, 2), (3, 2)):
        np.testing.assert_array_equal(
            t_cnn._im2col(_t(img), k, k, s).numpy(),
            _np(j_cnn._im2col(jnp.asarray(img), k, k, s)))
    np.testing.assert_allclose(
        t_cnn.maxpool_chain(_t(img), ((3, 2), (3, 1))).numpy(),
        _np(j_cnn.maxpool_chain(jnp.asarray(img), ((3, 2), (3, 1)))))


# ---------------------------------------------------------------------------
# K3: direct conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k,stride", [
    ((2, 7, 7, 8), 3, 1),       # odd H, stride 1
    ((2, 8, 8, 8), 3, 2),       # even H, stride 2: asymmetric SAME pad
    ((1, 9, 10, 4), 5, 2),
    ((2, 14, 14, 12), 5, 1),
    ((2, 6, 6, 3), 7, 2),
])
def test_direct_conv_matches_reference(shape, k, stride):
    rng = np.random.default_rng(19)
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=(k, k, shape[3], 16)).astype(np.float32) * 0.2
    jy = _np(j_conv.conv2d_direct(jnp.asarray(x), jnp.asarray(w),
                                  stride=stride, interpret=True))
    ty = t_conv.conv2d_direct(_t(x), _t(w), stride=stride).numpy()
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, **TOL)


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    t_rt.reset_launch_counts()
    rng = np.random.default_rng(23)
    x = _t(rng.normal(size=(1, 5, 5, 4)).astype(np.float32))
    w = _t(rng.normal(size=(3, 3, 4, 8)).astype(np.float32))
    t_conv.conv2d_direct(x, w)
    assert all(v == 0 for v in t_rt.KERNEL_LAUNCHES.values())
    with pytest.raises(ValueError, match="contiguous"):
        t_conv.conv2d_direct(x.permute(0, 2, 1, 3), w)
    with pytest.raises(TypeError):
        t_conv.conv2d_direct(x.double(), w.double())
