"""K3's and K9's launch plans on the CPU: the k-step table, tiles and
depth splits that ``conv2d_direct`` and ``branch_matmul`` hand their
kernels (``conv2d.direct_launch``, ``branch_matmul.bmm_launch``), at
every direct conv the serial, concurrent and stacked training steps and
bucket-1 serving launch on full-width GoogLeNet, at the stacked step's
K9 GEMMs and Winograd's 16 transform-domain GEMMs, and at small edge
shapes; and K3's table replayed in plain torch exactly as the kernel
walks it, held against the plain version ``conv2d_direct_ref`` and the
reference's Pallas kernel in interpret mode.

The replay reads only what the plan gives it: per split, its k-steps in
order, each one's (dh, dw, first channel, live channels); per output row
one source pixel and one in-image mask a k-step; an lhs k-step of
``DIRECT_BK`` columns zero past the live width and outside the image;
the splits' partials summed in split order.

Tolerance: float32 on both sides, summed in other orders: rtol = atol =
1e-5 against the plain version and the reference.
"""
import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs.googlenet import CONFIG
from repro_torch.core import plan_cache
from repro_torch.kernels import branch_matmul as kb
from repro_torch.kernels import conv2d as kc
from repro_torch.kernels import matmul as km
from repro_torch.models import cnn as t_cnn

# the module, not the package's function of the same name
j_conv = importlib.import_module("repro.kernels.conv2d")

torch.set_num_threads(2)
SMS = 132          # an H100 SXM's SMs: the card the plans are built for
BK = kc.DIRECT_BK
TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 8          # chip_smoke.py's training batch


def _direct_convs(plan):
    """(name, x shape, w shape, stride) of every conv the plan runs on K3
    (a serial group's ``direct`` op)."""
    graph = plan.context["graph"]
    out = []
    for g in plan.groups:
        if g.mode != "serial":
            continue
        for n in g.ops:
            op = graph.ops[n]
            if op.kind == "conv2d" and g.algorithms.get(n) == "direct":
                p = op.p
                out.append((n, (p["n"], p["h"], p["w"], p["c"]),
                            (p["kh"], p["kw"], p["c"], p["k"]), p["stride"]))
    return out


@functools.lru_cache(maxsize=None)
def _main_path_convs():
    """{path: direct convs}: the serial and concurrent training steps at
    batch 8 and bucket-1 serving, on full-width GoogLeNet."""
    serial, _ = t_cnn.plan_cnn(CONFIG, BATCH, train=True, concurrent=False)
    concurrent, _ = t_cnn.plan_cnn(CONFIG, BATCH, train=True)
    serve = plan_cache.cached_cnn_plan(CONFIG, 1, chain_modules=True).plan
    return {"serial": _direct_convs(serial),
            "concurrent": _direct_convs(concurrent),
            "serve-b1": _direct_convs(serve)}


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module, ``sys.path`` left
    as it was: it holds the one list of cases K3 is held at on the
    card."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_direct", path)
    cs = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(cs)
    finally:
        sys.path[:] = saved
    return cs


# small edge shapes and bucket 1's inc8 3x3: (x shape, w shape, stride,
# padding); C in {3, 5, 24, 32}, K in {16, 48, 64, 130}, taps 1/3/5/7,
# stride 2 with its asymmetric SAME pad, VALID
EDGE = _chip_smoke().DIRECT_CASES


def _cases(path):
    if path == "edge":
        return [(f"edge{i}",) + c for i, c in enumerate(EDGE)]
    return [(n, xs, ws, s, "SAME") for n, xs, ws, s in
            _main_path_convs()[path]]


PATHS = ["serial", "concurrent", "serve-b1", "edge"]


def test_main_path_direct_convs_are_the_ones_the_plans_count():
    convs = _main_path_convs()
    assert len(convs["serial"]) == 51
    assert [c[0] for c in convs["concurrent"]] == ["stem1", "stem2"]
    assert sorted(c[0] for c in convs["serve-b1"]) == ["inc8/3x3",
                                                       "inc8/5x5"]


@pytest.mark.parametrize("path", PATHS)
def test_direct_plan_covers_the_depth_once_on_whole_k_steps(path):
    for name, xs, ws, stride, padding in _cases(path):
        la = kc.direct_launch(xs, ws, stride, padding, SMS)
        kh, kw, c, k = ws
        steps = la["steps"]
        # tap-major, channel-minor: each (tap, channel) once, in order,
        # and no k-step straddles two taps
        seen = [(dh, dw, c0 + j) for dh, dw, c0, live in steps
                for j in range(live)]
        assert seen == [(dh, dw, ch) for dh in range(kh) for dw in range(kw)
                        for ch in range(c)], name
        for dh, dw, c0, live in steps:
            assert 0 < live <= BK and c0 % BK == 0 and c0 + live <= c, name
        # the splits: whole k-steps, each non-empty, together all of them
        s, kper, nk = la["splits"], la["kper"], len(steps)
        assert s >= 1 and kper >= 1
        assert (s - 1) * kper < nk <= s * kper, name
        assert la["tiles"] == -(-la["m"] // kc.DIRECT_TILE) * \
            -(-k // kc.DIRECT_TILE)
        assert la["ctas"] == la["tiles"] * s
        assert la["ws_bytes"] <= km.SPLIT_WS_CAP


@pytest.mark.parametrize("path", PATHS)
def test_direct_plan_issues_no_depth_past_each_taps_last_k_step(path):
    for name, xs, ws, stride, padding in _cases(path):
        la = kc.direct_launch(xs, ws, stride, padding, SMS)
        kh, kw, c, _ = ws
        issued = len(la["steps"]) * BK
        if c % BK == 0:
            assert issued == kh * kw * c, name
        else:
            assert issued <= kh * kw * -(-c // BK) * BK, name


@pytest.mark.parametrize("path", PATHS)
def test_direct_plan_splits_only_where_the_tiles_do_not_fill_the_card(path):
    for name, xs, ws, stride, padding in _cases(path):
        la = kc.direct_launch(xs, ws, stride, padding, SMS)
        if la["tiles"] >= kc.DIRECT_SPLIT_CTAS * SMS:
            assert la["splits"] == 1, name
        if la["splits"] > 1:
            assert la["kper"] * BK >= kc.DIRECT_SPLIT_MIN_DEPTH, name
            assert la["ctas"] > la["tiles"]


def test_concurrent_step_and_big_serial_convs_take_no_split():
    """The concurrent step's stem1 and stem2 (784 and 1568 tiles) run
    unsplit, so its float64 gradient check sees one FMA chain per output;
    bucket 1's inc8 3x3 (6 tiles, 108 k-steps) splits to fill the card."""
    for name, xs, ws, stride, padding in _cases("concurrent"):
        assert kc.direct_launch(xs, ws, stride, padding,
                                SMS)["splits"] == 1, name
    serve = {n: kc.direct_launch(xs, ws, s, p, SMS)
             for n, xs, ws, s, p in _cases("serve-b1")}
    la = serve["inc8/3x3"]
    assert la["tiles"] == 6 and len(la["steps"]) == 108
    assert la["splits"] > 1 and la["ctas"] >= SMS // 2


def _replay(x, w, stride, la):
    """K3's plan walked in plain torch: per split its k-steps, each an
    (M, BK) lhs of one source pixel per row under the in-image mask (zero
    past the live channels and outside the image) against BK weight rows
    (zero past the live ones); the splits summed in split order."""
    n, h, wd, c = x.shape
    kh, kw, _, k = w.shape
    oh, ow, m = la["oh"], la["ow"], la["m"]
    pt, pl = la["pad"]
    r = torch.arange(m)
    img, rem = r // (oh * ow), r % (oh * ow)
    oy, ox = rem // ow, rem % ow
    wmat = w.reshape(kh * kw * c, k)
    steps, kper = la["steps"], la["kper"]
    out = None
    for s in range(la["splits"]):
        acc = torch.zeros((m, k))
        for dh, dw, c0, live in steps[s * kper:(s + 1) * kper]:
            iy, ix = oy * stride + dh - pt, ox * stride + dw - pl
            inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < wd)
            lhs = torch.zeros((m, BK))
            lhs[inside, :live] = x[img[inside], iy[inside], ix[inside],
                                   c0:c0 + live]
            k0 = (dh * kw + dw) * c + c0
            rhs = torch.zeros((BK, k))
            rhs[:live] = wmat[k0:k0 + live]
            acc = acc + lhs @ rhs
        out = acc if out is None else out + acc
    return out.reshape(n, oh, ow, k)


@pytest.mark.parametrize("sms", [SMS, 2])
@pytest.mark.parametrize("case", range(len(EDGE)))
def test_direct_table_replay_matches_plain_and_reference(case, sms):
    """At the card's SM count (bucket 1's inc8 3x3 splits there) and at 2
    SMs (so that the small shapes split too)."""
    xs, ws, stride, padding = EDGE[case]
    rng = np.random.default_rng(41 + case)
    x = rng.normal(size=xs).astype(np.float32)
    w = (rng.normal(size=ws) * 0.2).astype(np.float32)
    la = kc.direct_launch(xs, ws, stride, padding, sms)
    wants_split = la["tiles"] < kc.DIRECT_SPLIT_CTAS * sms and \
        len(la["steps"]) * BK > kc.DIRECT_SPLIT_MIN_DEPTH
    assert (la["splits"] > 1) == wants_split
    got = _replay(torch.from_numpy(x), torch.from_numpy(w), stride, la)
    plain = kc.conv2d_direct_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=stride, padding=padding)
    ref = np.asarray(j_conv.conv2d_direct(jnp.asarray(x), jnp.asarray(w),
                                          stride=stride, padding=padding,
                                          interpret=True), np.float32)
    assert got.shape == plain.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stacked_gemms():
    """(role, G, M, N, K) of each K9 call of one stacked-plan training
    step: per stacked group the forward (G, M, K) @ (G, K, N), the
    backward's dx (G, M, N) @ (G, N, K) and dW (G, K, M) @ (G, M, N), K
    and N each the group's widest (the plan pads to them)."""
    plan, _ = t_cnn.plan_cnn(CONFIG, BATCH, train=True, fuse_pool=False)
    graph = plan.context["graph"]
    out = []
    for grp in plan.groups_of_mode("stacked"):
        ps = [graph.ops[n].p for n in grp.ops]
        g, m = len(ps), ps[0]["n"] * ps[0]["h"] * ps[0]["w"]
        k = max(p["c"] * p["kh"] * p["kw"] for p in ps)
        n = max(p["k"] for p in ps)
        out += [("fwd", g, m, n, k), ("dx", g, m, k, n), ("dW", g, k, n, m)]
    return out


def _winograd_gemms():
    """Winograd's 16 transform-domain GEMMs (T, C) @ (C, K) at paper
    Table 1's inception-3a 3x3 conv (batch 4, 28 x 28, 96 -> 128), as
    chip_smoke.py's conv zoo runs it."""
    t = 4 * 14 * 14
    return [("winograd", 16, t, 128, 96)]


def test_stacked_step_makes_nine_k9_gemms():
    gemms = _stacked_gemms()
    assert len(gemms) == 9
    assert ("dW", 4, 256, 128, 25088) in gemms


@pytest.mark.parametrize("which", ["stacked", "winograd"])
def test_bmm_plan_splits_k_only_where_the_tiles_do_not_cover_the_card(
        which):
    gemms = _stacked_gemms() if which == "stacked" else _winograd_gemms()
    for role, g, m, n, k in gemms:
        la = kb.bmm_launch(g, m, n, k, SMS)
        t = kb.BMM_TILE
        assert la["tiles"] == -(-m // t) * -(-n // t)
        s, kper = la["splits"], la["kper"]
        if g * la["tiles"] >= SMS:
            assert s == 1 and kper == k, role
        if s > 1:
            assert kper % km.SPLIT_BK == 0 and kper >= km.SPLIT_MIN_DEPTH
            assert (s - 1) * kper < k <= s * kper, role
            assert la["ctas"] == g * la["tiles"] * s
        assert la["ws_bytes"] <= km.SPLIT_WS_CAP
    if which == "stacked":
        dws = [kb.bmm_launch(g, m, n, k, SMS) for r, g, m, n, k in gemms
               if r == "dW"]
        # every dW fills at least one CTA per SM after its split
        assert all(la["splits"] > 1 and la["ctas"] >= SMS for la in dws)


def test_bmm_split_partials_summed_in_order_match_plain():
    """The dW of a stacked group cut as ``bmm_launch`` cuts it, at a small
    M and 16 SMs: the split partials summed in split order equal the plain
    version."""
    g, m, n, k = 4, 40, 24, 2000
    la = kb.bmm_launch(g, m, n, k, 16)
    assert la["splits"] > 1
    gen = torch.Generator().manual_seed(9)
    x = torch.randn((g, k, m), generator=gen).transpose(1, 2)
    y = torch.randn((g, k, n), generator=gen)
    kper = la["kper"]
    parts = [x[:, :, s * kper:(s + 1) * kper] @ y[:, s * kper:(s + 1) * kper]
             for s in range(la["splits"])]
    got = parts[0]
    for p in parts[1:]:
        got = got + p
    torch.testing.assert_close(got, kb.branch_matmul_ref(x, y), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(kb.branch_matmul(x, y),
                               kb.branch_matmul_ref(x, y), rtol=0, atol=0)
