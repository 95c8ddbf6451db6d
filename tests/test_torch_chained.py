"""K6's launch table on the CPU: the work items, k-step live widths and
output spans that ``grouped_matmul_chained`` hands its kernel
(``chained_launch``), replayed in plain torch in ticket order exactly as
the kernel walks them, and held against the plain version
``grouped_matmul_chained_ref``.

The replay reads only what an item's table rows give it: its m-block,
its branch's k-steps from chunk ``klo`` to ``khi`` (each step's live
columns, rounded up to the engine's k-step, and the matching weight
rows), its output tile (left half only where the table says so), and its
split, summed in split order by the last split.  Panels it has not yet
written hold NaN, so an item that read a producer row before the
producer's tile was done would poison its output.  It also asserts that
each item's producers come before it in ticket order, that each ring
item's dependencies cover the rows its taps read, and that the new table
issues at most 1.5x the live multiply-adds of a full-width bucket-2
serving dispatch, against the first design's (one launch per phase,
64 x 64 tiles over padded widths and depths) counted by the same function.

Tolerance: float32 on both sides, summed in other orders: max abs err
<= 1e-4 * max|ref| + 1e-6 per output panel.  Padding columns and rows at
or past ``m_valid`` inside a run block must be exactly 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import plan as t_plan
from repro_torch.kernels import grouped_matmul as kg
from repro_torch.models import cnn as t_cnn

torch.set_num_threads(2)
SMS = 132          # an H100 SXM's SMs: the card the table is built for
BLK = kg.CHAIN_TILE


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _stage1_launch(spec, m_lim):
    """The work items of K6's first design (one launch per phase, a 64 x
    64 tile per CTA over every m-block of 64 rows below ``m_lim``, every
    k-step's full 128 columns and every branch's padded width), in
    ``chained_launch``'s form, for ``chained_issued_macs``."""
    t, items, g = 64, [], 0
    for p, pspec in enumerate(spec):
        for n, nbb, ks in pspec:
            items += [(p, i, g, n0, t, 0, 1, 0, len(ks) * BLK // kg.CHAIN_BK)
                      for i in range(-(-m_lim // t))
                      for n0 in range(0, nbb * BLK, t)]
            g += 1
    return {"items": items, "m_lim": m_lim, "tile_rows": t, "warp_rows": t}


def _decode(la):
    """The table's sections as the kernel reads them, from its ints."""
    tab, offs = la["table"], la["offsets"]

    def rows(sec, width):
        flat = tab[offs[sec]:offs[sec + 1]]
        return [tuple(flat[i:i + width]) for i in range(0, len(flat), width)]
    return (rows(0, 13), rows(1, 3), rows(2, 6), rows(3, 8),
            tuple(tab[offs[4]:]))


def replay(phases, *, m, h, w, panels=(), m_valid=None, sms=SMS):
    """Plain-torch replay of K6's launch in ticket order; returns its
    output panels (rows of blocks not run are NaN: unwritten)."""
    spec, m_lim = kg._chain_check(phases, m, h, w, panels, BLK, m_valid)
    la = kg.chained_launch(spec, len(panels), m_lim, h, w, sms)
    items, deps, branches, steps, targets = _decode(la)
    nph, nblk = la["phases"], la["nblk"]
    mp = -(-m // BLK) * BLK
    xs = [a for ph in phases for br in ph if br["src"][0] == "x"
          for a in br["src"][1]]
    brs = [br for ph in phases for br in ph]
    outs = [torch.full((mp, sum(nbb for _, nbb, _ in ps) * BLK),
                       float("nan")) for ps in spec]
    srcs = list(panels) + outs
    done = {}
    partial = {}
    for ticket, it in enumerate(items):
        p, i, g, n0, cols, s, S, klo, khi, _, _, d0, nd = it
        for pp, jlo, jhi in deps[d0:d0 + nd]:
            for j in range(jlo, jhi + 1):
                assert done.get((pp, j), 0) == targets[pp], \
                    (ticket, it, (pp, j))
        _, n, ocol, step0, nsteps, nch = branches[g]
        m0 = i * BLK
        rows = torch.arange(m0, m0 + BLK)
        row_ok = rows < m_lim
        rem = rows % (h * w)
        ry, rx = rem // w, rem % w
        acc = torch.zeros(BLK, BLK)
        ncol = min(cols, n - n0)
        for st in steps[step0:step0 + nsteps]:
            kind, arr, cb, dh, dw, live, c0, slab = st
            c1 = c0 + -(-live // kg.CHAIN_BK)
            lo, hi = max(klo, c0), min(khi, c1)
            if lo >= hi:
                continue
            k_lo = (lo - c0) * kg.CHAIN_BK
            k_hi = min((hi - c0) * kg.CHAIN_BK, live)
            if kind == 2:
                ok = row_ok & (ry + dh >= 0) & (ry + dh < h) \
                    & (rx + dw >= 0) & (rx + dw < w)
                srow = torch.where(ok, rows + dh * w + dw, 0)
            else:
                ok, srow = row_ok, torch.where(row_ok, rows, 0)
            base = xs[arr] if kind == 0 else srcs[arr]
            c = cb * BLK
            a = base[srow, c + k_lo:c + k_hi]
            a = torch.where(ok[:, None], a, torch.zeros(()))
            wt = brs[g]["w"][slab * BLK + k_lo:slab * BLK + k_hi,
                             n0:n0 + ncol]
            acc[:, :ncol] += a @ wt
        if S > 1:
            partial.setdefault((p, i, g, n0), []).append(acc)
            if s < S - 1:
                continue
            acc = torch.stack(partial.pop((p, i, g, n0))).sum(0)
        y = acc[:, :ncol]
        if brs[g].get("b") is not None:
            y = y + brs[g]["b"][n0:n0 + ncol]
        y = torch.where(row_ok[:, None], torch.relu(y), torch.zeros(()))
        tile = torch.zeros(BLK, BLK)
        tile[:, :ncol] = y
        outs[p][m0:m0 + BLK, ocol + n0:ocol + n0 + BLK] = tile
        done[p, i] = done.get((p, i), 0) + 1
    assert not partial
    assert all(done.get((p, i)) == targets[p]
               for p in range(nph) for i in range(nblk))
    return outs, la


def _assert_replay_equals_ref(phases, *, m, h, w, panels=(), m_valid=None):
    got, la = replay(phases, m=m, h=h, w=w, panels=panels, m_valid=m_valid)
    ref = kg.grouped_matmul_chained_ref(phases, m=m, h=h, w=w,
                                        panels=panels, m_valid=m_valid)
    m_lim = m if m_valid is None else m_valid
    run = la["nblk"] * BLK
    for p, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        g, r = g[:run], r[:run]
        assert not torch.isnan(g).any(), p
        err = float((g - r).abs().max()) if g.numel() else 0.0
        assert err <= 1e-4 * float(r.abs().max() if r.numel() else 0) \
            + 1e-6, (p, err)
        assert not g[m_lim:].any()
    for p, cb, nbb, n in kg.chained_layout(phases):
        assert not got[p][:run, cb * BLK + n:(cb + nbb) * BLK].any()
    return la


def _check_order_and_halos(phases, la, *, h, w):
    """Every item's producers have smaller tickets; every ring item's
    dependencies cover the producer blocks of its rows widened by the
    halo [m0 - (kh/2)*W - kw/2, m0 + BM + (kh/2)*W + kw/2) below m_lim."""
    items, deps, _, _, _ = _decode(la)
    m_lim = la["m_lim"]
    last = {}
    for ticket, it in enumerate(items):
        last[it[0], it[1]] = ticket
    ringmap = {}
    for p, ph in enumerate(phases):
        for br in ph:
            for rc in br.get("ring_write") or ():
                ringmap[int(rc)] = p
    brs = [br for ph in phases for br in ph]
    for ticket, it in enumerate(items):
        p, i, g = it[:3]
        got = {(pp, j) for pp, jlo, jhi in deps[it[11]:it[11] + it[12]]
               for j in range(jlo, jhi + 1)}
        for pp, j in got:
            assert pp < p and last[pp, j] < ticket, (ticket, it, pp, j)
        src = brs[g]["src"]
        if src[0] != "ring":
            assert not got
            continue
        _, kh, kw, rcs = src
        halo = (kh // 2) * w + kw // 2
        lo = max(i * BLK - halo, 0)
        hi = min(i * BLK + BLK + halo, m_lim)
        need = {(ringmap[int(rc)], j) for rc in rcs
                for j in range(lo // BLK, -(-hi // BLK))}
        assert need <= got, (ticket, it, need - got)


# ---------------------------------------------------------------------------
# reference-shaped phases (tests/test_torch_kernels.py's shapes)
# ---------------------------------------------------------------------------

def _two_phase(rng, b, h, w, panel_live):
    m = b * h * w
    x0 = _t(rng.normal(size=(m, 64)) * 0.3)
    panel = _t(np.pad(rng.normal(size=(m, 200)), ((0, 0), (0, 56))))
    x1 = _t(rng.normal(size=(m, 200)) * 0.3)
    w0, wp = _t(rng.normal(size=(64, 48)) * 0.3), \
        _t(rng.normal(size=(200, 40)) * 0.1)
    wr, w1 = _t(rng.normal(size=(48 * 9, 40)) * 0.1), \
        _t(rng.normal(size=(200, 24)) * 0.1)
    bs = [_t(rng.normal(size=(n,))) for n in (48, 40, 40, 24)]
    ranges = [(0, 128), (128, 200)]
    pbr = {"n": 40, "w": t_plan._pack_w_blocks(wp, ranges, 128),
           "b": bs[1], "src": ("panel", [(0, 0), (0, 1)]),
           "ring_write": None}
    if panel_live:
        pbr["panel_live"] = (128, 72)
    return [
        [{"n": 48, "w": t_plan._pad_w_dense(w0, 128), "b": bs[0],
          "src": ("x", [x0]), "ring_write": (0,)}, pbr],
        [{"n": 40, "w": t_plan._pack_w_ring(wr, 3, 3, 48, 1, 128),
          "b": bs[2], "src": ("ring", 3, 3, (0,)), "ring_write": None},
         {"n": 24, "w": t_plan._pad_w_dense(w1, 128), "b": bs[3],
          "src": ("x", [x1]), "ring_write": None}],
    ], (panel,)


def _stem_like(rng, b):
    img = _t(rng.normal(size=(b, 16, 16, 3)))
    x0 = t_cnn._im2col(img, 7, 7, 2).reshape(-1, 147).contiguous()
    ws = [_t(rng.normal(size=s) * 0.2)
          for s in ((147, 64), (64, 64), (64 * 9, 96))]
    bs = [_t(rng.normal(size=(n,))) for n in (64, 64, 96)]
    return [
        [{"n": 64, "w": t_plan._pad_w_dense(ws[0], 128), "b": bs[0],
          "src": ("x", [x0]), "ring_write": (0,)}],
        [{"n": 64, "w": t_plan._pack_w_ring(ws[1], 1, 1, 64, 1, 128),
          "b": bs[1], "src": ("ring", 1, 1, (0,)), "ring_write": (1,)}],
        [{"n": 96, "w": t_plan._pack_w_ring(ws[2], 3, 3, 64, 1, 128),
          "b": bs[2], "src": ("ring", 3, 3, (1,)), "ring_write": None}],
    ]


@pytest.mark.parametrize("panel_live", [False, True])
@pytest.mark.parametrize("m_valid", [None, 0, 64, 128, 192, 256])
def test_table_replay_two_phase_equals_plain(m_valid, panel_live):
    b, h, w = 4, 8, 8
    phases, panels = _two_phase(np.random.default_rng(3), b, h, w,
                                panel_live)
    la = _assert_replay_equals_ref(phases, m=b * h * w, h=h, w=w,
                                   panels=panels, m_valid=m_valid)
    _check_order_and_halos(phases, la, h=h, w=w)
    widths = [st[5] for st in la["steps"] if st[0] == 1]
    assert widths == ([128, 72] if panel_live else [128, 128])


@pytest.mark.parametrize("m_valid", [None, 64, 128])
def test_table_replay_stem_like_equals_plain(m_valid):
    b, h, w = 2, 8, 8
    phases = _stem_like(np.random.default_rng(5), b)
    la = _assert_replay_equals_ref(phases, m=b * h * w, h=h, w=w,
                                   m_valid=m_valid)
    _check_order_and_halos(phases, la, h=h, w=w)
    # the im2col x: K = 147 is two k-steps of 128 and 19 live columns
    assert [st[5] for st in la["steps"] if st[0] == 0] == [128, 19]


def test_table_splits_a_phase_that_does_not_cover_the_sms():
    """A small-M chain on a card of many SMs: the deep ring phase splits,
    the replay sums its splits in order, and the result still matches."""
    b, h, w = 4, 8, 8
    phases, panels = _two_phase(np.random.default_rng(11), b, h, w, True)
    phases[1][0]["src"] = ("ring", 5, 5, (0,))
    phases[1][0]["w"] = t_plan._pack_w_ring(
        _t(np.random.default_rng(12).normal(size=(48 * 25, 40)) * 0.05),
        5, 5, 48, 1, 128)
    got, la = replay(phases, m=b * h * w, h=h, w=w, panels=panels,
                     sms=4096)
    assert max(it[6] for it in la["items"]) > 1
    ref = kg.grouped_matmul_chained_ref(phases, m=b * h * w, h=h, w=w,
                                        panels=panels)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= \
            1e-4 * float(r.abs().max()) + 1e-6
    _check_order_and_halos(phases, la, h=h, w=w)


# ---------------------------------------------------------------------------
# the phases of a full-width bucket-2 serving forward
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bucket2_calls():
    """Every K6 call of one planned full-width GoogLeNet forward at
    bucket 2 on the CPU, recorded at the wrapper (as ``chip_smoke.py``'s
    ``recording`` does)."""
    from repro_torch.configs.googlenet import CONFIG
    from repro_torch.core import plan_cache
    calls = []
    real = kg.grouped_matmul_chained

    def rec(*a, **k):
        calls.append((a, k))
        return real(*a, **k)
    params = t_cnn.init_params(CONFIG, torch.Generator().manual_seed(0),
                               "cpu")
    plan = plan_cache.cached_cnn_plan(CONFIG, 2, chain_modules=True).plan
    x = torch.randn((2,) + CONFIG.img,
                    generator=torch.Generator().manual_seed(1))
    kg.grouped_matmul_chained = rec
    try:
        with torch.no_grad():
            t_cnn.forward_plan(params, CONFIG, x, plan, valid_images=2)
    finally:
        kg.grouped_matmul_chained = real
    assert len(calls) == len(plan.groups_of_mode("grouped_chained")) == 10
    return calls


def test_full_width_bucket2_table_issues_live_work_only(bucket2_calls):
    """The new table issues <= 1.5x the live multiply-adds of a bucket-2
    dispatch's chains; the first design issued about 2.6x (the same
    counting function on its table)."""
    live = issued = stage1 = 0
    for a, k in bucket2_calls:
        spec, m_lim = kg._chain_check(a[0], k["m"], k["h"], k["w"],
                                      k.get("panels", ()), BLK,
                                      k.get("m_valid"))
        la = kg.chained_launch(spec, len(k.get("panels", ())), m_lim,
                               k["h"], k["w"], SMS)
        live += kg.chained_live_macs(la)
        issued += kg.chained_issued_macs(la)
        stage1 += kg.chained_issued_macs(_stage1_launch(spec, m_lim))
        # live widths come from the layout: they equal the weights'
        # nonzero rows (random weights have no zero row of their own)
        nz = sum(k["m_valid"] * br["n"] * int((br["w"] != 0).any(1).sum())
                 for ph in a[0] for br in ph)
        assert kg.chained_live_macs(la) == nz
    assert 11.9e9 < live < 12.0e9
    assert issued <= 1.5 * live, issued / live
    assert 2.5 * live < stage1 < 2.8 * live, stage1 / live


def test_full_width_bucket2_replay_equals_plain(bucket2_calls):
    for a, k in bucket2_calls:
        la = _assert_replay_equals_ref(
            a[0], m=k["m"], h=k["h"], w=k["w"], panels=k.get("panels", ()),
            m_valid=k.get("m_valid"))
        _check_order_and_halos(a[0], la, h=k["h"], w=k["w"])


def test_chip_smoke_k6_yardstick_multiplies_the_live_depth(bucket2_calls):
    """``chip_smoke.py``'s K6 yardstick in miniature: one ``torch.matmul``
    per branch on its live depth does exactly the FLOPs its bound counts,
    and the table's live count is the bound's."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_k6", path)
    cs = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(cs)
    finally:
        sys.path[:] = saved
    assert "grouped_matmul_chained" in cs.REPEAT_KERNELS
    for a, k in bucket2_calls[:3]:
        flops, _ = cs.work_of("grouped_matmul_chained", a, k)
        la = kg.chained_plan(a[0], m=k["m"], h=k["h"], w=k["w"],
                             panels=k.get("panels", ()),
                             m_valid=k.get("m_valid"), sms=SMS)
        outs = cs.library_call("grouped_matmul_chained", a, k)()
        lib = sum(2.0 * o.shape[0] * o.shape[1] * br["w"].shape[0]
                  for o, br in zip(outs, (br for ph in a[0] for br in ph)))
        nz = sum(2.0 * o.shape[0] * o.shape[1]
                 * int((br["w"] != 0).any(1).sum())
                 for o, br in zip(outs, (br for ph in a[0] for br in ph)))
        assert nz == flops < lib
        assert flops == 2.0 * kg.chained_live_macs(la)


@pytest.mark.parametrize("min_depth,split_ctas,lag",
                         [(128, 1, 0), (256, 2, 8), (1 << 30, 1, 3)])
def test_table_replay_holds_under_other_split_depths_and_lags(
        monkeypatch, min_depth, split_ctas, lag):
    """The split depth floor, the split rule and the ticket lag change
    the table, never what it computes nor the order its dependencies
    need."""
    monkeypatch.setattr(kg, "CHAIN_SPLIT_MIN_DEPTH", min_depth)
    monkeypatch.setattr(kg, "CHAIN_SPLIT_CTAS", split_ctas)
    monkeypatch.setattr(kg, "CHAIN_LAG", lag)
    b, h, w = 2, 8, 8
    phases = _stem_like(np.random.default_rng(5), b)
    la = _assert_replay_equals_ref(phases, m=b * h * w, h=h, w=w)
    _check_order_and_halos(phases, la, h=h, w=w)
    phases, panels = _two_phase(np.random.default_rng(3), 4, h, w, True)
    got, la = replay(phases, m=4 * h * w, h=h, w=w, panels=panels,
                     sms=4096)
    ref = kg.grouped_matmul_chained_ref(phases, m=4 * h * w, h=h, w=w,
                                        panels=panels)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= \
            1e-4 * float(r.abs().max()) + 1e-6
    _check_order_and_halos(phases, la, h=h, w=w)
