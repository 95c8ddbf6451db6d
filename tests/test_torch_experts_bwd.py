"""The launch table of the expert MLP backward (K12) on the CPU, and its
arithmetic replayed in plain torch against the JAX reference's kernel in
interpret mode.

K12 runs two launches of 128 x 128 tiles on the pipelined engine
(``grouped_matmul.experts_bwd_launch``): stage A, dH and the activation
VJP per (row tile, F tile); stage B, every dW tile (one CTA walks all
of its expert's live rows), then dX per (row tile, D tile) over dIn and
then dGate.  Its tiles must cover the panel [dIn | dGate] and h (rows x
nw * F), dX (rows x D), dW_out (E x F x D) and dW_in, dW_gate (E x D x
F) once each, no row tile may cross an M-block, and the CTA index the
kernel decodes must name the table's tile.  The replay sums as the
kernel does: dH per (row tile, F tile) on the tile's live rows, each dW
tile over its expert's live rows (its segment, from the block-meta
table), dX per (row tile, D tile) over the concatenated depth [dIn |
dGate] against [W_in^T ; W_gate^T], zeros past the live rows.  It is
held to the reference's ``grouped_matmul_experts_bwd`` run with
``interpret=True``, and at D and F not multiples of 4, which the
reference pads to its tiles, to the port's plain version.

Inputs are made with numpy from a seed and handed to both packages, at
a few hundred rows and columns (every test here allocates a few MB).
Tolerance: rtol 1e-4, atol 1e-5 (float32 gradients, as
``test_torch_moe.py``'s ``GRAD_TOL``).
"""
import bisect
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_matmul as t_gmm
from test_torch_ksplit_experts import LAUNCH_CASES, _packed

# the module, not the function ``repro.kernels`` exports under its name
j_gmm = importlib.import_module("repro.kernels.grouped_matmul")

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
T = t_gmm.EXPERT_TILE

# K11's launch cases with an expert count: (MBS, bm, D, F, E, gated);
# granite-moe-1b-a400m's layer 0 has 32 experts
BWD_LAUNCH_CASES = [(mbs, bm, d, f, 32 if d == 1024 else 8, gated)
                    for mbs, bm, d, f, gated in LAUNCH_CASES]


def _kernel_tile(la, e, d, f, gated, cta):
    """The stage-B tile that CTA ``cta`` decodes from its index, as
    ``experts_dxw_kernel`` does: E x (1 + nw) x tiles dW entries, expert
    by expert, dW_out's (rows over F) then dW_in's and dW_gate's (rows
    over D), then the dX entries, the D tile fastest."""
    nfb, ndb, nw = -(-f // T), -(-d // T), 1 + gated
    per = nfb * ndb
    n_dw = e * (1 + nw) * per
    if cta < n_dw:
        g, u = divmod(cta, (1 + nw) * per)
        which, v = divmod(u, per)
        if which == 0:
            i0, j0, rows, cols = (v // ndb) * T, (v % ndb) * T, f, d
        else:
            i0, j0, rows, cols = (v // nfb) * T, (v % nfb) * T, d, f
        return ("dw", g, ("out", "in", "gate")[which], i0, j0,
                min(T, rows - i0), min(T, cols - j0))
    q, c = divmod(cta - n_dw, ndb)
    b, r0, nr = la["row_tiles"][q]
    return ("dx", b, r0, nr, c * T, min(T, d - c * T))


@pytest.mark.parametrize("case", BWD_LAUNCH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_experts_bwd_tiles_cover_once_within_blocks(case):
    """Stage A covers h and the panel, stage B dX and every dW, once
    each, no row tile crossing an M-block; CTAs in launch order (the
    column tile fastest, the dW tiles first); each CTA index decodes to
    its tile."""
    mbs, bm, d, f, e, gated = case
    la = t_gmm.experts_bwd_launch(mbs, bm, d, f, e, gated)
    assert la["row_tiles"] == t_gmm.experts_launch(mbs, bm, d, f,
                                                   gated)["row_tiles"]
    nw = 1 + gated
    # stage A writes its columns of h and of each half of the panel
    for tiles, width, halves in ((la["dh_tiles"], f, nw),
                                 (la["dx_tiles"], d, 1)):
        # one small cover array per M-block: the tiles of block b lie in it
        by_block: dict = {}
        for b, r0, nr, c0, nc in tiles:
            assert 0 < nr <= T and 0 < nc <= T
            assert b * bm <= r0 and r0 + nr <= (b + 1) * bm
            by_block.setdefault(b, []).append((r0 - b * bm, nr, c0, nc))
        assert sorted(by_block) == list(range(mbs))
        for rects in by_block.values():
            cover = np.zeros((bm, halves * width), np.int8)
            for r, nr, c0, nc in rects:
                for h in range(halves):
                    cover[r:r + nr, h * width + c0:h * width + c0 + nc] += 1
            assert (cover == 1).all()
        # launch order: row tile by row tile, the column tile fastest
        ncol = -(-width // T)
        assert [t[:3] for t in tiles[::ncol]] == list(la["row_tiles"])
        assert [t[3] for t in tiles[:ncol]] == list(range(0, width, T))
    shapes = {"out": (f, d), "in": (d, f), "gate": (d, f)}
    kinds = ("out", "in", "gate")[:1 + nw]
    seen: dict = {}
    for g, which, r0, c0, nr, nc in la["dw_tiles"]:
        seen.setdefault((g, which), []).append((r0, c0, nr, nc))
    assert list(seen) == [(g, w) for g in range(e) for w in kinds]
    for (g, which), rects in seen.items():
        cover = np.zeros(shapes[which], np.int8)
        for r0, c0, nr, nc in rects:
            assert 0 < nr <= T and 0 < nc <= T
            cover[r0:r0 + nr, c0:c0 + nc] += 1
        assert (cover == 1).all()
    assert la["dh_grid"] == (mbs * -(-bm // T) * -(-f // T),)
    assert la["dxw_grid"] == (len(la["dw_tiles"]) + len(la["dx_tiles"]),)
    assert la["ctas"] == la["dh_grid"][0] + la["dxw_grid"][0]
    # the kernel's decoding of blockIdx.x, at every CTA of small tables
    # and at a spread of granite's
    n = la["dxw_grid"][0]
    step = 1 if n < 2000 else 7
    for cta in list(range(0, n, step)) + [n - 1]:
        got = _kernel_tile(la, e, d, f, gated, cta)
        n_dw = len(la["dw_tiles"])
        want = ("dw",) + la["dw_tiles"][cta] if cta < n_dw \
            else ("dx",) + la["dx_tiles"][cta - n_dw]
        assert got == want, cta


def test_experts_bwd_granite_layer0_table():
    """Granite's layer 0 (16384 slots, 32 experts at bm 128, D 1024, F
    512, gated): 640 stage-A CTAs, 3,072 dW CTAs and 1,280 dX CTAs."""
    la = t_gmm.experts_bwd_launch(160, 128, 1024, 512, 32, True)
    assert la["dh_grid"] == (640,)
    assert (len(la["dw_tiles"]), len(la["dx_tiles"])) == (3072, 1280)
    assert la["ctas"] == 640 + 3072 + 1280


def _segment(eid, valid, g, bm):
    """Expert g's first packed row and live rows, as the kernel finds
    them in the block-meta table: its blocks start where the sorted
    expert-id row first reaches g."""
    lo = bisect.bisect_left(eid, g)
    n, b = 0, lo
    while b < len(eid) and eid[b] == g:
        n += valid[b]
        b += 1
    return lo * bm, n


def _experts_bwd_replay(xp, dyp, w_in, w_out, w_gate, hinp, gatep, counts,
                        *, activation, bm):
    """K12's arithmetic from its table: stage A per (row tile, F tile) on
    the tile's live rows, the dW tiles over their experts' live rows, dX
    per (row tile, D tile) over [dIn | dGate]; zeros elsewhere."""
    e, d, f = w_in.shape
    rows = xp.shape[0]
    mbs = rows // bm
    gated = w_gate is not None
    la = t_gmm.experts_bwd_launch(mbs, bm, d, f, e, gated)
    eid, valid = t_gmm._expert_block_meta(counts, mbs, bm).tolist()
    act = t_gmm._moe_act(activation)

    def live_rows(b, r0, nr):
        return max(0, min(nr, valid[b] - (r0 - b * bm)))

    hpost = torch.zeros(rows, f)
    dpan = torch.zeros(rows, (1 + gated) * f)
    for b, r0, nr, c0, nc in la["dh_tiles"]:
        n = live_rows(b, r0, nr)
        r, c = slice(r0, r0 + n), slice(c0, c0 + nc)
        dh = dyp[r] @ w_out[eid[b]][c].t()
        pi = hinp[r, c]
        if gated:
            pg = gatep[r, c]
            s = act(pg)
            hpost[r, c] = s * pi
            dpan[r, c] = dh * s
            dpan[r, f + c0:f + c0 + nc] = \
                t_gmm._moe_act_grad(pg, activation) * (dh * pi)
        else:
            hpost[r, c] = act(pi)
            dpan[r, c] = t_gmm._moe_act_grad(pi, activation) * dh
    dwout = torch.zeros(e, f, d)
    dw = {"in": torch.zeros(e, d, f)}
    if gated:
        dw["gate"] = torch.zeros(e, d, f)
    for g, which, i0, j0, nr, nc in la["dw_tiles"]:
        r0, n = _segment(eid, valid, g, bm)
        r = slice(r0, r0 + n)
        ri, cj = slice(i0, i0 + nr), slice(j0, j0 + nc)
        if which == "out":
            dwout[g, ri, cj] = hpost[r, ri].t() @ dyp[r, cj]
        else:
            p0 = (which == "gate") * f
            dw[which][g, ri, cj] = xp[r, ri].t() @ dpan[r, p0 + j0:p0 + j0 + nc]
    dx = torch.zeros(rows, d)
    for b, r0, nr, c0, nc in la["dx_tiles"]:
        n = live_rows(b, r0, nr)
        ws = [w_in] + ([w_gate] if gated else [])
        wt = torch.cat([w[eid[b]][c0:c0 + nc].t() for w in ws])
        dx[r0:r0 + n, c0:c0 + nc] = dpan[r0:r0 + n] @ wt
    return dx, dw["in"], dw.get("gate"), dwout


def _bwd_inputs(seed, *, e, d, f, bm, gated, act):
    """K12's operands on ``_packed``'s routing (a zero-token expert,
    partial last blocks, dead tail blocks; zeros past the live rows):
    the forward's pre-activations from the plain forward and dYs = dY *
    sw on the live rows."""
    xp, swp, w_in, w_out, w_gate, counts = _packed(seed, e=e, d=d, f=f,
                                                   bm=bm, gated=gated)
    assert counts[1] == 0
    _, hin, gate = t_gmm.grouped_matmul_experts_ref(
        *(None if a is None else torch.from_numpy(a)
          for a in (xp, swp, w_in, w_out, w_gate, counts)),
        activation=act, bm=bm, train=True)
    dy = np.random.default_rng(seed + 1).normal(size=xp.shape)
    dyp = (dy * swp[:, None]).astype(np.float32)
    return [xp, dyp, w_in, w_out, w_gate, hin.numpy(),
            None if gate is None else gate.numpy(), counts]


def _check(got, ref):
    for name, g, r in zip(("dx", "dw_in", "dw_gate", "dw_out"), got, ref):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)


# (E, D, F, bm): the reduced widths at M-blocks of 8 to 32 rows, and one
# case of several tiles each way (F 192: a 64-column edge tile)
REF_CASES = [(8, 128, 64, 8), (8, 128, 64, 16), (8, 128, 64, 32),
             (4, 256, 192, 32)]


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("case", REF_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_experts_bwd_replay_equals_reference_kernel(case, gated, act):
    e, d, f, bm = case
    args = _bwd_inputs(sum(case) + 3 * gated, e=e, d=d, f=f, bm=bm,
                       gated=gated, act=act)
    ref = j_gmm.grouped_matmul_experts_bwd(
        *(None if a is None else jnp.asarray(a) for a in args),
        activation=act, bm=bm, interpret=True)
    got = _experts_bwd_replay(
        *(None if a is None else torch.from_numpy(a) for a in args),
        activation=act, bm=bm)
    _check(got, ref)
    for dw in got[1:]:
        if dw is not None:
            assert not dw[1].any()   # the zero-token expert


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
@pytest.mark.parametrize("bm", [16, 128])
def test_experts_bwd_replay_at_unaligned_widths_equals_plain(bm, gated, act):
    """D 90 and F 75, multiples of neither 4 nor 128 (the kernel's 4-byte
    copies and edge tiles), against the port's plain version."""
    args = _bwd_inputs(bm + gated, e=8, d=90, f=75, bm=bm, gated=gated,
                       act=act)
    ts = [None if a is None else torch.from_numpy(a) for a in args]
    ref = t_gmm.grouped_matmul_experts_bwd_ref(*ts, activation=act, bm=bm)
    _check(_experts_bwd_replay(*ts, activation=act, bm=bm), ref)
