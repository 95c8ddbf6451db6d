"""The PyTorch port's MoE expert engine on the CPU against the JAX
reference: the block helpers, K11's and K12's plain versions (what the
wrappers take for CPU tensors) against the reference kernels in Pallas
interpret mode and against ``jax.vjp`` of the reference's custom VJP,
the autograd Function by ``gradcheck``, the router's integers, and the
MoE layer with both engines.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32, rtol 1e-5 and atol 1e-6 unless a test says
otherwise; integers and the zero-token expert's dW exactly.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.models import moe as j_moe
from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import moe as t_moe

j_gmm = importlib.import_module("repro.kernels.grouped_matmul")

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
# sums over the contraction in another order than XLA's, at |values| ~ 1-10
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    j_ops.reset_launch_counts()
    t_rt.reset_launch_counts()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# block helpers
# ---------------------------------------------------------------------------

COUNT_MIXES = {
    "zero_token_expert": [5, 0, 17, 8],
    "all_on_one_expert": [0, 0, 30, 0],
    "dead_tail": [1, 2, 0, 3],
    "block_aligned": [16, 8, 24, 0],
}


@pytest.mark.parametrize("n,e", [(1, 1), (7, 8), (64, 8), (1000, 8),
                                 (16384, 32), (20000, 3)])
def test_block_m_and_static_blocks_equal_reference(n, e):
    bm = t_gmm.moe_block_m(n, e)
    assert bm == j_gmm.moe_block_m(n, e)
    assert t_gmm.moe_static_blocks(n, e, bm) == \
        j_gmm.moe_static_blocks(n, e, bm)


@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("mix", sorted(COUNT_MIXES))
def test_row_offsets_and_block_meta_equal_reference(mix, bm):
    counts = np.array(COUNT_MIXES[mix], np.int32)
    n = int(counts.sum()) + 5
    mbs = t_gmm.moe_static_blocks(n, len(counts), bm)
    np.testing.assert_array_equal(
        t_gmm.expert_row_offsets(_t(counts), bm).numpy(),
        np.asarray(j_gmm.expert_row_offsets(jnp.asarray(counts), bm)))
    got = t_gmm._expert_block_meta(_t(counts), mbs, bm)
    assert got.dtype == torch.int32 and got.shape == (2, mbs)
    # the reference's rows 2-3 (first/last block flags) carry its
    # accumulators across the in-order grid; the port's kernels have none
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(j_gmm._expert_block_meta(jnp.asarray(counts), mbs,
                                            bm))[:2])
    # K12's dW tiles find each expert's segment in the table alone: its
    # blocks start where the sorted expert-id row first reaches it, and
    # its live rows are the sum of those blocks' valid rows
    eid, valid = got.numpy()
    offs = np.asarray(j_gmm.expert_row_offsets(jnp.asarray(counts), bm))
    for g, c in enumerate(counts):
        b0, b1 = np.searchsorted(eid, [g, g + 1], side="left")
        assert b0 * bm == offs[g] and valid[b0:b1].sum() == c


def test_flops_equal_reference():
    for args in [(16384, 32, 1024, 512, True, 128), (64, 8, 96, 80, False, 8)]:
        n, e, d, f, gated, bm = args
        assert t_gmm.grouped_matmul_experts_flops(n, e, d, f, gated=gated,
                                                  bm=bm) == \
            j_gmm.grouped_matmul_experts_flops(n, e, d, f, gated=gated,
                                               bm=bm)


# ---------------------------------------------------------------------------
# K11 / K12 plain versions against the reference kernels
# ---------------------------------------------------------------------------

def _packed_case(seed, *, e=4, d=24, f=20, bm=8, gated=True,
                 counts=(5, 0, 17, 8)):
    """Tokens packed into block-aligned per-expert segments (zeros
    elsewhere, as the dispatch packs them), with a zero-token expert and
    dead tail blocks."""
    rng = np.random.default_rng(seed)
    counts = np.array(counts, np.int32)
    n = int(counts.sum()) + 3
    mbs = t_gmm.moe_static_blocks(n, e, bm)
    offs = t_gmm.expert_row_offsets(_t(counts), bm).numpy()
    xp = np.zeros((mbs * bm, d), np.float32)
    swp = np.zeros((mbs * bm,), np.float32)
    for a, c in zip(offs, counts):
        xp[a:a + c] = rng.normal(size=(c, d))
        swp[a:a + c] = rng.uniform(0.1, 1.0, size=c)
    w_in = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32)
    w_gate = (rng.normal(size=(e, d, f)) * d ** -0.5).astype(np.float32) \
        if gated else None
    w_out = (rng.normal(size=(e, f, d)) * f ** -0.5).astype(np.float32)
    dy = rng.normal(size=(mbs * bm, d)).astype(np.float32)
    return dict(xp=xp, swp=swp, w_in=w_in, w_out=w_out, w_gate=w_gate,
                counts=counts, dy=dy, bm=bm)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _tt(a, grad=False):
    return None if a is None else _t(a).requires_grad_(grad)


KERNEL_CASES = [("silu", True, 8), ("silu", True, 16), ("gelu", True, 8),
                ("gelu", True, 16), ("silu", False, 8), ("gelu", False, 16)]


@pytest.mark.parametrize("act,gated,bm", KERNEL_CASES)
def test_experts_plain_equals_reference_kernel(act, gated, bm):
    c = _packed_case(1, bm=bm, gated=gated)
    args = [c["xp"], c["swp"], c["w_in"], c["w_out"], c["w_gate"],
            c["counts"]]
    ref = j_gmm.grouped_matmul_experts(*map(_j, args), activation=act,
                                       train=True, bm=bm, interpret=True)
    got = t_gmm.grouped_matmul_experts(*map(_tt, args), activation=act,
                                       train=True, bm=bm)
    for g, r in zip(got, ref):
        if r is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    y_only = t_gmm.grouped_matmul_experts(*map(_tt, args), activation=act,
                                          bm=bm)
    np.testing.assert_array_equal(y_only.numpy(), got[0].numpy())
    np.testing.assert_allclose(
        y_only.numpy(),
        np.asarray(j_gmm.grouped_matmul_experts_ref(
            *map(_j, args), activation=act, bm=bm)), **TOL)


@pytest.mark.parametrize("act,gated,bm", KERNEL_CASES)
def test_experts_bwd_plain_equals_reference_kernel(act, gated, bm):
    c = _packed_case(2, bm=bm, gated=gated)
    args = [c["xp"], c["swp"], c["w_in"], c["w_out"], c["w_gate"],
            c["counts"]]
    _, hin, gate = t_gmm.grouped_matmul_experts(*map(_tt, args),
                                                activation=act, train=True,
                                                bm=bm)
    bargs = [c["xp"], c["dy"], c["w_in"], c["w_out"], c["w_gate"],
             hin.numpy(), None if gate is None else gate.numpy(),
             c["counts"]]
    ref = j_gmm.grouped_matmul_experts_bwd(*map(_j, bargs), activation=act,
                                           bm=bm, interpret=True)
    got = t_gmm.grouped_matmul_experts_bwd(*map(_tt, bargs), activation=act,
                                           bm=bm)
    for name, g, r in zip(("dx", "dw_in", "dw_gate", "dw_out"), got, ref):
        if r is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("act,gated,bm", KERNEL_CASES)
def test_experts_vjp_equals_reference_vjp(act, gated, bm):
    """dx, dsw, dW_in, dW_gate, dW_out of the port's autograd Function
    (one K12 call + the dsw row reduction) against ``jax.vjp`` of the
    reference's custom VJP; the zero-token expert's dW exactly 0."""
    c = _packed_case(3, bm=bm, gated=gated)
    names = ["xp", "swp", "w_in", "w_out"] + (["w_gate"] if gated else [])

    def jfn(*ts):
        kw = dict(zip(names, ts))
        return j_ops.grouped_matmul_experts(
            kw["xp"], kw["swp"], kw["w_in"], kw["w_out"], kw.get("w_gate"),
            jnp.asarray(c["counts"]), activation=act, interpret=True, bm=bm)

    y_j, vjp = jax.vjp(jfn, *(jnp.asarray(c[k]) for k in names))
    ref = vjp(jnp.asarray(c["dy"]))

    ts = {k: _tt(c[k], grad=True) for k in names}
    y_t = t_ops.grouped_matmul_experts(
        ts["xp"], ts["swp"], ts["w_in"], ts["w_out"], ts.get("w_gate"),
        _t(c["counts"]), activation=act, bm=bm)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    got = torch.autograd.grad(y_t, [ts[k] for k in names], _t(c["dy"]))
    for k, g, r in zip(names, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **GRAD_TOL,
                                   err_msg=k)
        if k.startswith("w_"):
            assert bool((g[1] == 0).all()), f"{k}: zero-token expert dW"


def test_experts_function_gradcheck_float64(monkeypatch):
    """The autograd Function's backward (K12's plain version + dsw)
    against finite differences of its forward, float64, tiny sizes.  The
    wrappers take float32 only, so the Function is pointed at the plain
    versions, which they call for CPU tensors anyway."""
    monkeypatch.setattr(t_gmm, "grouped_matmul_experts",
                        t_gmm.grouped_matmul_experts_ref)
    monkeypatch.setattr(t_gmm, "grouped_matmul_experts_bwd",
                        t_gmm.grouped_matmul_experts_bwd_ref)
    for gated, act in ((True, "silu"), (False, "gelu")):
        c = _packed_case(4, e=3, d=5, f=4, bm=8, gated=gated,
                         counts=(3, 0, 9))
        names = ["xp", "swp", "w_in", "w_out"] + (["w_gate"] if gated
                                                  else [])
        ts = [torch.from_numpy(c[k].astype(np.float64)).requires_grad_(True)
              for k in names]
        counts = _t(c["counts"])

        def fn(*a):
            kw = dict(zip(names, a))
            return t_ops.grouped_matmul_experts(
                kw["xp"], kw["swp"], kw["w_in"], kw["w_out"],
                kw.get("w_gate"), counts, activation=act, bm=8)
        assert torch.autograd.gradcheck(fn, ts, eps=1e-6, atol=1e-6,
                                        rtol=1e-5)


def test_experts_wrappers_check_their_inputs():
    c = _packed_case(5)
    args = [_tt(c[k]) for k in ("xp", "swp", "w_in", "w_out", "w_gate")]
    with pytest.raises(ValueError, match="bm=3"):
        t_gmm.grouped_matmul_experts(*args, _t(c["counts"]), bm=3)
    with pytest.raises(ValueError, match="do not fit"):
        t_gmm.grouped_matmul_experts(*args, _t(c["counts"][:2]), bm=8)
    with pytest.raises(TypeError, match="counts"):
        t_gmm.grouped_matmul_experts(*args, _t(c["counts"]).float(), bm=8)
    with pytest.raises(ValueError, match="activation"):
        t_gmm.grouped_matmul_experts(*args, _t(c["counts"]), bm=8,
                                     activation="relu")
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_experts"] == 0


# ---------------------------------------------------------------------------
# routing and the MoE layer
# ---------------------------------------------------------------------------

def _moe_case(seed, *, b=2, s=24, d=32, f=16, e=8, shared_f=0, gated=True):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) * d ** -0.5,
         "w_in": rng.normal(size=(e, d, f)) * d ** -0.5,
         "w_out": rng.normal(size=(e, f, d)) * f ** -0.5}
    if gated:
        p["w_gate"] = rng.normal(size=(e, d, f)) * d ** -0.5
    if shared_f:
        p["shared"] = {"w_in": rng.normal(size=(d, shared_f)) * d ** -0.5,
                       "w_out": rng.normal(size=(shared_f, d))
                       * shared_f ** -0.5,
                       "w_gate": rng.normal(size=(d, shared_f)) * d ** -0.5}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    return p, x


def _to_j(p):
    return jax.tree.map(jnp.asarray, p)


def _to_t(p):
    if isinstance(p, dict):
        return {k: _to_t(v) for k, v in p.items()}
    return _t(p)


@pytest.mark.parametrize("top_k,cf", [(2, 1.0), (2, 4.0), (1, 1.25),
                                      (8, 1.25)])
def test_route_integers_equal_reference(top_k, cf):
    p, x = _moe_case(6, e=16 if top_k == 8 else 8)
    (probs, flat_e, se, st, sw, pos, keep, _, cap, brow, e, _, sk) = \
        j_moe._route(_to_j(p), jnp.asarray(x), top_k=top_k,
                     capacity_factor=cf)
    got = t_moe._route(_to_t(p), _t(x), top_k=top_k, capacity_factor=cf)
    (t_probs, t_flat_e, t_se, t_st, t_sw, t_pos, t_keep, t_cap, t_brow,
     t_e, t_sk) = got
    assert (t_cap, t_e, t_sk) == (cap, e, sk)
    for name, a, r in (("ids", t_flat_e, flat_e), ("expert order", t_se, se),
                       ("token order", t_st, st), ("pos", t_pos, pos),
                       ("keep", t_keep, keep), ("brow", t_brow, brow)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r),
                                      err_msg=name)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(probs), **TOL)
    np.testing.assert_allclose(t_sw.numpy(), np.asarray(sw), **TOL)
    if cf == 1.0:
        assert not bool(t_keep.all()), "the case should drop tokens"


MOE_CASES = [
    dict(top_k=2, cf=4.0),
    dict(top_k=2, cf=1.0),                       # capacity drops
    dict(top_k=1, cf=1.25, gated=False),
    dict(top_k=2, cf=1.25, shared_f=24),
    dict(top_k=8, cf=1.25, e=16, act="gelu"),
]


@pytest.mark.parametrize("impl", ["einsum", "grouped"])
@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_apply_equals_reference(case, impl):
    kw = dict(MOE_CASES[case])
    top_k, cf = kw.pop("top_k"), kw.pop("cf")
    act = kw.pop("act", "silu")
    p, x = _moe_case(7 + case, **kw)
    out_j, aux_j = j_moe.moe_apply(_to_j(p), jnp.asarray(x), top_k=top_k,
                                   capacity_factor=cf, activation=act,
                                   impl=impl, interpret=True)
    out_t, aux_t = t_moe.moe_apply(_to_t(p), _t(x), top_k=top_k,
                                   capacity_factor=cf, activation=act,
                                   impl=impl)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    assert aux_t["capacity"] == aux_j["capacity"]
    for k in ("aux_loss", "drop_fraction", "padded_slot_fraction"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("impl", ["einsum", "grouped"])
def test_moe_apply_grads_equal_reference(impl):
    p, x = _moe_case(12)
    dy = np.random.default_rng(13).normal(size=x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = j_moe.moe_apply(pp, xx, top_k=2, capacity_factor=1.25,
                                   impl=impl, interpret=True)
        return jnp.sum(out * dy) + aux["aux_loss"]

    gp_j, gx_j = jax.grad(jloss, argnums=(0, 1))(_to_j(p), jnp.asarray(x))
    pt = {k: v.requires_grad_(True) for k, v in _to_t(p).items()}
    xt = _t(x).requires_grad_(True)
    out, aux = t_moe.moe_apply(pt, xt, top_k=2, capacity_factor=1.25,
                               impl=impl)
    loss = (out * _t(dy)).sum() + aux["aux_loss"]
    names = sorted(pt)
    got = torch.autograd.grad(loss, [pt[k] for k in names] + [xt])
    for k, g in zip(names + ["x"], got):
        r = np.asarray(gx_j if k == "x" else gp_j[k])
        np.testing.assert_allclose(g.numpy(), r, **GRAD_TOL, err_msg=k)


def test_moe_grouped_engine_one_call_per_direction():
    """A grouped moe_apply forward makes ONE expert call, and its
    backward ONE expert backward call (plain versions on the CPU count no
    launch; the call count is what the card counts as launches)."""
    p, x = _moe_case(14)
    pt = {k: v.requires_grad_(True) for k, v in _to_t(p).items()}
    calls = {"fwd": 0, "bwd": 0}
    real_f, real_b = t_gmm.grouped_matmul_experts, \
        t_gmm.grouped_matmul_experts_bwd

    def f(*a, **k):
        calls["fwd"] += 1
        return real_f(*a, **k)

    def b(*a, **k):
        calls["bwd"] += 1
        return real_b(*a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(t_gmm, "grouped_matmul_experts", f)
    mp.setattr(t_gmm, "grouped_matmul_experts_bwd", b)
    try:
        out, _ = t_moe.moe_apply(pt, _t(x), top_k=2, capacity_factor=1.25,
                                 impl="grouped")
        assert calls == {"fwd": 1, "bwd": 0}
        out.sum().backward()
        assert calls == {"fwd": 1, "bwd": 1}
    finally:
        mp.undo()
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


def test_moe_capacity_equals_reference():
    for sk, cf, e in [(16, 1.25, 8), (4096, 1.25, 32), (3, 4.0, 8),
                      (100, 1.0, 7), (64, 0.5, 8)]:
        assert t_moe.moe_capacity(sk, cf, e) == j_moe.moe_capacity(sk, cf, e)


def _chip_smoke():
    """The repository's ``chip_smoke.py`` as a module (it imports torch
    only inside its functions and runs nothing on import)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_moe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_expert_checks_reject_a_wrong_tensor(monkeypatch):
    """The smoke script holds each K11/K12 output tensor on its own: a
    zeroed pre-activation or weight gradient fails, the plain versions
    pass; its block-size sweep runs end to end on the plain versions."""
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))  # chip_smoke adds src/
    cs = _chip_smoke()
    c = _packed_case(15)
    fwd = tuple(_tt(c[k]) for k in ("xp", "swp", "w_in", "w_out",
                                    "w_gate")) + (_t(c["counts"]),)
    kw = dict(activation="silu", bm=8)
    got = t_gmm.grouped_matmul_experts(*fwd, train=True, **kw)
    cs.check_outputs("fwd", *cs._outputs("grouped_matmul_experts", got, got,
                                         fwd, kw))
    bad = (got[0], torch.zeros_like(got[1]), got[2])
    with pytest.raises(RuntimeError, match="hin"):
        cs.check_outputs("fwd", *cs._outputs("grouped_matmul_experts", bad,
                                             got, fwd, kw))
    bwd = (fwd[0], _t(c["dy"]), fwd[2], fwd[3], fwd[4], got[1], got[2],
           fwd[5])
    gb = t_gmm.grouped_matmul_experts_bwd(*bwd, **kw)
    bad = (gb[0], gb[1], torch.zeros_like(gb[2]), gb[3])
    with pytest.raises(RuntimeError, match="dW_gate"):
        cs.check_outputs("bwd", *cs._outputs("grouped_matmul_experts_bwd",
                                             bad, gb, bwd, kw))
    flops, byts = cs.work_of("grouped_matmul_experts_bwd", bwd, kw)
    assert flops == 2.0 * int(c["counts"].sum()) * 24 * 20 * 6 and byts > 0
    cs.check_expert_block_sizes(torch.device("cpu"))
