"""The fused plan mode on the CPU against the JAX reference: K10's plain
version (what ``kernels.fused_branches.fused_gemm_reduce`` takes for CPU
tensors) against the reference's Pallas kernel in interpret mode, the
differentiable ``ops.fused_gemm_reduce`` against ``jax.vjp`` of the
reference's custom VJP, the fused-pair plans of both packages, and the
fused and serial plans of that pair run through both packages'
``run_plan``, forward and gradients.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the kernel's plain version rtol = atol = 2e-4 (the
reference's own kernel-test tolerance), gradients and planned runs
rtol = atol = 1e-4 — the two sides sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Op as JOp
from repro.core import OpGraph as JGraph
from repro.core import OpImpl as JOpImpl
from repro.core import lower as j_lower
from repro.core import run_plan as j_run_plan
from repro.core import schedule as j_schedule
from repro.core.plan import backward_plan as j_backward_plan
from repro.core.scheduler import CoGroup as JCoGroup
from repro.core.scheduler import Schedule as JSchedule
from repro.kernels import fused_branches as j_fused
from repro.kernels import ops as j_ops
from repro_torch.core import plan as t_plan
from repro_torch.core.graph import Op as TOp
from repro_torch.core.graph import OpGraph as TGraph
from repro_torch.core.scheduler import CoGroup as TCoGroup
from repro_torch.core.scheduler import Schedule as TSchedule
from repro_torch.core.scheduler import schedule as t_schedule
from repro_torch.kernels import fused_branches as t_fused
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt

torch.set_num_threads(2)



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


# the cases K10 is held at on the card (``chip_smoke.FUSED_CASES``): the
# reference's kernel-test cases (its tests/test_kernels_fused.py) and
# four of the port's own, (M, K, N, R, C)
CASES = _load_chip_smoke("_chip_smoke_fused_cases").FUSED_CASES
# the fused pairs (GEMM M x K x N, reduction elements) that lower to
# one fused group: the reference benchmark's co-execution shape
# (benchmarks/branch_parallel_bench.py) and two smaller ones
PAIRS = [(2048, 2048, 2048, 65536 * 128), (1024, 2048, 1024, 1 << 22),
         (512, 1024, 512, 1 << 20)]
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_fused_gemm_reduce_ref_equals_reference_kernel(case):
    """Through the reference's ``ops.fused_gemm_reduce``, which pads M, K
    and N to its kernel's 128-blocks (the port's kernel masks them)."""
    m, k, n, r, c = case
    rng = np.random.default_rng(sum(case))
    x, y, z = _np(rng, m, k), _np(rng, k, n), _np(rng, r, c)
    wc, wr = j_ops.fused_gemm_reduce(jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(z), interpret=True)
    gc, gr = t_fused.fused_gemm_reduce(_t(x), _t(y), _t(z))
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("c", [8, 32, 64])
@pytest.mark.parametrize("r", [1, 2, 7, 63, 64, 65, 127, 128, 129, 331,
                               512, 599, 600])
def test_fused_gemm_reduce_any_reduce_shape(r, c):
    """Every R from 1 to 600 is legal: the reference pads z to its grid,
    the port's kernel masks rows past R (a sample of R around the
    reference's one-step grid and past it, at the property test's C)."""
    rng = np.random.default_rng(r * 100 + c)
    x, y, z = _np(rng, 128, 128), _np(rng, 128, 128), _np(rng, r, c)
    wc, wr = j_fused.fused_gemm_reduce(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(z), interpret=True)
    gc, gr = t_fused.fused_gemm_reduce(_t(x), _t(y), _t(z))
    assert gr.shape == (c,)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=2e-4,
                               atol=2e-4)


def test_fused_gemm_reduce_cpu_launches_nothing():
    t_rt.reset_launch_counts()
    rng = np.random.default_rng(0)
    t_fused.fused_gemm_reduce(_t(_np(rng, 8, 4)), _t(_np(rng, 4, 3)),
                              _t(_np(rng, 5, 2)))
    assert t_rt.KERNEL_LAUNCHES["fused_gemm_reduce"] == 0


def test_fused_gemm_reduce_rejects_bad_operands():
    with pytest.raises(ValueError, match="fused_gemm_reduce"):
        t_fused.fused_gemm_reduce(torch.ones(4, 3), torch.ones(4, 2),
                                  torch.ones(5, 2))
    with pytest.raises(TypeError, match="float32"):
        t_fused.fused_gemm_reduce(torch.ones(4, 3, dtype=torch.float64),
                                  torch.ones(3, 2, dtype=torch.float64),
                                  torch.ones(5, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        t_fused.fused_gemm_reduce(torch.ones(3, 4).t(), torch.ones(3, 2),
                                  torch.ones(5, 2))


@pytest.mark.parametrize("shape", [(96, 130, 72, 77, 40),
                                   (128, 128, 128, 512, 128)],
                         ids=["ragged", "aligned"])
def test_ops_fused_gemm_reduce_gradients_equal_reference(shape):
    m, k, n, r, c = shape
    rng = np.random.default_rng(m + r)
    x, y, z = _np(rng, m, k, scale=0.1), _np(rng, k, n, scale=0.1), \
        _np(rng, r, c)
    dc, dr = _np(rng, m, n), _np(rng, c)
    (wc, wr), vjp = jax.vjp(
        lambda a, b, cz: j_ops.fused_gemm_reduce(a, b, cz, interpret=True),
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    wdx, wdy, wdz = vjp((jnp.asarray(dc), jnp.asarray(dr)))
    tx, ty, tz = _t(x, True), _t(y, True), _t(z, True)
    gc, gr = t_ops.fused_gemm_reduce(tx, ty, tz)
    np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(gr.detach().numpy(), np.asarray(wr), **TOL)
    gdx, gdy, gdz = torch.autograd.grad((gc, gr), (tx, ty, tz),
                                        (_t(dc), _t(dr)))
    for got, want in ((gdx, wdx), (gdy, wdy), (gdz, wdz)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _pair_graph(graph_cls, op_cls, m, k, n, elements):
    g = graph_cls()
    g.add(op_cls.make("gemm", "matmul", m=m, k=k, n=n))
    g.add(op_cls.make("red", "pointwise", elements=elements))
    return g


def _rows(plan):
    return [(g.mode, g.ops, g.algorithms, g.reason) for g in plan.groups]


@pytest.mark.parametrize("concurrent", [True, False])
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: "x".join(map(str, p)))
def test_fused_pair_plans_equal_reference(pair, concurrent):
    """``schedule`` then ``lower`` (and the mirrored ``backward_plan``)
    give the same plans in both packages: one fused group (GEMM at
    ``large_tile``, the reduction at ``vpu``) when concurrent, serial
    singletons otherwise."""
    jg, tg = _pair_graph(JGraph, JOp, *pair), _pair_graph(TGraph, TOp, *pair)
    jp = j_lower(jg, j_schedule(jg, concurrent=concurrent))
    tp = t_plan.lower(tg, t_schedule(tg, concurrent=concurrent))
    assert _rows(tp) == _rows(jp)
    if concurrent:
        assert tp.mode_counts() == {"fused": 1}
        assert tp.groups[0].algorithms == {"gemm": "large_tile",
                                           "red": "vpu"}
    for a, b in zip(tp.groups, jp.groups):
        assert a.modeled_time == pytest.approx(b.modeled_time, rel=1e-12)
    jb, tb = j_backward_plan(jg, jp), t_plan.backward_plan(tg, tp)
    assert _rows(tb) == _rows(jb)
    for a, b in zip(tb.groups, jb.groups):
        assert a.modeled_time == pytest.approx(b.modeled_time, rel=1e-12)


def _fused_case(rng):
    """The reference's trainable fused-plan setup (its tests/test_plan.py):
    a 256^3 GEMM and a 512 x 128 reduction."""
    return (_np(rng, 256, 256, scale=0.1), _np(rng, 256, 256, scale=0.1),
            _np(rng, 512, 128))


def _plan(pkg, alg):
    """The pair's fused plan (``alg`` None) or its serial plan with the
    GEMM at ``alg``, lowered by ``pkg`` ("jax" or "torch") from the
    reference test's graph (a 1024 x 2048 x 1024 GEMM beside 2^22
    elements; its tensors are smaller, as there)."""
    graph_cls, op_cls, co, sch, low = (
        (JGraph, JOp, JCoGroup, JSchedule, j_lower) if pkg == "jax"
        else (TGraph, TOp, TCoGroup, TSchedule, t_plan.lower))
    g = _pair_graph(graph_cls, op_cls, *PAIRS[1])
    if alg is None:
        cgs = [co(["gemm", "red"], {"gemm": "mxu128", "red": "vpu"}, 1.0)]
    else:
        cgs = [co(["gemm"], {"gemm": alg}, 1.0),
               co(["red"], {"red": "vpu"}, 1.0)]
    return low(g, sch(cgs))


def _j_impls(w):
    """The reference test's bindings: its serial GEMM is plain ``x @ w``
    (the reference's zoo GEMM has no VJP)."""
    return {
        "gemm": JOpImpl(deps=("xin",), fn=lambda x, algorithm=None: x @ w,
                        gemm_x=lambda x: x, gemm_w=w,
                        gemm_post=lambda y: y),
        "red": JOpImpl(deps=("zin",),
                       fn=lambda z, algorithm=None: jax.nn.silu(z).sum(0),
                       stream_z=lambda z: z, stream_post=lambda r: r),
    }


def _t_impls(w):
    return {
        "gemm": t_plan.OpImpl(deps=("xin",),
                              fn=lambda x, algorithm=None: t_ops.matmul(
                                  x, w, algorithm=algorithm or "mxu128"),
                              gemm_x=lambda x: x, gemm_w=w,
                              gemm_post=lambda y: y),
        "red": t_plan.OpImpl(deps=("zin",),
                             fn=lambda z, algorithm=None:
                             torch.nn.functional.silu(z).sum(0),
                             stream_z=lambda z: z,
                             stream_post=lambda r: r),
    }


@pytest.mark.parametrize("alg", [None, "mxu128", "large_tile", "ksplit"],
                         ids=["fused", "serial-mxu128", "serial-large_tile",
                              "serial-ksplit"])
def test_run_plan_fused_pair_equals_reference(alg):
    """The fused plan (one K10 call) and the serial plan of the same
    graph (the port's GEMM on each zoo algorithm's plain version), run
    through both packages' ``run_plan`` on the same tensors: both outputs
    and the gradients of ``sum(gemm) + sum(red)`` with respect to x and
    z."""
    x, w, z = _fused_case(np.random.default_rng(3))
    jp, tp = _plan("jax", alg), _plan("torch", alg)
    assert _rows(tp) == _rows(jp)
    assert tp.mode_counts() == ({"fused": 1} if alg is None
                                else {"serial": 2})
    jw = jnp.asarray(w)

    def j_loss(xx, zz):
        env = j_run_plan(_j_impls(jw), {"xin": xx, "zin": zz}, jp)
        return env["gemm"].sum() + env["red"].sum(), (env["gemm"],
                                                      env["red"])

    (jl, (jc, jr)), (jdx, jdz) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(z))
    tx, tz = _t(x, True), _t(z, True)
    env = t_plan.run_plan(_t_impls(_t(w)), {"xin": tx, "zin": tz}, tp)
    tl = env["gemm"].sum() + env["red"].sum()
    tdx, tdz = torch.autograd.grad(tl, (tx, tz))
    np.testing.assert_allclose(env["gemm"].detach().numpy(), np.asarray(jc),
                               **TOL)
    np.testing.assert_allclose(env["red"].detach().numpy(), np.asarray(jr),
                               **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tdz.numpy(), np.asarray(jdz), **TOL)


def test_run_plan_fused_group_takes_the_plain_version_on_the_cpu(
        monkeypatch):
    """On CPU tensors the fused group calls K10's wrapper once, which
    takes the plain version and launches nothing."""
    calls = []
    real = t_fused.fused_gemm_reduce_ref
    monkeypatch.setattr(t_fused, "fused_gemm_reduce_ref",
                        lambda *a: calls.append(a) or real(*a))
    x, w, z = _fused_case(np.random.default_rng(4))
    t_rt.reset_launch_counts()
    env = t_plan.run_plan(_t_impls(_t(w)), {"xin": _t(x), "zin": _t(z)},
                          _plan("torch", None))
    assert len(calls) == 1
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0
    assert env["gemm"].shape == (256, 256) and env["red"].shape == (128,)


def test_run_plan_fused_group_needs_one_gemm_and_one_stream_binding():
    """No per-op fallback: a fused group whose bindings lack the views
    raises, naming the mode (the reference degrades it to per-op XLA)."""
    x, w, z = _fused_case(np.random.default_rng(5))
    impls = _t_impls(_t(w))
    impls["red"] = t_plan.OpImpl(deps=("zin",), fn=impls["red"].fn)
    with pytest.raises(NotImplementedError, match="fused"):
        t_plan.run_plan(impls, {"xin": _t(x), "zin": _t(z)},
                        _plan("torch", None))
