"""The paper's two baselines in the PyTorch port, on the CPU against the
JAX reference: the serial plan (``plan_cnn(concurrent=False)``) and the
stacked plan (``plan_cnn(fuse_pool=False)``, whose uniform quads run K9)
equal the reference's plans; K9's plain version and its autograd Function
equal the reference's ``branch_matmul`` and its VJP; reduced GoogLeNet
trains through both plans as the reference does; the float64 reference
``chip_smoke.py`` holds those plans to on the card follows the pieces it
is given; and the trainer's ``--plan serial`` runs end to end.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32, rtol = atol = 1e-4 unless a test says otherwise —
the two sides sum in different orders.
"""
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

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
from repro_torch.configs.googlenet import CONFIG as T_FULL
from repro_torch.configs.googlenet import reduced as t_reduced
from repro_torch.data import Pipeline as TPipeline
from repro_torch.data import SyntheticImages as TSyntheticImages
from repro_torch.kernels import branch_matmul as t_bmm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import cnn as t_cnn
from repro_torch.optim import tree_leaves, tree_map

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)
CFGS = {"full": (J_FULL, T_FULL), "reduced": (j_reduced(), t_reduced())}
# plan_cnn keywords of each baseline (both packages take the same ones)
BASELINES = {"serial": {"concurrent": False}, "stacked": {"fuse_pool": False}}


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


def _rows(plan):
    return [(g.mode, g.ops, g.algorithms, g.join, g.pools, g.chain, g.reason)
            for g in plan.groups]


# ---------------------------------------------------------------------------
# (a) the plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2, 3, 5, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("baseline", ["serial", "stacked"])
def test_baseline_plan_equals_reference(baseline, which, batch):
    jcfg, tcfg = CFGS[which]
    kw = BASELINES[baseline]
    jplan, jsch = j_cnn.plan_cnn(jcfg, batch, train=True, **kw)
    tplan, tsch = t_cnn.plan_cnn(tcfg, batch, train=True, **kw)
    assert [(g.ops, g.algorithms, g.serialized) for g in tsch.groups] == \
        [(g.ops, g.algorithms, g.serialized) for g in jsch.groups]
    for tg, jg in zip(tsch.groups, jsch.groups):
        assert tg.time == pytest.approx(jg.time, rel=1e-9)
    for tp, jp in ((tplan, jplan), (tplan.context["backward"],
                                    jplan.context["backward"])):
        assert _rows(tp) == _rows(jp)
        for tg, jg in zip(tp.groups, jp.groups):
            assert tg.modeled_time == pytest.approx(jg.modeled_time,
                                                    rel=1e-9)
    modes = tplan.mode_counts()
    if baseline == "serial":
        assert set(modes) == {"serial"}
        assert all(len(g.ops) == 1 for g in tplan.groups)
    else:
        # no pool is absorbed: every maxpool stays a serial group
        assert not any(g.pools for g in tplan.groups)
        assert "grouped_pooled" not in modes
    if which == "full" and batch == 8:
        want = {"serial": {"serial": 79},
                "stacked": {"serial": 16, "stacked": 3,
                            "grouped_concat": 9, "grouped": 6}}[baseline]
        assert modes == want


# ---------------------------------------------------------------------------
# (b) K9: plain version and autograd Function
# ---------------------------------------------------------------------------

BMM_SHAPES = [(3, 37, 20, 45), (4, 130, 129, 7), (2, 1, 200, 130)]


@pytest.mark.parametrize("g,m,k,n", BMM_SHAPES)
def test_branch_matmul_ref_equals_reference(g, m, k, n):
    rng = np.random.default_rng(g * m + k + n)
    x = rng.normal(size=(g, m, k)).astype(np.float32)
    y = rng.normal(size=(g, k, n)).astype(np.float32)
    want = _np(j_ops.branch_matmul(jnp.asarray(x), jnp.asarray(y),
                                   interpret=True))
    np.testing.assert_allclose(t_bmm.branch_matmul_ref(_t(x), _t(y)).numpy(),
                               want, **TOL)
    # the wrapper takes the plain version for CPU tensors, in either
    # layout, and launches nothing
    np.testing.assert_allclose(t_bmm.branch_matmul(_t(x), _t(y)).numpy(),
                               want, **TOL)
    xt = _t(x.transpose(0, 2, 1)).transpose(1, 2)
    np.testing.assert_allclose(t_bmm.branch_matmul(xt, _t(y)).numpy(),
                               want, **TOL)
    assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == 0


@pytest.mark.parametrize("g,m,k,n", BMM_SHAPES)
def test_branch_matmul_function_gradients_equal_reference(g, m, k, n):
    rng = np.random.default_rng(g + m * k + n)
    x = rng.normal(size=(g, m, k)).astype(np.float32)
    y = rng.normal(size=(g, k, n)).astype(np.float32)
    ct = rng.normal(size=(g, m, n)).astype(np.float32)
    jz, vjp = jax.vjp(lambda a, b: j_ops.branch_matmul(a, b, interpret=True),
                      jnp.asarray(x), jnp.asarray(y))
    jdx, jdy = vjp(jnp.asarray(ct))
    tx, ty = _t(x, True), _t(y, True)
    z = t_ops.branch_matmul(tx, ty)
    np.testing.assert_allclose(z.detach().numpy(), _np(jz), **TOL)
    dx, dy = torch.autograd.grad(z, (tx, ty), _t(ct))
    np.testing.assert_allclose(dx.numpy(), _np(jdx), **TOL)
    np.testing.assert_allclose(dy.numpy(), _np(jdy), **TOL)


def test_branch_matmul_wrapper_checks():
    x, y = torch.ones(2, 8, 4), torch.ones(2, 4, 3)
    with pytest.raises(ValueError, match="branch_matmul"):
        t_bmm.branch_matmul(x, torch.ones(3, 4, 3))
    with pytest.raises(ValueError, match="branch_matmul"):
        t_bmm.branch_matmul(x, torch.ones(2, 5, 3))
    with pytest.raises(TypeError, match="float32"):
        t_bmm.branch_matmul(x.double(), y.double())
    # the layouts the kernel reads in place: row-major per branch, or the
    # transpose of a row-major array, at the array's batch stride
    assert t_bmm._layout("bmm", x) == (0, 4, 32)
    assert t_bmm._layout("bmm", torch.ones(2, 4, 8).transpose(1, 2)) == \
        (1, 8, 32)
    with pytest.raises(ValueError, match="row-major nor transposed"):
        t_bmm._layout("bmm", torch.ones(2, 8, 8)[:, ::2, ::2])


# ---------------------------------------------------------------------------
# (c) reduced googlenet through both baselines, against the reference
# ---------------------------------------------------------------------------

STEPS = 2


@pytest.fixture(scope="module", params=["serial", "stacked"])
def reference_run(request):
    """The reference's planned training under one baseline plan, batch 2,
    seed 0: step-1 loss and gradients and the 2-step loss curve, and the
    initial parameters as numpy."""
    kw = BASELINES[request.param]
    cfg = j_reduced()
    params = j_cnn.init_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    plan, _ = j_cnn.plan_cnn(cfg, 2, train=True, **kw)
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
    return request.param, init, losses, grads0


def _port_setup(baseline, init):
    cfg = t_reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, **BASELINES[baseline])
    return cfg, plan, t_cnn.params_from_jax(init, device="cpu")


def test_baseline_loss_and_gradients_equal_reference(reference_run):
    baseline, init, losses, jgrads = reference_run
    cfg, plan, params = _port_setup(baseline, init)
    batch = TSyntheticImages(cfg.img, cfg.num_classes, 2,
                             seed=0).batch_at(0)
    loss, grads = t_steps.cnn_loss_and_grads(
        params, cfg, t_steps.to_device_batch(batch, "cpu"), plan=plan)
    assert float(loss) == pytest.approx(losses[0], rel=1e-4)
    tg = tree_leaves(grads)
    assert len(tg) == len(jgrads)
    for g, w in zip(tg, jgrads):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)
    # the CPU run took the plain versions
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


def test_baseline_loss_curve_tracks_reference(reference_run):
    baseline, init, losses, _ = reference_run
    cfg, plan, params = _port_setup(baseline, init)
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


# ---------------------------------------------------------------------------
# (d) the float64 reference on a planned forward's own pieces
# ---------------------------------------------------------------------------

def _chip_smoke(monkeypatch):
    """The repository's ``chip_smoke.py`` as a module (it imports torch
    only inside its functions and runs nothing on import; loading it puts
    ``src/`` on ``sys.path``, which the monkeypatch undoes)."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_pieces", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _f64_case(seed=0):
    cfg = t_reduced()
    params = t_cnn.init_params(cfg, torch.Generator().manual_seed(seed),
                               "cpu")
    # non-zero biases, so that ReLU inputs sit on both sides of zero
    g = torch.Generator().manual_seed(seed + 1)
    params = tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g)
                      if t.dim() == 1 else t, params)
    batch = TSyntheticImages(cfg.img, cfg.num_classes, 2,
                             seed=seed).batch_at(0)
    b = t_steps.to_device_batch(batch, "cpu")
    b64 = {"images": b["images"].double(), "labels": b["labels"]}
    return cfg, tree_map(lambda t: t.double(), params), b64


# float64 on both sides, the same operations but for the pool backward's
# summation order: relative 1e-12
TOL64 = dict(rtol=1e-12, atol=1e-15)


def test_pieces_from_a_float64_forward_give_the_plain_gradients(monkeypatch):
    cs = _chip_smoke(monkeypatch)
    cfg, p64, b64 = _f64_case()
    with torch.no_grad():
        loss0, pieces = cs.pieces_forward64(p64, cfg, b64["images"],
                                            b64["labels"])
    masks, choices = pieces
    assert len(masks) == len(cfg.stem) + 6 * len(cfg.modules)
    assert len(choices) == len(cfg.modules) + len(cfg.pool_between)
    assert all(0 < int(m.sum()) < m.numel() for m in masks.values())
    loss, grads = cs.pieces_grads64(p64, cfg, b64, pieces)
    want_loss, want = t_steps.cnn_loss_and_grads(p64, cfg, b64)
    assert float(loss) == float(want_loss) == float(loss0)
    for g, w in zip(tree_leaves(grads), tree_leaves(want)):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL64)


def test_pieces_with_one_relu_flipped_differ_downstream_only(monkeypatch):
    """Channel 0 of the last module's 1x1 conv is made zero before its
    ReLU everywhere (zero weights and bias), so flipping its ReLU at one
    element changes no forward value.  The gradient then flows through
    that element: that conv's channel-0 weights and bias change, and
    nothing else does (the zero weights pass nothing further back)."""
    cs = _chip_smoke(monkeypatch)
    cfg, p64, b64 = _f64_case()
    last = p64["modules"][-1]["b1"]
    last["w"][..., 0] = 0.0
    last["b"][0] = 0.0
    with torch.no_grad():
        _, pieces = cs.pieces_forward64(p64, cfg, b64["images"],
                                        b64["labels"])
    _, base = cs.pieces_grads64(p64, cfg, b64, pieces)
    name = f"inc{len(cfg.modules) - 1}/1x1"
    masks = dict(pieces[0])
    assert not masks[name][..., 0].any()
    masks[name] = masks[name].clone()
    masks[name][1, 0, 0, 0] = True
    loss_f, flipped = cs.pieces_grads64(p64, cfg, b64, (masks, pieces[1]))
    changed = []
    for path, g, w in zip(cs._leaf_names(p64), tree_leaves(flipped),
                          tree_leaves(base)):
        if not torch.equal(g, w):
            changed.append(path)
    n = len(cfg.modules) - 1
    assert changed == [f"modules.{n}.b1.b", f"modules.{n}.b1.w"]
    gb, wb = flipped["modules"][n]["b1"]["b"], base["modules"][n]["b1"]["b"]
    assert torch.equal(gb[1:], wb[1:]) and gb[0] != wb[0]
    gw, ww = flipped["modules"][n]["b1"]["w"], base["modules"][n]["b1"]["w"]
    assert torch.equal(gw[..., 1:], ww[..., 1:])


@pytest.mark.parametrize("baseline", ["serial", "stacked"])
def test_planned_pieces_hold_the_planned_gradients(monkeypatch, baseline):
    """``chip_smoke.py``'s phase-5 check in miniature, on the CPU: the
    pieces a planned f32 forward took, run in float64, give gradients
    within the check's bound (1e-3 * max|ref| + 1e-6) of the planned f32
    gradients, and every conv and pool of the graph has its piece."""
    cs = _chip_smoke(monkeypatch)
    cfg, p64, b64 = _f64_case(seed=3)
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, **BASELINES[baseline])
    p32 = tree_map(lambda t: t.float(), p64)
    b32 = {"images": b64["images"].float(), "labels": b64["labels"]}
    masks, choices = cs.planned_pieces(p32, cfg, b32["images"], plan)
    assert len(masks) == len(cfg.stem) + 6 * len(cfg.modules)
    assert len(choices) == len(cfg.modules) + len(cfg.pool_between)
    _, gp = t_steps.cnn_loss_and_grads(p32, cfg, b32, plan=plan)
    _, gm = cs.pieces_grads64(p64, cfg, b64, (masks, choices))
    assert cs._tree_check("planned vs pieces", gp, gm) <= 1.0
    # a concurrent plan absorbs its pools, so their choices never reach
    # the env: the helper refuses it
    conc, _ = t_cnn.plan_cnn(cfg, 2, train=True)
    with pytest.raises(ValueError, match="absorbs its pools"):
        cs.planned_pieces(p32, cfg, b32["images"], conc)


@pytest.mark.parametrize("case", ["planned", "zeroed_relu", "moved_pool"])
def test_flip_shares_tell_rounding_from_a_moved_forward(monkeypatch, case):
    """``chip_smoke.py`` holds every piece on which a planned f32 forward
    and the float64 forward differ within ``PIECE_RTOL`` of its kink.  The
    planned f32 pieces pass it; a conv whose activations were all zeroed
    and a pool choice moved to its plane's least element are each caught
    far past it."""
    cs = _chip_smoke(monkeypatch)
    cfg, p64, b64 = _f64_case(seed=3)
    seen = {}
    with torch.no_grad():
        _, nat = cs.pieces_forward64(p64, cfg, b64["images"], b64["labels"],
                                     seen=seen)
    assert set(seen) == set(nat[0]) | set(nat[1])
    if case == "planned":
        plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, concurrent=False)
        pieces = cs.planned_pieces(tree_map(lambda t: t.float(), p64), cfg,
                                   b64["images"].float(), plan)
        shares = cs.flip_shares(pieces, nat, seen)
        assert all(v <= cs.PIECE_RTOL for v in shares.values()), shares
        return
    masks, choices = dict(nat[0]), dict(nat[1])
    if case == "zeroed_relu":
        name = "inc0/3x3"
        masks[name] = torch.zeros_like(masks[name])
    else:
        name = next(iter(choices))
        plane = seen[name][0].flatten(2)
        least = plane.masked_fill(~plane.isfinite(), math.inf).argmin(2)
        i = choices[name][0].clone()
        i[0, 0, 0, 0] = least[0, 0]
        choices[name] = [i] + list(choices[name][1:])
        name = f"{name}[0]"
    shares = cs.flip_shares((masks, choices), nat, seen)
    assert list(shares) == [name] and shares[name] > 1e-2


# ---------------------------------------------------------------------------
# (e) the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps,batch", [(2, 2), (1, 1)])
def test_train_cli_plan_serial_runs_on_the_cpu(capsys, steps, batch):
    rc = t_train.main(["--arch", "googlenet", "--reduced", "--device", "cpu",
                       "--steps", str(steps), "--batch", str(batch),
                       "--plan", "serial", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[train] plan: modes={'serial': 19}" in out
    assert "[train] backward plan: modes={'serial': 19}" in out
    assert out.count("ms/step") == steps and "[train] done. loss" in out
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0
