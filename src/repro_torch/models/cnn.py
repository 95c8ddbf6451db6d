"""Inception-style CNN — the paper's native subject (GoogLeNet, Fig. 1).

The counterpart of ``repro/models/cnn.py``: parameters in the
reference's layout (HWIO conv weights, NHWC activations, the same
``stem`` / ``modules`` / ``head`` dict), the plain ``forward`` every
planned run is held to, the op graph the scheduler packs, the
plan-driven ``forward_plan`` whose grouped, concat, pooled, chained and
stacked groups launch the port's CUDA kernels (``repro_torch.kernels``),
and ``loss_fn``.  Training differentiates through ``forward_plan``: the
grouped and stacked groups' autograd Functions (``kernels.ops``) and
``_ConvAlg`` (serial convs) launch the backward kernels.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig, InceptionSpec  # noqa: F401
from repro_torch.core.graph import Op, OpGraph
from repro_torch.kernels import conv2d as kconv
from repro_torch.kernels import matmul as kmm
from repro_torch.kernels.conv2d import _im2col, _pad_amount
from repro_torch.kernels.ref import conv2d_ref
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L


def conv(x, w, b, *, stride=1, algorithm="xla"):
    """relu(conv(x, w) + b) through the op's scheduled algorithm: ``xla``
    is the plain torch convolution; ``direct`` (K3) and ``im2col_gemm``
    (K4) run the port's kernels through ``_ConvAlg``, whose backward is
    the GEMM-view ``_conv_gemm_bwd``.  The reference's other algorithms
    run TPU kernels this port does not have yet, so they raise."""
    if algorithm == "xla":
        y = conv2d_ref(x, w, stride=stride)
    elif algorithm in _CONV_ALGS:
        y = _ConvAlg.apply(x, w, int(stride), algorithm)
    else:
        raise NotImplementedError(
            f"conv algorithm {algorithm!r} is not ported (its kernel waits "
            f"in the roadmap)")
    return torch.relu(y + b)


_CONV_ALGS = {
    "direct": lambda x, w, stride: kconv.conv2d_direct(
        x.contiguous(), w.contiguous(), stride=stride),
    "im2col_gemm": lambda x, w, stride: kconv.conv2d_im2col_gemm(
        x, w, stride=stride),
}


class _ConvAlg(torch.autograd.Function):
    """Algorithm-zoo conv (the reference's ``_conv_alg`` custom VJP): the
    forward runs the algorithm's kernel; the gradient is
    algorithm-independent and runs the GEMM-view backward."""

    @staticmethod
    def forward(ctx, x, w, stride, algorithm):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return _CONV_ALGS[algorithm](x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _conv_gemm_bwd(x, w, g, ctx.stride,
                                need_dx=ctx.needs_input_grad[0])
        return dx, dw, None, None


def _conv_gemm_bwd(x, w, dy, stride, *, need_dx=True):
    """Conv backward through the stride-aware GEMM view
    (``repro/models/cnn.py::_conv_gemm_bwd``): dw = patches^T @ dY2d and
    dpatches = dY2d @ wmat^T, two K4 launches on transposed views (no
    copy), and dx pulls the patch cotangent back through the im2col
    gather by autograd (col2im in plain torch, as XLA does it in the
    reference).  A 1x1 stride-1 conv's views are plain reshapes.
    ``need_dx=False`` (the network's input images) skips the dx GEMM and
    the col2im; dx is then None."""
    kh, kw, cin, cout = w.shape
    dy2 = dy.contiguous().reshape(-1, cout)
    if (kh, kw) == (1, 1) and stride == 1:
        x2 = x.reshape(-1, cin)
        dx = kmm.matmul(dy2, w.reshape(cin, cout).t()).reshape(x.shape) \
            if need_dx else None
        dw2 = kmm.matmul(x2.t(), dy2)
        return dx, dw2.reshape(1, 1, cin, cout)
    with torch.enable_grad():
        xx = x.detach().requires_grad_(need_dx)
        patches = _im2col(xx, kh, kw, stride)
    p2 = patches.detach().reshape(-1, cin * kh * kw)
    wmat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    dx = None
    if need_dx:
        dpat = kmm.matmul(dy2, wmat.t())
        (dx,) = torch.autograd.grad(patches, xx,
                                    dpat.reshape(patches.shape))
    dw2 = kmm.matmul(p2.t(), dy2)
    return dx, dw2.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)


def _pool_pad(x, k, stride):
    """NHWC ``x`` as NCHW, padded for a SAME max-pool window (-inf
    padding, asymmetric like TF)."""
    _, h, w, _ = x.shape
    ph = _pad_amount(h, k, stride, "SAME")
    pw = _pad_amount(w, k, stride, "SAME")
    return F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]),
                 value=float("-inf"))


def maxpool(x, k=3, stride=2):
    """SAME maxpool (-inf padding, asymmetric like TF), NHWC."""
    return F.max_pool2d(_pool_pad(x, k, stride), k, stride).permute(0, 2, 3, 1)


def maxpool_chain(x, chain):
    """A ``((window, stride), ...)`` maxpool chain."""
    for k, s in chain:
        x = maxpool(x, k, s)
    return x


def _conv_init(generator, kh, cin, cout, device):
    w = L.normal_init(generator, (kh, kh, cin, cout),
                      (kh * kh * cin) ** -0.5, device=device)
    return {"w": w, "b": torch.zeros((cout,), device=device)}


def init_params(cfg: CNNConfig, generator: torch.Generator | None = None,
                device=None):
    """Random parameters in the reference's layout, drawn from
    ``generator`` (default: seed 0).  ``device=None`` means the card."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params: dict = {"stem": []}
    c = cfg.img[2]
    for (k, out, _s) in cfg.stem:
        params["stem"].append(_conv_init(generator, k, c, out, device))
        c = out
    params["modules"] = []
    for m in cfg.modules:
        params["modules"].append({
            "b1": _conv_init(generator, 1, c, m.n1, device),
            "r3": _conv_init(generator, 1, c, m.r3, device),
            "b3": _conv_init(generator, 3, m.r3, m.n3, device),
            "r5": _conv_init(generator, 1, c, m.r5, device),
            "b5": _conv_init(generator, 5, m.r5, m.n5, device),
            "pp": _conv_init(generator, 1, c, m.pp, device),
        })
        c = m.out
    params["head"] = {
        "w": L.normal_init(generator, (c, cfg.num_classes), c ** -0.5,
                           device=device),
        "b": torch.zeros((cfg.num_classes,), device=device)}
    return params


def params_from_jax(np_params, device=None):
    """The reference's parameter tree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), as this package's params:
    same nesting, same layouts, so both packages compute the same
    function.  ``device=None`` means the card."""
    return L.from_numpy_tree(np_params, resolve_device(device))


def inception_module(p, x, spec: InceptionSpec, alg):
    """alg: dict branch-name -> algorithm, or one algorithm for all."""
    a = (lambda n: alg.get(n, "xla")) if isinstance(alg, dict) \
        else (lambda n: alg)
    b1 = conv(x, p["b1"]["w"], p["b1"]["b"], algorithm=a("1x1"))
    r3 = conv(x, p["r3"]["w"], p["r3"]["b"], algorithm=a("r3"))
    b3 = conv(r3, p["b3"]["w"], p["b3"]["b"], algorithm=a("3x3"))
    r5 = conv(x, p["r5"]["w"], p["r5"]["b"], algorithm=a("r5"))
    b5 = conv(r5, p["b5"]["w"], p["b5"]["b"], algorithm=a("5x5"))
    pp = conv(maxpool(x, 3, 1), p["pp"]["w"], p["pp"]["b"],
              algorithm=a("pp"))
    return torch.cat([b1, b3, b5, pp], dim=-1)


def forward(params, cfg: CNNConfig, images, *, algorithms=None):
    """images (B, H, W, C) -> logits (B, classes), one op at a time.

    algorithms: None (plain torch convolutions), a str, or
    {module_idx: {branch: alg}} / {"stem<i>": alg}.
    """
    x = images
    for i, (p, (_k, _out, s)) in enumerate(zip(params["stem"], cfg.stem)):
        alg = "xla" if algorithms is None else (
            algorithms if isinstance(algorithms, str)
            else algorithms.get(f"stem{i}", "xla"))
        x = conv(x, p["w"], p["b"], stride=s, algorithm=alg)
    for i, (p, m) in enumerate(zip(params["modules"], cfg.modules)):
        if i in cfg.pool_between:
            x = maxpool(x, 3, 2)
        alg = "xla" if algorithms is None else (
            algorithms if isinstance(algorithms, str)
            else algorithms.get(i, {}))
        x = inception_module(p, x, m, alg)
    x = x.mean(dim=(1, 2))
    return x @ params["head"]["w"] + params["head"]["b"]


def loss_fn(params, cfg: CNNConfig, batch, *, plan=None, **kw):
    """(mean cross-entropy, {}) of the planned forward (``plan``) or of
    the plain/algorithms ``forward``; ``batch`` holds ``images`` and
    ``labels`` tensors."""
    if plan is not None:
        logits = forward_plan(params, cfg, batch["images"], plan, **kw)
    else:
        logits = forward(params, cfg, batch["images"], **kw)
    return L.cross_entropy(logits, batch["labels"]), {}


# ---------------------------------------------------------------------------
# plan-driven execution
# ---------------------------------------------------------------------------

def _plan_impls(params, cfg: CNNConfig):
    """``core.plan.OpImpl`` binding for every ``build_graph`` op; returns
    (impls, name of the final join op).  Every conv carries its GEMM
    views (a 1x1 conv is a channel matmul, a KxK conv its im2col view
    with M = B*OH*OW, K = C*KH*KW), its bias+ReLU epilogue and its raw
    geometry for chained launches; every pool its chain."""
    from repro_torch.core.plan import OpImpl

    impls: dict = {}
    h, w = cfg.img[:2]
    dep = "input"

    def conv_impl(pb, dep, oh, ow, stride=1):
        kh, kw, cin, _ = pb["w"].shape
        # (KH, KW, C, K) -> (C, KH, KW, K) -> (C*KH*KW, K): the (C, KH, KW)
        # feature order of _im2col
        wmat = pb["w"].permute(2, 0, 1, 3).reshape(cin * kh * kw, -1)

        def gemm_x(x, kh=kh, kw=kw, cin=cin, s=stride):
            if (kh, kw) == (1, 1) and s == 1:
                return x.reshape(-1, cin)
            return _im2col(x, kh, kw, s).reshape(-1, cin * kh * kw)

        def gemm_reshape(y2d, oh=oh, ow=ow):
            return y2d.reshape(-1, oh, ow, y2d.shape[-1])

        return OpImpl(
            deps=(dep,),
            fn=lambda x, algorithm="xla", pb=pb, s=stride: conv(
                x, pb["w"], pb["b"], stride=s, algorithm=algorithm),
            gemm_x=gemm_x,
            gemm_x_key=("conv_x", kh, kw, stride, cin),
            gemm_w=wmat,
            gemm_bias=pb["b"],
            gemm_relu=True,
            gemm_reshape=gemm_reshape,
            chain_geom=(kh, kw, stride, cin, oh, ow))

    def pool_impl(dep, chain):
        return OpImpl(
            deps=(dep,),
            fn=lambda x, algorithm=None, chain=chain: maxpool_chain(
                x, chain),
            pool_chain=tuple(chain))

    for i, (pb, (_k, _out, s)) in enumerate(zip(params["stem"], cfg.stem)):
        h, w = -(-h // s), -(-w // s)
        impls[f"stem{i}"] = conv_impl(pb, dep, h, w, stride=s)
        dep = f"stem{i}"

    for i, p in enumerate(params["modules"]):
        pooled = i in cfg.pool_between
        nm = f"inc{i}"
        if pooled:
            impls[f"{nm}/pool"] = pool_impl(dep, ((3, 2),))
            impls[f"{nm}/pppool"] = pool_impl(dep, ((3, 2), (3, 1)))
            bdep = f"{nm}/pool"
            h, w = -(-h // 2), -(-w // 2)
        else:
            impls[f"{nm}/pppool"] = pool_impl(dep, ((3, 1),))
            bdep = dep
        impls[f"{nm}/1x1"] = conv_impl(p["b1"], bdep, h, w)
        impls[f"{nm}/r3"] = conv_impl(p["r3"], bdep, h, w)
        impls[f"{nm}/r5"] = conv_impl(p["r5"], bdep, h, w)
        impls[f"{nm}/pp"] = conv_impl(p["pp"], f"{nm}/pppool", h, w)
        impls[f"{nm}/3x3"] = conv_impl(p["b3"], f"{nm}/r3", h, w)
        impls[f"{nm}/5x5"] = conv_impl(p["b5"], f"{nm}/r5", h, w)
        impls[f"{nm}/join"] = OpImpl(
            deps=(f"{nm}/1x1", f"{nm}/3x3", f"{nm}/5x5", f"{nm}/pp"),
            fn=lambda *ys, algorithm=None: torch.cat(ys, dim=-1),
            gemm_reshape=lambda y2d, oh=h, ow=w: y2d.reshape(
                -1, oh, ow, y2d.shape[-1]))
        dep = f"{nm}/join"
    return impls, dep


def forward_plan(params, cfg: CNNConfig, images, plan, *,
                 valid_images=None):
    """Plan-driven forward: images (B, H, W, C) -> logits (B, classes).

    ``plan`` comes from ``plan_cnn`` (or ``core.plan_cache``).
    ``valid_images`` makes the grouped-family launches ragged-M for a
    bucketed serving batch whose first ``valid_images`` images are real;
    logits rows at/past it are padding.  When the last group is chained
    its panels never assemble: each panel segment is average-pooled in
    place and multiplied by the matching rows of the head (the split
    head — the sum over segments is the whole GAP @ head)."""
    from repro_torch.core import plan as planlib
    impls, out_name = _plan_impls(params, cfg)
    env = {"input": images}
    planlib.run_plan(impls, env, plan, valid_images=valid_images)
    out = env[out_name]
    hw = params["head"]["w"]
    if isinstance(out, planlib.ChainPanels):
        logits = params["head"]["b"]
        coff = 0
        for pidx, cb, n in out.segments:
            seg = out.panels[pidx][:out.m, cb * out.blk: cb * out.blk + n]
            segm = seg.reshape(-1, out.h * out.w, n).mean(dim=1)
            logits = logits + segm @ hw[coff:coff + n]
            coff += n
        return logits
    return out.mean(dim=(1, 2)) @ hw + params["head"]["b"]


def plan_cnn(cfg: CNNConfig, batch: int, *, concurrent: bool = True,
             train: bool = False, fuse_pool: bool = True,
             chain_modules: bool = False):
    """graph -> schedule -> executable plan for this CNN; returns
    (Plan, Schedule), the plan's context carrying ``cfg``, ``batch`` and
    the mirrored backward plan (``context["backward"]``,
    ``core.plan.backward_plan``).  The reference's ``plan_cnn`` at its
    default budgets: ``concurrent=False`` is the paper's serial baseline
    (every op its own group at its per-op-fastest algorithm);
    ``train=True`` packs and budget-checks groups at forward+backward
    cost (the training path's plan; at some batches it differs from the
    serving plan); ``fuse_pool=False`` keeps the maxpools standalone (the
    unfused baseline: uniform quads run ``stacked`` on K9);
    ``chain_modules`` chains the absorbed launches across modules (the
    serving path's plan; forward only)."""
    from repro_torch.core import plan as planlib
    from repro_torch.core import scheduler as S
    g = build_graph(cfg, batch)
    sch = S.schedule(g, concurrent=concurrent, train=train)
    plan = planlib.lower(g, sch, train=train, fuse_pool=fuse_pool,
                         chain_modules=chain_modules)
    plan.context.update({"cfg": cfg, "batch": batch})
    plan.context["backward"] = planlib.backward_plan(g, plan)
    return plan, sch


# ---------------------------------------------------------------------------
# op-graph export (for the scheduler)
# ---------------------------------------------------------------------------

def build_graph(cfg: CNNConfig, batch: int) -> OpGraph:
    """Op-level DAG with the pooling primitives explicit: the
    inter-module maxpool (``inc{i}/pool``) and each pool-proj pre-pool
    (``inc{i}/pppool``, reading the raw module input with its composed
    chain) — the graph ``repro/models/cnn.py::build_graph`` builds."""
    g = OpGraph()
    h, w, c = cfg.img
    g.add(Op.make("input", "pointwise", elements=batch * h * w * c))
    dep = "input"
    for i, (k, out, s) in enumerate(cfg.stem):
        g.add(Op.make(f"stem{i}", "conv2d", n=batch, h=h, w=w, c=c, kh=k,
                      kw=k, k=out, stride=s), [dep])
        dep = f"stem{i}"
        h, w, c = -(-h // s), -(-w // s), out
    for i, m in enumerate(cfg.modules):
        nm = f"inc{i}"
        pooled = i in cfg.pool_between
        if pooled:
            g.add(Op.make(f"{nm}/pool", "maxpool", n=batch, h=h, w=w, c=c,
                          chain=((3, 2),)), [dep])
            pp_chain = ((3, 2), (3, 1))
        else:
            pp_chain = ((3, 1),)
        g.add(Op.make(f"{nm}/pppool", "maxpool", n=batch, h=h, w=w, c=c,
                      chain=pp_chain), [dep])
        branch_dep = f"{nm}/pool" if pooled else dep
        if pooled:
            h, w = -(-h // 2), -(-w // 2)
        g.add(Op.make(f"{nm}/1x1", "conv2d", n=batch, h=h, w=w, c=c, kh=1,
                      kw=1, k=m.n1, stride=1), [branch_dep])
        g.add(Op.make(f"{nm}/r3", "conv2d", n=batch, h=h, w=w, c=c, kh=1,
                      kw=1, k=m.r3, stride=1), [branch_dep])
        g.add(Op.make(f"{nm}/3x3", "conv2d", n=batch, h=h, w=w, c=m.r3,
                      kh=3, kw=3, k=m.n3, stride=1), [f"{nm}/r3"])
        g.add(Op.make(f"{nm}/r5", "conv2d", n=batch, h=h, w=w, c=c, kh=1,
                      kw=1, k=m.r5, stride=1), [branch_dep])
        g.add(Op.make(f"{nm}/5x5", "conv2d", n=batch, h=h, w=w, c=m.r5,
                      kh=5, kw=5, k=m.n5, stride=1), [f"{nm}/r5"])
        g.add(Op.make(f"{nm}/pp", "conv2d", n=batch, h=h, w=w, c=c, kh=1,
                      kw=1, k=m.pp, stride=1), [f"{nm}/pppool"])
        g.add(Op.make(f"{nm}/join", "pointwise",
                      elements=batch * h * w * m.out),
              [f"{nm}/1x1", f"{nm}/3x3", f"{nm}/5x5", f"{nm}/pp"])
        dep = f"{nm}/join"
        c = m.out
    return g
