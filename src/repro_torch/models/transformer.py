"""Language model: the reference's generic transformer
(``repro/models/transformer.py``) for the configs the port has —
attention blocks with a dense or MoE MLP and mamba (SSD) blocks, trained
over the whole sequence or served with a cache (``init_cache``,
``prefill``, ``decode_step``).

Parameters are plain nested dicts in the reference's layout: each
position of the layer pattern keeps its blocks' leaves stacked,
``params["blocks"][pos]`` with leaves ``(n_super, ...)``, and the stack
runs as a loop over super-blocks (the reference's ``lax.scan``), with
``remat=True`` recomputing each super-block in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

``impl`` is the reference's: ``"xla"`` (plain torch) or ``"pallas"``
(a mamba block's prefill on the SSD chunk kernel K14; attention without
a cache on the flash-attention kernel K13).  Neither kernel has a
backward, nor has the reference's, so ``"pallas"`` is a forward path:
``forward`` and ``loss_fn`` under ``torch.no_grad()``, and ``prefill``.
``moe_impl`` picks the MoE expert engine (``models.moe``): ``"einsum"``
(the default, plain torch) or ``"grouped"`` (the K11/K12 kernels).
Not ported yet: cross-attention and encoders, and the modality
frontends.

The cache is the reference's: a list per pattern position of dicts with
leaves ``(n_super, ...)`` — ``"kv"`` (2, B, Smax, Hkv, hd) for attention,
``"ssm"`` (B, H, N, P) f32 and ``"conv"`` (B, W-1, C_conv) for mamba —
in bfloat16 but for the SSM state, as the reference's ``init_cache``
makes it.  A step returns a new cache and leaves the old one as it was.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MOE


def _check_supported(cfg: ModelConfig):
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "mamba"):
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
        if spec.mixer == "mamba" and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a mamba mixer needs cfg.ssm")
        if spec.cross:
            raise NotImplementedError(
                f"{cfg.name}: cross-attention is not ported yet")
    if cfg.enc_dec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: encoders and modality frontends are not ported yet")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _block_init(g, cfg: ModelConfig, spec: BlockSpec):
    """One block's parameters, drawn on the generator's device."""
    dev = g.device
    norm_init = L.rmsnorm_init if cfg.norm == "rms" else L.layernorm_init
    p: dict = {"norm1": norm_init(cfg.d_model, device=dev)}
    if spec.mixer == "attn":
        p["attn"] = A.attn_init(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, device=dev,
                                qkv_bias=cfg.qkv_bias)
    else:
        s = cfg.ssm
        p["mamba"] = M.mamba_init(g, cfg.d_model, d_inner=s.d_inner,
                                  n_heads=s.n_heads, head_dim=s.head_dim,
                                  d_state=s.d_state, n_groups=s.n_groups,
                                  conv_width=s.conv_width, device=dev)
    if spec.mlp != "none":
        p["norm2"] = norm_init(cfg.d_model, device=dev)
    if spec.mlp == "dense":
        p["mlp"] = L.mlp_init(g, cfg.d_model, cfg.d_ff,
                              gated=cfg.activation in ("silu", "gelu"),
                              device=dev)
    elif spec.mlp == "moe":
        mo = cfg.moe
        p["moe"] = MOE.moe_init(g, cfg.d_model, mo.d_expert, mo.n_experts,
                                shared_f=mo.shared_f, device=dev)
    if cfg.post_norm:
        p["post_norm1"] = norm_init(cfg.d_model, device=dev)
        if spec.mlp != "none":
            p["post_norm2"] = norm_init(cfg.d_model, device=dev)
    return p


def _stack(trees, device):
    """Trees of the same shape as one tree whose leaves are stacked
    along a new leading axis, on ``device``."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], device) for k in trees[0]}
    return torch.stack(trees).to(device)


def _stack_drawn(draw, n: int, device):
    """``_stack([draw() for _ in range(n)], device)`` holding one drawn
    tree at a time beside the stack, so a full-width model's blocks are
    never held twice."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=device)

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    tree = draw()
    out = alloc(tree)
    for i in range(n):
        if i:
            tree = draw()
        put(out, tree, i)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None):
    """Random parameters in the reference's layout, drawn from
    ``generator`` (default: seed 0) on its device and moved to
    ``device`` (``None`` means the card).  The draws differ from the
    reference's ``jax.random`` ones; ``params_from_jax`` takes the
    reference's own."""
    device = resolve_device(device)
    _check_supported(cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n_super = cfg.n_layers // len(cfg.pattern)
    if n_super * len(cfg.pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: pattern {len(cfg.pattern)} does not "
                         f"divide {cfg.n_layers} layers")
    params: dict = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model,
                              device=device),
        "final_norm": (L.rmsnorm_init if cfg.norm == "rms"
                       else L.layernorm_init)(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.embed_init(generator, cfg.vocab, cfg.d_model,
                                         device=device)
    # the draw order fixes the parameters: a pattern position's blocks in
    # order, then the next position's
    params["blocks"] = [
        _stack_drawn(lambda spec=spec: _block_init(generator, cfg, spec),
                     n_super, device) for spec in cfg.pattern]
    return params


def params_from_jax(np_params, device=None):
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, T.init_params(...))``) as this package's
    params, same nesting and layouts — attention, MLP, MoE and mamba
    leaves alike.  ``device=None`` means the card."""
    return L.from_numpy_tree(np_params, resolve_device(device))


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------

def _norm(cfg, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def _block_apply(cfg: ModelConfig, spec: BlockSpec, p, x, *, cache=None,
                 cache_pos=None, positions=None, causal=True, impl="xla",
                 moe_impl="einsum"):
    """Returns (x, new_cache, aux_loss); new_cache is {} without a
    cache."""
    if spec.cross:
        raise NotImplementedError("cross-attention is not ported yet")
    aux = torch.zeros((), device=x.device)
    new_cache = {}
    h = _norm(cfg, p["norm1"], x)
    if spec.mixer == "attn":
        h, new_kv = A.attn_apply(
            p["attn"], h, hq=cfg.n_heads, hkv=cfg.n_kv_heads,
            hd=cfg.head_dim, positions=positions,
            kv_cache=cache.get("kv") if cache else None, cache_pos=cache_pos,
            causal=causal, window=spec.window, softcap=cfg.attn_softcap,
            rope_theta=cfg.rope_theta, query_scale=cfg.query_scale,
            impl=impl)
        if new_kv is not None:
            new_cache["kv"] = new_kv
    elif spec.mixer == "mamba":
        s = cfg.ssm
        h, (new_ssm, new_conv) = M.mamba_apply(
            p["mamba"], h, d_inner=s.d_inner, n_heads=s.n_heads,
            head_dim=s.head_dim, d_state=s.d_state, n_groups=s.n_groups,
            chunk=s.chunk, ssm_state=cache.get("ssm") if cache else None,
            conv_state=cache.get("conv") if cache else None, impl=impl)
        if cache:
            new_cache["ssm"] = new_ssm.to(cache["ssm"].dtype)
            new_cache["conv"] = new_conv.to(cache["conv"].dtype)
    else:
        raise ValueError(f"unknown mixer {spec.mixer!r}")
    if cfg.post_norm:
        h = _norm(cfg, p["post_norm1"], h)
    x = x + h
    if spec.mlp != "none":
        h = _norm(cfg, p["norm2"], x)
        if spec.mlp == "dense":
            h = L.mlp(p["mlp"], h, cfg.activation)
        else:
            h, moe_aux = MOE.moe_apply(
                p["moe"], h, top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                activation=cfg.activation, impl=moe_impl)
            aux = aux + moe_aux["aux_loss"]
        if cfg.post_norm:
            h = _norm(cfg, p["post_norm2"], h)
        x = x + h
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# stack
# ---------------------------------------------------------------------------

def _unstack(tree, n):
    """A stacked tree (leaves (n, ...)) as n trees of views, by one
    ``unbind`` per leaf (its backward stacks the n gradients once)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _run_stack(cfg: ModelConfig, params, x, *, cache=None, cache_pos=None,
               positions=None, causal=True, impl="xla", moe_impl="einsum",
               remat=False):
    """The super-blocks in order; returns (x, new cache (None without
    one), summed aux loss).  cache: the stacked per-position list of
    ``init_cache``."""
    pat = cfg.pattern
    n_super = cfg.n_layers // len(pat)
    per_pos = [_unstack(params["blocks"][i], n_super)
               for i in range(len(pat))]
    caches = None if cache is None else \
        [_unstack(cache[i], n_super) for i in range(len(pat))]

    def super_block(h, block_caches, *block_params):
        aux_tot = torch.zeros((), device=h.device)
        new_caches = []
        for spec, bp, bc in zip(pat, block_params, block_caches):
            h, nc, aux = _block_apply(cfg, spec, bp, h, cache=bc,
                                      cache_pos=cache_pos,
                                      positions=positions, causal=causal,
                                      impl=impl, moe_impl=moe_impl)
            new_caches.append(nc)
            aux_tot = aux_tot + aux
        return h, new_caches, aux_tot

    auxs, outs = [], []
    for i in range(n_super):
        bps = [per_pos[j][i] for j in range(len(pat))]
        bcs = [None] * len(pat) if caches is None else \
            [caches[j][i] for j in range(len(pat))]
        if remat:
            x, nc, aux = torch.utils.checkpoint.checkpoint(
                super_block, x, bcs, *bps, use_reentrant=False)
        else:
            x, nc, aux = super_block(x, bcs, *bps)
        auxs.append(aux)
        outs.append(nc)
    new_cache = None if cache is None else \
        [_stack([o[j] for o in outs], x.device) for j in range(len(pat))]
    return x, new_cache, torch.stack(auxs).sum()


def _embed(cfg, params, tokens):
    x = L.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _head(cfg, params, x):
    x = _norm(cfg, params["final_norm"], x)
    table = params["unembed" if "unembed" in params else "embed"]
    return L.unembed(table, x, cfg.final_softcap)


def forward(params, cfg: ModelConfig, tokens, *, impl="xla",
            moe_impl="einsum", remat=False):
    """Full-sequence forward -> (logits (B, S, V), summed MoE aux loss).
    tokens: (B, S) integers."""
    _check_supported(cfg)
    x = _embed(cfg, params, tokens)
    x, _, aux = _run_stack(cfg, params, x, impl=impl, moe_impl=moe_impl,
                           remat=remat)
    return _head(cfg, params, x), aux


def loss_fn(params, cfg: ModelConfig, batch, *, impl="xla",
            moe_impl="einsum", remat=True, moe_aux_weight: float = 0.01):
    """(CE + moe_aux_weight * aux, {"ce", "moe_aux"}); the CE is taken on
    the logits rounded to bfloat16, as the reference does."""
    logits, aux = forward(params, cfg, batch["tokens"], impl=impl,
                          moe_impl=moe_impl, remat=remat)
    loss = L.cross_entropy(logits.to(torch.bfloat16), batch["labels"])
    return loss + moe_aux_weight * aux, {"ce": loss, "moe_aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero cache for ``batch`` sequences of up to ``cache_len`` tokens:
    a list per pattern position, leaves (n_super, ...); KV and conv
    entries in ``dtype``, the SSM state in f32.  ``device=None`` means
    the card."""
    _check_supported(cfg)
    device = resolve_device(device)
    n_super = cfg.n_layers // len(cfg.pattern)
    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            c = {"kv": torch.zeros(
                (n_super, 2, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
                dtype=dtype, device=device)}
        else:
            s = cfg.ssm
            c = {"ssm": torch.zeros(
                    (n_super, batch, s.n_heads, s.d_state, s.head_dim),
                    dtype=torch.float32, device=device),
                 "conv": torch.zeros(
                    (n_super, batch, s.conv_width - 1,
                     s.d_inner + 2 * s.n_groups * s.d_state),
                    dtype=dtype, device=device)}
        caches.append(c)
    return caches


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens, cache, *, impl="xla"):
    """Prompt prefill: the forward over tokens (B, S), writing the cache
    at positions [0, S).  Returns (last-token logits (B, V), new
    cache)."""
    _check_supported(cfg)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None] \
        .expand(x.shape[0], -1)
    x, new_cache, _ = _run_stack(cfg, params, x, cache=cache, cache_pos=0,
                                 positions=positions, impl=impl)
    return _head(cfg, params, x[:, -1:])[:, 0], new_cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens, pos: int, *,
                impl="xla"):
    """One decode step: tokens (B, 1) at write position ``pos`` (the KV
    cache covers [0, cache_len)).  Returns (logits (B, 1, V), new
    cache)."""
    _check_supported(cfg)
    x = _embed(cfg, params, tokens)
    positions = torch.full((tokens.shape[0], 1), int(pos), device=x.device)
    x, new_cache, _ = _run_stack(cfg, params, x, cache=cache,
                                 cache_pos=int(pos), positions=positions,
                                 impl=impl)
    return _head(cfg, params, x), new_cache
