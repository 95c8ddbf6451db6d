"""Language model: the reference's generic transformer
(``repro/models/transformer.py``) for the configs the port has —
attention blocks with a dense or MoE MLP, trained over the whole
sequence.

Parameters are plain nested dicts in the reference's layout: each
position of the layer pattern keeps its blocks' leaves stacked,
``params["blocks"][pos]`` with leaves ``(n_super, ...)``, and the stack
runs as a loop over super-blocks (the reference's ``lax.scan``), with
``remat=True`` recomputing each super-block in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).

``moe_impl`` picks the MoE expert engine (``models.moe``): ``"einsum"``
(the default, plain torch) or ``"grouped"`` (the K11/K12 kernels).
Not ported yet: mamba mixers (K14), cross-attention and encoders, the
modality frontends, and serving with a KV cache (prefill, decode).
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE


def _check_supported(cfg: ModelConfig):
    for spec in cfg.pattern:
        if spec.mixer == "mamba":
            raise NotImplementedError(
                f"{cfg.name}: mamba mixers need the SSD chunk kernel (K14, "
                f"repro/kernels/ssd.py::_ssd_chunk_kernel), not ported yet")
        if spec.mixer != "attn":
            raise ValueError(f"{cfg.name}: unknown mixer {spec.mixer!r}")
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
    p: dict = {"norm1": norm_init(cfg.d_model, device=dev),
               "attn": A.attn_init(g, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.head_dim, device=dev,
                                   qkv_bias=cfg.qkv_bias)}
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
    params["blocks"] = [
        _stack([_block_init(generator, cfg, spec) for _ in range(n_super)],
               device) for spec in cfg.pattern]
    return params


def params_from_jax(np_params, device=None):
    """The reference's parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, T.init_params(...))``) as this package's
    params, same nesting and layouts.  ``device=None`` means the card."""
    return L.from_numpy_tree(np_params, resolve_device(device))


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------

def _norm(cfg, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def _block_apply(cfg: ModelConfig, spec: BlockSpec, p, x, *, positions=None,
                 causal=True, impl="xla", moe_impl="einsum"):
    """Returns (x, aux_loss)."""
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer {spec.mixer!r}: only attention blocks are ported (mamba "
            f"needs K14, repro/kernels/ssd.py::_ssd_chunk_kernel)")
    if spec.cross:
        raise NotImplementedError("cross-attention is not ported yet")
    aux = torch.zeros((), device=x.device)
    h = _norm(cfg, p["norm1"], x)
    h, _ = A.attn_apply(
        p["attn"], h, hq=cfg.n_heads, hkv=cfg.n_kv_heads, hd=cfg.head_dim,
        positions=positions, causal=causal, window=spec.window,
        softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta,
        query_scale=cfg.query_scale, impl=impl)
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
    return x, aux


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


def _run_stack(cfg: ModelConfig, params, x, *, positions=None, causal=True,
               impl="xla", moe_impl="einsum", remat=False):
    """The super-blocks in order; returns (x, summed aux loss)."""
    pat = cfg.pattern
    n_super = cfg.n_layers // len(pat)
    per_pos = [_unstack(params["blocks"][i], n_super)
               for i in range(len(pat))]

    def super_block(h, *block_params):
        aux_tot = torch.zeros((), device=h.device)
        for spec, bp in zip(pat, block_params):
            h, aux = _block_apply(cfg, spec, bp, h, positions=positions,
                                  causal=causal, impl=impl,
                                  moe_impl=moe_impl)
            aux_tot = aux_tot + aux
        return h, aux_tot

    auxs = []
    for i in range(n_super):
        bps = [per_pos[j][i] for j in range(len(pat))]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                super_block, x, *bps, use_reentrant=False)
        else:
            x, aux = super_block(x, *bps)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def forward(params, cfg: ModelConfig, tokens, *, impl="xla",
            moe_impl="einsum", remat=False):
    """Full-sequence forward -> (logits (B, S, V), summed MoE aux loss).
    tokens: (B, S) integers."""
    _check_supported(cfg)
    x = L.embed(params["embed"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    x, aux = _run_stack(cfg, params, x, impl=impl, moe_impl=moe_impl,
                        remat=remat)
    x = _norm(cfg, params["final_norm"], x)
    table = params["unembed" if "unembed" in params else "embed"]
    return L.unembed(table, x, cfg.final_softcap), aux


def loss_fn(params, cfg: ModelConfig, batch, *, impl="xla",
            moe_impl="einsum", remat=True, moe_aux_weight: float = 0.01):
    """(CE + moe_aux_weight * aux, {"ce", "moe_aux"}); the CE is taken on
    the logits rounded to bfloat16, as the reference does."""
    logits, aux = forward(params, cfg, batch["tokens"], impl=impl,
                          moe_impl=moe_impl, remat=remat)
    loss = L.cross_entropy(logits.to(torch.bfloat16), batch["labels"])
    return loss + moe_aux_weight * aux, {"ce": loss, "moe_aux": aux}
