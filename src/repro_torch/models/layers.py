"""Shared layer helpers (``repro/models/layers.py``'s counterparts):
initialisers, norms, rotary embeddings, the dense MLP, the tied
embedding and head, and the cross-entropy loss.  Parameters are plain
nested dicts of tensors in the reference's layouts."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def uniform_init(generator: torch.Generator, shape, scale: float,
                 dtype=torch.float32, device=None):
    """U(-scale, scale) draws from ``generator``, moved to ``device``."""
    t = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=generator.device)
    return (t * (2 * scale) - scale).to(device)


def normal_init(generator: torch.Generator, shape, std: float,
                dtype=torch.float32, device=None):
    """N(0, std^2) draws from ``generator`` (drawn on the generator's own
    device, then moved to ``device``)."""
    t = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                    device=generator.device)
    return (t * std).to(device)


def from_numpy_tree(np_params, device):
    """A nested dict/list tree of numpy arrays (the reference's parameters
    after ``jax.tree.map(np.asarray, params)``) as tensors on ``device``,
    same nesting, same layouts."""
    if isinstance(np_params, dict):
        return {k: from_numpy_tree(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [from_numpy_tree(v, device) for v in np_params]
    return torch.from_numpy(np.array(np_params)).to(device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    """Gemma-style RMSNorm, ``x * rsqrt(mean(x^2) + eps) * (1 + scale)``
    in f32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) integers.  Rotates the two
    halves of the head dimension, as the reference does."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations and the dense MLP
# ---------------------------------------------------------------------------

def gelu(x):
    """The tanh approximation, which is ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": gelu, "relu": torch.relu}


def mlp_init(generator: torch.Generator, d: int, f: int, gated: bool = True,
             dtype=torch.float32, device=None):
    std = d ** -0.5
    p = {"w_in": normal_init(generator, (d, f), std, dtype, device),
         "w_out": normal_init(generator, (f, d), f ** -0.5, dtype, device)}
    if gated:
        p["w_gate"] = normal_init(generator, (d, f), std, dtype, device)
    return p


def mlp(params, x, activation: str = "silu"):
    act = ACTIVATIONS[activation]
    h = x @ params["w_in"]
    if "w_gate" in params:
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype=torch.float32, device=None):
    return {"table": normal_init(generator, (vocab, d), d ** -0.5, dtype,
                                 device)}


def embed(params, tokens):
    return params["table"][tokens.long()]


def unembed(params, x, softcap: float | None = None):
    """Logits against the (tied) embedding table, with the optional tanh
    softcap."""
    logits = x @ params["table"].t()
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits, labels, ignore: int = -1):
    """Mean token NLL; logits (..., V) any dtype, f32 reduction."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    nll = lse - ll
    mask = (labels != ignore).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
