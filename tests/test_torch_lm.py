"""The PyTorch port's language-model training path on the CPU against the
JAX reference: the layers (norms, rotary embeddings, embedding and
tied head, dense MLP), attention (materialized and kv-chunked), the
whole granite-moe-1b-a400m reduced model with both MoE engines (logits,
loss, every gradient), two train steps, the token stream, and the
trainer's command line.

Inputs are made with numpy from a seed and handed to both packages; the
model's weights are the reference's own (``params_from_jax``).
Tolerance: float32, rtol 1e-5 and atol 1e-6 unless a test says
otherwise; gradients per parameter within 1e-4 * max|ref| + 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as j_ops
from repro.launch import steps as j_steps
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.optim import AdamW as JAdamW
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.base import BlockSpec
from repro_torch.data import Pipeline as TPipeline
from repro_torch.data import SyntheticLM as TSyntheticLM
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.optim import AdamW as TAdamW
from repro_torch.optim import tree_leaves

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
ARCH = "granite-moe-1b-a400m"


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    j_ops.reset_launch_counts()
    t_rt.reset_launch_counts()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_layernorm_equal_reference():
    rng = _rng(0)
    x = _f32(rng, 2, 5, 16, scale=3.0)
    scale, bias = _f32(rng, 16), _f32(rng, 16)
    np.testing.assert_allclose(
        t_layers.rmsnorm({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(j_layers.rmsnorm({"scale": jnp.asarray(scale)},
                                    jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        t_layers.layernorm({"scale": _t(scale), "bias": _t(bias)},
                           _t(x)).numpy(),
        np.asarray(j_layers.layernorm({"scale": jnp.asarray(scale),
                                       "bias": jnp.asarray(bias)},
                                      jnp.asarray(x))), **TOL)
    assert t_layers.rmsnorm_init(7)["scale"].shape == (7,)
    assert float(t_layers.layernorm_init(7)["scale"].sum()) == 7.0


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_equals_reference(theta):
    rng = _rng(1)
    x = _f32(rng, 2, 9, 3, 8)
    pos = rng.integers(0, 4096, size=(2, 9)).astype(np.int32)
    np.testing.assert_allclose(
        t_layers.rope(_t(x), _t(pos), theta).numpy(),
        np.asarray(j_layers.rope(jnp.asarray(x), jnp.asarray(pos), theta)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_embed_unembed_and_mlp_equal_reference(softcap):
    rng = _rng(2)
    table = _f32(rng, 50, 16)
    tok = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    x = _f32(rng, 2, 7, 16, scale=3.0)
    np.testing.assert_array_equal(
        t_layers.embed({"table": _t(table)}, _t(tok)).numpy(),
        np.asarray(j_layers.embed({"table": jnp.asarray(table)},
                                  jnp.asarray(tok))))
    np.testing.assert_allclose(
        t_layers.unembed({"table": _t(table)}, _t(x), softcap).numpy(),
        np.asarray(j_layers.unembed({"table": jnp.asarray(table)},
                                    jnp.asarray(x), softcap)),
        rtol=1e-5, atol=1e-5)
    for act, gated in (("silu", True), ("gelu", True), ("relu", False)):
        p = {"w_in": _f32(rng, 16, 12), "w_out": _f32(rng, 12, 16)}
        if gated:
            p["w_gate"] = _f32(rng, 16, 12)
        np.testing.assert_allclose(
            t_layers.mlp({k: _t(v) for k, v in p.items()}, _t(x),
                         act).numpy(),
            np.asarray(j_layers.mlp({k: jnp.asarray(v)
                                     for k, v in p.items()},
                                    jnp.asarray(x), act)),
            rtol=1e-5, atol=1e-4, err_msg=act)


SDPA = [dict(causal=True, window=None, softcap=None),
        dict(causal=True, window=5, softcap=None),
        dict(causal=False, window=None, softcap=20.0)]


@pytest.mark.parametrize("kw", SDPA, ids=["causal", "window", "softcap"])
def test_sdpa_materialized_equals_reference(kw):
    rng = _rng(3)
    q, k, v = _f32(rng, 2, 11, 4, 8), _f32(rng, 2, 11, 2, 8), \
        _f32(rng, 2, 11, 2, 8)
    got = t_attn._sdpa_materialized(_t(q), _t(k), _t(v), scale=0.35, **kw)
    ref = j_attn._sdpa_materialized(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale=0.35, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("kw", SDPA, ids=["causal", "window", "softcap"])
def test_sdpa_chunked_equals_reference(kw):
    """Past Sq*Skv = 1024^2 the reference takes its kv-chunked online
    softmax; 1040 positions with 256-wide chunks (padded last chunks)
    take it on both sides."""
    rng = _rng(4)
    s = 1040
    q, k, v = _f32(rng, 1, s, 2, 8), _f32(rng, 1, s, 1, 8), \
        _f32(rng, 1, s, 1, 8)
    got = t_attn._sdpa_xla(_t(q), _t(k), _t(v), scale=0.35, chunk_q=256,
                           chunk_kv=256, **kw)
    ref = j_attn._sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           scale=0.35, chunk_q=256, chunk_kv=256, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_attn_apply_equals_reference_and_pallas_raises():
    """``attn_apply`` without a cache against the reference's, on both
    impls: ``impl="pallas"`` runs K13 (its plain route on the CPU, the
    reference's Pallas kernel in interpret mode)."""
    rng = _rng(5)
    d, hq, hkv, hd = 32, 4, 2, 8
    sd, so = d ** -0.5, (hq * hd) ** -0.5
    p = {"wq": _f32(rng, d, hq * hd, scale=sd),
         "wk": _f32(rng, d, hkv * hd, scale=sd),
         "wv": _f32(rng, d, hkv * hd, scale=sd),
         "wo": _f32(rng, hq * hd, d, scale=so)}
    x = _f32(rng, 2, 10, d)
    kw = dict(hq=hq, hkv=hkv, hd=hd, rope_theta=10000.0)
    got, cache = t_attn.attn_apply({k: _t(v) for k, v in p.items()}, _t(x),
                                   **kw)
    ref, _ = j_attn.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    got, cache = t_attn.attn_apply({k: _t(v) for k, v in p.items()},
                                   _t(x), impl="pallas", **kw)
    ref, _ = j_attn.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), impl="pallas", **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_granite_config_equals_reference():
    from repro.configs import get_config as j_get_config
    for t_cfg, j_cfg in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_reduced(ARCH), j_get_reduced(ARCH))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()
    assert round(get_config(ARCH).param_count() / 1e6, 1) == 1334.6


def test_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="config is not ported"):
        get_config("jamba_1_5_large_398b")
    with pytest.raises(NotImplementedError, match="not ported"):
        get_reduced("whisper-tiny")
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("no-such-arch")
    cfg = dataclasses.replace(get_reduced(ARCH),
                              pattern=(BlockSpec(mixer="mamba"),))
    with pytest.raises(ValueError, match="needs cfg.ssm"):
        t_tf.init_params(cfg, device="cpu")
    cfg = dataclasses.replace(get_reduced(ARCH),
                              pattern=(BlockSpec(cross=True),))
    with pytest.raises(NotImplementedError, match="cross-attention"):
        t_tf.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="cross-attention"):
        t_tf._block_apply(cfg, cfg.pattern[0], {}, torch.zeros(1, 2, 128))


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def granite():
    """Reduced granite-moe: the reference's params (seed 0) on both sides,
    and one batch of the reference's token stream."""
    j_cfg, t_cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    tp = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = JSyntheticLM(j_cfg.vocab, 16, 2, seed=0).batch_at(0)
    return j_cfg, t_cfg, jp, tp, batch


def _tb(batch):
    return t_steps.to_device_batch(batch, "cpu")


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_params_and_init_layout_equal_reference(granite):
    j_cfg, t_cfg, jp, tp, _ = granite
    shapes = lambda leaves: [tuple(a.shape) for a in leaves]
    assert shapes(tree_leaves(tp)) == \
        shapes(jax.tree_util.tree_leaves(jp))
    fresh = t_tf.init_params(t_cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    assert shapes(tree_leaves(fresh)) == shapes(tree_leaves(tp))
    n = sum(t.numel() for t in tree_leaves(fresh))
    assert n == t_cfg.param_count() + t_cfg.d_model * (
        1 + 2 * t_cfg.n_layers)   # + the norms, which param_count omits


@pytest.mark.parametrize("moe_impl", ["einsum", "grouped"])
def test_forward_and_loss_equal_reference(granite, moe_impl):
    j_cfg, t_cfg, jp, tp, batch = granite
    lj, aux_j = j_tf.forward(jp, j_cfg, jnp.asarray(batch["tokens"]),
                             moe_impl=moe_impl)
    lt, aux_t = t_tf.forward(tp, t_cfg, _tb(batch)["tokens"],
                             moe_impl=moe_impl)
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    loss_j, parts_j = j_tf.loss_fn(jp, j_cfg, _jb(batch), moe_impl=moe_impl)
    loss_t, parts_t = t_tf.loss_fn(tp, t_cfg, _tb(batch), moe_impl=moe_impl)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    np.testing.assert_allclose(float(parts_t["ce"]), float(parts_j["ce"]),
                               rtol=1e-6)


@pytest.mark.parametrize("moe_impl,remat", [("einsum", False),
                                            ("grouped", False),
                                            ("grouped", True)])
def test_gradients_equal_reference(granite, moe_impl, remat):
    j_cfg, t_cfg, jp, tp, batch = granite
    gj = jax.grad(lambda p: j_tf.loss_fn(p, j_cfg, _jb(batch),
                                         moe_impl=moe_impl)[0])(jp)
    loss, parts, gt = t_steps.loss_and_grads(
        t_tf.loss_fn, tp, t_cfg, _tb(batch), moe_impl=moe_impl, remat=remat)
    assert set(parts) == {"ce", "moe_aux"}
    for i, (g, r) in enumerate(zip(tree_leaves(gt),
                                   jax.tree_util.tree_leaves(gj))):
        r = np.asarray(r)
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()) + 1e-6, (i, r.shape, err)


def test_two_train_steps_equal_reference(granite):
    """Two grouped-engine steps of the port's ``make_train_step`` against
    the reference's ``make_train_step`` (its einsum engine; the grouped
    one reproduces it): losses, metrics and the parameters after."""
    j_cfg, t_cfg, jp, tp, _ = granite
    kw = dict(lr=1e-3, warmup=1, total=2)
    j_opt, t_opt = JAdamW(**kw), TAdamW(**kw)
    j_step = jax.jit(j_steps.make_train_step(j_cfg, j_opt))
    t_step = t_steps.make_train_step(t_cfg, t_opt, moe_impl="grouped",
                                     device="cpu")
    src = JSyntheticLM(j_cfg.vocab, 16, 2, seed=3)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    tp0 = tp
    for i in range(2):
        b = src.batch_at(i)
        jp, js, jm = j_step(jp, js, _jb(b))
        tp, ts, tm = t_step(tp, ts, b)
        for k in ("loss", "ce", "moe_aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    # AdamW moves every element by about lr (1e-3) a step whatever the
    # size of its gradient, so f32 rounding in a near-zero gradient
    # element can move it by a large part of lr: the two updates are held
    # per parameter in the L2 norm, not element by element
    for g, r, g0 in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                        tree_leaves(tp0)):
        du_t, du_j = g.numpy() - g0.numpy(), np.asarray(r) - g0.numpy()
        assert np.linalg.norm(du_t - du_j) <= 1e-2 * np.linalg.norm(du_j) \
            + 1e-7, g.shape


# ---------------------------------------------------------------------------
# data and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_lm_bit_equal_to_reference(step):
    for host in (0, 1):
        got = TSyntheticLM(97, 33, 4, seed=11).batch_at(
            step, host_index=host, host_count=2)
        ref = JSyntheticLM(97, 33, 4, seed=11).batch_at(
            step, host_index=host, host_count=2)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == ref[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], ref[k])
    pipe = TPipeline(TSyntheticLM(97, 8, 2, seed=1))
    np.testing.assert_array_equal(next(pipe)["tokens"],
                                  JSyntheticLM(97, 8, 2, seed=1)
                                  .batch_at(0)["tokens"])


def test_train_cli_runs_reduced_granite_on_cpu(capsys):
    assert t_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                         "--batch", "2", "--seq", "16", "--device", "cpu",
                         "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "granite-moe-reduced" in out and "[train] done." in out
    assert out.count("loss=") == 2


def test_train_cli_refuses_what_is_not_ported():
    # K13 and K14 have no backward, nor have the reference's kernels
    for arch in (ARCH, "llama3-8b"):
        with pytest.raises(NotImplementedError, match="K13.*no backward"):
            t_train.main(["--arch", arch, "--reduced", "--steps", "1",
                          "--impl", "pallas", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="K14"):
        t_train.main(["--arch", "mamba2-370m", "--reduced", "--steps", "1",
                      "--impl", "pallas", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="not ported"):
        t_train.main(["--arch", "jamba-1-5-large-398b", "--reduced",
                      "--steps", "1", "--device", "cpu"])


def test_lm_entry_points_need_the_card_unless_asked_for_the_cpu(granite):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.params_from_jax({"embed": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_steps.make_train_step(cfg, t_steps.make_optimizer(cfg),
                                moe_impl="grouped")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", ARCH, "--reduced"])
