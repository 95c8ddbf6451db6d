"""The PyTorch port's Mamba-2 path on the CPU against the JAX reference:
the chunked SSD (the K14 wrapper's plain route, ``ssd_chunk_ref``) against
the reference's Pallas kernel in interpret mode, the quadratic SSD, the
mamba mixer in training, prefill and decode form, the port's
``impl="pallas"`` against its ``impl="xla"``, and the reduced mamba2
model's forward, prefill (logits and caches) and teacher-forced decode.

Inputs are made with numpy from a seed and handed to both packages; the
model's weights are the reference's own (``params_from_jax``).
Tolerance: float32, max abs err <= 1e-4 * max|ref| + 1e-6 for every
tensor.  The bfloat16 conv cache is held to that bound or to one bf16
spacing of the reference's element: the two packages' f32 values differ
in the last bits, and a value near a bf16 rounding boundary then rounds
to the neighbouring bf16 number on one side.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ref as j_ref
from repro.models import mamba2 as j_mamba
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.kernels import ssd as t_ssd
from repro_torch.launch import steps as t_steps
from repro_torch.models import mamba2 as t_mamba
from repro_torch.models import transformer as t_tf
from repro_torch.optim import tree_leaves

torch.set_num_threads(2)
ARCH = "mamba2-370m"
# the reference's kernel module (``repro.kernels`` re-exports the
# function ``ssd`` under the module's name)
j_ssd = importlib.import_module("repro.kernels.ssd")
# the reference's functions under jit (one compile per shape)
j_ssd_chunked = jax.jit(j_ssd.ssd_chunked, static_argnames=(
    "chunk", "return_final_state", "interpret"))
j_mamba_apply = jax.jit(j_mamba.mamba_apply, static_argnames=(
    "d_inner", "n_heads", "head_dim", "d_state", "n_groups", "chunk",
    "impl"))
j_forward = jax.jit(j_tf.forward, static_argnums=(1,))
j_prefill = jax.jit(j_tf.prefill, static_argnums=(1,))
j_decode_step = jax.jit(j_tf.decode_step, static_argnums=(1,))

CASES = [
    # (b, s, h, p, g, n, chunk): the reference's tests/test_kernels_ssd.py
    (2, 256, 4, 16, 2, 32, 64),
    (1, 100, 2, 8, 1, 16, 32),     # non-divisible seq
    (1, 64, 8, 32, 8, 64, 64),     # single chunk
    (2, 96, 4, 64, 1, 128, 32),    # mamba2-370m-like dims
]


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    t_rt.reset_launch_counts()


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, dtype=np.float32)


def _close(got, ref, what=""):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    lim = 1e-4 * float(np.abs(ref).max()) + 1e-6
    assert err <= lim, (what, err, lim)


def _close_bf16(got, ref, what=""):
    """A bfloat16 tensor: each element within 1e-4 * max|ref| + 1e-6 of
    the reference's, or one bf16 spacing of it (a rounding flip)."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    spacing = np.abs(ref) * 2.0 ** -7 + 1e-30
    err = np.abs(got - ref)
    ok = (err <= 1e-4 * float(np.abs(ref).max()) + 1e-6) | (err <= spacing)
    assert ok.all(), (what, float(err.max()), int((~ok).sum()))


def _ssd_inputs(case, seed):
    b, s, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, s, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, s, h))) * 0.3).astype(np.float32)
    bb = (rng.normal(size=(b, s, g, n)) * n ** -0.5).astype(np.float32)
    cc = (rng.normal(size=(b, s, g, n)) * n ** -0.5).astype(np.float32)
    d = rng.normal(size=(h,)).astype(np.float32)
    st0 = (rng.normal(size=(b, h, n, p)) * 0.5).astype(np.float32)
    return x, a, bb, cc, d, st0


# ---------------------------------------------------------------------------
# the SSD algorithms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_chunked_equals_reference_kernel(case):
    """The port's chunked SSD (K14's plain route on the CPU) against the
    reference's Pallas kernel in interpret mode, with d_skip, an initial
    state and the final state."""
    x, a, bb, cc, d, st0 = _ssd_inputs(case, 0)
    chunk = case[-1]
    yj, fj = j_ssd_chunked(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(bb), jnp.asarray(cc),
        chunk=chunk, d_skip=jnp.asarray(d), init_state=jnp.asarray(st0),
        return_final_state=True, interpret=True)
    yt, ft = t_ssd.ssd_chunked(_t(x), _t(a), _t(bb), _t(cc), chunk=chunk,
                               d_skip=_t(d), init_state=_t(st0),
                               return_final_state=True)
    _close(yt, yj, "y")
    _close(ft, fj, "final state")
    # without a state: from zeros, and y alone
    yj = j_ssd_chunked(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bb),
                           jnp.asarray(cc), chunk=chunk, interpret=True)
    _close(t_ssd.ssd_chunked(_t(x), _t(a), _t(bb), _t(cc), chunk=chunk), yj,
           "y from zeros")
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == 0    # the CPU route


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_ssd_quadratic_and_zoo_equal_reference_oracle(case):
    x, a, bb, cc, d, _ = _ssd_inputs(case, 1)
    want = j_ref.ssd_ref(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bb),
                         jnp.asarray(cc), d_skip=jnp.asarray(d))
    args = (_t(x), _t(a), _t(bb), _t(cc))
    _close(t_ssd.ssd_quadratic(*args, d_skip=_t(d)), want, "quadratic")
    for alg in t_ssd.SSD_ALGORITHMS:
        _close(t_ops.ssd(*args, chunk=case[-1], d_skip=_t(d), algorithm=alg),
               want, alg)
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_ops.ssd(*args, algorithm="scan")


def test_ssd_chunk_cells_hold_their_definition():
    """``ssd_chunk_ref``'s three outputs per cell against a direct loop
    over (cell, head) of the definitions in the reference's kernel body
    (``_ssd_chunk_kernel``), G = 2 groups of 2 heads, and the
    reference's Pallas call's outputs through the state it returns."""
    rng = np.random.default_rng(2)
    b, nc, l, h, p, g, n = 2, 3, 8, 4, 5, 2, 6
    x = rng.normal(size=(b, nc, l, h, p)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(b, nc, l, h))) * 0.3).astype(np.float32)
    bb = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    cc = rng.normal(size=(b, nc, l, g, n)).astype(np.float32)
    y, st, cum = t_ssd.ssd_chunk_ref(_t(x), _t(a), _t(bb), _t(cc))
    assert y.dtype == st.dtype == cum.dtype == torch.float32
    for i in range(b):
        for j in range(nc):
            for hh in range(h):
                gg = hh // (h // g)
                cm = np.cumsum(a[i, j, :, hh].astype(np.float64))
                _close(cum[i, j, :, hh], cm, "cum")
                m = np.tril(np.exp(cm[:, None] - cm[None, :])) * \
                    (cc[i, j, :, gg] @ bb[i, j, :, gg].T)
                _close(y[i, j, :, hh], m @ x[i, j, :, hh], "y_diag")
                sd = np.exp(cm[-1] - cm)[:, None]
                _close(st[i, j, hh], (bb[i, j, :, gg] * sd).T @ x[i, j, :, hh],
                       "state")
    with pytest.raises(NotImplementedError, match="no backward"):
        t_ssd.ssd_chunk(_t(x).requires_grad_(True), _t(a), _t(bb), _t(cc))


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

_MKW = dict(d_inner=64, n_heads=4, head_dim=16, d_state=16, n_groups=2)


@pytest.fixture(scope="module")
def mixer():
    """The reference's mixer parameters (d 32, conv width 4, non-zero
    conv bias, dt bias and norm scale) on both sides, and an input of 20
    tokens (chunk 8: three chunks, the last one padded)."""
    jp = j_mamba.mamba_init(jax.random.PRNGKey(0), 32, conv_width=4, **_MKW)
    rng = np.random.default_rng(3)
    npp = {k: np.asarray(v) for k, v in jp.items() if k != "norm"}
    for k in ("conv_b", "dt_bias"):
        npp[k] = (rng.normal(size=npp[k].shape) * 0.1).astype(np.float32)
    npp["norm"] = {"scale": (rng.normal(size=(64,)) * 0.1)
                   .astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, npp)
    tp = jax.tree.map(lambda v: _t(np.asarray(v)), npp)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    return jp, tp, x


def test_mamba_init_layout_equals_reference():
    g = torch.Generator().manual_seed(0)
    tp = t_mamba.mamba_init(g, 32, conv_width=4, **_MKW)
    jp = j_mamba.mamba_init(jax.random.PRNGKey(0), 32, conv_width=4, **_MKW)
    assert set(tp) == set(jp)
    for k in tp:
        want = jp[k]["scale"] if k == "norm" else jp[k]
        got = tp[k]["scale"] if k == "norm" else tp[k]
        assert tuple(got.shape) == want.shape, k
    for k in ("conv_b", "A_log", "D", "dt_bias"):
        _close(tp[k], jp[k], k)


def test_mamba_apply_train_form_equals_reference(mixer):
    jp, tp, x = mixer
    yj, (sj, cj) = j_mamba_apply(jp, jnp.asarray(x), chunk=8, **_MKW)
    yt, (st, ct) = t_mamba.mamba_apply(tp, _t(x), chunk=8, **_MKW)
    _close(yt, yj, "out")
    _close(st, sj, "ssm state")
    _close(ct, cj, "conv tail")


def test_mamba_apply_prefill_with_state_then_decode_equals_reference(mixer):
    """A prefill of 9 tokens, a second prefill of 5 from its states, then
    single-step decode to the end, each output and state against the
    reference's."""
    jp, tp, x = mixer
    j_state = t_state = (None, None)
    for lo, hi in ((0, 9), (9, 14)) + tuple((t, t + 1) for t in range(14, 20)):
        yj, j_state = j_mamba_apply(
            jp, jnp.asarray(x[:, lo:hi]), chunk=8, ssm_state=j_state[0],
            conv_state=j_state[1], **_MKW)
        yt, t_state = t_mamba.mamba_apply(
            tp, _t(x[:, lo:hi]), chunk=8, ssm_state=t_state[0],
            conv_state=t_state[1], **_MKW)
        _close(yt, yj, f"out [{lo}, {hi})")
        _close(t_state[0], j_state[0], f"ssm [{lo}, {hi})")
        _close(t_state[1], j_state[1], f"conv [{lo}, {hi})")


def test_mamba_pallas_equals_xla_on_cpu(mixer):
    """``impl="pallas"`` (the K14 wrapper, its plain route here) against
    the port's own ``impl="xla"``, from zeros and from a state."""
    _, tp, x = mixer
    xs = _t(x)
    with torch.no_grad():
        ref = t_mamba.mamba_apply(tp, xs[:, :13], chunk=8, **_MKW)
        got = t_mamba.mamba_apply(tp, xs[:, :13], chunk=8, impl="pallas",
                                  **_MKW)
        for r, g_, what in zip((ref[0],) + ref[1], (got[0],) + got[1],
                               ("out", "ssm", "conv")):
            _close(g_, r, what)
        kw = dict(ssm_state=ref[1][0], conv_state=ref[1][1], **_MKW)
        ref = t_mamba.mamba_apply(tp, xs[:, 13:], chunk=8, **kw)
        got = t_mamba.mamba_apply(tp, xs[:, 13:], chunk=8, impl="pallas",
                                  **kw)
        for r, g_ in zip((ref[0],) + ref[1], (got[0],) + got[1]):
            _close(g_, r)
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == 0
    with pytest.raises(ValueError, match="unknown mamba impl"):
        t_mamba.mamba_apply(tp, xs, impl="triton", **_MKW)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_mamba2_config_equals_reference():
    for t_cfg, j_cfg in ((get_config(ARCH), j_get_config(ARCH)),
                         (get_reduced(ARCH), j_get_reduced(ARCH))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.param_count() == j_cfg.param_count()
    assert round(get_config(ARCH).param_count() / 1e6, 2) == 368.08


@pytest.fixture(scope="module")
def mamba_model():
    """Reduced mamba2 (4 layers, d 128, chunk 32): the reference's params
    (seed 0) on both sides."""
    j_cfg, t_cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    tp = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return j_cfg, t_cfg, jp, tp


def test_mamba2_forward_equals_reference(mamba_model):
    j_cfg, t_cfg, jp, tp = mamba_model
    tok = np.random.default_rng(4).integers(0, j_cfg.vocab, (2, 40))
    lj, _ = j_forward(jp, j_cfg, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        lt, _ = t_tf.forward(tp, t_cfg, _t(tok))
        lp, _ = t_tf.forward(tp, t_cfg, _t(tok), impl="pallas")
    _close(lt, lj, "logits, impl xla")
    _close(lp, lj, "logits, impl pallas")


def test_mamba2_loss_and_gradients_equal_reference(mamba_model):
    """Training form: the loss and every parameter's gradient (torch
    autograd through the plain chunked SSD) against the reference's
    ``jax.grad``, per parameter within 1e-4 * max|ref| + 1e-6."""
    j_cfg, t_cfg, jp, tp = mamba_model
    batch = JSyntheticLM(j_cfg.vocab, 40, 2, seed=0).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), gj = jax.jit(jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, j_cfg, jb), has_aux=True))(jp)
    loss_t, _, gt = t_steps.loss_and_grads(
        t_tf.loss_fn, tp, t_cfg, t_steps.to_device_batch(batch, "cpu"),
        remat=False)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    leaves_j = jax.tree_util.tree_leaves(gj)
    assert len(tree_leaves(gt)) == len(leaves_j)
    for i, (g, r) in enumerate(zip(tree_leaves(gt), leaves_j)):
        _close(g, r, f"gradient {i} {r.shape}")


def _to_torch_cache(jc, dtype):
    return [{k: _t(np.asarray(v.astype(jnp.float32))).to(
        torch.float32 if k == "ssm" else dtype) for k, v in c.items()}
        for c in jc]


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mamba2_prefill_and_decode_equal_reference(mamba_model, impl,
                                                   cache_dtype):
    """Prefill of 40 tokens (two chunks of 32, the last padded) into the
    cache, then 8 decode steps fed fixed tokens (teacher forcing):
    logits, SSM state (f32) and conv tail at every step against the
    reference's ``impl="xla"``.  With the f32 cache each package runs on
    its own cache throughout.  With the bf16 cache (the default) each
    decode step starts from the reference's cache: a conv entry that
    rounds to the other bf16 neighbour moves the next steps by up to
    2^-8 of a channel, more than the f32 bound, so the step function is
    held on equal inputs rather than the two trajectories."""
    j_cfg, t_cfg, jp, tp = mamba_model
    rng = np.random.default_rng(5)
    b, s, gen = 2, 40, 8
    tok = rng.integers(0, j_cfg.vocab, (b, s))
    feed = rng.integers(0, j_cfg.vocab, (b, gen))
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jc = j_tf.init_cache(j_cfg, b, s + gen, dtype=jdt)
    tc = t_tf.init_cache(t_cfg, b, s + gen, dtype=tdt, device="cpu")
    assert [{k: tuple(v.shape) for k, v in c.items()} for c in tc] == \
        [{k: v.shape for k, v in c.items()} for c in jc]
    assert tc[0]["ssm"].dtype == torch.float32
    assert tc[0]["conv"].dtype == tdt
    close_conv = _close_bf16 if cache_dtype == "bfloat16" else _close
    lj, jc = j_prefill(jp, j_cfg, jnp.asarray(tok, jnp.int32), jc)
    lt, tc = t_tf.prefill(tp, t_cfg, _t(tok), tc, impl=impl)
    for step in range(gen + 1):
        _close(lt, lj, f"logits, step {step}")
        _close(tc[0]["ssm"], jc[0]["ssm"], f"ssm, step {step}")
        close_conv(tc[0]["conv"], jc[0]["conv"].astype(jnp.float32),
                   f"conv, step {step}")
        if step == gen:
            break
        if cache_dtype == "bfloat16":
            tc = _to_torch_cache(jc, tdt)
        t = feed[:, step:step + 1]
        lj, jc = j_decode_step(jp, j_cfg, jc, jnp.asarray(t, jnp.int32),
                                  jnp.int32(s + step))
        lt, tc = t_tf.decode_step(tp, t_cfg, tc, _t(t), s + step, impl=impl)
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == 0
