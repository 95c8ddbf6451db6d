"""The port's attention-only language-model configs on the CPU against the
JAX reference: llama3-8b, codeqwen1.5-7b, minitron-8b, gemma2-27b and
qwen2-moe-a2.7b.  Each ``CONFIG`` and ``reduced()`` field for field;
each reduced model's logits with ``impl="xla"`` and with
``impl="pallas"`` (attention on the flash-attention kernel K13's plain
route here, on the reference's Pallas kernel in interpret mode there) at
batch 2 x seq 160, which pads the reference's keys to 256 and passes
gemma2's reduced window of 64; its loss and every gradient with
``impl="xla"``; and the pallas loss refusing a gradient.  qwen2-moe runs
the einsum MoE engine, the reference's default.

The model's weights are the reference's own (``params_from_jax``); the
tokens are made with numpy from a seed.  Tolerance: float32, rtol 1e-5
and atol 1e-5 for logits and losses; gradients rtol 1e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import transformer as j_tf
from repro_torch.configs import NOT_PORTED, get_config, get_reduced
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf
from repro_torch.optim import tree_leaves

torch.set_num_threads(2)
# torch's CPU exp and tanh (MKL VML) can come out at reduced accuracy on
# their first multi-threaded call in a process; make that call here, on
# a tensor large enough to be split across the threads
torch.exp(torch.tanh(torch.zeros(1 << 18)))
ARCHS = ["llama3-8b", "codeqwen1-5-7b", "minitron-8b", "gemma2-27b",
         "qwen2-moe-a2-7b"]
_MODULES = {"llama3-8b": "llama3_8b", "codeqwen1-5-7b": "codeqwen1_5_7b",
            "minitron-8b": "minitron_8b", "gemma2-27b": "gemma2_27b",
            "qwen2-moe-a2-7b": "qwen2_moe_a2_7b"}
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    t_rt.reset_launch_counts()


_MODELS: dict = {}


def _model(arch):
    """The reduced model with the reference's params (seed 0) on both
    sides, built once per arch and worker."""
    if arch not in _MODELS:
        mod = _MODULES[arch]
        j_cfg, t_cfg = j_get_reduced(mod), get_reduced(arch)
        jp = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
        tp = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (j_cfg, t_cfg, jp, tp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    mod = _MODULES[arch]
    for t_cfg, j_cfg in ((get_config(arch), j_get_config(mod)),
                         (get_reduced(arch), j_get_reduced(mod))):
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        assert t_cfg.param_count() == j_cfg.param_count()
        assert t_cfg.active_param_count() == j_cfg.active_param_count()
    assert mod not in NOT_PORTED
    assert get_config(mod) == get_config(arch)


def test_registry_keeps_only_the_unported_three():
    assert set(NOT_PORTED) == {"jamba_1_5_large_398b", "internvl2_1b",
                               "whisper_tiny"}
    assert round(get_config("llama3-8b").param_count() / 1e6, 1) == 8030.0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_equals_reference(arch, impl):
    j_cfg, t_cfg, jp, tp = _model(arch)
    tok = np.random.default_rng(7).integers(0, j_cfg.vocab, (2, 160))
    lj, aux_j = j_tf.forward(jp, j_cfg, jnp.asarray(tok, jnp.int32),
                             impl=impl)
    with torch.no_grad():
        lt, aux_t = t_tf.forward(tp, t_cfg, torch.from_numpy(tok), impl=impl)
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0     # the CPU route
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


def _batch(cfg):
    return JSyntheticLM(cfg.vocab, 32, 2, seed=1).batch_at(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_loss_and_gradients_equal_reference(arch):
    j_cfg, t_cfg, jp, tp = _model(arch)
    batch = _batch(j_cfg)
    (lj, _), gj = jax.value_and_grad(
        lambda p: j_tf.loss_fn(p, j_cfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()}),
        has_aux=True)(jp)
    lt, parts, gt = t_steps.loss_and_grads(
        t_tf.loss_fn, tp, t_cfg, t_steps.to_device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(lt), float(lj), **TOL)
    leaves = jax.tree_util.tree_leaves(gj)
    assert len(tree_leaves(gt)) == len(leaves)
    for i, (g, r) in enumerate(zip(tree_leaves(gt), leaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-5, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_pallas_loss_value_equals_xla_and_refuses_a_gradient(arch):
    """``loss_fn(impl="pallas")`` under ``torch.no_grad()`` is the forward
    value of the xla loss; under autograd it raises naming K13, whose
    backward the reference has not either."""
    _, t_cfg, _, tp = _model(arch)
    batch = t_steps.to_device_batch(_batch(t_cfg), "cpu")
    with torch.no_grad():
        lp, _ = t_tf.loss_fn(tp, t_cfg, batch, impl="pallas")
        lx, _ = t_tf.loss_fn(tp, t_cfg, batch, impl="xla")
    np.testing.assert_allclose(float(lp), float(lx), **TOL)
    with pytest.raises(NotImplementedError, match="K13 has no backward"):
        t_steps.loss_and_grads(t_tf.loss_fn, tp, t_cfg, batch, impl="pallas")
