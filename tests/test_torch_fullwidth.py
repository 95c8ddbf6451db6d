"""The PyTorch port's planned forward at the full width of GoogLeNet
(224x224x3, nine inception modules), through the plain versions on the
CPU, against the JAX reference's plain ``CNN.forward`` — the serving
slice held at full width on this host, at the serving buckets 1 and 2
with one real image (the chained plans the serving loop dispatches).

Weights come from the reference's initializer as numpy arrays.
Tolerance: 1e-4 absolute and relative on the logits (float32; summation
order differs).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.googlenet import CONFIG as J_FULL
from repro.models import cnn as j_cnn
from repro_torch.configs.googlenet import CONFIG as T_FULL
from repro_torch.core import plan_cache as t_pc
from repro_torch.models import cnn as t_cnn

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def full():
    jp = j_cnn.init_params(J_FULL, jax.random.PRNGKey(0))
    tp = t_cnn.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(size=(2,) + J_FULL.img).astype(
        np.float32)
    ref = np.asarray(j_cnn.forward(jp, J_FULL, x))
    t_pc.reset(clear_entries=True)
    yield tp, x, ref
    t_pc.reset(clear_entries=True)


@pytest.mark.parametrize("bucket", [1, 2])
def test_full_width_forward_plan_matches_reference(full, bucket):
    tp, x, ref = full
    plan = t_pc.cached_cnn_plan(T_FULL, bucket, backend="cpu",
                                chain_modules=True).plan
    logits = t_cnn.forward_plan(tp, T_FULL, torch.from_numpy(x[:bucket]),
                                plan, valid_images=1).numpy()
    assert logits.shape == (bucket, T_FULL.num_classes)
    assert np.isfinite(logits[:1]).all()
    np.testing.assert_allclose(logits[:1], ref[:1], rtol=1e-4, atol=1e-4)


def test_full_width_plain_forward_matches_reference(full):
    tp, x, ref = full
    logits = t_cnn.forward(tp, T_FULL, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(logits, ref, rtol=1e-4, atol=1e-4)
