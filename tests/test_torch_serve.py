"""The PyTorch port's serving slice on the CPU against the JAX reference:
the planned forward of reduced GoogLeNet (chained and unchained, dense
and ragged), the serving loop's splitting and admission on a seeded
stream, and the serving loop end to end.

Weights come from the reference's initializer as numpy arrays
(``params_from_jax``); images from numpy.  Tolerance on logits: 1e-3
absolute and relative (float32, summation order differs between the
packages and between kernel and plain paths).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.googlenet import reduced as j_reduced
from repro.core import cost_model as j_cm
from repro.core import plan_cache as j_pc
from repro.kernels import ops as j_ops
from repro.launch import serve as j_serve
from repro.models import cnn as j_cnn
from repro_torch.configs.googlenet import reduced as t_reduced
from repro_torch.core import cost_model as t_cm
from repro_torch.core import plan_cache as t_pc
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import serve as t_serve
from repro_torch.models import cnn as t_cnn

torch.set_num_threads(2)
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(autouse=True)
def _fresh_state():
    t_pc.reset(clear_entries=True)
    yield
    t_pc.reset(clear_entries=True)
    j_pc.reset(clear_entries=True)
    j_ops.reset_launch_counts()
    t_rt.reset_launch_counts()


@pytest.fixture(scope="module")
def reduced_params():
    jcfg = j_reduced()
    jp = j_cnn.init_params(jcfg, jax.random.PRNGKey(0))
    tp = t_cnn.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, t_reduced(), tp


@pytest.mark.parametrize("bucket,chain,valid", [
    (4, True, 4), (4, True, 1), (2, False, None), (4, False, 3)])
def test_reduced_forward_plan_matches_reference(reduced_params, bucket,
                                                chain, valid):
    jcfg, jp, tcfg, tp = reduced_params
    x = np.random.default_rng(1).normal(
        size=(bucket,) + jcfg.img).astype(np.float32)
    jplan, _ = j_cnn.plan_cnn(jcfg, bucket, chain_modules=chain)
    tplan, _ = t_cnn.plan_cnn(tcfg, bucket, chain_modules=chain)
    assert tplan.mode_counts() == jplan.mode_counts()
    jl = np.asarray(j_cnn.forward_plan(jp, jcfg, x, jplan,
                                       valid_images=valid))
    tl = t_cnn.forward_plan(tp, tcfg, torch.from_numpy(x), tplan,
                            valid_images=valid).numpy()
    n = bucket if valid is None else valid
    assert tl.shape == jl.shape == (bucket, jcfg.num_classes)
    np.testing.assert_allclose(tl[:n], jl[:n], **TOL)
    # and the port's plan against the port's own plain forward
    ref = t_cnn.forward(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tl[:n], ref[:n], **TOL)


def _stream(seed, num_requests, max_images, img):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, max_images + 2, size=num_requests)
    deadlines = rng.uniform(0.05, 0.5, size=num_requests)
    reqs = [rng.normal(size=(int(s),) + img).astype(np.float32)
            for s in sizes]
    return reqs, deadlines


@pytest.mark.parametrize("max_images", [2, 4])
def test_split_and_admit_match_reference(max_images):
    img = (8, 8, 3)
    reqs, dls = _stream(5, 24, max_images, img)
    rows = img[0] * img[1]
    ladder = t_cm.serve_buckets(max_images, rows)
    assert ladder == j_cm.serve_buckets(max_images, rows)
    jp, tp = [], []
    for rid, (r, dl) in enumerate(zip(reqs, dls)):
        js = j_serve._split_request(rid, r, float(dl), max_images)
        ts = t_serve._split_request(rid, r, float(dl), max_images)
        assert [(c["rid"], c["imgs"].shape[0], c["deadline"]) for c in ts] \
            == [(c["rid"], c["imgs"].shape[0], c["deadline"]) for c in js]
        jp.extend(js)
        tp.extend(ts)
    while jp:
        jb, jt = j_serve._admit(jp, max_images, ladder, rows,
                                j_cm.padded_m_factor)
        tb, tt = t_serve._admit(tp, max_images, ladder, rows,
                                t_cm.padded_m_factor)
        assert tt == jt
        assert [(c["rid"], c["imgs"].shape[0]) for c in tb] == \
            [(c["rid"], c["imgs"].shape[0]) for c in jb]
        assert t_serve._bucket_for(tt, ladder) == \
            j_serve._bucket_for(jt, ladder)
    assert not tp


def test_serving_loop_end_to_end_on_cpu():
    m = t_serve.serve_cnn_metrics(t_reduced(), max_images=4,
                                  num_requests=6, device="cpu")
    assert m["plan_cache"]["hit_rate"] == 1.0
    assert m["plan_cache"]["misses"] == 0
    assert m["images"] == m["images_submitted"]
    assert m["buckets"] == j_cm.serve_buckets(4, 32 * 32)
    assert m["requests"] == 6 and m["latency_samples"] == 6
    assert m["padded_m_factor_mean"] >= 1.0
    # the CPU run goes through the plain versions: no kernel launched
    assert all(v == 0 for v in t_rt.KERNEL_LAUNCHES.values())


def _smoke_serve_seed(monkeypatch):
    """``SERVE_SEED`` of the repository's ``chip_smoke.py`` (loading it
    puts ``src/`` on ``sys.path``; the monkeypatch undoes that)."""
    import importlib.util
    import sys
    from pathlib import Path
    monkeypatch.setattr(sys, "path", list(sys.path))
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SERVE_SEED


def test_serving_launches_per_bucket_on_cpu(monkeypatch):
    """The smoke run's seeded 12-request stream dispatches at every bucket
    of the ladder after warmup, and the per-bucket launch ledger accounts
    for every dispatch, warmup and measured apart."""
    seed = _smoke_serve_seed(monkeypatch)
    m = t_serve.serve_cnn_metrics(t_reduced(), max_images=4,
                                  num_requests=12, seed=seed, device="cpu")
    warm, meas = m["launches"]["warmup"], m["launches"]["measured"]
    assert sorted(warm) == sorted(meas) == m["buckets"] == [1, 2, 4]
    assert all(r["dispatches"] == 1 for r in warm.values())
    assert sum(r["dispatches"] for r in meas.values()) == m["dispatches"]
    kernels = set(t_rt.KERNEL_LAUNCHES)
    for row in list(warm.values()) + list(meas.values()):
        assert set(row) == kernels | {"dispatches"}
        assert all(row[k] == 0 for k in kernels)    # plain versions here


def test_serve_main_on_cpu(capsys):
    assert t_serve.main(["--arch", "googlenet", "--reduced", "--requests",
                         "3", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "googlenet-reduced on cpu" in out and "hit_rate': 1.0" in out
