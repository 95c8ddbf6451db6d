"""The PyTorch port's planner against the JAX reference: the same graph,
schedule and lowered plan — groups, modes, chains, pools, joins and
algorithms — for googlenet, full and reduced, at every serving bucket,
chained and unchained; plus the serving ladder, the padded-M factor, the
graph fingerprint and the port's plan cache."""
import pytest
import torch

from repro.configs.googlenet import CONFIG as J_FULL
from repro.configs.googlenet import reduced as j_reduced
from repro.core import cost_model as j_cm
from repro.core import plan_cache as j_pc
from repro.models import cnn as j_cnn
from repro_torch.configs.googlenet import CONFIG as T_FULL
from repro_torch.configs.googlenet import reduced as t_reduced
from repro_torch.core import cost_model as t_cm
from repro_torch.core import plan_cache as t_pc
from repro_torch.models import cnn as t_cnn

torch.set_num_threads(2)

CFGS = {"full": (J_FULL, T_FULL), "reduced": (j_reduced(), t_reduced())}


@pytest.fixture(autouse=True)
def _fresh_caches():
    t_pc.reset(clear_entries=True)
    yield
    t_pc.reset(clear_entries=True)
    j_pc.reset(clear_entries=True)


def _group_rows(plan):
    return [(g.mode, g.ops, g.algorithms, g.join, g.pools, g.chain, g.reason)
            for g in plan.groups]


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("bucket", [1, 2, 4])
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_plan_equals_reference(which, bucket, chain):
    jcfg, tcfg = CFGS[which]
    jplan, jsch = j_cnn.plan_cnn(jcfg, bucket, chain_modules=chain)
    tplan, tsch = t_cnn.plan_cnn(tcfg, bucket, chain_modules=chain)
    assert tplan.mode_counts() == jplan.mode_counts()
    assert _group_rows(tplan) == _group_rows(jplan)
    assert tplan.algorithms == jplan.algorithms
    for tg, jg in zip(tplan.groups, jplan.groups):
        assert tg.modeled_time == pytest.approx(jg.modeled_time, rel=1e-12)
    assert [(g.ops, g.algorithms, g.serialized) for g in tsch.groups] == \
        [(g.ops, g.algorithms, g.serialized) for g in jsch.groups]
    assert tplan.context["batch"] == bucket


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_graph_fingerprint_equals_reference(which):
    jcfg, tcfg = CFGS[which]
    for b in (1, 2, 4):
        assert t_pc.graph_fingerprint(t_cnn.build_graph(tcfg, b)) == \
            j_pc.graph_fingerprint(j_cnn.build_graph(jcfg, b))


def test_serve_buckets_and_padded_m_factor_equal_reference():
    for max_images in (1, 2, 3, 4, 5, 8):
        for rows in (1, 49, 196, 1024, 50176):
            assert t_cm.serve_buckets(max_images, rows) == \
                j_cm.serve_buckets(max_images, rows)
    for m_true, m_bucket in ((1, 1), (100, 300), (196, 784), (1000, 4096),
                             (50176, 200704)):
        assert t_cm.padded_m_factor(m_true, m_bucket) == \
            j_cm.padded_m_factor(m_true, m_bucket)


def test_planner_profile_is_the_reference_tpu_constants():
    p = t_cm.TPU_PLANNER_PROFILE
    assert t_cm.PROFILE is p
    assert (p.peak_flops, p.hbm_bw, p.ici_bw, p.vmem_bytes, p.hbm_bytes,
            p.pipeline_loss, p.xla_interleave_loss) == (
        j_cm.PEAK_FLOPS, j_cm.HBM_BW, j_cm.ICI_BW, j_cm.VMEM_BYTES,
        j_cm.HBM_BYTES, j_cm.PIPELINE_LOSS, j_cm.XLA_INTERLEAVE_LOSS)


def test_plan_cache_hits_and_keys():
    cfg = t_reduced()
    e1 = t_pc.cached_cnn_plan(cfg, 2, chain_modules=True)
    assert t_pc.cached_cnn_plan(cfg, 2, chain_modules=True) is e1
    e2 = t_pc.cached_cnn_plan(cfg, 2, chain_modules=False)
    e3 = t_pc.cached_cnn_plan(cfg, 4, chain_modules=True)
    assert len({id(e1), id(e2), id(e3)}) == 3
    assert e1.plan.context["batch"] == 2 and e3.plan.context["batch"] == 4
    assert t_pc.stats() == {"hits": 1, "misses": 3, "entries": 3,
                            "hit_rate": 0.25, "evictions": 0,
                            "capacity": t_pc.CAPACITY}


def test_plan_cache_lru_eviction(monkeypatch):
    monkeypatch.setattr(t_pc, "CAPACITY", 2)
    cfg = t_reduced()
    first = t_pc.cached_cnn_plan(cfg, 1)
    t_pc.cached_cnn_plan(cfg, 2)
    t_pc.cached_cnn_plan(cfg, 4)
    s = t_pc.stats()
    assert s["entries"] == 2 and s["evictions"] == 1
    assert t_pc.cached_cnn_plan(cfg, 1) is not first   # re-lowered


@pytest.mark.parametrize("mode", ["stacked", "fused", "spatial", "xla"])
def test_run_plan_refuses_modes_it_does_not_port(mode):
    """A mode the port does not run raises, naming it; so does a stacked
    group whose ops have no binding with the GEMM views K9 needs, and a
    fused group without the GEMM and stream views K10 needs."""
    from repro_torch.core import plan as t_plan
    plan = t_plan.Plan([t_plan.ExecGroup(mode, ("a", "b"), {}, 0.0)])
    with pytest.raises(NotImplementedError, match=mode):
        t_plan.run_plan({}, {}, plan)


def test_run_modes_name_stacked():
    from repro_torch.core import plan as t_plan
    assert "stacked" in t_plan.RUN_MODES
    assert "fused" in t_plan.RUN_MODES
    assert set(t_plan.RUN_MODES) <= set(t_plan.MODES)
    assert not {"spatial", "xla"} & set(t_plan.RUN_MODES)


def _stacked_case(device):
    """Reduced googlenet's stacked plan (batch 2), random parameters and
    images on ``device``."""
    cfg = t_reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, fuse_pool=False)
    assert plan.mode_counts()["stacked"] == 2
    params = t_cnn.init_params(cfg, torch.Generator().manual_seed(4), device)
    x = torch.randn((2,) + cfg.img,
                    generator=torch.Generator().manual_seed(5)).to(device)
    return cfg, plan, params, x


def test_run_plan_stacked_group_takes_the_plain_version_on_the_cpu(
        monkeypatch):
    from repro_torch.kernels import branch_matmul as t_bmm
    from repro_torch.kernels import runtime as t_rt
    calls = []
    real = t_bmm.branch_matmul_ref
    monkeypatch.setattr(t_bmm, "branch_matmul_ref",
                        lambda *a: calls.append(a) or real(*a))
    t_rt.reset_launch_counts()
    cfg, plan, params, x = _stacked_case("cpu")
    got = t_cnn.forward_plan(params, cfg, x, plan)
    assert len(calls) == 2 and t_rt.KERNEL_LAUNCHES["branch_matmul"] == 0
    torch.testing.assert_close(got, t_cnn.forward(params, cfg, x),
                               rtol=1e-4, atol=1e-5)


def test_run_plan_stacked_group_does_not_fall_back_on_cuda(monkeypatch):
    """A tensor the wrappers see on a CUDA device goes to K9 or raises: it
    never reaches the plain version.  (Here the device check is told the
    CPU tensors are CUDA tensors; with no card the launch path raises.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_card.py "
                    "runs the stacked group on it")
    import types
    from repro_torch.kernels import branch_matmul as t_bmm
    from repro_torch.kernels import runtime as t_rt

    def refuse(*a):
        raise AssertionError("the plain version ran for a CUDA tensor")
    seen = []
    rt = types.SimpleNamespace(**vars(t_rt))
    rt.kernel_device = lambda name, ts: seen.append(name) or \
        torch.device("cuda")
    monkeypatch.setattr(t_bmm, "branch_matmul_ref", refuse)
    monkeypatch.setattr(t_bmm, "_rt", rt)
    cfg, plan, params, x = _stacked_case("cpu")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA") as info:
        t_cnn.forward_plan(params, cfg, x, plan)
    assert "plain version ran" not in str(info.value)
    assert seen == ["branch_matmul"]
