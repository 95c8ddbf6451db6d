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


def test_run_plan_refuses_modes_it_does_not_port():
    from repro_torch.core import plan as t_plan
    plan = t_plan.Plan([t_plan.ExecGroup("stacked", ("a", "b"), {}, 0.0)])
    with pytest.raises(NotImplementedError, match="stacked"):
        t_plan.run_plan({}, {}, plan)
