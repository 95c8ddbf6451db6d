"""The PyTorch port's attention algorithms on the CPU against the JAX
reference: the flash-attention kernel's plain version (the route a CPU
tensor takes through K13's wrapper) against the reference's Pallas
kernel in interpret mode and its materialized algorithm, at every case
of the reference's own kernel tests and at the three more the card holds
K13 at (``chip_smoke.FLASH_CASES``: a window-plus-softcap case with GQA,
more queries than keys, a non-causal window); ``ops.attention`` with both algorithms; ``attn_apply`` with
``impl="pallas"`` and no cache; and what the wrapper refuses.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: float32, rtol 1e-5 and atol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as j_ops
from repro.models import attention as j_attn
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import attention as t_attn

torch.set_num_threads(2)
# torch's CPU exp and tanh (MKL VML) can come out at reduced accuracy on
# their first multi-threaded call in a process; make that call here, on
# a tensor large enough to be split across the threads
torch.exp(torch.tanh(torch.zeros(1 << 18)))
TOL = dict(rtol=1e-5, atol=1e-5)



def _load_chip_smoke(name):
    """The repository's ``chip_smoke.py`` as a module, ``sys.path`` left
    as it was (its import puts ``src/`` first)."""
    import importlib.util
    import sys
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location(name, path)
    cs = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(cs)
    finally:
        sys.path[:] = saved
    return cs


# the cases K13 is held at on the card (``chip_smoke.FLASH_CASES``): the
# reference's kernel-test cases, then a sliding window with a softcap,
# two batches and GQA group 4 at a sequence that is no multiple of a
# tile, more queries than keys, and a non-causal window;
# (b, sq, skv, hq, hkv, d, causal, window, softcap)
CASES = _load_chip_smoke("_chip_smoke_cases").FLASH_CASES
WINDOW_SOFTCAP_CASE = (2, 300, 300, 8, 2, 32, True, 64, 50.0)
assert WINDOW_SOFTCAP_CASE in CASES


@pytest.fixture(autouse=True)
def _fresh_counters():
    yield
    t_rt.reset_launch_counts()


def _qkv(case, seed=0):
    b, sq, skv, hq, hkv, d = case[:6]
    rng = np.random.default_rng(seed + sum(case[:6]))
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return f(b, sq, hq, d), f(b, skv, hkv, d), f(b, skv, hkv, d)


def _kw(case):
    return dict(causal=case[6], window=case[7], softcap=case[8])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_flash_attention_equals_reference_kernel(case):
    q, k, v = _qkv(case)
    got = t_fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               **_kw(case))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert t_rt.KERNEL_LAUNCHES["flash_attention"] == 0   # the CPU route
    # a row that sees no key (more queries than keys) is 0 in the port,
    # as the reference documents; its flash kernel, starting the running
    # max at -1e30, gives such a row the mean of v there instead, and its
    # materialized algorithm no value: both are held on the other rows
    live = t_fa._masks(case[1], case[2], case[6], case[7], "cpu").any(-1)
    live = live.numpy()
    assert not got.numpy()[:, ~live].any()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = np.asarray(j_fa.flash_attention(jq, jk, jv, interpret=True,
                                           **_kw(case)))
    np.testing.assert_allclose(got.numpy()[:, live], want[:, live], **TOL)
    mat = np.asarray(j_fa.attention_materialized(jq, jk, jv, **_kw(case)))
    np.testing.assert_allclose(got.numpy()[:, live], mat[:, live], **TOL)
    port_mat = t_fa.attention_materialized(
        *map(torch.from_numpy, (q, k, v)), **_kw(case))
    np.testing.assert_allclose(port_mat.numpy()[:, live], mat[:, live],
                               **TOL)


@pytest.mark.parametrize("alg", ["flash", "materialized"])
def test_ops_attention_algorithms_equal_reference(alg):
    case = WINDOW_SOFTCAP_CASE
    q, k, v = _qkv(case, seed=1)
    kw = dict(_kw(case), scale=0.07)
    got = t_ops.attention(*map(torch.from_numpy, (q, k, v)), algorithm=alg,
                          **kw)
    want = j_ops.attention(*map(jnp.asarray, (q, k, v)), algorithm=alg,
                           interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tuple(t_fa.ATTENTION_ALGORITHMS) == j_ops.ATTENTION_ALGORITHMS
    for args in ((alg, 1, 128, 1024, 8), (alg, 2, 300, 300, 32)):
        assert t_ops.attention_workspace_bytes(*args) == \
            j_ops.attention_workspace_bytes(*args)
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_ops.attention(*map(torch.from_numpy, (q, k, v)), algorithm="fft")


def _attn_params(rng, d, hq, hkv, hd, bias):
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(
        np.float32)
    sd, so = d ** -0.5, (hq * hd) ** -0.5
    p = {"wq": f(d, hq * hd, scale=sd), "wk": f(d, hkv * hd, scale=sd),
         "wv": f(d, hkv * hd, scale=sd), "wo": f(hq * hd, d, scale=so)}
    if bias:
        p.update(bq=f(hq * hd), bk=f(hkv * hd), bv=f(hkv * hd))
    return p


@pytest.mark.parametrize("window,softcap,bias", [(None, None, False),
                                                 (48, 50.0, True)])
def test_attn_apply_pallas_without_a_cache_equals_reference(window, softcap,
                                                            bias):
    rng = np.random.default_rng(5)
    d, hq, hkv, hd = 32, 8, 2, 16
    p = _attn_params(rng, d, hq, hkv, hd, bias)
    x = rng.normal(size=(2, 130, d)).astype(np.float32)
    kw = dict(hq=hq, hkv=hkv, hd=hd, rope_theta=10000.0, window=window,
              softcap=softcap, query_scale=0.2, impl="pallas")
    got, cache = t_attn.attn_apply({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x), **kw)
    want, _ = j_attn.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), **kw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_refuses_a_gradient_and_a_wide_head():
    q, k, v = map(torch.from_numpy, _qkv((1, 8, 8, 2, 1, 16)))
    with pytest.raises(NotImplementedError, match="K13 has no backward"):
        t_fa.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():   # no gradient to take: the forward runs
        assert t_fa.flash_attention(q, k, v).shape == q.shape
    q = q.detach()
    wide = torch.zeros((1, 4, 2, t_fa.MAX_HEAD_DIM + 8))
    with pytest.raises(ValueError, match="head dim"):
        t_fa.flash_attention(wide, wide[:, :, :1], wide[:, :, :1])
    with pytest.raises(ValueError, match="window"):
        t_fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="flash_attention"):
        t_fa.flash_attention(q, k[:, :, :, :8], v)
    with pytest.raises(TypeError, match="float32"):
        t_fa.flash_attention(q.double(), k.double(), v.double())
    # through the model layer: a weight that needs a gradient
    rng = np.random.default_rng(2)
    p = {kk: torch.from_numpy(vv).requires_grad_()
         for kk, vv in _attn_params(rng, 16, 2, 1, 8, False).items()}
    with pytest.raises(NotImplementedError, match="K13"):
        t_attn.attn_apply(p, torch.zeros((1, 4, 16)), hq=2, hkv=1, hd=8,
                          impl="pallas")


def test_flash_attention_row_that_sees_no_key_is_zero():
    """More queries than keys, causal: the first Sq - Skv queries sit
    before every key and come out as 0, as K13 defines it; the others
    hold the materialized softmax."""
    q, k, v = map(torch.from_numpy, _qkv((1, 12, 8, 4, 2, 16)))
    got = t_fa.flash_attention(q, k, v)
    assert not got[:, :4].any()
    want = t_fa.attention_materialized(q, k, v)
    torch.testing.assert_close(got[:, 4:], want[:, 4:], **TOL)


def _chip_smoke(monkeypatch):
    cs = _load_chip_smoke("_chip_smoke_attn")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    return cs


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_chip_smoke_attention_checks_in_miniature(arch, monkeypatch,
                                                  capsys):
    """``chip_smoke.py``'s K13 capture and phase-4b check on the CPU at
    a reduced size (K13's plain route here, so no launch is expected),
    and its yardstick and work counts on the captured calls: the SDPA
    yardstick computes the plain version's function where there is no
    softcap, and the FLOPs count the visible (query, key) pairs."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps as t_steps
    from repro_torch.models import transformer as t_tf
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "ATTN_REPS", 1)
    cfg = get_reduced(arch)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = t_steps.to_device_batch(
        SyntheticLM(cfg.vocab, 100, 2, seed=0).batch_at(0), "cpu")
    calls = cs.capture_flash_calls(params, cfg, batch["tokens"])
    assert cs.check_attention_lm(cfg, params, batch, torch.device("cpu"),
                                 0) == (0, None)
    out = capsys.readouterr().out
    assert f"[attn-lm] {cfg.name}: pallas against xla logits" in out
    assert out.count(f"[attn-lm] {cfg.name} impl ") == 2
    windows = []
    for label, a, kw in calls["flash_attention"]:
        assert label == cfg.name.split()[0]
        q, k, _ = a
        mask = t_fa._masks(q.shape[1], k.shape[1], kw["causal"],
                           kw["window"], q.device)
        flops, byts = cs.work_of("flash_attention", a, kw)
        assert flops == 4.0 * q.shape[0] * q.shape[2] * q.shape[3] * \
            int(mask.sum())
        assert byts == 4.0 * (2 * q.numel() + 2 * k.numel())
        lib = cs.library_call("flash_attention", a, kw)
        if kw["softcap"] is None:
            torch.testing.assert_close(lib().transpose(1, 2),
                                       t_fa.flash_attention_ref(*a, **kw),
                                       **TOL)
        else:
            assert lib is None
        windows.append(kw["window"])
    assert windows == [s.window for s in cfg.pattern] * (
        cfg.n_layers // len(cfg.pattern))


def test_chip_smoke_visible_pairs_and_yardstick_at_the_cases(monkeypatch):
    cs = _chip_smoke(monkeypatch)
    for case in cs.FLASH_CASES:
        b, sq, skv, hq, hkv, d, causal, window, softcap = case
        mask = t_fa._masks(sq, skv, causal, window, "cpu")
        assert cs.visible_pairs(sq, skv, causal, window) == int(mask.sum())
        if softcap is None:
            q, k, v = map(torch.from_numpy, _qkv(case))
            kw = dict(causal=causal, window=window, softcap=None,
                      scale=0.1)
            got = cs.library_call("flash_attention", (q, k, v), kw)()
            want = t_fa.flash_attention_ref(q, k, v, **kw)
            live = mask.any(-1)      # SDPA gives NaN where no key is seen
            torch.testing.assert_close(got.transpose(1, 2)[:, live],
                                       want[:, live], **TOL)
