"""The PyTorch port's language-model serving on the CPU against the JAX
reference: reduced granite-moe-1b-a400m's ``init_cache``, ``prefill``
and teacher-forced ``decode_step`` (through ``launch.steps``'
``make_prefill_step`` and ``make_decode_step``) with the bf16 and the f32
KV cache, and the serving command line end to end on ``--device cpu``
for reduced granite and reduced mamba2.

The model's weights are the reference's own (``params_from_jax``); the
tokens are made with numpy from a seed.  Tolerance: float32, max abs err
<= 1e-4 * max|ref| + 1e-6; a bf16 cache entry may also sit one bf16
spacing from the reference's (a value near a rounding boundary rounds to
the other neighbour), so with the bf16 cache each decode step starts from
the reference's cache (see ``tests/test_torch_ssm.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import transformer as j_tf
from repro_torch.configs import get_reduced
from repro_torch.kernels import runtime as t_rt
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as t_steps
from repro_torch.models import transformer as t_tf

torch.set_num_threads(2)
ARCH = "granite-moe-1b-a400m"
j_prefill = jax.jit(j_tf.prefill, static_argnums=(1,))
j_decode_step = jax.jit(j_tf.decode_step, static_argnums=(1,))


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
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref)
    ok = (err <= 1e-4 * float(np.abs(ref).max()) + 1e-6) \
        | (err <= np.abs(ref) * 2.0 ** -7)
    assert ok.all(), (what, float(err.max()), int((~ok).sum()))


@pytest.fixture(scope="module")
def granite():
    j_cfg, t_cfg = j_get_reduced(ARCH), get_reduced(ARCH)
    jp = j_tf.init_params(j_cfg, jax.random.PRNGKey(0))
    tp = t_tf.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return j_cfg, t_cfg, jp, tp


@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_granite_prefill_and_decode_equal_reference(granite, cache_dtype):
    """Prefill of 24 tokens into a 32-slot KV cache, then 8 decode steps
    fed fixed tokens: logits and the KV cache at every step."""
    j_cfg, t_cfg, jp, tp = granite
    rng = np.random.default_rng(6)
    b, s, gen = 2, 24, 8
    tok = rng.integers(0, j_cfg.vocab, (b, s))
    feed = rng.integers(0, j_cfg.vocab, (b, gen))
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jc = j_tf.init_cache(j_cfg, b, s + gen, dtype=jdt)
    tc = t_tf.init_cache(t_cfg, b, s + gen, dtype=tdt, device="cpu")
    assert len(tc) == 1 and set(tc[0]) == {"kv"}
    assert tuple(tc[0]["kv"].shape) == jc[0]["kv"].shape
    assert tc[0]["kv"].dtype == tdt
    close_kv = _close_bf16 if cache_dtype == "bfloat16" else _close
    prefill = t_steps.make_prefill_step(t_cfg)
    decode = t_steps.make_decode_step(t_cfg)
    lj, jc = j_prefill(jp, j_cfg, jnp.asarray(tok, jnp.int32), jc)
    lt, tc = prefill(tp, _t(tok), tc)
    assert tuple(lt.shape) == (b, j_cfg.vocab)
    for step in range(gen + 1):
        _close(lt, lj, f"logits, step {step}")
        close_kv(tc[0]["kv"], jc[0]["kv"].astype(jnp.float32),
                 f"kv, step {step}")
        if step == gen:
            break
        if cache_dtype == "bfloat16":
            tc = [{"kv": _t(np.asarray(jc[0]["kv"].astype(jnp.float32)))
                   .to(tdt)}]
        t = feed[:, step:step + 1]
        lj, jc = j_decode_step(jp, j_cfg, jc, jnp.asarray(t, jnp.int32),
                               jnp.int32(s + step))
        lt, tc = decode(tp, tc, _t(t), s + step)
        assert tuple(lt.shape) == (b, 1, j_cfg.vocab)
    # the slots past the last written position are still zero
    assert not tc[0]["kv"][:, :, :, s + gen:].any()
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


def test_kv_cache_step_leaves_the_old_cache_unchanged(granite):
    _, t_cfg, _, tp = granite
    tc = t_tf.init_cache(t_cfg, 1, 8, device="cpu")
    _, new = t_tf.prefill(tp, t_cfg, torch.tensor([[1, 2, 3]]), tc)
    assert not tc[0]["kv"].any()
    assert new[0]["kv"][:, :, :, :3].any() and not new[0]["kv"][:, :, :,
                                                                3:].any()


def test_attention_pallas_still_needs_k13_without_a_cache(granite):
    """Without a cache, ``impl="pallas"`` runs attention on K13 (its plain
    route on the CPU) and equals the reference's pallas forward; with a
    cache, attention stays on the plain path on every impl."""
    j_cfg, t_cfg, jp, tp = granite
    tok = np.random.default_rng(8).integers(0, j_cfg.vocab, (2, 40))
    lj, _ = j_tf.forward(jp, j_cfg, jnp.asarray(tok, jnp.int32),
                         impl="pallas")
    with torch.no_grad():
        lt, _ = t_tf.forward(tp, t_cfg, _t(tok), impl="pallas")
    _close(lt, lj, "pallas forward logits")
    # with a cache, attention takes the plain path on every impl, as in
    # the reference
    tc = t_tf.init_cache(t_cfg, 1, 8, device="cpu")
    got, _ = t_tf.prefill(tp, t_cfg, torch.tensor([[1, 2, 3]]), tc,
                          impl="pallas")
    want, _ = t_tf.prefill(tp, t_cfg, torch.tensor([[1, 2, 3]]), tc)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["mamba2-370m", ARCH])
def test_serve_cli_runs_reduced_lm_on_cpu(arch, capsys):
    assert t_serve.main(["--arch", arch, "--reduced", "--batch", "2",
                         "--prompt-len", "40", "--gen", "5", "--device",
                         "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill 40 tok in" in out and "4 decode steps at" in out
    assert "ms/tok (batch 2)" in out and "[serve] sample:" in out


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_serve_transformer_figures_on_cpu(impl):
    args = t_serve.parser().parse_args(
        ["--arch", "mamba2-370m", "--reduced", "--batch", "2",
         "--prompt-len", "40", "--gen", "4", "--device", "cpu"])
    m = t_serve._serve_transformer(args, impl=impl)
    assert m["tokens"].shape == (2, 4) and m["finite"]
    assert m["impl"] == impl and m["peak_gib"] is None
    assert m["prefill_ms"] > 0 and m["decode_ms_per_token"] > 0
    cfg = get_reduced("mamba2-370m")
    s = cfg.ssm
    assert m["cache_shapes"] == [{
        "ssm": (4, 2, s.n_heads, s.d_state, s.head_dim),
        "conv": (4, 2, s.conv_width - 1,
                 s.d_inner + 2 * s.n_groups * s.d_state)}]
    assert t_rt.KERNEL_LAUNCHES["ssd_chunked"] == 0


def test_lm_serving_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for arch in ("mamba2-370m", ARCH):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_serve.main(["--arch", arch, "--reduced", "--gen", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.init_cache(get_reduced(ARCH), 1, 4)


def test_chip_smoke_ssm_serving_check_in_miniature(monkeypatch, capsys):
    """``chip_smoke.py``'s phase-6b check run on the CPU at a reduced
    size: the pallas prefill (K14's plain route here) against plain, the
    chunk-8 and chunk-32 controls, and teacher-forced decode on bf16 and
    f32 caches; it must pass and print the controls' drift."""
    import importlib.util
    import sys
    from pathlib import Path
    monkeypatch.setattr(sys, "path", list(sys.path))
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_ssm", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(cs, "SSM_BATCH", 2)
    monkeypatch.setattr(cs, "SSM_PROMPT", 40)
    monkeypatch.setattr(cs, "SSM_GEN", 4)
    monkeypatch.setattr(cs, "SSM_CONTROL_CHUNKS", (8, 32))
    # a CPU tensor takes K14's plain route, which counts no launch
    monkeypatch.setattr(cs, "SSM_LAUNCHES",
                        {k: 0 for k in cs.SSM_LAUNCHES})
    cfg = get_reduced("mamba2-370m")
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)))
    cs.check_ssm_serving(cfg, params, tokens, torch.device("cpu"))
    out = capsys.readouterr().out
    for name in ("plain chunk 8", "plain chunk 32"):
        assert f"steps, {name} against plain" in out
        assert f"[ssm] {name} conv cache after prefill (bf16)" in out
    assert "the controls' most drift" in out
