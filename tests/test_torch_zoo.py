"""The rest of the algorithm zoo on the CPU against the JAX reference:
the ``ksplit`` GEMM (K8's plain version, what ``kernels.matmul``'s
wrappers take for CPU tensors) and the whole GEMM zoo through
``ops.matmul``, its split count and accounting; the grouped
backward-weight launch (K7's plain version) against the reference's
Pallas kernel in interpret mode; Winograd F(2x2, 3x3) and the rest of the
conv zoo through ``ops.conv2d``, the support matrix and the workspace,
and ``cnn.conv(algorithm="winograd3x3")``'s forward and gradients.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the reference's own kernel-test tolerances (GEMM zoo rtol =
atol = 2e-3, K7 1e-5, the conv zoo 2e-3 and Winograd 5e-3); the
differentiable conv rtol = atol = 1e-4.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.models import cnn as j_cnn
from repro_torch.kernels import conv2d as t_conv
from repro_torch.kernels import grouped_matmul as t_gmm
from repro_torch.kernels import matmul as t_mm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import cnn as t_cnn

j_mm = importlib.import_module("repro.kernels.matmul")

torch.set_num_threads(2)



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


_CS = _load_chip_smoke("_chip_smoke_zoo_cases")
# the cases K8 is held at on the card (``chip_smoke.KSPLIT_SHAPES``): the
# reference's GEMM zoo shapes (its tests/test_kernels_matmul.py) and a
# ragged K, (M, K, N)
SHAPES = _CS.KSPLIT_SHAPES
# the reference's conv zoo cases (its tests/test_kernels_conv.py):
# (n, h, w, c, kh, kw, k, stride, padding)
CONV_CASES = [
    (2, 16, 16, 32, 3, 3, 64, 1, "SAME"),
    (2, 15, 15, 16, 3, 3, 24, 1, "SAME"),
    (1, 16, 16, 8, 5, 5, 16, 1, "SAME"),
    (2, 16, 16, 8, 3, 3, 16, 2, "SAME"),
    (1, 14, 14, 8, 1, 1, 16, 1, "VALID"),
    (1, 16, 16, 8, 3, 3, 16, 1, "VALID"),
    (1, 28, 28, 192, 1, 1, 64, 1, "SAME"),
    (1, 8, 8, 4, 7, 7, 8, 2, "SAME"),
]
# the reference's ragged branch sets (its tests/test_grouped_matmul.py),
# the ones K7 is held at on the card (``chip_smoke.DW_SETS``)
RAGGED_SETS = _CS.DW_SETS


def _np(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.fixture(autouse=True)
def _fresh_counters():
    t_rt.reset_launch_counts()
    yield
    t_rt.reset_launch_counts()


# ---------------------------------------------------------------------------
# the GEMM zoo: ksplit (K8) and the accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["mxu128", "large_tile", "ksplit"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_zoo_equals_reference(shape, alg):
    m, k, n = shape
    rng = np.random.default_rng(m * k + n)
    x, y = _np(rng, m, k), _np(rng, k, n)
    want = j_ops.matmul(jnp.asarray(x), jnp.asarray(y), algorithm=alg)
    got = t_ops.matmul(_t(x), _t(y), algorithm=alg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


@pytest.mark.parametrize("k", [1, 100, 128, 129, 200, 384, 640, 1024, 1152,
                               100352])
def test_ksplit_split_count_equals_reference(k, monkeypatch):
    """The split count the reference's ``_alg_ksplit`` hands its kernel:
    the largest count up to 4 dividing ceil(K/128)."""
    seen = []
    monkeypatch.setattr(j_mm, "matmul_ksplit",
                        lambda x, y, **kw: seen.append(kw["splits"]))
    j_mm._alg_ksplit(jnp.zeros((128, -(-k // 128) * 128)), None)
    assert t_mm.ksplit_splits(k) == seen[0]
    kper = t_mm._ksplit_depth(k, seen[0])
    assert kper % 128 == 0 and (seen[0] - 1) * kper < k <= seen[0] * kper


@pytest.mark.parametrize("k", [200, 640, 1000])
def test_ksplit_ref_sums_split_partials_of_transposed_operands(k):
    """K8's plain version on the layouts K8 reads in place (row-major and
    transposed views, as the dW GEMMs hand it) with ragged K: the split
    partials sum to x @ y."""
    rng = np.random.default_rng(k)
    xt, y = _t(_np(rng, k, 48)), _t(_np(rng, 70, k))
    got = t_mm.matmul(xt.t(), y.t(), algorithm="ksplit")
    torch.testing.assert_close(got, xt.t() @ y.t(), rtol=1e-5, atol=1e-4)
    assert t_rt.KERNEL_LAUNCHES["matmul_ksplit"] == 0


@pytest.mark.parametrize("alg", ["mxu128", "large_tile", "ksplit"])
def test_matmul_accounting_equals_reference(alg):
    assert t_mm.matmul_block_shape(alg) == j_mm.matmul_block_shape(alg)
    for bpe in (2, 4):
        assert t_ops.matmul_vmem_bytes(alg, bpe) == \
            j_ops.matmul_vmem_bytes(alg, bpe)
    for m, n, k in SHAPES + [(576, 192, 100352)]:
        for splits in (1, 2, 4):
            assert t_ops.matmul_workspace_bytes(alg, m, n, k, splits) == \
                j_ops.matmul_workspace_bytes(alg, m, n, k, splits)
    assert tuple(t_ops.MATMUL_ALGORITHMS) == tuple(j_ops.MATMUL_ALGORITHMS)


@pytest.mark.parametrize("lead", [(15,), (3, 5)])
def test_ops_matmul_folds_leading_dimensions(lead):
    rng = np.random.default_rng(len(lead))
    x, y = _np(rng, *lead, 96, 130), _np(rng, 130, 40)
    got = t_ops.matmul(_t(x), _t(y), algorithm="ksplit")
    want = jnp.einsum("...mk,kn->...mn", jnp.asarray(x), jnp.asarray(y))
    assert got.shape == (*lead, 96, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)


def test_matmul_rejects_unknown_algorithm():
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_mm.matmul(torch.ones(2, 2), torch.ones(2, 2), algorithm="fft")


# ---------------------------------------------------------------------------
# the grouped backward-weight launch (K7)
# ---------------------------------------------------------------------------

def _dw_case(shapes, m=77):
    rng = np.random.default_rng(len(shapes) * 13 + shapes[0][0])
    xs = [_np(rng, m, k, scale=0.3) for k, _ in shapes]
    dys = [_np(rng, m, n) for _, n in shapes]
    ys = [_np(rng, m, n) for _, n in shapes]
    return xs, dys, ys


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shapes", RAGGED_SETS,
                         ids=lambda s: "-".join(f"{k}x{n}" for k, n in s))
def test_grouped_matmul_dw_ref_equals_reference_kernel(shapes, masked):
    xs, dys, ys = _dw_case(shapes)
    j = lambda a: [jnp.asarray(v) for v in a]
    wdw, wdb = j_ops.grouped_matmul_dw(j(xs), j(dys),
                                       j(ys) if masked else None,
                                       interpret=True)
    gdw, gdb = t_ops.grouped_matmul_dw([_t(v) for v in xs],
                                       [_t(v) for v in dys],
                                       [_t(v) for v in ys] if masked
                                       else None)
    for a, b, (k, n) in zip(gdw, wdw, shapes):
        assert a.shape == (k, n) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    for a, b, (_, n) in zip(gdb, wdb, shapes):
        assert a.shape == (n,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    assert t_rt.KERNEL_LAUNCHES["grouped_matmul_dw"] == 0


def test_grouped_matmul_dw_ref_equals_k5_dw_db_on_column_slices():
    """K7's plain version on the operands K5 takes on the training path
    (cotangents and masks that are column slices of one joint buffer,
    read in place, a NaN in the mask) equals K5's dw and db."""
    shapes = RAGGED_SETS[1]
    xs, _, _ = _dw_case(shapes)
    rng = np.random.default_rng(9)
    total = sum(n for _, n in shapes)
    g, y = _t(_np(rng, 77, total)), _t(np.maximum(_np(rng, 77, total), 0))
    y[3, 5] = float("nan")
    offs = np.cumsum([0] + [n for _, n in shapes])
    dys = [g[:, o:o + n] for o, (_, n) in zip(offs, shapes)]
    mask = [y[:, o:o + n] for o, (_, n) in zip(offs, shapes)]
    ws = [_t(_np(rng, k, n)) for k, n in shapes]
    txs = [_t(v) for v in xs]
    dws, dbs = t_gmm.grouped_matmul_dw(txs, dys, mask)
    _, dws5, dbs5 = t_gmm.grouped_matmul_bwd(txs, ws, dys, mask)
    for a, b in zip(dws + dbs, dws5 + dbs5):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_chip_smoke_zoo_cases_in_miniature(monkeypatch, capsys):
    """``chip_smoke.py``'s untimed K8 and K7 checks at their case lists,
    on the CPU (the plain routes here, so no launch is expected)."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    _CS.check_zoo_cases(torch.device("cpu"))
    out = capsys.readouterr().out
    assert out.count("matmul_ksplit case") == 2 * len(_CS.KSPLIT_SHAPES)
    assert out.count("against K5") == 2 * len(_CS.DW_SETS)
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


def test_grouped_matmul_dw_rejects_mismatched_branches():
    with pytest.raises(ValueError, match="grouped_matmul_dw"):
        t_gmm.grouped_matmul_dw([torch.ones(4, 3)], [torch.ones(5, 2)])
    with pytest.raises(ValueError, match="at most 8"):
        t_gmm.grouped_matmul_dw([torch.ones(4, 3)] * 9,
                                [torch.ones(4, 2)] * 9)


# ---------------------------------------------------------------------------
# the conv zoo: Winograd F(2x2, 3x3) on K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["im2col_gemm", "direct", "winograd3x3"])
@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_conv2d_zoo_equals_reference(case, alg):
    """Every algorithm against the reference's at its conv cases; where
    the support matrix says no (Winograd off 3x3 stride 1), both the
    support matrices agree and the port raises."""
    n, h, w, c, kh, kw, k, s, pad = case
    supported = t_ops.conv2d_supported(alg, kh, kw, s)
    assert supported == j_ops.conv2d_supported(alg, kh, kw, s)
    rng = np.random.default_rng(h * 100 + c + kh)
    x, wgt = _np(rng, n, h, w, c), _np(rng, kh, kw, c, k, scale=0.1)
    if not supported:
        with pytest.raises(ValueError, match="3x3 filter at stride 1"):
            t_ops.conv2d(_t(x), _t(wgt), stride=s, padding=pad,
                         algorithm=alg)
        return
    want = j_ops.conv2d(jnp.asarray(x), jnp.asarray(wgt), stride=s,
                        padding=pad, algorithm=alg)
    got = t_ops.conv2d(_t(x), _t(wgt), stride=s, padding=pad, algorithm=alg)
    tol = 5e-3 if alg == "winograd3x3" else 2e-3
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    assert sum(t_rt.KERNEL_LAUNCHES.values()) == 0


@pytest.mark.parametrize("alg", ["im2col_gemm", "direct", "winograd3x3"])
def test_conv2d_workspace_equals_reference(alg):
    assert tuple(t_ops.CONV2D_ALGORITHMS) == tuple(j_ops.CONV2D_ALGORITHMS)
    for case in CONV_CASES + [(32, 28, 28, 256, 3, 3, 128, 1, "SAME")]:
        n, h, w, c, kh, kw, k, s, pad = case
        xs, ws = (n, h, w, c), (kh, kw, c, k)
        for bpe in (2, 4):
            assert t_ops.conv2d_workspace_bytes(alg, xs, ws, s, pad, bpe) \
                == j_ops.conv2d_workspace_bytes(alg, xs, ws, s, pad, bpe)


def test_winograd_is_one_branch_matmul_call(monkeypatch):
    """The 16 transform-domain GEMMs are one K9 call, (16, T, C) @ (16,
    C, K) with T = N * ceil(OH/2) * ceil(OW/2), unpadded."""
    from repro_torch.kernels import branch_matmul as t_bmm
    calls = []
    real = t_bmm.branch_matmul
    monkeypatch.setattr(t_bmm, "branch_matmul",
                        lambda x, y: calls.append((x.shape, y.shape))
                        or real(x, y))
    rng = np.random.default_rng(0)
    t_conv.conv2d_winograd3x3(_t(_np(rng, 2, 15, 15, 16)),
                              _t(_np(rng, 3, 3, 16, 24)))
    assert calls == [((16, 2 * 8 * 8, 16), (16, 16, 24))]


@pytest.mark.parametrize("case", [(2, 15, 15, 16, 24), (1, 28, 28, 96, 128)],
                         ids=lambda c: "x".join(map(str, c)))
def test_cnn_conv_winograd_forward_and_gradients_equal_reference(case):
    n, h, w, c, k = case
    rng = np.random.default_rng(n + h + c)
    x, wgt, b = _np(rng, n, h, w, c), _np(rng, 3, 3, c, k, scale=0.1), \
        _np(rng, k, scale=0.1)
    dy = _np(rng, n, h, w, k)
    wy, vjp = jax.vjp(lambda a, ww, bb: j_cnn.conv(a, ww, bb,
                                                   algorithm="winograd3x3"),
                      jnp.asarray(x), jnp.asarray(wgt), jnp.asarray(b))
    wdx, wdw, wdb = vjp(jnp.asarray(dy))
    tx, tw, tb = _t(x, True), _t(wgt, True), _t(b, True)
    ty = t_cnn.conv(tx, tw, tb, algorithm="winograd3x3")
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(wy),
                               rtol=1e-4, atol=1e-4)
    gdx, gdw, gdb = torch.autograd.grad(ty, (tx, tw, tb), _t(dy))
    for got, want in ((gdx, wdx), (gdw, wdw), (gdb, wdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_cnn_conv_rejects_winograd_off_3x3_and_unknown_algorithms():
    with pytest.raises(ValueError, match="3x3 filter at stride 1"):
        t_cnn.conv(torch.ones(1, 8, 8, 4), torch.ones(3, 3, 4, 2),
                   torch.zeros(2), stride=2, algorithm="winograd3x3")
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_cnn.conv(torch.ones(1, 8, 8, 4), torch.ones(3, 3, 4, 2),
                   torch.zeros(2), algorithm="fft")
