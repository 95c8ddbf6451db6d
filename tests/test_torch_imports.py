"""The PyTorch port stands alone: no module of ``src/repro_torch`` and
not ``chip_smoke.py`` imports JAX or the JAX package, the entry points
refuse to run without the device they were asked for, and the chip smoke
script exits non-zero, printing no result, on a host without a card or
away from the repository."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_covers_the_serving_slice_modules():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    for mod in ("configs/googlenet.py", "core/graph.py",
                "core/cost_model.py", "core/selector.py",
                "core/scheduler.py", "core/plan.py", "core/plan_cache.py",
                "analysis/budgets.py", "kernels/grouped_matmul.py",
                "kernels/conv2d.py", "models/cnn.py", "models/layers.py",
                "launch/steps.py", "launch/serve.py",
                # the training slice
                "configs/base.py", "data/pipeline.py", "optim/adamw.py",
                "kernels/matmul.py", "kernels/ops.py", "launch/train.py",
                # the MoE language-model training slice
                "configs/granite_moe_1b_a400m.py", "models/attention.py",
                "models/moe.py", "models/transformer.py",
                # the serial and stacked baselines
                "kernels/branch_matmul.py",
                # mamba2 serving and LM serving with a cache
                "configs/mamba2_370m.py", "kernels/ssd.py",
                "models/mamba2.py",
                # the attention LMs' impl="pallas" forward on K13
                "kernels/flash_attention.py", "configs/llama3_8b.py",
                "configs/gemma2_27b.py", "configs/codeqwen1_5_7b.py",
                "configs/minitron_8b.py", "configs/qwen2_moe_a2_7b.py",
                # the fused plan mode on K10, ksplit on K8, K7
                "kernels/fused_branches.py"):
        assert mod in names
    csrc = {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob(
        "*.cu")}
    assert csrc == {"grouped_matmul.cu", "grouped_matmul_chained.cu",
                    "conv2d.cu", "matmul.cu", "grouped_matmul_bwd.cu",
                    "grouped_matmul_experts.cu",
                    "grouped_matmul_experts_bwd.cu", "branch_matmul.cu",
                    "ssd_chunk.cu", "flash_attention.cu",
                    "fused_branches.cu", "matmul_ksplit.cu"}
    from repro_torch.kernels import build
    assert set(build.SOURCES) == csrc
    # every header is in the build's content hash, so an edited header
    # rebuilds the library
    headers = {p.name for p in (ROOT / "src" / "repro_torch" / "csrc").glob(
        "*.cuh")}
    assert set(build.HEADERS) == headers == {"gemm_pipe.cuh", "moe_act.cuh",
                                             "mma_tf32.cuh"}


def test_entry_points_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs.googlenet import reduced
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_cnn_metrics(reduced(), num_requests=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "googlenet", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-370m", "--reduced"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.init_params(reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cnn.params_from_jax({"head": {}})
    from repro_torch.launch import steps, train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "googlenet", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.make_cnn_train_step(reduced(), steps.make_optimizer(reduced()))


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_away_from_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
