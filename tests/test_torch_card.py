"""The port's planned GoogLeNet paths on the card: the serial and the
stacked baseline plans launch their kernels (K3/K4, and K9 for the
stacked groups) through ``run_plan`` and agree with the plain forward.

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a host
without them; there, skip ``tests/conftest.py`` (it imports JAX):

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card.py

Tolerance: logits within rtol 1e-3, atol 1e-5 of the plain forward (f32
kernels against cuDNN's f32 convolutions, TF32 off).
"""
import pytest
import torch

from repro_torch.configs.googlenet import reduced
from repro_torch.kernels import runtime as t_rt
from repro_torch.models import cnn as t_cnn

# plan_cnn keywords and the kernels each plan's forward must launch
PLANS = {"serial": ({"concurrent": False}, ("conv2d_direct", "matmul")),
         "stacked": ({"fuse_pool": False}, ("branch_matmul",))}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PLANS))
def test_baseline_plan_launches_its_kernels_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw, kernels = PLANS[name]
    cfg = reduced()
    plan, _ = t_cnn.plan_cnn(cfg, 2, train=True, **kw)
    params = t_cnn.init_params(cfg, torch.Generator().manual_seed(4), "cuda")
    x = torch.randn((2,) + cfg.img,
                    generator=torch.Generator().manual_seed(5)).cuda()
    t_rt.reset_launch_counts()
    with torch.no_grad():
        got = t_cnn.forward_plan(params, cfg, x, plan)
        want = t_cnn.forward(params, cfg, x)
    torch.cuda.synchronize()
    for k in kernels:
        assert t_rt.KERNEL_LAUNCHES[k] > 0, (k, t_rt.KERNEL_LAUNCHES)
    if name == "stacked":
        assert t_rt.KERNEL_LAUNCHES["branch_matmul"] == \
            len(plan.groups_of_mode("stacked"))
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-5)
