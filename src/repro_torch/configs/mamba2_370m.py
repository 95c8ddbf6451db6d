"""mamba2-370m [ssm] — 48L d1024 attention-free, ssm_state=128 vocab=50280.
SSD (state-space duality) [arXiv:2405.21060; unverified]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig, SSMSpec

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    d_model=1024, n_layers=48, vocab=50280,
    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
    pattern=(BlockSpec(mixer="mamba", mlp="none"),),
    ssm=SSMSpec(d_inner=2048, n_heads=32, head_dim=64, d_state=128,
                n_groups=1),
    rope_theta=None, activation="silu", tie_embeddings=True,
    sub_quadratic=True,   # SSM: runs long_500k
    notes=("attention-free: branch-parallelism inapplicable to topology "
           "(linear chain); algorithm selection applies to the SSD mixer "
           "(chunked vs quadratic) — DESIGN.md §Arch-applicability"),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="mamba2-reduced", d_model=128, n_layers=4, vocab=512,
        ssm=SSMSpec(d_inner=256, n_heads=8, head_dim=32, d_state=32,
                    n_groups=1, chunk=32))
