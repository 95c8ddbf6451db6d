"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) d_ff(expert)=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    d_model=1024, n_layers=24, vocab=49155,
    n_heads=16, n_kv_heads=8, head_dim=64, d_ff=512,
    pattern=(BlockSpec(mixer="attn", mlp="moe"),),
    moe=MoESpec(n_experts=32, top_k=8, d_expert=512),
    rope_theta=10000.0, activation="silu", tie_embeddings=True,
    notes="experts = branches: full branch-parallel EP (32e | 16-way axis)",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="granite-moe-reduced", d_model=128, n_layers=4, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=64,
        moe=MoESpec(n_experts=8, top_k=2, d_expert=64, capacity_factor=4.0))
