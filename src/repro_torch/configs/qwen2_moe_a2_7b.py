"""qwen2-moe-a2.7b [moe] — 24L d2048 16H (MHA kv=16) d_ff(expert)=1408
vocab=151936, MoE 60e top-4 + 4-expert-wide shared expert (5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig, MoESpec

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    d_model=2048, n_layers=24, vocab=151936,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408,
    pattern=(BlockSpec(mixer="attn", mlp="moe"),),
    moe=MoESpec(n_experts=60, top_k=4, d_expert=1408, shared_f=5632),
    rope_theta=1000000.0, qkv_bias=True, activation="silu",
    tie_embeddings=True,
    notes=("shared-vs-routed experts are a fork/join; 60 % 16 != 0 -> "
           "TP inside experts instead of EP (DESIGN.md §Arch-applicability)"),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="qwen2-moe-reduced", d_model=128, n_layers=4, vocab=512,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=64,
        moe=MoESpec(n_experts=8, top_k=2, d_expert=64, shared_f=128,
                    capacity_factor=4.0))
