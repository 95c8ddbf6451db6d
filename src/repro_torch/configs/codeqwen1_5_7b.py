"""codeqwen1.5-7b [dense] — 32L d4096 32H (MHA kv=32) d_ff=13440 vocab=92416.
[hf:Qwen/CodeQwen1.5-7B; hf]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    d_model=4096, n_layers=32, vocab=92416,
    n_heads=32, n_kv_heads=32, head_dim=128, d_ff=13440,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    rope_theta=1000000.0, qkv_bias=True, activation="silu",
    tie_embeddings=True,
    notes="qwen1.5 arch (qkv bias); linear topology: selection-only",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="codeqwen1.5-7b-reduced", d_model=128, n_layers=4,
        vocab=512, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256)
