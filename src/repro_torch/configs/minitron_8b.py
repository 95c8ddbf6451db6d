"""minitron-8b [dense] — 32L d4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
Pruned nemotron [arXiv:2407.14679; hf]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    d_model=4096, n_layers=32, vocab=256000,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=16384,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    rope_theta=10000.0, activation="silu", tie_embeddings=False,
    notes="linear topology: selection-only",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="minitron-8b-reduced", d_model=128, n_layers=4, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=320)
