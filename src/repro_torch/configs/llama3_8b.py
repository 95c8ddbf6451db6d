"""llama3-8b [dense] — 32L d4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[arXiv:2407.21783; unverified]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    d_model=4096, n_layers=32, vocab=128256,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
    pattern=(BlockSpec(mixer="attn", mlp="dense"),),
    rope_theta=500000.0, activation="silu", tie_embeddings=False,
    notes="linear topology: selection-only (DESIGN.md §Arch-applicability)",
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="llama3-8b-reduced", d_model=128, n_layers=4, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256)
