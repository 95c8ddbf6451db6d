"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Local+global alternating attention, logit softcaps [arXiv:2408.00118; hf]"""
import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    d_model=4608, n_layers=46, vocab=256000,
    n_heads=32, n_kv_heads=16, head_dim=128, d_ff=36864,
    # alternating sliding-window(4096) / global layers
    pattern=(BlockSpec(mixer="attn", mlp="dense", window=4096),
             BlockSpec(mixer="attn", mlp="dense", window=None)),
    rope_theta=10000.0, activation="gelu",
    attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, tie_embeddings=True, embed_scale=True,
    query_scale=(4608 // 32) ** -0.5,   # query_pre_attn_scalar = d/nh
    notes=("local/global alternate sequentially (not parallel branches): "
           "selection-only. long_500k skipped: global layers' full-attention "
           "KV at 512k exceeds per-chip HBM (DESIGN.md)."),
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="gemma2-27b-reduced", d_model=128, n_layers=4, vocab=512,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384,
        pattern=(BlockSpec(mixer="attn", mlp="dense", window=64),
                 BlockSpec(mixer="attn", mlp="dense", window=None)),
        query_scale=32 ** -0.5)
