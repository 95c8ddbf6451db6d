from repro_torch.optim.adamw import (  # noqa: F401
    AdamW, clip_by_global_norm, cosine_schedule, tree_leaves, tree_map)
