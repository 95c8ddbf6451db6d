from repro_torch.data.pipeline import Pipeline, SyntheticImages  # noqa: F401
