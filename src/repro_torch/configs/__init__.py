"""Architecture registry: ``get_config(arch)`` / ``--arch <id>``.

The port has the paper's native CNN, granite-moe-1b-a400m and
qwen2-moe-a2.7b (MoE language models; granite's experts run on the
grouped expert kernels), the dense attention LMs llama3-8b,
codeqwen1.5-7b, minitron-8b and gemma2-27b (whose ``impl="pallas"``
forward runs the flash-attention kernel) and mamba2-370m (the SSM whose
prefill runs the SSD chunk kernel).  The reference's other
architectures are known by name and raise ``NotImplementedError``
saying what they wait for.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    BlockSpec, CNNConfig, InceptionSpec, ModelConfig, MoESpec, SSMSpec,
    TrainConfig)

ARCHS = ("granite_moe_1b_a400m", "qwen2_moe_a2_7b", "codeqwen1_5_7b",
         "minitron_8b", "llama3_8b", "gemma2_27b", "mamba2_370m",
         "googlenet")

#: The reference's architectures the port has no config for yet.
NOT_PORTED = {
    "jamba_1_5_large_398b": "its config is not ported yet",
    "internvl2_1b": "its patch frontend is not ported yet",
    "whisper_tiny": "its encoder and cross-attention are not ported yet",
}

_ALIASES = {a.replace("_", "-"): a for a in ARCHS + tuple(NOT_PORTED)}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch in NOT_PORTED:
        raise NotImplementedError(f"arch {arch!r}: {NOT_PORTED[arch]}")
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig | CNNConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig | CNNConfig:
    return _module(arch).reduced()
