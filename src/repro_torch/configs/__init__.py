"""Architecture registry: ``get_config(arch)`` / ``--arch <id>``.

The port serves the paper's native CNN only; the reference's language
and MoE configs arrive with the slices that port their models.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import CNNConfig, InceptionSpec  # noqa: F401

ARCHS = ("googlenet",)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch)
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> CNNConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> CNNConfig:
    return _module(arch).reduced()
