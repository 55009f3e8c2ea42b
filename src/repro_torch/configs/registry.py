"""Config registry of the port: ``get_config("<arch-id>")``.

Holds the architectures the port serves so far; each entry mirrors the
reference config of the same name field for field."""
from __future__ import annotations

from .base import ModelConfig
from .moonshot_v1_16b_a3b import CONFIG as _moonshot

CONFIGS = {c.name: c for c in [_moonshot]}

ARCH_IDS = tuple(sorted(CONFIGS))


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return CONFIGS[name]
