"""Config registry of the port: ``get_config("<arch-id>")``.

Holds the transformer architectures of the reference (the ``dense``,
``moe`` and ``vlm`` families); each entry mirrors the reference config of
the same name field for field."""
from __future__ import annotations

from .base import ModelConfig
from .command_r_35b import CONFIG as _commandr
from .gemma3_27b import CONFIG as _gemma3
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .llava_next_mistral_7b import CONFIG as _llava
from .moonshot_v1_16b_a3b import CONFIG as _moonshot
from .qwen3_14b import CONFIG as _qwen3
from .tinyllama_1_1b import CONFIG as _tinyllama

CONFIGS = {c.name: c for c in [_qwen3, _gemma3, _commandr, _tinyllama, _moonshot, _kimi,
                               _llava]}

ARCH_IDS = tuple(sorted(CONFIGS))


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return CONFIGS[name]
