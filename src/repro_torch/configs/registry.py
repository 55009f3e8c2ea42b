"""Config registry of the port: ``get_config("<arch-id>")``.

Holds every architecture of the reference (the ``dense``, ``moe``, ``vlm``,
``encdec``, ``hybrid`` and ``ssm`` families); each entry mirrors the
reference config of the same name field for field."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, supported_shapes  # noqa: F401
from .command_r_35b import CONFIG as _commandr
from .gemma3_27b import CONFIG as _gemma3
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .llava_next_mistral_7b import CONFIG as _llava
from .moonshot_v1_16b_a3b import CONFIG as _moonshot
from .qwen3_14b import CONFIG as _qwen3
from .recurrentgemma_2b import CONFIG as _rgemma
from .tinyllama_1_1b import CONFIG as _tinyllama
from .whisper_small import CONFIG as _whisper
from .xlstm_350m import CONFIG as _xlstm

CONFIGS = {c.name: c for c in [_qwen3, _gemma3, _commandr, _tinyllama, _whisper, _moonshot,
                               _kimi, _rgemma, _llava, _xlstm]}

ARCH_IDS = tuple(sorted(CONFIGS))


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return CONFIGS[name]


def all_cells():
    """Every ``(arch, shape)`` cell, with each arch's supported shapes."""
    for name in ARCH_IDS:
        for shape_name in supported_shapes(CONFIGS[name]):
            yield name, shape_name
