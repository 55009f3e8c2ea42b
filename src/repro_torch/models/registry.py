"""The model API the serving oracle calls (port of ``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelBundle` whose members close over
the config. The port serves the transformer families ``dense``, ``moe``
and ``vlm``, so a bundle holds their dense-cache ``prefill`` and
``decode_step``:

* ``prefill(params, batch) -> (cache, logits)`` (``batch["patch_embeds"]``
  goes ahead of ``batch["tokens"]`` for ``vlm``)
* ``decode_step(params, cache, token, pos) -> (cache, logits)``
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from . import transformer

__all__ = ["ModelBundle", "get_model"]


@dataclasses.dataclass
class ModelBundle:
    prefill: Callable
    decode_step: Callable


def get_model(cfg) -> ModelBundle:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelBundle(prefill=partial(transformer.prefill, cfg=cfg),
                           decode_step=partial(transformer.decode_step, cfg=cfg))
    raise ValueError(f"the port has no model of family {cfg.family!r}")
