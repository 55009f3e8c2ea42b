"""The model API (port of ``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelBundle` whose members close over
the config. The port has the transformer families ``dense``, ``moe`` and
``vlm``:

* ``init(gen) -> params`` (drawn from a ``torch.Generator`` on its device)
* ``train_loss(params, batch) -> (loss, {"nll", "aux"})``
* ``prefill(params, batch) -> (cache, logits)`` (``batch["patch_embeds"]``
  goes ahead of ``batch["tokens"]`` for ``vlm``)
* ``decode_step(params, cache, token, pos) -> (cache, logits)``

The reference's ``encdec`` (whisper), ``hybrid`` (recurrentgemma) and
``ssm`` (xlstm) families are not ported yet and are refused by name.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from . import transformer

__all__ = ["ModelBundle", "get_model"]

_LATER = {"encdec": "whisper", "hybrid": "recurrentgemma", "ssm": "xlstm"}


@dataclasses.dataclass
class ModelBundle:
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable


def get_model(cfg) -> ModelBundle:
    if cfg.family in ("dense", "moe", "vlm"):
        return ModelBundle(init=partial(transformer.init_lm, cfg=cfg),
                           train_loss=partial(transformer.train_loss, cfg=cfg),
                           prefill=partial(transformer.prefill, cfg=cfg),
                           decode_step=partial(transformer.decode_step, cfg=cfg))
    if cfg.family in _LATER:
        raise ValueError(f"the port has no model of family {cfg.family!r} "
                         f"({_LATER[cfg.family]}) yet: the non-transformer families are "
                         f"ROADMAP queue 1 item 4")
    raise ValueError(f"the port has no model of family {cfg.family!r}")
