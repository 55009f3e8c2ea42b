"""The model API (port of ``repro/models/registry.py``).

``get_model(cfg)`` returns a :class:`ModelBundle` whose members close over
the config, for every family of the reference — the transformer families
``dense``, ``moe`` and ``vlm``, ``encdec`` (whisper), ``hybrid``
(recurrentgemma) and ``ssm`` (xlstm):

* ``init(gen) -> params`` (drawn from a ``torch.Generator`` on its device)
* ``train_loss(params, batch) -> (loss, metrics)``
* ``prefill(params, batch) -> (cache, logits)`` (``batch["patch_embeds"]``
  goes ahead of ``batch["tokens"]`` for ``vlm``; ``batch["frames"]`` is
  the encoder's input for ``encdec``)
* ``decode_step(params, cache, token, pos) -> (cache, logits)``
* ``hidden(params, batch) -> [B, S, D]``, the states after the final norm
  at ``batch["tokens"]``'s positions, that ``train_loss`` and ``prefill``
  turn into logits

Only the transformer families have the paged path the serving engine runs,
as in the reference.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

from . import recurrent, transformer, whisper, xlstm

__all__ = ["ModelBundle", "get_model"]

#: family → (module, its init)
_FAMILIES = {
    "dense": (transformer, transformer.init_lm),
    "moe": (transformer, transformer.init_lm),
    "vlm": (transformer, transformer.init_lm),
    "encdec": (whisper, whisper.init_whisper),
    "hybrid": (recurrent, recurrent.init_recurrent),
    "ssm": (xlstm, xlstm.init_xlstm),
}


@dataclasses.dataclass
class ModelBundle:
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    hidden: Callable


def get_model(cfg) -> ModelBundle:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mod, init = _FAMILIES[cfg.family]
    return ModelBundle(init=partial(init, cfg=cfg), train_loss=partial(mod.train_loss, cfg=cfg),
                       prefill=partial(mod.prefill, cfg=cfg),
                       decode_step=partial(mod.decode_step, cfg=cfg),
                       hidden=partial(mod.hidden, cfg=cfg))
