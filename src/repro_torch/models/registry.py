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
* ``param_shapes()``, ``batch_specs(shape, kind)`` and
  ``input_specs(shape) -> (step_name, kwargs)``: the reference's dry-run
  stand-ins as tensors on the ``meta`` device (no allocation) — the
  parameters from ``init`` traced under a fake-tensor mode, decode's cache
  from ``prefill`` on the meta tensors.

Only the transformer families have the paged path the serving engine runs,
as in the reference.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, Tuple

import torch

from ..core.tree import tree_map
from . import recurrent, transformer, whisper, xlstm

__all__ = ["ModelBundle", "get_model", "on_meta"]

#: family → (module, its init)
_FAMILIES = {
    "dense": (transformer, transformer.init_lm),
    "moe": (transformer, transformer.init_lm),
    "vlm": (transformer, transformer.init_lm),
    "encdec": (whisper, whisper.init_whisper),
    "hybrid": (recurrent, recurrent.init_recurrent),
    "ssm": (xlstm, xlstm.init_xlstm),
}


def _meta(t):
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    if isinstance(t, int) and not isinstance(t, bool):  # a cache's host-int position
        return torch.empty((), dtype=torch.int32, device="meta")
    return t


def on_meta(node):
    """A tree's tensors (and host ints, as int32 scalars) as ``meta``
    tensors of their shapes and dtypes."""
    return tree_map(_meta, node)


def _act_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class ModelBundle:
    init: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    hidden: Callable
    cfg: Any = None

    def param_shapes(self):
        """``init``'s tree on the ``meta`` device (traced under a fake-tensor
        mode: nothing is drawn or allocated)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            params = self.init(torch.Generator())
        return on_meta(params)

    # ------------------------------------------------------------- specs
    def batch_specs(self, shape, kind: str) -> Dict[str, Any]:
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        tok = lambda bb, ss: torch.empty((bb, ss), dtype=torch.int32, device="meta")  # noqa: E731
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            p = cfg.num_patch_tokens
            s_text = max(s - p, 1)
            batch["tokens"] = tok(b, s_text)
            batch["patch_embeds"] = torch.empty((b, p, cfg.d_model), dtype=_act_dtype(cfg),
                                                device="meta")
            if kind == "train":
                batch["labels"] = tok(b, s_text)
        elif cfg.family == "encdec":
            batch["frames"] = torch.empty((b, cfg.encoder_seq, cfg.d_model),
                                          dtype=_act_dtype(cfg), device="meta")
            batch["tokens"] = tok(b, s)
            if kind == "train":
                batch["labels"] = tok(b, s)
        else:
            batch["tokens"] = tok(b, s)
            if kind == "train":
                batch["labels"] = tok(b, s)
        return batch

    def input_specs(self, shape) -> Tuple[str, Dict[str, Any]]:
        """``(step_name, kwargs of meta tensors)``; decode's cache is
        ``prefill``'s on the meta parameters and prompt, ``pos`` an int32
        scalar."""
        if shape.kind == "train":
            return "train", {"batch": self.batch_specs(shape, "train")}
        if shape.kind == "prefill":
            return "prefill", {"batch": self.batch_specs(shape, "prefill")}
        with torch.no_grad():
            cache, _ = self.prefill(self.param_shapes(), self.batch_specs(shape, "prefill"))
        token = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
        pos = torch.empty((), dtype=torch.int32, device="meta")
        return "decode", {"cache": on_meta(cache), "token": token, "pos": pos}


def get_model(cfg) -> ModelBundle:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mod, init = _FAMILIES[cfg.family]
    return ModelBundle(init=partial(init, cfg=cfg), train_loss=partial(mod.train_loss, cfg=cfg),
                       prefill=partial(mod.prefill, cfg=cfg),
                       decode_step=partial(mod.decode_step, cfg=cfg),
                       hidden=partial(mod.hidden, cfg=cfg), cfg=cfg)
