"""Training launcher of the port (``repro/launch/train.py`` on one device):
train a reduced config on the synthetic corpus with checkpoint/restart and
straggler monitoring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 20 --device cpu

:func:`train_step` is the one step (loss, gradients, ``warmup_cosine``,
``adamw_update``) that :func:`train_reduced`, the examples and
``chip_smoke.py``'s full-width training all run. ``--coordinator
HOST:PORT`` joins a multi-process job first, as the reference's joins
``jax.distributed``: ``torch.distributed.init_process_group`` at
``tcp://HOST:PORT`` with the rank and world size ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``; 0 and 1 when unset), the ``nccl`` backend on
the card and ``gloo`` on the CPU; everything else runs as without it.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs.registry import ARCH_IDS, get_config
from ..data.pipeline import HostDataLoader
from ..models.registry import get_model
from ..core.tree import tree_leaves, tree_unflatten
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.schedule import warmup_cosine
from ..runtime.fault_tolerance import StragglerMonitor

__all__ = ["batch_to", "main", "train_reduced", "train_step"]


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on ``device``: integer entries
    (tokens, labels) as int64, float entries (a whisper batch's ``frames``)
    in their own dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v, device=device)
        out[k] = t if t.is_floating_point() else t.long()
    return out


def train_step(loss_fn: Callable, params, opt_state, batch, ocfg: AdamWConfig, *,
               warmup: int, total: int) -> Tuple[Dict, Dict, torch.Tensor]:
    """One step: ``loss_fn(params, batch) -> (loss, metrics)``, its
    gradients with respect to every parameter, the LR scale
    ``warmup_cosine(opt_state["step"])`` and one AdamW update. Returns
    ``(params, opt_state, loss)`` (the loss detached, on the device)."""
    leaves = [p if p.requires_grad else p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = loss_fn(params, batch)
    grads = tree_unflatten(params, torch.autograd.grad(loss, leaves))
    lr_scale = warmup_cosine(opt_state["step"], warmup=warmup, total=total)
    params, opt_state = adamw_update(params, grads, opt_state, ocfg, lr_scale)
    return params, opt_state, loss.detach()


def train_reduced(arch: str, steps: int = 100, batch: int = 8, seq: int = 128,
                  lr: float = 3e-4, ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                  seed: int = 0, resume: bool = True, log_every: int = 10,
                  device="cuda") -> Tuple[Dict, List[float]]:
    """Train the reduced ``arch`` on one device (the reference's
    ``train_reduced``: AdamW at ``lr`` with ``warmup_cosine(warmup=10)``,
    data ``HostDataLoader(seed)``, a checkpoint every ``ckpt_every`` steps
    and at the end, resumed from the latest when ``resume``). Returns
    ``(params, losses)``."""
    cfg = get_config(arch).reduced()
    bundle = get_model(cfg)
    ocfg = AdamWConfig(lr=lr)
    loader = HostDataLoader(vocab=cfg.vocab_size, global_batch=batch, seq_len=seq, seed=seed)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed))
    opt_state = adamw_init(params, ocfg)
    start_step = 0
    ckpt = None
    if ckpt_dir:
        ckpt = Checkpointer(ckpt_dir, keep=2)
        last = ckpt.latest_step()
        if resume and last is not None:
            state = ckpt.restore(last, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = last + 1
    monitor = StragglerMonitor()
    history = []
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        params, opt_state, loss = train_step(bundle.train_loss, params, opt_state,
                                             batch_to(loader.batch_at(step), device), ocfg,
                                             warmup=10, total=steps)
        loss = float(loss)
        dt = time.perf_counter() - t0
        monitor.record(0, dt)
        if step % log_every == 0 or step == steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        history.append(loss)
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()  # the writer may hold this very step: let it land first
        ckpt.save(steps - 1, {"params": params, "opt": opt_state}, blocking=True)
    return params, history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS, required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--reduced", action="store_true", default=True,
                   help="train the reduced config (always on, as the reference's flag)")
    p.add_argument("--coordinator", default=None,
                   help="HOST:PORT -> torch.distributed.init_process_group (multi-process; "
                        "RANK and WORLD_SIZE as torchrun sets them)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.coordinator:
        import torch.distributed as dist

        dist.init_process_group(
            backend="nccl" if str(args.device).startswith("cuda") else "gloo",
            init_method=f"tcp://{args.coordinator}", rank=int(os.environ.get("RANK", 0)),
            world_size=int(os.environ.get("WORLD_SIZE", 1)))
    try:
        _, hist = train_reduced(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                                lr=args.lr, ckpt_dir=args.ckpt_dir, device=args.device)
    finally:
        if args.coordinator:
            dist.destroy_process_group()
    if hist:
        print(json.dumps({"first_loss": hist[0], "last_loss": hist[-1]}))
    return hist


if __name__ == "__main__":
    main()
