"""Continuous-batching engine over the paged KV pool (port of
``repro/serving/engine.py``, slice 1).

* **prefill** — an admitted request's prompt streams through
  :func:`paged_prefill_chunk` in fixed-size chunks, writing K/V straight
  into its pages; the last chunk's logits give the first token (TTFT).
* **decode megastep** — every slot advances up to ``decode_horizon``
  tokens through :func:`paged_decode_horizon`: greedy argmax on the device
  feeds each step's token into the next, per-slot stop logic rides the
  carried ``active`` mask, and the host fetches the ``[H, slots]`` token
  matrix once per megastep.

Between megasteps the FCFS scheduler admits queued requests into free
slots, reserving ``prompt + max_new`` pages (``reserve_full``). Expert
capacity is raised to the drop-free bound (capacity factor = number of
experts), so a request's tokens never depend on who it shares a step with.

This slice honours only the :class:`EngineConfig` fields below. Growth and
preemption (``reserve_full=False``), swap, prefix cache, int8 KV, expert
offload, temperature sampling, the controller, faults and tracing are later
slices: their settings do not exist here, and ``reserve_full=False`` is
refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..models.transformer import paged_decode_horizon, paged_prefill_chunk
from .kvcache import PagedKVCache
from .scheduler import Request, Scheduler

__all__ = ["EngineConfig", "PagedServingEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4
    block_size: int = 16
    num_blocks: int = 64
    max_blocks_per_slot: int = 8
    prefill_chunk: int = 16
    use_otp: bool = True  # OTP decode masks when the model carries them
    # raise expert capacity to the drop-free bound inside every step
    drop_free_capacity: bool = True
    decode_horizon: int = 8
    # pages for prompt + max_new are reserved at admission; False (growth +
    # preemption) is a later slice and refused
    reserve_full: bool = True


class PagedServingEngine:
    """Serve :class:`Request`s against the port's PMQ + OTP MoE params on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``)."""

    def __init__(self, cfg, params: Dict, engine_cfg: Optional[EngineConfig] = None, *,
                 device="cuda"):
        self.ecfg = engine_cfg or EngineConfig()
        if cfg.family != "moe":
            raise ValueError(f"the port serves MoE decoders, got family {cfg.family!r}")
        if not self.ecfg.reserve_full:
            raise ValueError("reserve_full=False needs page growth and preemption, "
                             "which this slice does not implement")
        if self.ecfg.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be ≥ 1, got {self.ecfg.decode_horizon}")
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"params hold {len(params['layers'])} layers, "
                             f"config says {cfg.num_layers}")
        self.device = torch.device(device)
        self.model_cfg = cfg
        if self.ecfg.drop_free_capacity:
            self.model_cfg = dataclasses.replace(
                cfg, moe_capacity_factor=float(max(cfg.moe_capacity_factor, cfg.num_experts))
            )
        self.params = params
        self.cache = PagedKVCache(
            cfg, num_blocks=self.ecfg.num_blocks, block_size=self.ecfg.block_size,
            max_slots=self.ecfg.max_slots, max_blocks_per_slot=self.ecfg.max_blocks_per_slot,
            device=self.device,
        )
        self.scheduler = Scheduler(self.cache)
        self.results: Dict[int, List[int]] = {}
        self.metrics = {
            "ttft_s": [], "prefill_chunks": 0, "megasteps": 0, "decode_s": 0.0,
            "decode_tokens": 0, "expert_activation": [],
        }
        # the last megastep's per-step emit mask [H, slots] and expert
        # dispatch counts [H, L, num_slots] (which expert rows it touched)
        self.last_emits: Optional[np.ndarray] = None
        self.last_slot_counts: Optional[np.ndarray] = None

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        req.arrival_s = time.time()
        self.scheduler.submit(req)

    def serve(self, requests: Iterable[Request]) -> Dict[int, List[int]]:
        """Submit + run; returns the outputs of this batch."""
        reqs = list(requests)
        for r in reqs:
            self.submit(r)
        self.run()
        return {r.rid: self.results[r.rid] for r in reqs}

    def run(self) -> Dict[int, List[int]]:
        while self.step():
            pass
        return dict(self.results)

    def step(self) -> bool:
        """One megastep boundary: admit (and prefill) FCFS while the head
        fits, then advance every active slot one megastep. Returns whether
        work remains."""
        if not self.scheduler.has_work():
            return False
        while True:
            req = self.scheduler.try_admit()
            if req is None:
                break
            self._prefill(req)
            self.results[req.rid] = req.out
            if req.done:  # max_new == 1
                self.scheduler.finish(req.slot)
        if self.scheduler.active:
            self._decode_megastep()
        elif self.scheduler.waiting:
            raise RuntimeError("idle pool cannot admit the queue head "
                               f"(request {self.scheduler.waiting[0].rid})")
        return self.scheduler.has_work()

    # ------------------------------------------------------------ prefill
    def _prefill(self, req: Request) -> None:
        c = self.ecfg.prefill_chunk
        p_len = len(req.prompt)
        table_row = torch.as_tensor(self.cache.block_tables[req.slot:req.slot + 1],
                                    device=self.device)
        logits = None
        for off in range(0, p_len, c):
            n = min(c, p_len - off)
            chunk = np.zeros((1, c), np.int64)
            chunk[0, :n] = req.prompt[off:off + n]
            logits, _ = paged_prefill_chunk(
                self.params, self.cache.k, self.cache.v, table_row,
                torch.as_tensor(chunk, device=self.device), off, n, self.model_cfg,
                block_size=self.ecfg.block_size, use_otp=self.ecfg.use_otp,
            )
            self.metrics["prefill_chunks"] += 1
        tok = int(torch.argmax(logits[0, -1]))  # the one host sync of the prefill
        self.metrics["ttft_s"].append(time.time() - req.arrival_s)
        req.out.append(tok)
        req.pos = p_len

    # ------------------------------------------------------------ decode
    def _decode_megastep(self) -> None:
        b, h = self.ecfg.max_slots, self.ecfg.decode_horizon
        tokens = np.zeros((b, 1), np.int64)
        positions = np.zeros((b,), np.int32)
        active = np.zeros((b,), bool)
        budgets = np.zeros((b,), np.int32)
        eos_ids = np.full((b,), -1, np.int32)
        for slot, req in self.scheduler.active.items():
            tokens[slot, 0] = req.out[-1]
            positions[slot] = req.pos
            active[slot] = True
            budgets[slot] = req.max_new - len(req.out)
            eos_ids[slot] = req.eos_id
        dev = self.device
        t0 = time.time()
        toks, emits, acts, counts = paged_decode_horizon(
            self.params, self.cache.k, self.cache.v, self.cache.tables_device(),
            torch.as_tensor(tokens, device=dev), torch.as_tensor(positions, device=dev),
            torch.as_tensor(active, device=dev), self.model_cfg,
            block_size=self.ecfg.block_size, horizon=h,
            budgets=torch.as_tensor(budgets, device=dev),
            eos_ids=torch.as_tensor(eos_ids, device=dev), use_otp=self.ecfg.use_otp,
        )
        toks, emits, acts = toks.cpu().numpy(), emits.cpu().numpy(), acts.cpu().numpy()
        self.metrics["decode_s"] += time.time() - t0
        self.last_emits, self.last_slot_counts = emits, counts.cpu().numpy()
        self.metrics["megasteps"] += 1
        self.metrics["decode_tokens"] += int(emits.sum())
        self.metrics["expert_activation"].extend(
            float(a) for a, e in zip(acts, emits) if e.any()
        )
        for slot, req in list(self.scheduler.active.items()):
            for s in range(h):
                if emits[s, slot]:
                    req.out.append(int(toks[s, slot]))
                    req.pos += 1
            if req.done:
                self.scheduler.finish(slot)

    def summary(self) -> Dict[str, float]:
        """TTFT, decode rate and OTP activation of the requests served so far
        (wall clock on the host; the decode time ends in a device sync)."""
        m = self.metrics
        ttft = np.asarray(m["ttft_s"])
        act = np.asarray(m["expert_activation"])
        return {
            "requests": int(ttft.size),
            "ttft_mean_s": float(ttft.mean()) if ttft.size else 0.0,
            "ttft_max_s": float(ttft.max()) if ttft.size else 0.0,
            "prefill_chunks": m["prefill_chunks"],
            "megasteps": m["megasteps"],
            "decode_tokens": m["decode_tokens"],
            "decode_s": m["decode_s"],
            "decode_tokens_per_s": m["decode_tokens"] / m["decode_s"] if m["decode_s"] else 0.0,
            "expert_activation": float(act.mean()) if act.size else 1.0,
        }
