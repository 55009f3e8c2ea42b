"""Serve requests through the port's paged engine (or its legacy wave batcher).

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch ID] [--pmq] [--kv-bits 8] \
        [--prefix-cache] [--pool-blocks N] [--preempt-mode swap|recompute] [--no-preempt] \
        [--policy fair --tenant-weights batch=1,interactive=4] \
        [--ttft-budget-ms MS] [--trace-level spans --trace-out F] \
        [--resident-experts N [--async-offload] [--offload-dir DIR [--host-expert-bytes B]]] \
        [--temperature T [--sample-seed S]] [--chaos-seed SEED] [--deadline-steps N] \
        [--ffn-backend grouped|ref|scan] [--legacy] [--device cpu]

Like the reference CLI (``repro/launch/serve.py``) it serves
``cfg.reduced()`` of ``--arch`` on random prompts of 24 tokens; the
uncompressed weights of a dense, VLM-backbone (served on tokens alone, as
the reference's engine serves it) or MoE model are built from seed 0
(:func:`repro_torch.core.synthetic.build_uncompressed`); a whisper,
recurrentgemma or xlstm model is its bundle's ``init`` at seed 0, which the
paged engine refuses as the reference's does, and ``--legacy`` serves
(recurrentgemma) or fails on (whisper has no frames, xlstm's cache no
``k``) as the reference CLI does. ``--pmq`` (MoE only)
compresses them first with the MC# pipeline
(:mod:`repro_torch.core.pipeline`), as the reference CLI does: calibration
on 4 × 64 random tokens (numpy seed 0), Eq. 6 significance, the layer-uniform
PMQ plan at an average of 2.05 bits, 4-bit attention and shared experts, no
OTP routers; it prints the plan's histogram and average bits. Runs on the
GPU unless ``--device cpu``.

``--temperature T`` samples ``softmax(logits / T)`` on the device instead
of decoding greedily, seeded per megastep from ``--sample-seed``.

Admission reserves pages for the context and the next megastep and the
engine grows slots on demand, as the reference does; ``--pool-blocks``
undersizes the pool (default: worst-case demand) so that growth preempts
requests, which ``--preempt-mode`` restores from the host swap store or by
re-prefilling their context. ``--no-preempt`` reserves ``prompt + max_new``
pages at admission instead (no growth, no preemption).

``--policy`` picks the admission order (``fcfs``, ``priority`` or ``fair``
over ``--tenant-weights``; requests are assigned round-robin to the named
tenants), ``--ttft-budget-ms`` sheds requests that wait longer for their
first token, and ``--trace-out F`` writes the span trace as Chrome JSON to
``F`` and as a JSONL event log to ``F.jsonl``; check either with
``python -m repro_torch.serving.trace F F.jsonl``.

``--resident-experts N`` (implies ``--pmq``) keeps N expert slots per layer
on the device and the cold PMQ rows on the host, prefetched by routing
statistics; a program that routes to a missing expert is replayed after a
synchronous upload, so the tokens are the all-resident engine's.
``--async-offload`` stages the planned uploads on a side stream while the
next program runs, ``--offload-dir DIR`` spills the expert store to mmap'd,
CRC-checked files under ``DIR`` with a host row cache of
``--host-expert-bytes`` in front of it.

``--chaos-seed SEED`` attaches the reference CLI's seeded fault plan (8
faults over the first ``4 · max_new`` logical steps at the ``swap_out``,
``swap_in``, ``pool`` and ``logits`` sites, ``upload`` too with
``--resident-experts``) and ``--deadline-steps N`` bounds every request to N
logical steps; the run then prints the fault plane's counters and each typed
error. Every request still finishes with the tokens it would have had, or
ends with a typed error.

``--ffn-backend`` picks the PMQ expert FFN's path for the engine and the
wave batcher alike: ``grouped`` (the default: the Hopper kernels on the card,
their plain versions on the CPU), ``ref`` (the plain versions on either
device) or ``scan`` (the reference's per-expert scan: ``quant_matmul`` per
expert matrix); the reference's ``interpret`` is refused by name.

``--legacy`` serves with :class:`BatchedServer` instead, the static wave
batcher the paged engine replaced, kept for comparison: it refuses the
options that live in the paged engine, as the reference CLI does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import pipeline
from ..core.compressed_moe import resolve_ffn_backend
from ..core.synthetic import build_uncompressed
from ..models.registry import get_model
from ..models.transformer import extend_cache
from ..serving import EngineConfig, FaultPlan, PagedServingEngine
from ..serving import Request as PagedRequest
from .workload import calibration_tokens

__all__ = ["BatchedServer", "Request", "main"]

PROMPT_TOKENS = 24


@dataclasses.dataclass
class Request:
    """A request of the wave batcher."""

    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int = 16


class BatchedServer:
    """Static-batch wave server over a fixed slot count (the legacy baseline
    of ``repro/launch/serve.py``): requests are taken in waves of
    ``max_slots``, a short wave is padded with ``max_new=0`` dummies, every
    wave is prefilled anew through the dense-cache ``prefill`` (prompts
    left-padded or cut to ``prompt_len``) and decoded greedily one
    ``decode_step`` at a time at ``prompt_len + step``, every slot held until
    the wave's longest request is done."""

    def __init__(self, cfg, params, max_slots: int = 4, prompt_len: int = 32, *,
                 device="cuda", ffn_backend: Optional[str] = None):
        self.cfg = cfg
        self.ffn_backend = ffn_backend
        self.bundle = get_model(cfg)
        self.params = params
        self.max_slots = max_slots
        self.prompt_len = prompt_len
        self.device = torch.device(device)
        self.stats: Dict[str, list] = {"prefill_s": [], "decode_s": [], "active": []}

    def _pad_prompts(self, reqs: List[Request]) -> torch.Tensor:
        toks = np.zeros((len(reqs), self.prompt_len), np.int64)
        for i, r in enumerate(reqs):
            p = r.prompt[-self.prompt_len:]
            toks[i, -len(p):] = p
        return torch.as_tensor(toks, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, reqs: List[Request]) -> Dict[int, List[int]]:
        """Serve ``reqs`` wave by wave: rid → its greedy tokens."""
        results: Dict[int, List[int]] = {}
        for i in range(0, len(reqs), self.max_slots):
            wave = reqs[i:i + self.max_slots]
            while len(wave) < self.max_slots:
                # a dummy never extends the wave's decode loop nor counts in the stats
                wave = wave + [Request(rid=-1, prompt=wave[0].prompt, max_new=0)]
            tokens = self._pad_prompts(wave)
            max_new = max(r.max_new for r in wave)
            t0 = time.perf_counter()
            cache, logits = self.bundle.prefill(self.params, {"tokens": tokens},
                                                ffn_backend=self.ffn_backend)
            self._sync()
            self.stats["prefill_s"].append(time.perf_counter() - t0)
            cache = extend_cache(cache, max_new)
            cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
            outs: List[List[int]] = [[] for _ in wave]
            host = cur[:, 0].tolist()
            for j, r in enumerate(wave):
                if r.rid >= 0 and r.max_new > 0:
                    outs[j].append(host[j])
            for step in range(max_new - 1):
                t0 = time.perf_counter()
                cache, logits = self.bundle.decode_step(self.params, cache, cur,
                                                        self.prompt_len + step,
                                                        ffn_backend=self.ffn_backend)
                self._sync()
                self.stats["decode_s"].append(time.perf_counter() - t0)
                live = [r.rid >= 0 and step + 1 < r.max_new for r in wave]
                self.stats["active"].append(sum(live))
                cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
                host = cur[:, 0].tolist()
                for j in range(len(wave)):
                    if live[j]:
                        outs[j].append(host[j])
            for j, r in enumerate(wave):
                if r.rid >= 0:
                    results[r.rid] = outs[j]
        return results

    def summary(self) -> Dict[str, float]:
        d = np.asarray(self.stats["decode_s"])
        gen = float(np.sum(self.stats["active"]))  # real, still-decoding slots only
        return {
            "prefill_mean_s": float(np.mean(self.stats["prefill_s"])),
            "decode_mean_s": float(np.mean(d)) if d.size else 0.0,
            "decode_p95_s": float(np.percentile(d, 95)) if d.size else 0.0,
            "tokens_per_s": gen / float(d.sum()) if d.size else 0.0,
        }


def _parse_tenant_weights(spec: str):
    """``"name=w,name=w"`` → the ``(name, weight)`` pairs EngineConfig
    carries; refuses empty names, repeats and w ≤ 0."""
    pairs, seen = [], set()
    for item in spec.split(","):
        name, eq, w = item.partition("=")
        try:
            weight = float(w)
        except ValueError:
            weight = -1.0
        if not name or not eq or weight <= 0 or name in seen:
            raise SystemExit("--tenant-weights expects 'name=w,name=w' with unique names "
                             f"and w > 0 (got {spec!r})")
        seen.add(name)
        pairs.append((name, weight))
    return tuple(pairs)


def _compress_for_serving(cfg, device):
    """The reduced model from seed 0 compressed by the MC# pipeline on the
    reference CLI's calibration tokens; prints the plan."""
    params = build_uncompressed(cfg, seed=0, device=device)
    calib = pipeline.calibrate(params, torch.as_tensor(calibration_tokens(cfg), device=device),
                               cfg)
    params_c, avg_bits = pipeline.compress_for_serving(params, calib, cfg, consume=True)
    meta = params_c["layers"][0]["moe_ce"].meta
    hist = {m.bits: m.count * cfg.num_layers for m in meta}
    print(f"PMQ plan (layer-uniform, {cfg.num_layers} layers x {cfg.num_experts} experts): "
          f"histogram {hist}, average {avg_bits:.4f} bits")
    return params_c


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (default: the command line), serve, print the report.
    Returns the engine (the wave server with ``--legacy``)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS, default="moonshot-v1-16b-a3b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--pmq", action="store_true",
                   help="compress the model with the MC# pipeline (PMQ experts, 4-bit "
                        "attention; MoE models) and serve it")
    p.add_argument("--resident-experts", type=int, default=None, metavar="N",
                   help="per-layer device budget in expert slots; cold PMQ rows live on the "
                        "host and are prefetched by router stats (implies --pmq)")
    p.add_argument("--async-offload", action="store_true",
                   help="stage planned expert uploads on a side stream while the next "
                        "megastep computes (requires --resident-experts)")
    p.add_argument("--offload-dir", default=None, metavar="DIR",
                   help="spill the expert store to mmap'd packed buckets under DIR (disk -> "
                        "host -> device; CRC-checked; requires --resident-experts)")
    p.add_argument("--host-expert-bytes", type=int, default=None, metavar="B",
                   help="byte budget of the host row cache in front of --offload-dir "
                        "(default: unbounded)")
    p.add_argument("--decode-horizon", type=int, default=8, metavar="H",
                   help="decode steps per fused megastep")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="on-device sampling temperature inside the megastep (0 = greedy "
                        "argmax, the default)")
    p.add_argument("--sample-seed", type=int, default=0,
                   help="seed for temperature sampling; one generator per megastep, so runs "
                        "replay deterministically")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share cached prompt prefixes copy-on-write and skip their "
                        "prefill (outputs stay bit-identical)")
    p.add_argument("--kv-bits", type=int, choices=[8], default=None, metavar="B",
                   help="store the KV pool as B-bit codes with per-row f32 scales")
    p.add_argument("--pool-blocks", type=int, default=None,
                   help="KV pool size in pages; undersize it to exercise growth + preemption "
                        "(default: worst-case demand)")
    p.add_argument("--preempt-mode", choices=["swap", "recompute"], default="swap",
                   help="restore preempted requests from the host swap store or by "
                        "re-prefilling their context")
    p.add_argument("--no-preempt", action="store_true",
                   help="reserve prompt+max_new pages at admission (no growth, no preemption)")
    p.add_argument("--policy", choices=["fcfs", "priority", "fair"], default=None,
                   help="admission order: arrival order (the default), strict priority "
                        "classes, or weighted-deficit token fairness across tenants (outputs "
                        "are identical across policies)")
    p.add_argument("--tenant-weights", default=None, metavar="T=W,...",
                   help="per-tenant weights for --policy fair, e.g. 'batch=1,interactive=4'; "
                        "requests are assigned round-robin to the named tenants")
    p.add_argument("--ttft-budget-ms", type=float, default=None, metavar="MS",
                   help="shed (empty output) a never-admitted request that has waited "
                        "longer than MS for its first token")
    p.add_argument("--trace-level", choices=["off", "spans", "full"], default=None,
                   help="span tracing detail (default 'full' with --trace-out, else 'off'); "
                        "the metrics are the same at every level")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the Chrome trace-event JSON to PATH and the event log to "
                        "PATH.jsonl")
    p.add_argument("--chaos-seed", type=int, default=None, metavar="SEED",
                   help="attach a seeded fault plan (KV swap, pool, logits faults; expert "
                        "uploads with --resident-experts) and print the fault plane's "
                        "counters; every request still finishes bit-exact or typed")
    p.add_argument("--deadline-steps", type=int, default=None, metavar="N",
                   help="per-request deadline in logical steps; a request not finished "
                        "within N steps of submission ends with DeadlineExceeded")
    p.add_argument("--ffn-backend", choices=["grouped", "ref", "scan", "interpret"],
                   default=None,
                   help="PMQ expert-FFN path: grouped (default; the Hopper kernels on the "
                        "card), ref (the plain versions) or scan (per-expert quant_matmul); "
                        "interpret is not ported")
    p.add_argument("--legacy", action="store_true",
                   help="serve with the static wave batcher instead of the paged engine")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.ffn_backend is not None:
        try:
            resolve_ffn_backend(args.ffn_backend)
        except ValueError as e:
            raise SystemExit(f"--ffn-backend: {e}") from None
    if args.legacy and (args.prefix_cache or args.kv_bits is not None):
        raise SystemExit("--prefix-cache/--kv-bits require the paged engine (drop --legacy)")
    if args.legacy and (args.trace_out or args.trace_level not in (None, "off")):
        raise SystemExit("--trace-out/--trace-level require the paged engine (drop --legacy)")
    if args.legacy and (args.chaos_seed is not None or args.deadline_steps is not None):
        raise SystemExit("--chaos-seed/--deadline-steps require the paged engine "
                         "(drop --legacy)")
    if args.deadline_steps is not None and args.deadline_steps < 1:
        raise SystemExit("--deadline-steps must be >= 1")
    if args.legacy and (args.policy or args.tenant_weights
                        or args.ttft_budget_ms is not None):
        raise SystemExit("--policy/--tenant-weights/--ttft-budget-ms require the paged "
                         "engine (drop --legacy)")
    if args.tenant_weights and (args.policy or "fcfs") != "fair":
        raise SystemExit("--tenant-weights only applies to --policy fair")
    if args.ttft_budget_ms is not None and args.ttft_budget_ms < 0:
        raise SystemExit("--ttft-budget-ms must be >= 0")
    if args.resident_experts is not None and args.legacy:
        raise SystemExit("--resident-experts requires the paged engine (drop --legacy)")
    if (args.async_offload or args.offload_dir is not None) and args.resident_experts is None:
        raise SystemExit("--async-offload/--offload-dir require --resident-experts")
    if args.host_expert_bytes is not None and args.offload_dir is None:
        raise SystemExit("--host-expert-bytes requires --offload-dir")
    args.pmq = args.pmq or args.resident_experts is not None
    tenant_weights = _parse_tenant_weights(args.tenant_weights) if args.tenant_weights else None
    trace_level = args.trace_level or ("full" if args.trace_out else "off")
    cfg = get_config(args.arch).reduced()
    if args.pmq and not cfg.is_moe:
        raise SystemExit(f"--pmq/--resident-experts need MoE experts; {args.arch} is "
                         f"{cfg.family}")
    if args.pmq:
        params = _compress_for_serving(cfg, args.device)
    elif cfg.family in ("dense", "moe", "vlm"):
        params = build_uncompressed(cfg, seed=0, device=args.device)
    else:  # whisper, recurrentgemma, xlstm: the paged engine refuses them (the reference's too)
        params = get_model(cfg).init(torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT_TOKENS).astype(np.int32)
               for _ in range(args.requests)]
    if args.legacy:
        server = BatchedServer(cfg, params, max_slots=args.slots, device=args.device,
                               ffn_backend=args.ffn_backend)
        out = server.serve([Request(rid=i, prompt=prompts[i], max_new=args.max_new)
                            for i in range(args.requests)])
        for rid, toks in sorted(out.items()):
            print(f"request {rid}: {toks}")
        print(f"served {len(out)} requests on {args.device} (legacy wave batcher); stats: "
              f"{json.dumps(server.summary())}")
        return server
    plan = None
    if args.chaos_seed is not None:
        sites = ("swap_out", "swap_in", "pool", "logits")
        if args.resident_experts is not None:
            sites = ("upload",) + sites
        plan = FaultPlan.generate(args.chaos_seed, n_faults=8, max_step=4 * args.max_new,
                                  sites=sites, rids=list(range(args.requests)))
    blocks_per_req = (PROMPT_TOKENS + args.max_new) // args.block_size + 2
    engine = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=args.slots, block_size=args.block_size,
                     num_blocks=args.pool_blocks or args.slots * blocks_per_req,
                     max_blocks_per_slot=blocks_per_req, preempt_mode=args.preempt_mode,
                     reserve_full=args.no_preempt, decode_horizon=args.decode_horizon,
                     temperature=args.temperature, sample_seed=args.sample_seed,
                     prefix_cache=args.prefix_cache, kv_bits=args.kv_bits,
                     policy=args.policy or "fcfs", tenant_weights=tenant_weights,
                     ttft_budget_s=(args.ttft_budget_ms / 1000.0
                                    if args.ttft_budget_ms is not None else None),
                     trace_level=trace_level, resident_experts=args.resident_experts,
                     async_offload=args.async_offload, offload_dir=args.offload_dir,
                     host_expert_bytes=args.host_expert_bytes,
                     ffn_backend=args.ffn_backend),
        faults=plan, device=args.device,
    )
    if engine.offload is not None:
        del params  # the engine holds the resident partitions and the host store
    tenants = [t for t, _ in tenant_weights] if tenant_weights else ["default"]
    out = engine.serve(PagedRequest(rid=i, prompt=prompts[i], max_new=args.max_new,
                                    tenant=tenants[i % len(tenants)],
                                    deadline_steps=args.deadline_steps)
                       for i in range(args.requests))
    for rid, toks in sorted(out.items()):
        print(f"request {rid}: {toks}")
    m = engine.summary()
    print(f"served {len(out)} requests on {args.device}; metrics: {json.dumps(m)}")
    if args.prefix_cache:
        print(f"prefix cache: {m['prefix_hits']} hits, {m['cached_tokens']} prompt tokens "
              f"reused, {m['cow_copies']} COW copies")
    print(f"KV pool: {engine.cache.allocator.num_blocks} pages, {engine.cache.pool_bytes} bytes "
          f"({'int8 codes + f32 row tables' if args.kv_bits else 'fp'}); "
          f"{'full reservation' if args.no_preempt else 'growth, preempt mode ' + args.preempt_mode}"
          f": {m['preemptions']} preemptions, swap bytes out {m['swap_out_bytes']} in "
          f"{m['swap_in_bytes']}, {m['swap_fallbacks']} swap fallbacks")
    print(f"scheduling: policy {engine.ecfg.policy}; {m['sheds']} sheds, {m['plans']} plans "
          f"{m['plan_actions']}; tenant tokens {m['tenant_tokens']}")
    if engine.offload is not None:
        off = engine.offload
        print(f"expert offload: budget {off.budgets} (resident {off.resident_bytes} B of "
              f"{off.host_bytes} B), hit rate {m['expert_hit_rate']:.2f}, "
              f"{m['expert_prefetch_uploads']} prefetch + {m['expert_miss_uploads']} miss "
              f"uploads ({m['expert_upload_bytes']} B), {off.grows} budget grows, prefill runs "
              f"{engine.metrics.prefill_dispatches} for {m['prefill_chunks']} chunks, decode "
              f"runs {engine.metrics.decode_dispatches} for {engine.metrics.megasteps} "
              f"megasteps")
        if args.async_offload:
            print(f"async offload: {m['uploads_overlapped']} overlapped "
                  f"({m['uploads_committed']} committed, {m['uploads_dropped_stale']} dropped "
                  f"stale), stall {m['upload_stall_s']:.4f} s, hidden "
                  f"{m['upload_hidden_s']:.4f} s")
        if args.offload_dir is not None:
            print(f"expert tiers: {m['tier_host_hits']} host hits, {m['tier_disk_hits']} disk "
                  f"fetches ({m['tier_disk_bytes']} B, CRC-checked)")
    if plan is not None or args.deadline_steps is not None:
        ctr = engine.metrics.counters()
        print(f"fault plane: {ctr['fault_injected']} injected {dict(ctr['faults_by_site'])}; "
              f"{ctr['upload_retries']} upload retries, {ctr['degraded_serves']} degraded "
              f"serves, {ctr['swap_fallbacks']} swap fallbacks, {ctr['cancelled']} cancelled, "
              f"{ctr['deadline_exceeded']} deadline-exceeded, {ctr['poisoned']} poisoned")
        if engine.errors:
            print("typed errors: " + ", ".join(f"rid {r}: {type(e).__name__}"
                                               for r, e in sorted(engine.errors.items())))
    report = engine.routing_report()
    if report is not None:
        corr = report["mean_freq_bits_corr"]
        print(f"routing telemetry: {report['steps']} steps over {report['num_layers']}x"
              f"{report['num_slots']} (layer, slot) cells; freq-bits corr "
              f"{'n/a' if corr is None else f'{corr:+.2f}'}")
    if args.trace_out:
        extra = {"routing_report": report} if report is not None else None
        engine.tracer.write_chrome(args.trace_out, extra=extra)
        engine.tracer.write_jsonl(args.trace_out + ".jsonl")
        print(f"trace: {len(engine.tracer.events)} events -> {args.trace_out} (+ .jsonl)")
    return engine


if __name__ == "__main__":
    main()
