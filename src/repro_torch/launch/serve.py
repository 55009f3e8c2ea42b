"""Serve requests through the port's paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch ID] [--pmq] [--kv-bits 8] \
        [--prefix-cache] [--pool-blocks N] [--preempt-mode swap|recompute] [--no-preempt] \
        [--policy fair --tenant-weights batch=1,interactive=4] \
        [--ttft-budget-ms MS] [--trace-level spans --trace-out F] \
        [--resident-experts N [--async-offload] [--offload-dir DIR [--host-expert-bytes B]]] \
        [--temperature T [--sample-seed S]] [--device cpu]

Like the reference CLI (``repro/launch/serve.py``) it serves
``cfg.reduced()`` of ``--arch`` on random prompts of 24 tokens; the
uncompressed weights of a dense or MoE model are built from seed 0
(:func:`repro_torch.core.synthetic.build_uncompressed`). ``--pmq`` (MoE only)
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
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core import pipeline
from ..core.synthetic import build_uncompressed
from ..serving import EngineConfig, PagedServingEngine, Request
from .workload import calibration_tokens

PROMPT_TOKENS = 24


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


def main() -> None:
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
    p.add_argument("--policy", choices=["fcfs", "priority", "fair"], default="fcfs",
                   help="admission order: arrival order, strict priority classes, or "
                        "weighted-deficit token fairness across tenants (outputs are "
                        "identical across policies)")
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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    if args.tenant_weights and args.policy != "fair":
        raise SystemExit("--tenant-weights only applies to --policy fair")
    if args.ttft_budget_ms is not None and args.ttft_budget_ms < 0:
        raise SystemExit("--ttft-budget-ms must be >= 0")
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
    else:
        params = build_uncompressed(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT_TOKENS).astype(np.int32)
               for _ in range(args.requests)]
    blocks_per_req = (PROMPT_TOKENS + args.max_new) // args.block_size + 2
    engine = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=args.slots, block_size=args.block_size,
                     num_blocks=args.pool_blocks or args.slots * blocks_per_req,
                     max_blocks_per_slot=blocks_per_req, preempt_mode=args.preempt_mode,
                     reserve_full=args.no_preempt, decode_horizon=args.decode_horizon,
                     temperature=args.temperature, sample_seed=args.sample_seed,
                     prefix_cache=args.prefix_cache, kv_bits=args.kv_bits,
                     policy=args.policy, tenant_weights=tenant_weights,
                     ttft_budget_s=(args.ttft_budget_ms / 1000.0
                                    if args.ttft_budget_ms is not None else None),
                     trace_level=trace_level, resident_experts=args.resident_experts,
                     async_offload=args.async_offload, offload_dir=args.offload_dir,
                     host_expert_bytes=args.host_expert_bytes),
        device=args.device,
    )
    if engine.offload is not None:
        del params  # the engine holds the resident partitions and the host store
    tenants = [t for t, _ in tenant_weights] if tenant_weights else ["default"]
    out = engine.serve(Request(rid=i, prompt=prompts[i], max_new=args.max_new,
                               tenant=tenants[i % len(tenants)])
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
    print(f"scheduling: policy {args.policy}; {m['sheds']} sheds, {m['plans']} plans "
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


if __name__ == "__main__":
    main()
