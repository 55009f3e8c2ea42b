"""Serve requests through the port's paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve [--arch ID] [--pmq] [--kv-bits 8] \
        [--prefix-cache] [--policy fair --tenant-weights batch=1,interactive=4] \
        [--ttft-budget-ms MS] [--trace-level spans --trace-out F] [--device cpu]

Like the reference CLI (``repro/launch/serve.py``) it serves
``cfg.reduced()`` of ``--arch`` on random prompts of 24 tokens; the model is
built from seed 0 by :mod:`repro_torch.core.synthetic`: with ``--pmq`` (MoE
only) PMQ bit buckets at an average of 2.05 bits, 4-bit attention and
shared experts and OTP routers, without it the uncompressed weights of a
dense or MoE model. Runs on the GPU unless ``--device cpu``.

``--policy`` picks the admission order (``fcfs``, ``priority`` or ``fair``
over ``--tenant-weights``; requests are assigned round-robin to the named
tenants), ``--ttft-budget-ms`` sheds requests that wait longer for their
first token, and ``--trace-out F`` writes the span trace as Chrome JSON to
``F`` and as a JSONL event log to ``F.jsonl``; check either with
``python -m repro_torch.serving.trace F F.jsonl``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..core.synthetic import build_synthetic, build_uncompressed
from ..serving import EngineConfig, PagedServingEngine, Request

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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS, default="moonshot-v1-16b-a3b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--pmq", action="store_true",
                   help="serve PMQ-compressed experts with OTP (MoE models)")
    p.add_argument("--decode-horizon", type=int, default=8, metavar="H",
                   help="decode steps per fused megastep")
    p.add_argument("--prefix-cache", action="store_true",
                   help="share cached prompt prefixes copy-on-write and skip their "
                        "prefill (outputs stay bit-identical)")
    p.add_argument("--kv-bits", type=int, choices=[8], default=None, metavar="B",
                   help="store the KV pool as B-bit codes with per-row f32 scales")
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
    tenant_weights = _parse_tenant_weights(args.tenant_weights) if args.tenant_weights else None
    trace_level = args.trace_level or ("full" if args.trace_out else "off")
    cfg = get_config(args.arch).reduced()
    if args.pmq and not cfg.is_moe:
        raise SystemExit(f"--pmq compresses MoE experts; {args.arch} is {cfg.family}")
    make = build_synthetic if args.pmq else build_uncompressed
    params = make(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT_TOKENS).astype(np.int32)
               for _ in range(args.requests)]
    blocks_per_req = (PROMPT_TOKENS + args.max_new) // args.block_size + 2
    engine = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=args.slots, block_size=args.block_size,
                     num_blocks=args.slots * blocks_per_req,
                     max_blocks_per_slot=blocks_per_req, decode_horizon=args.decode_horizon,
                     prefix_cache=args.prefix_cache, kv_bits=args.kv_bits,
                     policy=args.policy, tenant_weights=tenant_weights,
                     ttft_budget_s=(args.ttft_budget_ms / 1000.0
                                    if args.ttft_budget_ms is not None else None),
                     trace_level=trace_level),
        device=args.device,
    )
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
    print(f"KV pool: {engine.cache.pool_bytes} bytes "
          f"({'int8 codes + f32 row tables' if args.kv_bits else 'fp'})")
    print(f"scheduling: policy {args.policy}; {m['sheds']} sheds, {m['plans']} plans "
          f"{m['plan_actions']}; tenant tokens {m['tenant_tokens']}")
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
