"""Serve PMQ + OTP compressed requests through the port's paged engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --pmq [--device cpu]

Like the reference CLI (``repro/launch/serve.py``) it serves
``cfg.reduced()`` of ``--arch`` on random prompts of 24 tokens; the model is
built from seed 0 by :mod:`repro_torch.core.synthetic` (PMQ bit buckets at
an average of 2.05 bits, 4-bit attention and shared experts, OTP routers).
``--pmq`` is required: uncompressed MoE serving is a later slice of the
port. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..core.synthetic import build_synthetic
from ..serving import EngineConfig, PagedServingEngine, Request

PROMPT_TOKENS = 24


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", choices=ARCH_IDS, default="moonshot-v1-16b-a3b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--pmq", action="store_true",
                   help="serve PMQ-compressed experts (required in this slice)")
    p.add_argument("--decode-horizon", type=int, default=8, metavar="H",
                   help="decode steps per fused megastep")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()
    if not args.pmq:
        raise SystemExit("the port serves PMQ-compressed models only: pass --pmq")
    cfg = get_config(args.arch).reduced()
    params = build_synthetic(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT_TOKENS).astype(np.int32)
               for _ in range(args.requests)]
    blocks_per_req = (PROMPT_TOKENS + args.max_new) // args.block_size + 2
    engine = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=args.slots, block_size=args.block_size,
                     num_blocks=args.slots * blocks_per_req,
                     max_blocks_per_slot=blocks_per_req, decode_horizon=args.decode_horizon),
        device=args.device,
    )
    out = engine.serve(Request(rid=i, prompt=prompts[i], max_new=args.max_new)
                       for i in range(args.requests))
    for rid, toks in sorted(out.items()):
        print(f"request {rid}: {toks}")
    print(f"served {len(out)} requests on {args.device}; metrics: "
          f"{json.dumps(engine.summary())}")


if __name__ == "__main__":
    main()
