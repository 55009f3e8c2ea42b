"""Continuous-batching serving over the paged-KV engine, on the PyTorch port
(the port's counterpart of ``serve_batched.py``).

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch moonshot-v1-16b-a3b] [--device cpu]

Drives the *reduced* config of an arch through
``repro_torch.serving.PagedServingEngine`` (on the card unless ``--device
cpu``) and shows what a wave batcher cannot:

1. requests with different ``max_new`` finish independently (a finished
   request frees its slot and KV pages at once);
2. a queued request is admitted **mid-flight** into the running batch
   (``mid_flight_admissions`` and slot releases in the metrics);
3. paged decode is the dense decode: a solo request's greedy tokens equal
   the dense-cache prefill + decode's (``dense_greedy_reference``);
4. page growth and preemption: the same workload through a pool at about
   half its worst-case demand, and through a tighter one where a request's
   growth must preempt another, finishes every request with the same tokens, its
   victims swapped to host memory and resumed (``preempt_mode="swap"``) or
   dropped and re-prefilled (``"recompute"``: the resume rewrites their
   decode-era KV rows bit for bit, so the tokens are the same too).
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models.registry import get_model
from repro_torch.serving import EngineConfig, PagedServingEngine, Request
from repro_torch.serving.engine import dense_greedy_reference


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=ARCH_IDS, default="moonshot-v1-16b-a3b")
    p.add_argument("--requests", type=int, default=6)
    p.add_argument("--max-new", type=int, default=12)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args()

    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced()
    params = get_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)

    engine = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=3, block_size=8, num_blocks=24, max_blocks_per_slot=8,
                     prefill_chunk=8),
        device=dev)
    # different max_new per request: slots free at different steps
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=16).astype(np.int32),
                    max_new=max(2, args.max_new - 2 * i))
            for i in range(args.requests)]
    out = engine.serve(reqs)
    for rid in sorted(out):
        print(f"req {rid}: {len(out[rid])} tokens {out[rid][:8]}...")
    m = engine.metrics.summary()
    print("metrics:", engine.metrics.to_json())
    assert all(len(out[r.rid]) == r.max_new for r in reqs), \
        "requests must finish at their own max_new"
    assert m["mid_flight_admissions"] > 0, \
        "queued requests should join the batch mid-decode (slot turnover)"
    print(f"continuous batching OK: {m['mid_flight_admissions']} requests admitted "
          f"mid-flight, {m['slot_releases']} slot releases")

    # --- paged vs dense (a solo request, greedy) --------------------------
    prompt = rng.integers(0, cfg.vocab_size, size=13).astype(np.int32)
    max_new = 6
    # the oracle runs at the engine's drop-free expert capacity, so the
    # comparison isolates the cache layout
    ref_toks, _ = dense_greedy_reference(engine.model_cfg, params, prompt, max_new, device=dev)
    solo = PagedServingEngine(
        cfg, params,
        EngineConfig(max_slots=2, block_size=4, num_blocks=16, max_blocks_per_slot=8,
                     prefill_chunk=4),
        device=dev)
    paged_toks = solo.serve([Request(rid=0, prompt=prompt, max_new=max_new)])[0]
    assert paged_toks == ref_toks, (paged_toks, ref_toks)
    print(f"paged == dense greedy decode: {paged_toks}")

    # --- pool pressure: growth and preemption, the same outputs -----------
    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new) for r in reqs]

    bs = 8  # block size shared by the page-count math and the engine
    demand = sum(-(-(len(r.prompt) + r.max_new) // bs) for r in reqs)
    biggest = max(-(-(len(r.prompt) + r.max_new) // bs) for r in reqs)
    # the reference's half pool, then a tighter one (the largest request's
    # pages and two more), where a running request's growth preempts another
    for name, pages in (("half", max(biggest, demand // 2)), ("tight", biggest + 2)):
        for mode in ("swap", "recompute"):
            tight = PagedServingEngine(
                cfg, params,
                EngineConfig(max_slots=len(reqs), block_size=bs, num_blocks=pages,
                             max_blocks_per_slot=8, prefill_chunk=bs, preempt_mode=mode),
                device=dev)
            out_tight = tight.serve(fresh())
            mt = tight.metrics.summary()
            assert out_tight == out, f"{name} pool, {mode}: pool pressure changed the outputs"
            assert name == "half" or mt["preemptions"] > 0, f"{mode}: the tight pool must preempt"
            print(f"{name}-pool serve OK ({mode}): {mt['preemptions']} preemptions, "
                  f"{mt['swap_bytes']} swap bytes, page util p95 {mt['page_util_p95']:.2f} "
                  f"(pool {pages} of {demand} worst-case pages)")

if __name__ == "__main__":
    main()
