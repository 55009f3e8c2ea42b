"""The port's int8-KV serving with the shared-prefix cache against the JAX
reference.

* The refcounted allocator and the copy-on-write ``PrefixCache`` give the
  reference's block tables, refcounts, free lists and prefix entries byte
  for byte over one seeded admit / register / evict / COW sequence, and
  the COW copy moves codes and all four scale/zero tables.
* ``moonshot-v1-16b-a3b.reduced()``, compressed by the reference with a
  fixed PMQ plan of 1/2/3-bit experts (``planned_reference``) and carried
  into the port by ``repro_torch.interop``, served with
  ``kv_bits=8`` and ``prefix_cache=True``: the port's greedy tokens equal
  the reference engine's (same ``EngineConfig``) at H = 4 and H = 1, and
  the prefill dispatches, hits and COW copies match; prefix on equals
  prefix off; ``quantized_greedy_reference`` equals the reference's.
* A head blocked by the cache's pinned pages on an idle pool clears the
  cache and is served instead of raising.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import PagedServingEngine as JEngine  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving.engine import quantized_greedy_reference as jqgr  # noqa: E402
from repro.serving.kvcache import PagedKVCache as JCache  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.synthetic import build_synthetic  # noqa: E402
from repro_torch.serving import EngineConfig, PagedServingEngine, Request  # noqa: E402
from repro_torch.serving.engine import quantized_greedy_reference as tqgr  # noqa: E402
from repro_torch.serving.kvcache import QUANT_TABLES  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache as TCache  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    flatten_reference, planned_reference, torch_one_thread)

ARCH = "moonshot-v1-16b-a3b"


# ------------------------------------------------ allocator + prefix cache
def _cache_state(c):
    entries = [(e.key, list(e.pages), e.n_tokens, e.hits, e.last_logits is None)
               for e in c.prefix.snapshot()]
    refs = {pg: c.allocator.refcount(pg) for pg in range(c.allocator.num_blocks)}
    return (c.block_tables.tolist(), refs, list(c.allocator.free_pages), list(c.free_slots),
            entries, dict(c.prefix.holds))


def test_allocator_and_prefix_cache_match_reference():
    """One seeded sequence of admissions with and without prefix hits,
    registrations, releases and LRU evictions on both caches: identical
    host state after every step; the COW copy duplicates the tail page's
    codes and its scale/zero rows."""
    cfg = jget_config(ARCH).reduced()
    nb, bs = 10, 4
    geo = dict(num_blocks=nb, block_size=bs, max_slots=3, max_blocks_per_slot=5)
    jc = JCache.create(cfg, **geo, kv_bits=8, prefix_cache=True)
    tc = TCache(cfg, **geo, device="cpu", kv_bits=8, prefix_cache=True)
    rng = np.random.default_rng(7)
    # the same random codes and tables in both pools
    codes = rng.integers(0, 256, size=(2,) + tuple(jc.k.shape), dtype=np.uint8)
    tabs = {n: rng.standard_normal(jc.quant[n].shape).astype(np.float32) for n in QUANT_TABLES}
    jc.k, jc.v = jnp.asarray(codes[0]), jnp.asarray(codes[1])
    jc.quant = {n: jnp.asarray(a) for n, a in tabs.items()}
    flat = lambda a: torch.from_numpy(a.reshape(a.shape[0], nb * bs, *a.shape[3:]))  # noqa
    tc.k[:, : nb * bs], tc.v[:, : nb * bs] = flat(codes[0]), flat(codes[1])
    for n in QUANT_TABLES:
        tc.quant[n][:, : nb * bs] = flat(tabs[n])

    a = rng.integers(0, 500, size=10).astype(np.int32)
    b = np.concatenate([a[:8], rng.integers(0, 500, size=5)]).astype(np.int32)
    d = rng.integers(0, 500, size=9).astype(np.int32)
    logits = np.arange(3, dtype=np.float32)
    slots = {}

    def admit(name, prompt, total):
        got = []
        for c in (jc, tc):
            entry = c.prefix_lookup(prompt)
            slot = c.acquire_slot(total, prefix_entry=entry)
            got.append((slot, None if entry is None else entry.n_tokens))
        assert got[0] == got[1], (name, got)
        slots[name] = got[0][0]
        return got[0][1]

    def register(name, prompt):
        assert jc.register_prefix(prompt, slots[name], last_logits=logits) == \
            tc.register_prefix(prompt, slots[name], last_logits=torch.from_numpy(logits))

    def release(name):
        for c in (jc, tc):
            c.release_slot(slots[name])

    steps = [
        lambda: admit("a", a, 14), lambda: register("a", a),
        lambda: admit("b", b, 16), lambda: register("b", b),
        lambda: admit("c", a, 12),  # full hit ending mid-page: COW of the tail
        lambda: release("a"), lambda: release("b"),
        lambda: admit("d", d, 20),  # evicts LRU entries to fit
        lambda: register("d", d), lambda: release("c"), lambda: release("d"),
        lambda: admit("e", b, 20),
    ]
    hits, entries = [], []
    for step in steps:
        hits.append(step())
        for c in (jc, tc):
            c.check_consistency()
        assert _cache_state(tc) == _cache_state(jc)
        entries.append(tc.prefix.n_entries)
    assert [h for h in hits if h is not None] == [8, 10]
    assert entries[6] == 5 and entries[7] < entries[6]  # d's admission evicted
    assert tc.cow_copies == 1
    pairs = [(jc.k, tc.k), (jc.v, tc.v)] + [(jc.quant[n], tc.quant[n]) for n in QUANT_TABLES]
    for jt, tt in pairs:  # pools and tables after the COW copy
        paged = tt[:, : nb * bs].numpy()
        assert np.array_equal(paged, np.asarray(jt).reshape(paged.shape))


# ------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def served():
    """(cfg, port params, prompts, reference tokens and metrics at H = 4,
    reference quantized_greedy_reference of prompt 1)."""
    cfg = jget_config(ARCH).reduced()
    params_j = planned_reference(cfg, [1, 2, 2, 3, 2, 2, 3, 2])
    flat, meta = flatten_reference(params_j)
    params_t = interop.params_from_reference(flat, meta, device="cpu")
    rng = np.random.default_rng(9)
    system = rng.integers(0, cfg.vocab_size, size=32)
    prompts = [np.concatenate([system, rng.integers(0, cfg.vocab_size, size=n)]).astype(np.int32)
               for n in (10, 5, 16)]
    prompts.insert(2, prompts[1].copy())  # a retried prompt: full hit ending mid-page
    eng = JEngine(cfg, params_j, JEngineConfig(**_geo(4)))
    want = eng.serve(JRequest(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    m = eng.metrics
    counts = (m.prefill_dispatches, m.prefix_hits, m.prefix_full_hits, m.prefix_tokens_saved,
              m.cow_copies)
    qgr = jqgr(cfg, params_j, prompts[1], 6, kv_bits=8)
    return cfg, params_t, prompts, want, counts, qgr


def _geo(horizon, prefix=True):
    return dict(max_slots=2, block_size=16, num_blocks=16, max_blocks_per_slot=4,
                prefill_chunk=16, decode_horizon=horizon, reserve_full=True, use_otp=True,
                kv_bits=8, prefix_cache=prefix)


def _serve(cfg, params, prompts, **geo):
    eng = PagedServingEngine(tget_config(ARCH).reduced(), params, EngineConfig(**geo),
                             device="cpu")
    out = eng.serve(Request(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts))
    eng.cache.check_consistency()
    return eng, out


@pytest.mark.parametrize("horizon", [1, 4])
def test_int8_prefix_engine_matches_reference(served, horizon):
    """Identical greedy tokens to the reference engine; the same prefill
    dispatches, prefix hits, reused tokens and COW copies (the retried
    prompt is a full hit: no prefill chunk, one tail copy)."""
    cfg, params_t, prompts, want, counts, _ = served
    eng, got = _serve(cfg, params_t, prompts, **_geo(horizon))
    assert got == want
    s = eng.summary()
    chunks, hits, full_hits, saved, cow = counts
    assert (s["prefill_chunks"], s["prefix_hits"], s["cached_tokens"], s["cow_copies"]) == \
        (chunks, hits, saved, cow)
    assert full_hits == 1 and cow == 1
    # prompts of 42, 37, 37, 48 tokens: 3 + 1 + 0 + 1 chunks with the cache
    assert chunks == 5
    assert eng.cache.kv_bits == 8 and eng.cache.k.dtype == torch.uint8


def test_int8_prefix_on_equals_off(served):
    """The cache changes no token: cached pages hold exactly the KV the
    skipped prefill writes; without it every prompt prefills in full."""
    cfg, params_t, prompts, want, _, _ = served
    eng, got = _serve(cfg, params_t, prompts, **_geo(4, prefix=False))
    assert got == want
    assert eng.summary()["prefill_chunks"] == 3 + 3 + 3 + 3
    assert eng.summary()["cow_copies"] == 0


def test_quantized_greedy_reference_matches(served):
    cfg, params_t, prompts, want, _, qgr = served
    got = tqgr(tget_config(ARCH).reduced(), params_t, prompts[1], 6, kv_bits=8, device="cpu")
    assert got == qgr == want[1]


def test_blocked_head_clears_prefix_cache():
    """A prefix hit whose entries pin every page eviction could free blocks
    the head on an idle pool; the engine drops the cache and serves it at
    the next boundary instead of raising, with the tokens it serves alone."""
    cfg = tget_config(ARCH).reduced()
    params = build_synthetic(cfg, seed=0, device="cpu")
    geo = dict(max_slots=1, block_size=4, num_blocks=4, max_blocks_per_slot=4,
               prefill_chunk=4, decode_horizon=2, kv_bits=8, reserve_full=True)
    rng = np.random.default_rng(4)
    a = rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
    b = np.concatenate([a[:4], rng.integers(0, cfg.vocab_size, size=8)]).astype(np.int32)
    eng = PagedServingEngine(cfg, params, EngineConfig(**geo, prefix_cache=True), device="cpu")
    out_a = eng.serve([Request(rid=0, prompt=a, max_new=4)])
    assert eng.cache.prefix.pages_held  # a's prefixes pin 2 of the 4 pages
    out_b = eng.serve([Request(rid=1, prompt=b, max_new=4)])
    assert eng.cache.prefix.n_entries == 3  # cleared, then b registered its own
    assert eng.summary()["prefix_hits"] == 0
    eng.cache.check_consistency()
    alone = PagedServingEngine(cfg, params, EngineConfig(**geo), device="cpu")
    assert out_a == alone.serve([Request(rid=0, prompt=a, max_new=4)])
    assert out_b == alone.serve([Request(rid=1, prompt=b, max_new=4)])


def test_shared_prefix_workload_counts():
    """The full-width SHARED_PREFIX workload's prompts and engine settings
    on the reduced model: 6 prefill chunks instead of 16 and one COW copy,
    the counts chip_smoke.py checks at full width."""
    from repro_torch.launch import workload

    cfg = tget_config(workload.ARCH).reduced()
    params = build_synthetic(cfg, seed=0, device="cpu")
    eng = PagedServingEngine(cfg, params, workload.SHARED_PREFIX, device="cpu")
    out = eng.serve(workload.shared_prefix_requests(cfg))
    s = eng.summary()
    assert (s["prefill_chunks"], s["cow_copies"]) == (workload.SHARED_PREFIX_CHUNKS,
                                                      workload.SHARED_PREFIX_COW_COPIES)
    assert out[2] == out[3]  # r3 retries r2's prompt
    off = PagedServingEngine(cfg, params, dataclasses.replace(workload.SHARED_PREFIX,
                                                              prefix_cache=False), device="cpu")
    assert off.serve(workload.shared_prefix_requests(cfg)) == out
    assert off.summary()["prefill_chunks"] == 16
