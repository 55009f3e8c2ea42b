"""The port's page growth, victim preemption and KV swap against the JAX
reference's engine, on seeded ``reserve_full=False`` request traces.

Each trace runs on both engines with the same ``EngineConfig`` (growth on,
``preempt_mode`` as the trace says) and the same arrivals, with the
structural invariants of ``tests/test_serving_sim.py`` checked after every
step on both; held, exactly: greedy tokens, the typed ``errors`` per rid,
``metrics.counters()`` (dict equality, swap bytes and floats included) and
the tracer's ``deterministic_jsonl()`` at trace level ``full``. The traces:

* the half-pool 12-request ``TINY_MOE`` trace of ``test_serving_sim.py:579``
  in both modes (≥ 1 preemption; in swap mode swap-in bytes = swap-out
  bytes);
* ``test_trace.py:225``'s fuzzed trace at the tightest pool, H ∈ {1, 4, 8}
  × both modes;
* ``test_trace.py:281``'s ``(2, 2), (10, 10)`` pool-4 lifecycle trace (every
  lifecycle event kind, a resumed admission);
* the fault fuzz of ``test_serving_sim.py:873`` over the ``swap_out``,
  ``swap_in``, ``pool`` and ``logits`` sites (the same fault log, recovery
  bit-exact or a typed ``PoisonedRequest``), and each swap fault site and
  mode on the lifecycle trace's preemption (one ``swap_fallback``, the
  fault-free tokens);
* a PMQ + OTP ``planned_reference`` model with an int8 pool in swap mode;
* recompute mode on the PMQ + OTP model in f32 and on the dense model in
  bf16 (the CPU's plain kernels): tokens, ``counters()`` and the JSONL equal the
  reference engine's, and the tokens equal the unpressured run's.

A recompute resume rewrites the decode-era KV rows bit for bit: the
reduced moonshot-v1-16b-a3b (PMQ + OTP, 4 layers) at f32 and bf16, a
64-token prompt, 16 tokens decoded over 4 slots, the context re-prefilled
(``tests/_torch_resume.py``), a context whose decode-era tokens one
capacity dispatch of the chunk would drop in part.

Units: ``SwappedKV`` has the reference's shapes, ``nbytes`` and CRC (the
port's ``payload_checksum`` equals ``repro.serving.faults.checksum_tree`` of
the reference's payload) on f32, bf16 and int8 pools, restores bit for bit
into other pages and catches corruption; ``grow`` leaves all state alone on
``PoolExhausted``. ``launch/workload.py``'s ``PREEMPT_COUNTERS`` and
``PREEMPT_FAULT_EVENTS`` are the reference engine's on ``TINY_DENSE``, and
the serving CLI preempts on an undersized pool.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as J  # noqa: E402
from repro.serving.faults import checksum_tree as jchecksum_tree  # noqa: E402
from repro.serving.kvcache import PagedKVCache as JCache  # noqa: E402

from repro_torch import serving as T  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import workload  # noqa: E402
from repro_torch.serving.kvcache import QUANT_TABLES  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache as TCache  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401
from test_serving_sim import FUZZ_SITES, TINY_DENSE, Trace, _random_trace  # noqa: E402
import test_torch_serving_control as control  # noqa: E402
from _torch_resume import compare, op_deltas, reprefilled_rows  # noqa: E402

LIFECYCLE = {"enqueue", "admit", "prefill_chunk", "first_token", "compute", "megastep",
             "decode", "page_grow", "preempt", "kv_swap_out", "swap_in", "kv_swap_in",
             "release", "request", "pool"}
#: growth on, the trace's preempt_mode, every event recorded
GROWTH = dict(reserve_full=False, trace_level="full")


@pytest.fixture(scope="module")
def dense():
    return control._model("dense")


@pytest.fixture(scope="module")
def moe():
    return control._model("moe")


@pytest.fixture(scope="module")
def pmq():
    return control._model("pmq")


def _run(pkg, m, trace, faults=None, **kw):
    return control._run(pkg, m, trace, faults, **GROWTH, **kw)


def _both(m, trace, plan=None, **kw):
    """The trace with growth on the reference and on the port: tokens, typed
    errors, counters, the JSONL at level ``full`` and the fault log equal;
    returns the port's engine."""
    return control._both(m, trace, plan, **GROWTH, **kw)


# ---------------------------------------------------------------- traces
@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
def test_half_pool_mixed_trace_matches_reference(moe, preempt_mode):
    """``test_serving_sim.py:579``: 12 requests through a pool at half
    their demand, 8 slots, on the uncompressed MoE model."""
    rng = np.random.default_rng(7)
    trace = Trace(tuple(int(x) for x in rng.integers(2, 7, 12)),
                  tuple(int(x) for x in rng.integers(6, 13, 12)), (0,) * 12, 0, preempt_mode,
                  max_slots=8)
    trace = dataclasses.replace(trace, pool_blocks=max(trace.demand // 2, trace.min_pool))
    te = _both(moe, trace)
    s = te.metrics.summary()
    assert s["preemptions"] >= 1
    if preempt_mode == "swap":
        assert s["swap_out_bytes"] > 0 and s["swap_in_bytes"] == s["swap_out_bytes"]
    else:
        assert s["swap_bytes"] == 0
    assert s["page_util_p95"] > 0.8


@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
@pytest.mark.parametrize("horizon", [1, 4, 8])
def test_fuzzed_trace_under_pressure_matches_reference(dense, horizon, preempt_mode):
    """``test_trace.py:225``: the fuzzed trace of seed 5 at the tightest
    admissible pool, across horizons and modes."""
    base = _random_trace(np.random.default_rng(5))
    trace = dataclasses.replace(base, horizon=horizon, pool_blocks=base.min_pool,
                                preempt_mode=preempt_mode)
    _both(dense, trace)


@pytest.mark.parametrize("preempt_mode", ["swap", "recompute"])
def test_lifecycle_trace_matches_reference(dense, preempt_mode):
    """``test_trace.py:281``: two 2-token prompts of 10 new tokens on 4
    pages; the first growth finds no free page and preempts the youngest,
    which resumes later (swapped in, or re-prefilled)."""
    trace = Trace((2, 2), (10, 10), (0, 0), 4, preempt_mode, max_slots=2, horizon=4)
    te = _both(dense, trace)
    names = {e["name"] for e in te.tracer.events}
    swap = {"kv_swap_out", "swap_in", "kv_swap_in"}
    assert LIFECYCLE - (set() if preempt_mode == "swap" else swap) <= names
    assert te.metrics.counters()["preemptions"]
    assert any(e["name"] == "admit" and e["args"]["resumed"] for e in te.tracer.events)
    if preempt_mode == "recompute":
        assert any(e["name"] == "prefill_chunk" and e["args"]["resume"]
                   for e in te.tracer.events)


@pytest.mark.parametrize("seed,horizon", [(0, 1), (3, 4)])
def test_swap_fault_fuzz_matches_reference(dense, seed, horizon):
    """``test_serving_sim.py:873`` in swap mode: a seeded fault schedule over
    the swap, pool and logits sites on the tightest pool (these two traces
    never preempt, so their ``pool`` and ``logits`` specs fire; the swap
    sites fire in the test below). Pool faults recover bit-exactly, a
    poisoned request ends typed; the port fires the same faults at the same
    steps, and a replay of the plan gives the same outcome again."""
    base = _random_trace(np.random.default_rng(200 + seed))
    trace = dataclasses.replace(base, horizon=horizon, preempt_mode="swap",
                                pool_blocks=base.min_pool)
    plan = T.FaultPlan.generate(400 + seed, n_faults=8, max_step=16, sites=FUZZ_SITES,
                                rids=list(range(len(trace.prompt_lens))))
    te = _both(dense, trace, plan.specs)
    assert all(isinstance(e, T.PoisonedRequest) for e in te.errors.values())
    assert te.metrics.counters()["fault_injected"] > 0
    clean = _run(T, dense, trace)
    for rid, toks in clean.results.items():
        if rid not in te.errors:
            assert te.results[rid] == toks
    again = _run(T, dense, trace, plan.replay())
    assert again.results == te.results and control._errors(again) == control._errors(te)
    assert again.metrics.counters() == te.metrics.counters()


@pytest.mark.parametrize("site,mode", [("swap_out", "fail"), ("swap_out", "corrupt"),
                                       ("swap_in", "fail"), ("swap_in", "corrupt")])
def test_swap_faults_under_pressure_match_reference(dense, site, mode):
    """The lifecycle trace's preemption with a fault on the victim's swap:
    a swap-out ``fail`` degrades the preemption to recompute on the spot,
    any other fault is caught at swap-in and the victim is re-prefilled.
    One ``swap_fallback``, no swap-in bytes, the fault-free tokens."""
    trace = Trace((2, 2), (10, 10), (0, 0), 4, "swap", max_slots=2, horizon=4)
    te = _both(dense, trace, [T.FaultSpec(site=site, mode=mode, key=1)])
    c = te.metrics.counters()
    assert (c["swap_fallbacks"], c["swap_in_bytes"], c["fault_injected"]) == (1, 0, 1)
    assert not te.errors and te.results == _run(T, dense, trace).results
    resumed = [e for e in te.tracer.events if e["name"] == "prefill_chunk" and e["args"]["resume"]]
    assert resumed and all(e["args"]["rid"] == 1 for e in resumed)


def test_int8_pool_swap_matches_reference(pmq):
    """A PMQ + OTP model with an int8 pool under pressure in swap mode: the
    payload carries codes and all four scale/zero tables; the routing gauges
    ride the trace once per capacity record."""
    rng = np.random.default_rng(11)
    trace = Trace(tuple(int(x) for x in rng.integers(2, 9, 6)),
                  tuple(int(x) for x in rng.integers(6, 11, 6)), (0, 0, 0, 1, 1, 2), 0,
                  "swap", max_slots=3, horizon=4)
    trace = dataclasses.replace(trace, pool_blocks=trace.min_pool)
    te = _both(pmq, trace, kv_bits=8)
    c = te.metrics.counters()
    assert c["preemptions"] and c["swap_in_bytes"] == c["swap_out_bytes"] > 0
    routing = sum(e["name"] == "routing" for e in te.tracer.events)
    assert routing == len(c["capacity_utilization"]) > 0


@pytest.fixture(scope="module")
def dense_bf16():
    """``TINY_DENSE`` in bf16, built by the reference and carried into the
    port."""
    from repro.models.registry import get_model as jget_model
    from repro_torch import interop

    jcfg = dataclasses.replace(TINY_DENSE, dtype="bfloat16")
    import jax

    params_j = jget_model(jcfg).init(jax.random.PRNGKey(0))
    flat, meta = control.flatten_reference(params_j)
    return (jcfg, TModelConfig(**dataclasses.asdict(jcfg)), params_j,
            interop.params_from_reference(flat, meta, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recompute_resume_matches_reference_and_unpressured(pmq, dense_bf16, dtype):
    """Recompute mode under pressure — the PMQ + OTP model in f32, the dense
    model in bf16: the resumed chunks (``resume`` in the trace) run the
    decode kernel for their decode-era rows and still dispatch, count and
    trace as the reference engine does, token for token; every request's
    tokens are those of the same requests on a pool that never preempts.
    (The bf16 PMQ model's routing gauges differ from the reference's on the
    CPU in swap mode too, resume or not, on a gate near-tie:
    :func:`test_bf16_pmq_routing_gauges_flip_on_a_gate_near_tie`.)"""
    m = pmq if dtype == "float32" else dense_bf16
    trace = _recompute_trace()
    te = _both(m, trace)
    assert te.metrics.counters()["preemptions"]
    assert any(e["name"] == "prefill_chunk" and e["args"]["resume"] for e in te.tracer.events)
    calm = _run(T, m, dataclasses.replace(trace, pool_blocks=trace.demand))
    assert not calm.metrics.counters()["preemptions"]
    assert te.results == calm.results


def _recompute_trace():
    """The 6-request recompute trace of the resume tests, on its tightest
    pool."""
    rng = np.random.default_rng(11)
    trace = Trace(tuple(int(x) for x in rng.integers(2, 9, 6)),
                  tuple(int(x) for x in rng.integers(6, 11, 6)), (0, 0, 0, 1, 1, 2), 0,
                  "recompute", max_slots=3, horizon=4)
    return dataclasses.replace(trace, pool_blocks=trace.min_pool)


def test_bf16_pmq_routing_gauges_flip_on_a_gate_near_tie(pmq, monkeypatch):
    """The PMQ + OTP model with every float leaf cast to bf16 on the recompute
    trace: tokens and ``counters()`` equal the reference engine's, but its
    routing gauges differ — a divergence by design (``ROADMAP.md`` §3). The
    first step whose ``slot_counts`` differ moves one pick between two
    slots, and in the port that step's router, at that layer, gives one
    token exactly those two experts with top-2 gates less than one bf16 ulp
    at 0.5 (2⁻⁸) apart (0.5016 / 0.4984: 0.80 ulp): the OTP mask keeps the
    stronger of the two, and which one is stronger turns on bf16 roundings
    that XLA's fused CPU program and torch's per-op kernels place
    differently."""
    import jax

    from repro.serving import trace as jtrace
    from repro_torch import interop
    from repro_torch.core import compressed_moe as tcm
    from repro_torch.serving import trace as ttrace

    jcfg, _, params_j, _ = pmq
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    params_j = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                            if jnp.issubdtype(a.dtype, jnp.floating) else a, params_j)
    flat, meta = control.flatten_reference(params_j)
    m = (jcfg, TModelConfig(**dataclasses.asdict(jcfg)), params_j,
         interop.params_from_reference(flat, meta, device="cpu"))
    counts = {"J": [], "T": []}
    routes = []  # the port's router calls and counts, in order
    for key, mod in (("J", jtrace), ("T", ttrace)):
        def update(self, c, _key=key, _orig=mod.ExpertRoutingTelemetry.update):
            counts[_key].append(np.asarray(c).copy())
            if _key == "T":
                routes.append(("counts", len(counts["T"]) - 1))
            return _orig(self, c)
        monkeypatch.setattr(mod.ExpertRoutingTelemetry, "update", update)
    route_topk = tcm.route_topk

    def recorded(router_p, x2, k):
        out = route_topk(router_p, x2, k)
        routes.append(("route", out[1].clone(), out[2].clone()))
        return out

    monkeypatch.setattr(tcm, "route_topk", recorded)
    trace = _recompute_trace()
    je = _run(J, m, trace)
    te = _run(T, m, trace)
    assert te.results == je.results
    assert te.metrics.counters() == je.metrics.counters()
    gauges = [[e["args"] for e in eng.tracer.events if e["name"] == "routing"]
              for eng in (je, te)]
    assert gauges[0] != gauges[1]
    step = next(i for i, (a, b) in enumerate(zip(counts["J"], counts["T"]))
                if not np.array_equal(a, b))
    layer = next(l for l in range(jcfg.num_layers)
                 if not np.array_equal(counts["J"][step][l], counts["T"][step][l]))
    delta = counts["T"][step][layer].astype(int) - counts["J"][step][layer].astype(int)
    assert sorted(delta[delta != 0].tolist()) == [-1, 1]  # one pick moved
    slots = {int(np.flatnonzero(delta == 1)[0]), int(np.flatnonzero(delta == -1)[0])}
    # the router calls of that step: each program's calls (layer by layer,
    # step by step) come before its steps' counts
    pending, calls = [], None
    for ev in routes:
        if ev[0] == "route":
            pending.append(ev[1:])
            continue
        if ev[1] == step:
            calls = pending[:jcfg.num_layers]
            break
        pending = pending[jcfg.num_layers:]
    idx, gates = calls[layer]
    slot_of = te.params["layers"][layer]["moe_ce"].slot_of_expert
    ties = [float(g[0] - g[1]) for i, g in zip(idx, gates)
            if {int(slot_of[e]) for e in i} == slots]
    assert ties and min(ties) < 2.0 ** -8, ties


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resumed_rows_are_the_decode_written_rows(dtype):
    """The rows a recompute resume rewrites equal the rows the prefill and
    the decode wrote, bit for bit, at every layer (the CPU's plain kernels;
    the card's are ``test_reprefilled_kv_rows_against_decode_written``), on
    a context (prompt seed 6) whose decode-era tokens one capacity dispatch
    of the 16-row chunk would drop in part: the resume dispatches them so
    that none is dropped, as the decode's 4 slots never were."""
    from repro_torch.configs import get_config
    from repro_torch.core.synthetic import build_synthetic

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), dtype=dtype,
                              num_layers=4)
    params = build_synthetic(cfg, seed=0, device="cpu")
    slots = workload.PREEMPT.max_slots
    decoded, again, context = reprefilled_rows(params, cfg, "cpu", slots=slots, seed=6)
    assert op_deltas(params, cfg, "cpu", decoded, context, slots=slots)["dropped"] > 0
    assert all(torch.equal(a, b) for a, b in zip(decoded, again))
    deltas, scales = compare(decoded, again, 64)
    assert deltas == [0.0] * cfg.num_layers and min(scales) > 0


# ------------------------------------------------------------- units
POOL = dict(num_blocks=8, block_size=4, max_slots=3, max_blocks_per_slot=4)


def _filled_caches(kind):
    """A reference and a port cache of the same geometry holding the same
    random pool (f32, bf16 or int8 codes with random scale/zero tables)."""
    cfg = dataclasses.replace(TINY_DENSE, dtype="bfloat16" if kind == "bf16" else "float32")
    kv_bits = 8 if kind == "int8" else None
    jc = JCache.create(cfg, **POOL, kv_bits=kv_bits)
    tc = TCache(TModelConfig(**dataclasses.asdict(cfg)), **POOL, device="cpu", kv_bits=kv_bits)
    rng = np.random.default_rng(3)
    nb, bs = POOL["num_blocks"], POOL["block_size"]

    def flat(a):
        return torch.from_numpy(np.ascontiguousarray(a.reshape(a.shape[0], nb * bs,
                                                               *a.shape[3:])))

    for name in ("k", "v"):
        shape = tuple(getattr(jc, name).shape)
        if kind == "int8":
            a = rng.integers(0, 256, size=shape, dtype=np.uint8)
            setattr(jc, name, jnp.asarray(a))
            getattr(tc, name)[:, :nb * bs] = flat(a)
        else:
            a = rng.standard_normal(shape).astype(np.float32)
            setattr(jc, name, jnp.asarray(a, getattr(jc, name).dtype))
            getattr(tc, name)[:, :nb * bs] = flat(a).to(getattr(tc, name).dtype)
    if kind == "int8":
        tabs = {n: rng.standard_normal(jc.quant[n].shape).astype(np.float32)
                for n in QUANT_TABLES}
        jc.quant = {n: jnp.asarray(a) for n, a in tabs.items()}
        for n in QUANT_TABLES:
            tc.quant[n][:, :nb * bs] = flat(tabs[n])
    return jc, tc


def _slot_rows(c, slot):
    """The slot's pages' rows of every pool tensor, in page order."""
    bs = c.block_size
    rows = torch.cat([torch.arange(b * bs, (b + 1) * bs) for b in c.slot_blocks[slot]])
    return [t[:, rows].clone() for t in (c.k, c.v, *c.quant_tables)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_swapped_kv_matches_reference(kind):
    """``swap_out`` gives the reference's payload layout, size and CRC, frees
    the same pages; ``swap_in`` into other physical pages restores every row
    bit for bit; a corrupted payload raises ``SwapFault`` with the pool
    untouched."""
    jc, tc = _filled_caches(kind)
    for c in (jc, tc):
        assert c.acquire_slot(9) == 0 and c.acquire_slot(6) == 1
    before = _slot_rows(tc, 1)
    js, ts = jc.swap_out(1, 6, rid=1), tc.swap_out(1, 6, rid=1)
    assert tuple(ts.k.shape) == tuple(js.k.shape) == (2, 2, 4, 2, 16)
    assert (ts.n_pages, ts.nbytes, ts.n_tokens) == (js.n_pages, js.nbytes, js.n_tokens)
    assert ts.checksum == js.checksum == jchecksum_tree(
        {"k": js.k, "v": js.v, **({"quant": js.quant} if js.quant is not None else {})})
    assert ts.payload_checksum() == ts.checksum
    if kind == "int8":
        assert sorted(ts.quant) == sorted(js.quant) == sorted(QUANT_TABLES)
        for n in QUANT_TABLES:
            assert tuple(ts.quant[n].shape) == tuple(js.quant[n].shape) == (2, 2, 4, 2)
    assert list(tc.allocator.free_pages) == list(jc.allocator.free_pages)
    assert 1 not in tc.slot_blocks and tc.block_tables.tolist() == jc.block_tables.tolist()
    tc.acquire_slot(5)  # takes the freed pages: the restore lands elsewhere
    slot = tc.acquire_slot(6)
    assert set(tc.slot_blocks[slot]).isdisjoint({3, 4})
    assert tc.swap_in(slot, ts, rid=1) == ts.nbytes
    for a, b in zip(_slot_rows(tc, slot), before):
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.uint8) if b.dtype == torch.bfloat16 else b)
    # corruption in transit: the CRC trips before any row moves
    tc.release_slot(slot)
    slot = tc.acquire_slot(6)
    pool = [t.clone() for t in (tc.k, tc.v, *tc.quant_tables)]
    bad = dataclasses.replace(ts, k=ts.k.clone())
    bad.k.view(-1).view(torch.uint8)[0] ^= 0xFF
    with pytest.raises(T.SwapFault, match="checksum"):
        tc.swap_in(slot, bad, rid=1)
    assert all(torch.equal(a, b) for a, b in zip((tc.k, tc.v, *tc.quant_tables), pool))


@pytest.mark.parametrize("site,mode", [("swap_out", "fail"), ("swap_out", "corrupt"),
                                       ("swap_in", "fail"), ("swap_in", "corrupt")])
def test_swap_fault_sites_match_reference(site, mode):
    """The ``swap_out``/``swap_in`` fault sites: ``fail`` raises before any
    state moves, ``corrupt`` is caught by the CRC at swap-in; both caches
    raise the same typed error and log the same firing."""
    outcome = []
    for pkg, c in zip((J, T), _filled_caches("f32")):
        c.faults = pkg.FaultPlan([pkg.FaultSpec(site=site, mode=mode, key=7)])
        c.acquire_slot(9)
        errs = []
        try:
            swapped = c.swap_out(0, 9, rid=7)
        except pkg.SwapFault as exc:
            errs.append(("out", str(exc)))
            assert c.slot_blocks == {0: [0, 1, 2]}  # nothing moved
        else:
            slot = c.acquire_slot(9)
            try:
                c.swap_in(slot, swapped, rid=7)
            except pkg.SwapFault as exc:
                errs.append(("in", str(exc)))
        outcome.append((errs, c.faults.log, list(c.allocator.free_pages)))
    assert outcome[1] == outcome[0] and outcome[0][0]


def test_grow_leaves_state_untouched_on_pool_exhausted():
    """``grow`` past ``max_blocks_per_slot`` raises ``PoolExhausted`` with
    everything as it was; a grow the free pages cannot cover first evicts
    the LRU prefix entries, then raises with the tables and the allocator's
    pages as they were; a grow that fits appends the reference's pages."""
    geo = dict(POOL, num_blocks=6)
    jc = JCache.create(TINY_DENSE, **geo, prefix_cache=True)
    tc = TCache(TModelConfig(**dataclasses.asdict(TINY_DENSE)), **geo, device="cpu",
                prefix_cache=True)

    def state(c):
        return (c.block_tables.tolist(), {s: list(b) for s, b in c.slot_blocks.items()},
                list(c.allocator.free_pages), c.prefix.n_entries)

    prompt = np.arange(4, dtype=np.int32)
    for c, pkg in ((jc, J), (tc, T)):
        c.acquire_slot(5)
        c.acquire_slot(4)
        c.register_prefix(prompt, 1)  # page 2, held by slot 1 and the entry
        assert c.grow(0, 2) == [3, 4]
        before = state(c)
        with pytest.raises(pkg.PoolExhausted, match="max_blocks_per_slot"):
            c.grow(0, 1)  # slot 0 holds 4 pages already
        assert state(c) == before
        with pytest.raises(pkg.PoolExhausted):
            c.grow(1, 2)  # one page free; evicting the entry frees none
        assert state(c)[:3] == before[:3] and c.prefix.n_entries == 0
        c.check_consistency()
    assert state(tc) == state(jc)
    assert tc.grow(1, 1) == jc.grow(1, 1) == [5]
    assert state(tc) == state(jc)


# ------------------------------------------------------------ workload
def test_preempt_counters_are_the_reference_schedule(dense):
    """The reference engine on ``TINY_DENSE`` with ``PREEMPT``'s geometry and
    the fp workload's lengths gives ``PREEMPT_COUNTERS`` (one self-preemption
    of rid 1 with 5 pages); under ``PREEMPT_FAULTS`` at trace level ``full``
    one swap fallback, no swap-in bytes, 21 prefill chunks and
    ``PREEMPT_FAULT_EVENTS`` events. The port gives the same counters and
    trace in both runs."""
    jcfg, tcfg, params_j, params_t = dense
    for plan, level in ((None, "off"), (workload.PREEMPT_FAULTS, "full")):
        ecfg = dataclasses.replace(workload.PREEMPT, trace_level=level)
        je = J.PagedServingEngine(
            jcfg, params_j, J.EngineConfig(**dataclasses.asdict(ecfg)),
            plan and J.FaultPlan([J.FaultSpec(**dataclasses.asdict(s)) for s in plan.specs]))
        je.serve(J.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
                 for r in workload.requests(tcfg))
        te = T.PagedServingEngine(tcfg, params_t, ecfg, plan and plan.replay(), device="cpu")
        te.serve(workload.requests(tcfg))
        c = je.metrics.counters()
        assert te.results == je.results and te.metrics.counters() == c
        assert te.tracer.deterministic_jsonl() == je.tracer.deterministic_jsonl()
        pre = c["preemptions"]
        assert [p["rid"] for p in pre] == [workload.PREEMPT_VICTIM]
        assert pre[0]["swap_bytes"] == c["swap_out_bytes"] == (
            workload.PREEMPT_VICTIM_PAGES * 2 * jcfg.num_layers * workload.PREEMPT.block_size
            * jcfg.num_kv_heads * jcfg.head_dim * 4)
        if plan is None:
            assert workload.preempt_schedule(c) == workload.PREEMPT_COUNTERS
            assert c["swap_in_bytes"] == c["swap_out_bytes"]
        else:
            sched = workload.preempt_schedule(c)
            assert {k: v for k, v in sched.items() if k not in ("prefill_dispatches",
                                                                "swap_fallbacks")} == \
                {k: v for k, v in workload.PREEMPT_COUNTERS.items()
                 if k not in ("prefill_dispatches", "swap_fallbacks")}
            assert (c["swap_fallbacks"], c["swap_in_bytes"], c["prefill_dispatches"]) == (1, 0, 21)
            assert len(je.tracer.events) == workload.PREEMPT_FAULT_EVENTS
            assert sum(e["name"] == "page_grow" for e in je.tracer.events) == 3


def test_serve_cli_preempts_on_an_undersized_pool(monkeypatch, capsys):
    """``--pmq --pool-blocks 11 --device cpu``: the CLI's 8 requests, served by
    the reduced model the pipeline compresses, grow into an 11-page pool,
    preempt, swap back in and all finish."""
    import sys

    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--pmq", "--pool-blocks", "11",
                                      "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert out.count("request ") >= 8
    pool = next(line for line in out.splitlines() if line.startswith("KV pool: 11 pages"))
    n = int(pool.split(": ")[2].split(" preemptions")[0])
    assert n >= 1, pool
    assert "growth, preempt mode swap" in pool and " 0 swap fallbacks" in pool
