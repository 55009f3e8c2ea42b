"""The port's engine on the control plane against the JAX reference's
engine, on seeded ``reserve_full=True`` request traces.

Three models, each built once by the reference and carried into the port
byte for byte by ``repro_torch.interop``: ``TINY_DENSE`` and the
uncompressed ``TINY_MOE`` of ``tests/test_serving_sim.py``, and ``TINY_MOE``
compressed by ``planned_reference`` (PMQ buckets of 1/2/2/3 bits, 4-bit
attention and shared experts, OTP routers). Each trace runs on both engines
with the same ``EngineConfig`` (``reserve_full=True``) and the same
arrivals; held, exactly:

* greedy tokens, the typed ``errors`` per rid, ``metrics.counters()``
  (dict equality, floats included) and, at ``trace_level="spans"``, the
  tracer's ``deterministic_jsonl()``;
* the traces: the three-tenant mix of ``test_serving_sim.py:628`` under
  ``fcfs``, ``priority`` and ``fair``; the SLO shed of ``:712``; a mix with a
  ``pool`` and a ``logits`` fault; deadlines (queued and active, ``:1188``),
  submit validation (``:1238``), the watchdog through the injectable
  ``_clock`` (``:1271``) and the livelock guard (``:1295``), each with the
  reference test's assertions on the port; cancellation before admission
  and between prefill chunks with the prefix cache on (``:1137``), the pool
  drained clean after every trace;
* trace levels ``off``/``spans``/``full`` leave tokens and counters alone;
  ``routing_report`` equals the reference's on the PMQ model;
* ``launch/workload.py``'s ``TENANT_MIX_COUNTERS`` are the reference
  engine's schedule counters on the tenant mix's lengths, geometry, policy
  and fault plan, and the port's engine gives them too.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.registry import get_model as jget_model  # noqa: E402
from repro import serving as J  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import workload  # noqa: E402

from _torch_interop import (  # noqa: E402,F401
    flatten_reference, planned_reference, torch_one_thread)
from test_serving_sim import BLOCK, TINY_DENSE, TINY_MOE, Trace, _tenant_mix_trace  # noqa: E402

MAX_TICKS = 10_000


@pytest.fixture(scope="module", params=["dense", "moe", "pmq"])
def model(request):
    """(reference cfg, port cfg, reference params, port params)."""
    return _model(request.param)


@pytest.fixture(scope="module")
def dense():
    return _model("dense")


@pytest.fixture(scope="module")
def pmq():
    return _model("pmq")


@functools.lru_cache(maxsize=None)
def _model(name):
    cfg = TINY_DENSE if name == "dense" else TINY_MOE
    if name == "pmq":
        params_j = planned_reference(cfg, [1, 2, 2, 3])
    else:
        params_j = jget_model(cfg).init(jax.random.PRNGKey(0))
    flat, meta = flatten_reference(params_j)
    params_t = interop.params_from_reference(flat, meta, device="cpu")
    return cfg, TModelConfig(**dataclasses.asdict(cfg)), params_j, params_t


# --------------------------------------------------------------- runners
def _ecfg(trace, **kw):
    mb = -(-(max(p + m for p, m in zip(trace.full_lens, trace.max_news))) // BLOCK)
    return dict(max_slots=trace.max_slots, block_size=BLOCK, num_blocks=trace.pool_blocks,
                max_blocks_per_slot=mb, prefill_chunk=BLOCK, decode_horizon=trace.horizon,
                prefix_cache=trace.prefix_cache, reserve_full=True, policy=trace.policy,
                tenant_weights=trace.tenant_weights or None,
                ttft_budget_steps=trace.ttft_budget_steps if trace.ttft_budget_steps >= 0 else None,
                **kw)


def _requests(pkg, trace, vocab, overrides=None):
    """The trace's requests as ``pkg``'s Request (``overrides``: rid →
    extra fields, e.g. a deadline)."""
    out = []
    for r in trace.requests(vocab):
        extra = (overrides or {}).get(r.rid, {})
        out.append(pkg.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new, tenant=r.tenant,
                               priority=r.priority, **extra))
    return out


def _engine(pkg, m, trace, faults=None, **kw):
    jcfg, tcfg, params_j, params_t = m
    if pkg is J:
        return J.PagedServingEngine(jcfg, params_j, J.EngineConfig(**_ecfg(trace, **kw)), faults)
    return T.PagedServingEngine(tcfg, params_t, T.EngineConfig(**_ecfg(trace, **kw)), faults,
                                device="cpu")


def _run(pkg, m, trace, faults=None, cancel_at=None, midprefill=(), overrides=None, **kw):
    """Drive one engine through ``trace`` boundary by boundary (arrivals
    at their ticks, client cancels at theirs, ``midprefill`` rids cancelled
    right after their first prefill chunk), checking the pool after every
    step and that it drains clean."""
    engine = _engine(pkg, m, trace, faults, **kw)
    mid = set(midprefill)
    if mid:
        complete = engine.tracer.complete

        def hooked(name, **args):
            complete(name, **args)
            rid = (args.get("args") or {}).get("rid")
            if name == "prefill_chunk" and rid in mid:
                mid.discard(rid)
                assert engine.cancel(rid)

        engine.tracer.complete = hooked
    pending = sorted(zip(trace.submit_steps,
                         _requests(pkg, trace, m[0].vocab_size, overrides)),
                     key=lambda t: t[0])
    tick = 0
    while pending or engine.scheduler.has_work():
        assert tick < MAX_TICKS, "trace failed to drain"
        while pending and pending[0][0] <= tick:
            engine.submit(pending.pop(0)[1])
        for rid, t in (cancel_at or {}).items():
            if t == tick:
                engine.cancel(rid)
        if engine.scheduler.has_work():
            engine.step()
            engine.cache.check_consistency()
        tick += 1
    _assert_drained_clean(engine, trace.pool_blocks, trace.max_slots)
    return engine


def _assert_drained_clean(engine, pool_blocks, max_slots):
    """Every page free or held only by the prefix cache, all slots free, and
    a cache teardown frees the whole pool."""
    assert not engine.scheduler.active and not engine.scheduler.waiting
    cache = engine.cache
    held = cache.prefix.pages_held if cache.prefix is not None else frozenset()
    assert cache.allocator.allocated == held
    assert cache.allocator.num_free + len(held) == pool_blocks
    assert sorted(cache.free_slots) == list(range(max_slots))
    assert cache.slot_blocks == {}
    cache.check_consistency()
    cache.clear_prefix_cache()
    assert cache.allocator.num_free == pool_blocks


def _errors(engine):
    return {rid: type(e).__name__ for rid, e in sorted(engine.errors.items())}


def _assert_same(je, te, jsonl=True):
    assert te.results == je.results
    assert _errors(te) == _errors(je)
    assert te.metrics.counters() == je.metrics.counters()
    if jsonl:
        assert te.tracer.deterministic_jsonl() == je.tracer.deterministic_jsonl()


def _both(m, trace, plan=None, **kw):
    """The trace on the reference and on the port (each with its own copy of
    ``plan``'s specs); asserts they agree and returns the port's engine."""
    jplan = tplan = None
    if plan is not None:
        jplan = J.FaultPlan([J.FaultSpec(**dataclasses.asdict(s)) for s in plan])
        tplan = T.FaultPlan([T.FaultSpec(**dataclasses.asdict(s)) for s in plan])
    je = _run(J, m, trace, jplan, **kw)
    te = _run(T, m, trace, tplan, **kw)
    _assert_same(je, te, jsonl=kw.get("trace_level") == "spans")
    if plan is not None:
        assert tplan.log == jplan.log
    return te


# ---------------------------------------------------------------- policies
@pytest.mark.parametrize("policy", ["fcfs", "priority", "fair"])
def test_tenant_mix_policies_match_reference(model, policy):
    base = _tenant_mix_trace(np.random.default_rng(100))
    te = _both(model, dataclasses.replace(base, policy=policy), trace_level="spans")
    assert te.metrics.plans > 0 and te.tracer.events
    got = te.metrics.counters()["tenant_tokens"]
    want = {}
    for req in base.requests(model[0].vocab_size):
        want[req.tenant] = want.get(req.tenant, 0) + len(te.results[req.rid])
    assert got == {t: n for t, n in want.items() if n > 0}


def test_policies_leave_tokens_alone(dense):
    """Policies reorder when requests run, never what they decode."""
    base = _tenant_mix_trace(np.random.default_rng(7))
    base = dataclasses.replace(base, pool_blocks=max(base.min_pool, (2 * base.demand) // 3))
    outs = [_run(T, dense, dataclasses.replace(base, policy=p)).results
            for p in T.VALID_POLICIES]
    assert outs[0] == outs[1] == outs[2]


def test_slo_shed_matches_reference(model):
    """A single-slot engine pinned by a batch request sheds the interactive
    requests stuck behind it past their 3-step TTFT budget (``:712``)."""
    trace = Trace(prompt_lens=(6, 4, 4), max_news=(12, 4, 4), submit_steps=(0, 1, 1),
                  pool_blocks=5, preempt_mode="swap", max_slots=1, horizon=1,
                  tenants=("batch", "interactive", "interactive"), priorities=(0, 2, 2),
                  policy="priority", ttft_budget_steps=3)
    te = _both(model, trace, trace_level="spans")
    m = te.metrics
    assert sorted(rec["rid"] for rec in m.sheds) == [1, 2]
    for rec in m.sheds:
        assert rec["tenant"] == "interactive"
        assert rec["wait_steps"] > trace.ttft_budget_steps
        assert te.results[rec["rid"]] == []
    assert m.counters()["sheds"] == list(m.sheds)
    assert te.summary()["sheds"] == 2
    assert [a["rid"] for a in m.admissions] == [0]


def test_pool_and_logits_faults_match_reference(model):
    """A tight tenant mix with a TTFT budget, a ``pool`` fault hiding 3
    pages from step 2 and a ``logits`` fault poisoning rid 3: the same
    sheds, one typed PoisonedRequest with no tokens, the same fault log."""
    base = _tenant_mix_trace(np.random.default_rng(101))
    trace = dataclasses.replace(base, policy="fair", ttft_budget_steps=3,
                                pool_blocks=base.min_pool)
    plan = [T.FaultSpec(site="pool", step=2, arg=3),
            T.FaultSpec(site="logits", mode="corrupt", key=3)]
    te = _both(model, trace, plan, trace_level="spans")
    c = te.metrics.counters()
    assert c["faults_by_site"] == {"logits": 1, "pool": 1}
    assert c["poisoned"] == 1 and c["sheds"]
    assert _errors(te) == {3: "PoisonedRequest"} and te.results[3] == []


# ------------------------------------------------------ typed terminations
def test_deadline_queued_and_active_terminate_typed(dense):
    """A request stuck behind a single-slot hog expires with no tokens; a
    running one past its deadline keeps a prefix of the tokens it would
    have decoded. Both end with DeadlineExceeded and release everything."""
    trace = Trace(prompt_lens=(6, 4), max_news=(12, 8), submit_steps=(0, 0), pool_blocks=8,
                  preempt_mode="swap", max_slots=1, horizon=1)
    te = _both(dense, trace, overrides={1: {"deadline_steps": 3}}, trace_level="spans")
    assert isinstance(te.errors[1], T.DeadlineExceeded)
    assert te.results[1] == [] and len(te.results[0]) == 12
    assert te.metrics.counters()["deadline_exceeded"] == 1

    trace2 = Trace(prompt_lens=(4,), max_news=(10,), submit_steps=(0,), pool_blocks=8,
                   preempt_mode="swap", max_slots=1, horizon=1)
    te2 = _both(dense, trace2, overrides={0: {"deadline_steps": 4}}, trace_level="spans")
    assert isinstance(te2.errors[0], T.DeadlineExceeded)
    full = _run(T, dense, trace2).results[0]
    got = te2.results[0]
    assert 0 < len(got) < 10 and got == full[:len(got)]


def test_submit_validation_typed_errors(dense):
    """Malformed requests are refused at submit with InvalidRequest (a
    ServingFault and a ValueError); the engine then serves on."""
    trace = Trace((4,), (4,), (0,), 8, "swap")
    jcfg = dense[0]
    tokens = {}
    for pkg in (J, T):
        engine = _engine(pkg, dense, trace)
        good = _requests(pkg, trace, jcfg.vocab_size)[0]
        bad = [pkg.Request(rid=10, prompt=np.zeros(0, np.int32), max_new=4),
               pkg.Request(rid=11, prompt=good.prompt, max_new=0),
               pkg.Request(rid=12, prompt=good.prompt, max_new=4, priority=-1),
               pkg.Request(rid=13, prompt=good.prompt, max_new=4, deadline_steps=0)]
        for r in bad:
            with pytest.raises(pkg.InvalidRequest) as ei:
                engine.submit(r)
            assert isinstance(ei.value, pkg.ServingFault)
            assert isinstance(ei.value, ValueError)
            assert ei.value.rid == r.rid
        engine.submit(good)
        with pytest.raises(pkg.InvalidRequest, match="already live"):
            engine.submit(pkg.Request(rid=good.rid, prompt=good.prompt, max_new=4))
        while engine.scheduler.has_work():
            engine.step()
        tokens[pkg] = engine.results
        if pkg is T:
            _assert_drained_clean(engine, 8, trace.max_slots)
    assert tokens[T] == tokens[J]


def _watchdog(pkg, m, trace):
    engine = _engine(pkg, m, trace, watchdog_timeout_s=10.0, trace_level="spans")
    t = [0.0]

    def fake_clock():
        t[0] += 100.0  # every megastep "takes" 100 s against a 10 s budget
        return t[0]

    engine._clock = fake_clock
    for r in _requests(pkg, trace, m[0].vocab_size):
        engine.submit(r)
    with pytest.raises(pkg.WatchdogTimeout):
        while engine.scheduler.has_work():
            engine.step()
    return engine


def test_watchdog_fails_closed_on_slow_megastep(dense):
    trace = Trace((4, 3), (8, 6), (0, 0), 8, "swap", max_slots=2)
    je, te = _watchdog(J, dense, trace), _watchdog(T, dense, trace)
    assert set(te.errors) == {0, 1}
    assert all(isinstance(e, T.ServingFault) for e in te.errors.values())
    _assert_drained_clean(te, 8, 2)
    _assert_same(je, te)


def _livelock(pkg, m, trace):
    engine = _engine(pkg, m, trace, livelock_steps=5, trace_level="spans")
    engine.submit(_requests(pkg, trace, m[0].vocab_size)[0])
    engine.step()  # admits and prefills; then the decode path stalls
    engine._decode_megastep = lambda: None
    with pytest.raises(pkg.LivelockDetected):
        for _ in range(20):
            engine.step()
    return engine


def test_livelock_guard_fails_closed(dense):
    trace = Trace((4,), (8,), (0,), 8, "swap", max_slots=1)
    je, te = _livelock(J, dense, trace), _livelock(T, dense, trace)
    assert isinstance(te.errors[0], T.ServingFault)
    _assert_drained_clean(te, 8, 1)
    _assert_same(je, te)


def test_cancellation_with_prefix_cow(model):
    """A shared-template trace with the prefix cache on: rid 0 cancelled
    between its prefill chunks (its template pages COW-shared), one rid
    before admission and one at a later boundary (a no-op if it already
    finished). Cancelled rids end with RequestCancelled; refcounts hold
    after every step and the pool drains clean (``:1137``)."""
    rng = np.random.default_rng(300)
    n = 6
    base = Trace(prompt_lens=tuple(int(x) for x in rng.integers(1, 5, n)),
                 max_news=tuple(int(x) for x in rng.integers(3, 9, n)),
                 submit_steps=(0, 0, 1, 1, 2, 3), pool_blocks=0, preempt_mode="swap",
                 max_slots=4, horizon=4, template_len=8, n_templates=2, prefix_cache=True)
    trace = dataclasses.replace(base, pool_blocks=max(base.min_pool, (2 * base.demand) // 3))
    te = _both(model, trace, cancel_at={5: 3, 2: 3}, midprefill=(0,), trace_level="spans")
    assert all(isinstance(e, T.RequestCancelled) for e in te.errors.values())
    assert 0 in te.errors and te.results[0] == []
    assert 5 in te.errors and te.results[5] == []  # cancelled while queued
    assert te.metrics.counters()["cancelled"] == len(te.errors)
    assert te.metrics.counters()["prefix_hits"] > 0
    assert te.cancel(0) is False and te.cancel(10_000) is False


# -------------------------------------------------------- tracing, routing
def test_trace_levels_are_invisible_and_routing_matches(pmq):
    """``off``, ``spans`` and ``full`` give the same tokens and counters;
    at ``full`` the JSONL (routing gauges included) and the
    bit-misallocation report equal the reference's."""
    trace = dataclasses.replace(_tenant_mix_trace(np.random.default_rng(100)), policy="fair")
    runs = {level: _run(T, pmq, trace, trace_level=level) for level in ("off", "spans", "full")}
    for level in ("spans", "full"):
        assert runs[level].results == runs["off"].results
        assert runs[level].metrics.counters() == runs["off"].metrics.counters()
    assert runs["off"].tracer.events == [] and runs["off"].routing_report() is None
    je = _run(J, pmq, trace, trace_level="full")
    te = runs["full"]
    _assert_same(je, te)
    assert any(e["ph"] == "C" and e["name"] == "routing" for e in te.tracer.events)
    report = te.routing_report()
    assert report == je.routing_report()
    assert report["bits_per_slot"] == [1, 2, 2, 3]
    assert te.metrics.counters()["capacity_utilization"]
    assert T.validate_events(te.tracer.events) == len(te.tracer.events)
    assert T.validate_chrome_trace(te.tracer.chrome_trace()) > len(te.tracer.events)


# ------------------------------------------------------------ tenant mix
SCHEDULE_KEYS = tuple(workload.TENANT_MIX_COUNTERS)


def _tenant_mix(pkg, m, ecfg, faults):
    jcfg, tcfg, params_j, params_t = m
    arrivals = workload.tenant_mix_requests(tcfg)
    if pkg is J:
        arrivals = [(b, J.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new,
                                  tenant=r.tenant, priority=r.priority)) for b, r in arrivals]
        plan = faults and J.FaultPlan([J.FaultSpec(**dataclasses.asdict(s))
                                       for s in faults.specs])
        engine = J.PagedServingEngine(jcfg, params_j,
                                      J.EngineConfig(**dataclasses.asdict(ecfg)), plan)
    else:
        engine = T.PagedServingEngine(tcfg, params_t, ecfg, faults, device="cpu")
    workload.serve_tenant_mix(engine, arrivals)
    return engine


def test_tenant_mix_counters_are_the_reference_schedule(dense):
    """The reference engine, on a tiny model with the tenant mix's lengths,
    geometry, policy and fault plan, gives ``TENANT_MIX_COUNTERS``; the
    port's engine gives the same counters and trace, a replay of the plan
    the same again; the ``fcfs`` and ``priority`` runs without faults agree
    on the tokens of every rid completed in two runs."""
    ecfg = workload.TENANT_MIX
    je = _tenant_mix(J, dense, ecfg, workload.tenant_mix_faults())
    c = je.metrics.counters()
    assert {k: c[k] for k in SCHEDULE_KEYS} == workload.TENANT_MIX_COUNTERS
    plan = workload.tenant_mix_faults()
    te = _tenant_mix(T, dense, ecfg, plan)
    _assert_same(je, te)
    replay = _tenant_mix(T, dense, ecfg, plan.replay())
    _assert_same(te, replay)
    assert _errors(te) == {workload.TENANT_MIX_POISONED: "PoisonedRequest"}
    assert any(s["tenant"] == "interactive" for s in c["sheds"])
    runs = [te] + [_tenant_mix(T, dense, dataclasses.replace(ecfg, policy=p), None)
                   for p in ("fcfs", "priority")]
    for a in runs:
        for b in runs:
            for rid, toks in a.results.items():
                if rid not in a.errors and rid not in b.errors and toks and b.results.get(rid):
                    assert b.results[rid] == toks
