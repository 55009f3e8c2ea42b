"""The port's serving control plane against the JAX reference, without an
engine: the fault plan, ``checksum_tree``, the span tracer and its schema
checks, the routing telemetry, ``ServingMetrics`` and the resource
controller's plans.

* ``FaultPlan.generate(seed)`` gives the reference's specs, and one scripted
  ``at_step``/``fire`` sequence the same firings and ``log``;
  ``checksum_tree`` gives the reference's CRC over a nested tree of f32,
  bf16 and uint8 arrays (torch tensors on the port's side), in jax's
  flatten order; ``corrupt_tree`` breaks it and keeps the structure.
* The tracer's level gating, deterministic projection, lifecycle dispatch
  at every level, schema validation and Chrome export, ``gini``, the
  telemetry's gauges and the bit-misallocation report: as
  ``tests/test_trace.py`` holds the reference's, and equal to them.
* ``ServingMetrics``: the reference's ``counters()`` and ``summary()`` keys,
  and equal counters and JSON after one sequence of records.
* ``ResourceController.reconcile`` over the same scheduler and pool state,
  built in both packages (two finished requests' prefixes cached, one
  admission sharing a cached prefix copy-on-write while another entry must
  be evicted, an injected ``pool`` penalty, an overdue waiter): equal
  observations, target states and plans under each policy.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.compressed_moe import BucketMeta as JBucketMeta  # noqa: E402
from repro.runtime.fault_tolerance import HeartbeatTable as JHeartbeatTable  # noqa: E402
from repro.serving import controller as jcontroller  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro.serving.kvcache import PagedKVCache as JCache  # noqa: E402
from repro.serving.metrics import ServingMetrics as JMetrics  # noqa: E402
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as JScheduler  # noqa: E402

from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.core.compressed_moe import BucketMeta as TBucketMeta  # noqa: E402
from repro_torch.runtime.fault_tolerance import HeartbeatTable  # noqa: E402
from repro_torch.serving import controller as tcontroller  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import trace as ttrace  # noqa: E402
from repro_torch.serving.kvcache import PagedKVCache as TCache  # noqa: E402
from repro_torch.serving.metrics import ServingMetrics as TMetrics  # noqa: E402
from repro_torch.serving.scheduler import Request as TRequest  # noqa: E402
from repro_torch.serving.scheduler import Scheduler as TScheduler  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401

PKGS = {"ref": (jfaults, jtrace, JMetrics), "port": (tfaults, ttrace, TMetrics)}


# ------------------------------------------------------------ fault plan
def _drive_plan(plan):
    """One scripted call sequence: steps advance, sites fire with keys."""
    fired = []
    for step in range(0, 30, 3):
        plan.at_step(step)
        for site, key in (("pool", None), ("logits", 1), ("logits", 2), ("swap_out", 3),
                          ("swap_in", 3), ("upload", (0, 1)), ("upload", (1, 2))):
            spec = plan.fire(site, key)
            fired.append(None if spec is None else dataclasses.astuple(spec))
    return fired, list(plan.log), plan.injected


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_fault_plan_generate_and_replay_match_reference(seed):
    kw = dict(n_faults=6, rids=(1, 2, 3), expert_keys=((0, 1), (1, 2)))
    j, t = jfaults.FaultPlan.generate(seed, **kw), tfaults.FaultPlan.generate(seed, **kw)
    assert [dataclasses.astuple(s) for s in t.specs] == [dataclasses.astuple(s) for s in j.specs]
    want = _drive_plan(j)
    assert _drive_plan(t) == want
    assert _drive_plan(t.replay()) == want  # a replay fires the same faults
    persistent = tfaults.FaultPlan.generate(seed, persistent=True, **kw)
    assert [dataclasses.astuple(s) for s in persistent.specs] == [
        dataclasses.astuple(s) for s in jfaults.FaultPlan.generate(seed, persistent=True, **kw).specs]


def test_fault_spec_and_error_types():
    for site, mode in (("disk", "fail"), ("pool", "explode")):
        with pytest.raises(ValueError, match="fault"):
            tfaults.FaultSpec(site=site, mode=mode)
    assert tfaults.FAULT_SITES == jfaults.FAULT_SITES
    assert tfaults.FAULT_MODES == jfaults.FAULT_MODES
    for name in ("RequestCancelled", "DeadlineExceeded", "PoisonedRequest", "ExpertUploadFailed",
                 "SwapFault", "WatchdogTimeout", "LivelockDetected", "InvalidRequest"):
        exc = getattr(tfaults, name)("x", rid=4)
        assert isinstance(exc, tfaults.ServingFault) and exc.rid == 4
    assert isinstance(tfaults.InvalidRequest("x"), ValueError)


def _tree(seed):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf16 = rng.standard_normal((4, 2)).astype(np.float32)
    u8 = rng.integers(0, 256, size=(7,), dtype=np.uint8)
    scalar = np.float32(rng.standard_normal())
    ref = {"zeta": {"codes": jnp.asarray(u8), "skip": None},
           "alpha": [jnp.asarray(f32), (jnp.asarray(bf16, jnp.bfloat16), jnp.asarray(scalar))],
           "mid": jnp.asarray(f32[::-1].copy())}
    port = {"zeta": {"codes": torch.from_numpy(u8), "skip": None},
            "alpha": [torch.from_numpy(f32), (torch.from_numpy(bf16).to(torch.bfloat16),
                                              torch.tensor(scalar))],
            "mid": f32[::-1].copy()}  # a numpy leaf beside the tensors
    return ref, port


@pytest.mark.parametrize("seed", [0, 1])
def test_checksum_tree_matches_reference(seed):
    """Same CRC over the same bytes in jax's flatten order (dict keys
    sorted, ``None`` dropped, bf16 through its raw 16 bits)."""
    ref, port = _tree(seed)
    crc = tfaults.checksum_tree(port)
    assert crc == jfaults.checksum_tree(ref)
    bad = tfaults.corrupt_tree(port)
    assert tfaults.checksum_tree(bad) != crc
    assert tfaults.checksum_tree(port) == crc  # the original is untouched
    assert bad["zeta"]["skip"] is None and isinstance(bad["alpha"][1], tuple)
    assert bad["alpha"][1][0].dtype == torch.bfloat16
    # the first leaf in flatten order (alpha[0]) lost its leading byte
    assert not torch.equal(bad["alpha"][0], port["alpha"][0])
    assert torch.equal(bad["alpha"][1][0], port["alpha"][1][0])
    jbad = jfaults.corrupt_tree(ref)
    assert tfaults.checksum_tree(bad) == jfaults.checksum_tree(jbad)


# ------------------------------------------------------------- tracer
def _drive_tracer(t):
    with t.span("megastep", track="engine", cat="decode", horizon=4):
        t.instant("enqueue", track="queue", cat="lifecycle", rid=1)
    t.instant("page_grow", track="pool", cat="kv", slot=0)
    t.flow("s", 7, track="queue")
    t.counter("pool", track="engine", page_util=0.5, active=3)
    t.complete("prefill_chunk", track="slot1", cat="prefill", start_us=0.0,
               args={"rid": 1, "offset": 0, "tokens": 4, "resume": False, "runs": 1})
    t.flow("f", 7, track="slot1")


@pytest.mark.parametrize("level", ["off", "spans", "full"])
def test_tracer_levels_and_projection_match_reference(level):
    """Level gating, the wall-clock-free projection (only ``ts_us`` and
    ``dur_us`` stripped) and the JSONL equal the reference's."""
    j, t = jtrace.SpanTracer(level), ttrace.SpanTracer(level)
    _drive_tracer(j)
    _drive_tracer(t)
    assert t.deterministic_jsonl() == j.deterministic_jsonl()
    assert [e["ph"] for e in t.events] == {
        "off": [], "spans": ["i", "X", "i", "s", "X", "f"],
        "full": ["i", "X", "i", "s", "C", "X", "f"]}[level]
    assert all("ts_us" in e for e in t.events)
    assert all("ts_us" not in e and "dur_us" not in e for e in t.deterministic_events())
    assert (t.enabled, t.full) == (j.enabled, j.full)
    t.reset()
    assert t.events == []
    with pytest.raises(ValueError, match="trace level"):
        ttrace.SpanTracer("verbose")
    with pytest.raises(ValueError, match="flow phase"):
        ttrace.SpanTracer("spans").flow("x", 1, track="queue")
    assert ttrace.NULL_TRACER.events == []


def _lifecycle(t):
    t.lifecycle("admit", track="slot0", rid=1, slot=0, step=0, active_before=0, queue_depth=1,
                resumed=False, tenant="chat", priority=1, wait_steps=0)
    t.lifecycle("plan", track="pool", step=0, actions=2, admits=1, preempts=0, grows=0,
                prefix_evictions=0, sheds=1, expert_uploads=0)
    t.lifecycle("shed", track="queue", rid=2, step=0, tenant="batch", priority=0, wait_steps=9)
    t.lifecycle("fault", track="pool", site="pool", mode="fail", pages=4, step=0)
    t.lifecycle("fault", track="slot0", site="logits", mode="corrupt", rid=3)
    t.lifecycle("poisoned", track="slot0", rid=3, step=0, tokens=0)
    t.lifecycle("prefix_hit", track="slot0", rid=4, tokens_saved=8, full=True)
    t.lifecycle("prefix_miss", track="slot0", rid=5)
    t.lifecycle("cow_copy", track="pool", rid=4, src_page=1, dst_page=2)
    t.lifecycle("cancel", track="queue", rid=6, step=3, tokens=0)
    t.lifecycle("deadline", track="slot1", rid=7, step=3, tokens=2)
    t.lifecycle("release", track="slot0", rid=1, slot=0, step=5)
    t.lifecycle("enqueue", track="queue", rid=8)  # carries no metric state


@pytest.mark.parametrize("level", ["off", "spans"])
def test_lifecycle_feeds_metrics_at_every_level(level):
    """Metrics book-keep through the lifecycle stream at every level, to
    the reference's counters."""
    got = {}
    for name, (_, trace, metrics) in PKGS.items():
        m = metrics()
        _lifecycle(trace.SpanTracer(level, consumers=(trace.MetricsConsumer(lambda: m),)))
        got[name] = m.counters()
    assert got["port"] == got["ref"]
    assert got["port"]["plans"] == 1 and got["port"]["faults_by_site"] == {"logits": 1, "pool": 1}
    assert got["port"]["cow_copies"] == 1 and got["port"]["poisoned"] == 1


def _docs():
    """Documents both validators must accept or refuse alike."""
    ok = {"ph": "i", "name": "a", "cat": "c", "track": "t", "seq": 0, "ts_us": 0.0, "args": {}}
    return [
        [ok],
        [ok, dict(ok, seq=0)],  # seq not increasing
        [dict(ok, ph="s", name="request")],  # flow without an id
        [dict(ok, ph="X")],  # no dur_us
        [dict(ok, ph="X", dur_us=-1.0)],
        [dict(ok, args={"x": [1]})],  # a non-scalar arg
        [dict(ok, ph="Q")],
        [{k: v for k, v in ok.items() if k != "ts_us"}],
    ]


def test_schema_validation_matches_reference():
    for doc in _docs():
        outcomes = []
        for validate in (jtrace.validate_events, ttrace.validate_events):
            try:
                outcomes.append(validate(doc))
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
    t = ttrace.SpanTracer("full")
    _drive_tracer(t)
    assert ttrace.validate_events(t.events) == 7
    doc = t.chrome_trace(extra={"note": "x"})
    assert ttrace.validate_chrome_trace(doc) == jtrace.validate_chrome_trace(doc) > 7
    assert doc["otherData"] == {"note": "x"}
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert names == {"engine", "queue", "pool", "slot1"}
    for bad in ({"events": []}, {"traceEvents": [{"ph": "i", "name": "a", "pid": 1}]},
                {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 1, "ts": 0.0}]}):
        with pytest.raises(ValueError):
            ttrace.validate_chrome_trace(bad)
        with pytest.raises(ValueError):
            jtrace.validate_chrome_trace(bad)


def test_trace_cli_validates_files(tmp_path):
    t = ttrace.SpanTracer("spans")
    _drive_tracer(t)
    t.write_jsonl(str(tmp_path / "a.jsonl"))
    t.write_jsonl(str(tmp_path / "det.jsonl"), deterministic=True)
    t.write_chrome(str(tmp_path / "a.trace.json"))
    assert ttrace.main([str(tmp_path / "a.jsonl"), str(tmp_path / "a.trace.json")]) == 0
    # the deterministic projection has no wall clock: the schema refuses it
    assert ttrace.main([str(tmp_path / "det.jsonl")]) == 1
    (tmp_path / "bad.json").write_text("{}")
    assert ttrace.main([str(tmp_path / "bad.json")]) == 1


# ---------------------------------------------------------- telemetry
def test_gini_matches_reference():
    for x in ([], [0, 0, 0], [5, 5, 5, 5], [0, 0, 0, 12], [1, 2, 3, 4], [3, 0, 9, 1, 1]):
        assert ttrace.gini(x) == jtrace.gini(x)
    assert ttrace.gini([0, 0, 0, 12]) == pytest.approx(0.75)


def _routing_steps():
    rng = np.random.default_rng(3)
    steps = [np.array([[2, 2, 2, 2], [3, 3, 3, 3]]), np.array([[4, 0, 0, 0], [0, 0, 0, 4]]),
             np.zeros((2, 4), np.int64), np.zeros((2, 0), np.int64)]
    steps += [rng.integers(0, 6, size=(2, 4)) for _ in range(5)]
    return steps


def test_routing_telemetry_and_report_match_reference():
    j, t = jtrace.ExpertRoutingTelemetry(0.5), ttrace.ExpertRoutingTelemetry(0.5)
    jm = (JBucketMeta(1, 0, 1), JBucketMeta(2, 1, 2), JBucketMeta(3, 3, 1))
    tm = tuple(TBucketMeta(m.bits, m.start, m.count) for m in jm)
    assert t.bit_misallocation_report(tm) is None
    for counts in _routing_steps():
        assert t.update(counts) == j.update(counts)
    assert t.steps == j.steps and np.array_equal(t.hist, j.hist)
    report = t.bit_misallocation_report(tm)
    assert json.dumps(report, sort_keys=True) == json.dumps(
        j.bit_misallocation_report(jm), sort_keys=True)
    assert report["bits_per_slot"] == [1, 2, 2, 3]


# ------------------------------------------------------------- metrics
def _record(m):
    m.record_admission(0, 1, 0, 0, 3, tenant="chat", priority=1, wait_steps=0)
    m.record_admission(1, 0, 4, 1, 2, resumed=True)
    m.record_shed(2, 4, tenant="batch", wait_steps=9)
    m.record_plan(3, admits=2, sheds=1, grows=0)
    m.record_tenant_tokens("chat", 5)
    m.record_tenant_tokens("batch", 0)
    m.record_ttft(0.5, 0.25, tenant="chat")
    m.record_prefill_runs(1)
    m.record_megastep(3, 0.1, 0.0, 1, 1)
    for n in (2, 2, 1):
        m.record_decode_step(0.03, n, 0.75, 1, page_utilization=1.0 - 3 / 7)
    m.record_decode_step(0.03, 1, 0.5, 0)  # no pool gauge: skipped, not 0.0
    m.record_capacity_utilization(0.1875)
    m.record_release(0, 1, 6)
    m.record_prefix_hit(8, full=True)
    m.record_prefix_miss()
    m.record_cow_copy()
    for site in ("pool", "logits", "pool"):
        m.record_fault(site)
    m.record_cancel()
    m.record_deadline()
    m.record_poisoned()


def test_serving_metrics_match_reference():
    j, t = JMetrics(), TMetrics()
    assert list(t.counters()) == list(j.counters())
    assert list(t.summary()) == list(j.summary())
    _record(j)
    _record(t)
    assert t.counters() == j.counters()
    assert t.to_json(include_counters=False) != ""
    got, want = json.loads(t.to_json(True)), json.loads(j.to_json(True))
    assert got["counters"] == want["counters"]
    assert set(got["summary"]) == set(want["summary"])
    for key in ("sheds", "plans", "tenant_tokens", "poisoned", "generated_tokens",
                "page_util_mean", "mid_flight_admissions", "readmissions"):
        assert got["summary"][key] == want["summary"][key], key
    assert t.counters()["page_utilization"] == [1.0 - 3 / 7] * 3


def test_heartbeat_table_matches_reference():
    clock = iter(range(0, 1000, 5))
    for table in (HeartbeatTable(["megastep", "h1"], timeout=10.0, clock=lambda: next(clock)),
                  JHeartbeatTable(["megastep", "h1"], timeout=10.0, clock=lambda: 0.0)):
        table.beat("megastep", now=100.0)
        table.beat("h1", now=95.0)
        assert table.failed(now=106.0) == ["h1"]
        assert table.alive(now=106.0) == ["megastep"]
        assert table.failed(now=111.0) == ["megastep", "h1"]


# ---------------------------------------------------------- controller
CFG = dict(name="tiny-ctl", family="dense", num_layers=1, d_model=16, num_heads=1,
           num_kv_heads=1, head_dim=8, d_ff=16, vocab_size=64, dtype="float32", remat="none")
WEIGHTS = {"batch": 1.0, "chat": 2.0, "interactive": 4.0}
BS = 4


def _prompts():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 64, size=8).astype(np.int32)
    g = rng.integers(0, 64, size=6).astype(np.int32)
    return {
        "A": (a, 4, "batch", 0), "G": (g, 2, "chat", 1),
        "B": (rng.integers(0, 64, size=6).astype(np.int32), 2, "chat", 1),
        # D shares A's two cached pages (8 tokens, a page-aligned full hit
        # demoted to A[:8] of a longer prompt) and needs 2 fresh pages
        "D": (np.concatenate([a, rng.integers(0, 64, size=4)]).astype(np.int32), 4, "chat", 1),
        "E": (rng.integers(0, 64, size=10).astype(np.int32), 6, "batch", 0),
        "F": (rng.integers(0, 64, size=3).astype(np.int32), 2, "interactive", 2),
    }


def _world(pkg, policy, penalty, reserve_full=True):
    """The same pool, scheduler and controller state built in one package:
    A and G served and finished (their prefixes cached), B running, and
    D, E, F waiting, E since step 0 (overdue at step 6 with a budget of 4).
    With page growth (``reserve_full=False``) B asks for 8 new tokens and
    has emitted 3, so its next megastep's writes need a third page."""
    if pkg == "ref":
        cache = JCache.create(JModelConfig(**CFG), num_blocks=9, block_size=BS, max_slots=3,
                              max_blocks_per_slot=6, prefix_cache=True)
        sched_cls, req_cls, ctl, faults, logits = (
            JScheduler, JRequest, jcontroller, jfaults, np.arange(3, dtype=np.float32))
    else:
        cache = TCache(TModelConfig(**CFG), num_blocks=9, block_size=BS, max_slots=3,
                       max_blocks_per_slot=6, device="cpu", prefix_cache=True)
        sched_cls, req_cls, ctl, faults, logits = (
            TScheduler, TRequest, tcontroller, tfaults, torch.arange(3, dtype=torch.float32))
    sched = sched_cls(cache, reserve_full=reserve_full, horizon=2, policy=policy,
                      tenant_weights=WEIGHTS)
    plan = faults.FaultPlan([faults.FaultSpec(site="pool", arg=penalty)] if penalty else [])
    controller = ctl.ResourceController(sched, ttft_budget_steps=4, faults=plan)
    reqs = {name: req_cls(rid=i, prompt=p, max_new=m, tenant=t, priority=pr)
            for i, (name, (p, m, t, pr)) in enumerate(_prompts().items())}
    for name in ("A", "G", "B"):
        sched.submit(reqs[name], 0)
        req = sched.try_admit(0)
        cache.register_prefix(req.prompt, req.slot, last_logits=logits)
    sched.finish(reqs["A"].slot)
    sched.finish(reqs["G"].slot)
    if not reserve_full:
        b = reqs["B"]
        b.max_new, b.out, b.pos = 8, [5, 6, 7], len(b.prompt) + 2
    sched.submit(reqs["E"], 0)
    for name in ("D", "F"):
        sched.submit(reqs[name], 5)
    sched.refresh_grants()
    sched.note_tokens("chat", 3)
    return controller


def _snapshot(controller, step):
    obs = controller.observe(step)
    target, actions = controller.reconcile(obs)
    view = (obs.free_pages, obs.free_slot_count, sorted(obs.refcounts.items()),
            sorted(obs.slot_pages.items()),
            [(e.key, e.pages, e.n_tokens, e.has_logits) for e in obs.prefix_entries],
            [r.rid for r in obs.waiting], obs.tenants, obs.deficits, obs.pool_penalty)
    return view, dataclasses.astuple(target), [dataclasses.astuple(a) for a in actions]


@pytest.mark.parametrize("penalty", [0, 3])
@pytest.mark.parametrize("policy", ["fcfs", "priority", "fair"])
def test_reconcile_matches_reference(policy, penalty):
    want = _snapshot(_world("ref", policy, penalty), 6)
    got = _snapshot(_world("port", policy, penalty), 6)
    assert got == want
    kinds = [a[0] for a in got[2]]
    assert got[0][-1] == penalty  # the pool fault fired into the observation
    if policy == "fcfs":  # E heads the queue: LRU evictions free its 4 pages
        assert kinds == ["evict_prefix", "admit"]
    elif penalty:  # hidden pages defer D; the overdue E is shed
        assert kinds == ["admit", "shed"]
    else:  # F, then D on A's protected pages while G's entry is evicted
        assert kinds == ["admit", "evict_prefix", "admit", "shed"]
        assert got[2][1][5] == (0, 1)


@pytest.mark.parametrize("penalty", [0, 3])
@pytest.mark.parametrize("policy", ["fcfs", "priority", "fair"])
def test_reconcile_with_growth_matches_reference(policy, penalty):
    """The same world with page growth: admissions reserve the context and
    the next megastep's writes, and phase 1 grows B horizon-ahead before
    anything is admitted; the port plans exactly what the reference plans."""
    want = _snapshot(_world("ref", policy, penalty, reserve_full=False), 6)
    got = _snapshot(_world("port", policy, penalty, reserve_full=False), 6)
    assert got == want
    kinds = [a[0] for a in got[2]]
    assert kinds[0] == "grow" and got[2][0][4] == 1  # one page for B
    assert kinds.count("grow") == 1
