"""The port's host-offloaded PMQ expert buckets against the JAX reference's:
miss replay, EMA prefetch, async uploads, the disk → host → device tier
store and the ``upload`` fault site.

Two models, each built once by the reference and carried into the port byte
for byte: ``test_offload.py``'s ``TINY_MOE`` compressed by its
``compress_for_serving`` (buckets of 1/2/2/3 bits, group 32, fp attention),
and ``test_serving_sim.py``'s ``TINY_MOE`` compressed with bits 2/2/3/3 (its
``compressed_moe_model``). Held against the reference, exactly: greedy
tokens, the typed ``errors``, ``metrics.counters()`` and, at trace level
``full``, ``deterministic_jsonl()``, on

* ``test_offload.py``'s budget sweep and forced miss (``:179``, ``:201``), the
  composition with preemption (``:224``, ``:349``), the horizons (``:286``),
  the megastep replay counts (``:307``), the grow (``:263``), async streaming
  and the tier store;
* ``test_trace.py:246`` (budget 2 at H 1, budget 4 at H 4) and ``:324``;
* ``test_serving_sim.py:963-1060``: transient upload faults (the same fault
  log), fail-closed without degradation, and the degraded-row oracle.

The wider sweeps run the offloaded port against the all-resident port (sync
and async). ``_split_budget``, ``degrade_expert_row``, ``residency_targets``
and upload bytes are byte-identical to the reference's, and each package
reopens the other's tier-store directory with equal rows and CRCs.
"""
import contextlib
import dataclasses
import functools
import json
import shutil
import types
import warnings

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as J  # noqa: E402
from repro.core.packing import pack_bits as jpack_bits  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402
from repro.serving.offload import degrade_expert_row as jdegrade  # noqa: E402
from repro.serving.tierstore import TieredExpertStore as JStore  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401
from test_offload import ECFG, TINY_MOE, compress_for_serving, make_requests  # noqa: E402
import test_serving_sim as sim  # noqa: E402
import test_torch_serving_control as control  # noqa: E402

#: every event recorded, so the deterministic JSONL is compared too
FULL = dict(trace_level="full")


#: (config, PMQ bits per expert) of the models: ``test_offload.py``'s, the
#: same widths with 16 experts (a decode step's working set fits the budget
#: without growing it to the bucket, so the EMA prefetch and the async
#: batches have work), and ``test_serving_sim.py``'s ``compressed_moe_model``
MODELS = {
    "offload": (TINY_MOE, [1, 2, 2, 3]),
    "wide": (dataclasses.replace(TINY_MOE, name="tiny-offload-moe16", num_experts=16),
             [1] * 4 + [2] * 8 + [3] * 4),
    "sim": (sim.TINY_MOE, [2, 2, 3, 3]),
}


@functools.lru_cache(maxsize=None)
def _model(name):
    """(reference cfg, port cfg, reference params, port params)."""
    cfg, bits = MODELS[name]
    params_j = compress_for_serving(cfg, jget_model(cfg).init(jax.random.PRNGKey(0)), bits=bits)
    flat, meta = flatten_reference(params_j)
    params_t = interop.params_from_reference(flat, meta, device="cpu")
    return cfg, TModelConfig(**dataclasses.asdict(cfg)), params_j, params_t


@pytest.fixture(scope="module")
def tiny():
    return _model("offload")


@pytest.fixture(scope="module")
def wide():
    return _model("wide")


@pytest.fixture(scope="module")
def simm():
    return _model("sim")


def _ecfg(pkg, **kw):
    """``test_offload.py``'s ECFG with ``kw``, as ``pkg``'s EngineConfig."""
    fields = {f.name: getattr(ECFG, f.name) for f in dataclasses.fields(T.EngineConfig)}
    return pkg.EngineConfig(**{**fields, **kw})


def _engine(pkg, m, faults=None, **kw):
    jcfg, tcfg, params_j, params_t = m
    if pkg is J:
        return J.PagedServingEngine(jcfg, params_j, _ecfg(J, **kw), faults)
    return T.PagedServingEngine(tcfg, params_t, _ecfg(T, **kw), faults, device="cpu")


def _requests(pkg, reqs):
    return [pkg.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new) for r in reqs]


def _serve(pkg, m, req_args, **kw):
    eng = _engine(pkg, m, **kw)
    eng.serve(_requests(pkg, make_requests(m[0], *req_args[:2], **req_args[2])))
    return eng


def _both(m, req_args, **kw):
    """``make_requests(cfg, *req_args)`` on the reference and the port with
    the same engine settings; asserts they agree, returns both engines."""
    je, te = (_serve(pkg, m, req_args, **kw) for pkg in (J, T))
    control._assert_same(je, te, jsonl=kw.get("trace_level") in ("spans", "full"))
    return je, te


def _args(n, seed, **kw):
    return (n, seed, kw)


# -------------------------------------------------------- against the reference
def test_budget_sweep_and_forced_miss_match_reference(tiny):
    """``test_offload.py:179`` and ``:201``: budget 3 of 4 slots forces misses
    and replays; the tokens are the all-resident engine's."""
    je, te = _both(tiny, _args(3, 0), resident_experts=3, **FULL)
    base = _serve(T, tiny, _args(3, 0))
    assert te.results == base.results and base.offload is None
    m = te.metrics.summary()
    assert m["expert_prefetch_misses"] >= 1 and m["expert_miss_uploads"] >= 1
    assert m["expert_upload_bytes"] > 0
    assert m["expert_resident_bytes_last"] == te.offload.resident_bytes
    assert te.offload.resident_bytes == je.offload.resident_bytes
    assert te.offload.host_bytes == je.offload.host_bytes
    full = _serve(T, tiny, _args(3, 0), resident_experts=4).metrics.summary()
    assert full["expert_prefetch_misses"] == 0 and full["expert_hit_rate"] == 1.0


@pytest.mark.parametrize("case", ["preempt", "preempt_horizon"])
def test_offload_with_preemption_matches_reference(tiny, case):
    """``test_offload.py:224`` and ``:349``: offload and KV preemption at once
    (``:349`` with H = 4)."""
    if case == "preempt":
        geo = dict(max_slots=3, num_blocks=6, max_blocks_per_slot=4, preempt_mode="swap",
                   resident_experts=3)
        args, roomy = _args(3, 2, max_new=8, plen=3), dict(max_slots=3, num_blocks=16,
                                                           max_blocks_per_slot=4)
    else:
        geo = dict(max_slots=3, num_blocks=7, max_blocks_per_slot=6, preempt_mode="swap",
                   resident_experts=3, decode_horizon=4)
        args, roomy = _args(3, 2, max_new=16, plen=3), dict(max_slots=3, num_blocks=24,
                                                            max_blocks_per_slot=6)
    _, te = _both(tiny, args, **geo, **FULL)
    assert te.metrics.summary()["preemptions"] >= 1
    assert te.results == _serve(T, tiny, args, **roomy).results


def test_horizon_and_grow_match_reference(tiny):
    """``test_offload.py:286`` at H = 4 and ``:263``'s budget below the
    working set (clamped to 3, then grown)."""
    _, te = _both(tiny, _args(3, 1, max_new=7), resident_experts=3, decode_horizon=4, **FULL)
    assert te.results == _serve(T, tiny, _args(3, 1, max_new=7)).results
    with pytest.warns(RuntimeWarning, match="clamped"):
        _, te = _both(tiny, _args(2, 3), resident_experts=1)
    assert te.offload.grows >= 1
    assert all(r <= m.count for r, m in zip(te.offload.budgets, te.offload.meta))
    # every layer's experts view the grown partitions
    assert all(ce.resident_rows == tuple(te.offload.budgets) for ce in te.offload.ces)


def test_megastep_replay_counts_match_reference(tiny):
    """``test_offload.py:307``: bucket b1 force-evicted after prefill and the
    controller's prefetch off, so the megasteps miss inside the horizon and
    replay whole."""
    engines = []
    for pkg in (J, T):
        eng = _engine(pkg, tiny, resident_experts=3, decode_horizon=4, **FULL)
        for r in _requests(pkg, make_requests(tiny[0], 2, 0, max_new=6)):
            eng.submit(r)
        eng._converge()
        eng.offload.slot_row["b1"][:, :] = -1
        eng.offload.row_slot["b1"][:, :] = -1
        eng.controller.offload = None
        eng.run()
        engines.append(eng)
    je, te = engines
    control._assert_same(je, te)
    assert te.results == _serve(T, tiny, _args(2, 0, max_new=6), decode_horizon=4).results
    c = te.metrics.counters()
    assert c["expert_prefetch_misses"] >= 1 and c["decode_replays"] >= 1
    assert c["decode_dispatches"] == c["megasteps"] + c["decode_replays"]
    assert c["decode_dispatches"] <= c["megasteps"] * (1 + 4 * tiny[0].num_layers)
    s = te.metrics.summary()
    assert s["decode_offload_mean_s"] > 0.0 and s["decode_compute_mean_s"] > 0.0


@pytest.mark.parametrize("budget,horizon", [(2, 1), (4, 4)])
def test_trace_determinism_offloaded_matches_reference(tiny, budget, horizon):
    """``test_trace.py:246``: the offloaded engine's projection at level
    ``full`` (miss replays, EMA prefetch, grows)."""
    ctx = pytest.warns(RuntimeWarning) if budget < 3 else contextlib.nullcontext()
    with ctx:
        _, te = _both(tiny, _args(3, 11), resident_experts=budget, decode_horizon=horizon,
                      **FULL)
    assert T.validate_events(te.tracer.events) == len(te.tracer.events)


def test_upload_spans_and_replays_match_reference(tiny):
    """``test_trace.py:324``: budget 2 at H = 2 surfaces miss uploads with
    kind and bytes, replay spans and the routing gauges."""
    with pytest.warns(RuntimeWarning):
        _, te = _both(tiny, _args(3, 11), resident_experts=2, decode_horizon=2, **FULL)
    ev = te.tracer.events
    ups = [e for e in ev if e["name"] == "expert_upload"]
    assert ups and any(e["args"]["kind"] == "miss" for e in ups)
    assert all(e["args"]["kind"] in ("miss", "prefetch") and e["args"]["bytes"] > 0
               for e in ups)
    assert any(e["name"] == "replay" for e in ev)
    assert any(e["name"] == "routing" and e["ph"] == "C" for e in ev)


def test_prefetch_async_and_tiers_match_reference(wide, tmp_path):
    """On the 16-expert model at budget 8 (buckets of 2/4/2 rows of 4/8/4, no
    grow on this trace):
    the tiered store (disk spill, a host row cache of 24 KiB) executing the
    controller's EMA prefetch at each boundary, and the same plans staged
    after the next dispatch and committed or dropped as stale
    (``async_offload``) — each run's tokens, counters and trace are the
    reference's, and its tokens the all-resident port's."""
    args = _args(3, 2, max_new=6)
    base = _serve(T, wide, args).results
    dirs = [tmp_path / "j", tmp_path / "t"]
    engines = [_serve(pkg, wide, args, resident_experts=8, offload_dir=str(d),
                      host_expert_bytes=24576, **FULL)
               for pkg, d in zip((J, T), dirs)]
    control._assert_same(*engines)
    te = engines[1]
    assert te.offload.host is None and te.offload.store.host_cached_bytes <= 24576
    c = te.metrics.counters()
    assert min(c["tier_disk_hits"], c["tier_host_hits"], c["tier_disk_bytes"],
               c["expert_prefetch_uploads"]) >= 1
    assert te.results == base
    assert te.results == _serve(T, wide, args, resident_experts=8).results
    _assert_same_spill(*dirs)
    _, te = _both(wide, args, resident_experts=8, async_offload=True, **FULL)
    c = te.metrics.counters()
    assert min(c["uploads_overlapped"], c["uploads_committed"], c["uploads_dropped_stale"]) >= 1
    assert te.results == base


@pytest.mark.parametrize("budget,horizon,seed", [(2, 1, 0), (2, 4, 1), (3, 4, 0)])
def test_transient_upload_faults_match_reference(simm, budget, horizon, seed):
    """``test_serving_sim.py:963``: transient upload faults (corrupt payloads
    caught by the row CRC and re-fetched, I/O failures within the retry
    budget) give the reference's fault log, counters and trace, and the
    fault-free offloaded run's tokens."""
    trace = sim._offload_trace(50 + seed, horizon)
    plan = J.FaultPlan.generate(70 + seed, n_faults=6, max_step=10, sites=("upload",),
                                max_count=2)
    kw = dict(resident_experts=budget, reserve_full=False, **FULL)
    te = control._both(simm, trace, list(plan.specs), **kw)
    free = control._run(T, simm, trace, None, resident_experts=budget, reserve_full=False)
    assert te.errors == {} and te.results == free.results
    c = te.metrics.counters()
    assert c["fault_injected"] >= 1 and c["upload_retries"] >= 1 and c["degraded_serves"] == 0


def test_persistent_upload_fail_fails_closed_like_reference(simm):
    """``test_serving_sim.py:1009``: with degradation off a row whose upload
    keeps failing fails the engine closed with ``ExpertUploadFailed``, every
    live request ends with a typed error and the pool drains clean."""
    trace = sim._offload_trace(5, 1)
    seen = []
    for pkg in (J, T):
        plan = pkg.FaultPlan([pkg.FaultSpec(site="upload", mode="fail", count=-1)])
        eng = control._engine(pkg, simm, trace, plan, resident_experts=2,
                              reserve_full=False, **FULL)
        for r in control._requests(pkg, trace, simm[0].vocab_size):
            eng.submit(r)
        with pytest.raises(pkg.ExpertUploadFailed):
            for _ in range(sim.MAX_TICKS):
                if not eng.step():
                    break
        assert eng.errors and all(isinstance(e, pkg.ServingFault) for e in eng.errors.values())
        control._assert_drained_clean(eng, trace.pool_blocks, trace.max_slots)
        seen.append((control._errors(eng), eng.metrics.counters(), plan.log,
                     eng.tracer.deterministic_jsonl()))
    assert seen[0] == seen[1]


def test_degraded_rows_match_reference_and_oracle(simm):
    """``test_serving_sim.py:1029``: the never-resident 2-bit row (global slot
    1) fails persistently in every layer with ``degrade_experts=True``; it is
    served 1-bit snapped, as by the reference, and the run equals an oracle
    engine whose params carry exactly that degraded row."""
    cfg = simm[0]
    target = 1
    specs = [J.FaultSpec(site="upload", mode="fail", key=(l, target), count=-1)
             for l in range(cfg.num_layers)]
    trace = sim._offload_trace(9, 4)
    te = control._both(simm, trace, specs, resident_experts=3, degrade_experts=True,
                       reserve_full=False, **FULL)
    off = te.offload
    assert te.errors == {} and off.degraded
    assert set(off.degraded) <= {(l, target) for l in range(cfg.num_layers)}
    assert all(v == (2, 1) for v in off.degraded.values())
    assert te.metrics.counters()["degraded_serves"] >= 1
    rep = te.routing_report()
    assert {(d["layer"], d["slot"]) for d in rep["degraded_experts"]} == set(off.degraded)
    # the oracle: the degraded row baked into the port's host params
    _, tcfg, _, params_t = simm
    layers = []
    for l, p in enumerate(params_t["layers"]):
        ce = p["moe_ce"]
        arrays = {bk: {w: {k: t.clone() for k, t in parts.items()} for w, parts in b.items()}
                  for bk, b in ce.arrays.items()}
        row = {w: {k: t[target].numpy() for k, t in parts.items()}
               for w, parts in arrays["b0"].items()}
        for w, parts in T.degrade_expert_row(row, 2, 1).items():
            for k, a in parts.items():
                arrays["b0"][w][k][target] = torch.from_numpy(a)
        layers.append(dict(p, moe_ce=dataclasses.replace(ce, arrays=arrays)))
    oracle_m = (simm[0], tcfg, None, dict(params_t, layers=layers))
    oracle = control._run(T, oracle_m, trace, None, resident_experts=3, reserve_full=False)
    assert te.results == oracle.results


def test_engine_offload_settings(tiny):
    """The reference's seven offload fields with its defaults, and its
    ``ValueError``s: offload without PMQ params, async or tiered without a
    budget."""
    names = ("resident_experts", "prefetch_ema", "async_offload", "offload_dir",
             "host_expert_bytes", "degrade_experts", "upload_max_retries")
    assert {n: getattr(T.EngineConfig(), n) for n in names} == \
        {n: getattr(J.EngineConfig(), n) for n in names} == \
        dict(zip(names, (None, 0.8, False, None, None, False, 3)))
    moe = control._model("moe")
    with pytest.raises(ValueError, match="PMQ"):
        T.PagedServingEngine(moe[1], moe[3], T.EngineConfig(resident_experts=2), device="cpu")
    for kw in ({"async_offload": True}, {"offload_dir": "/nonexistent"}):
        with pytest.raises(ValueError, match="require resident_experts"):
            _engine(T, tiny, **kw)
    with pytest.raises(ValueError, match="already host-offloaded"):
        T.ExpertOffloadManager(_engine(T, tiny, resident_experts=3).offload.ces,
                               resident_slots=3)
    with pytest.raises(ValueError, match="one CompressedExperts per layer"):
        T.ExpertOffloadManager(tiny[3]["layers"][0]["moe_ce"], resident_slots=3)


# --------------------------------------------------- the port against itself
@pytest.mark.parametrize("seed", range(6))
def test_offloaded_port_matches_all_resident_port(tiny, seed):
    """Random traces, budgets and horizons, sync and async: the offloaded
    port's tokens are the all-resident port's."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(2, 5))
    args = _args(n, 200 + seed, max_new=int(rng.integers(3, 9)), plen=int(rng.integers(3, 9)))
    horizon = int(rng.choice([1, 2, 4, 8]))
    base = _serve(T, tiny, args, decode_horizon=horizon).results
    budget = int(rng.integers(3, 5))
    for async_offload in (False, True):
        eng = _serve(T, tiny, args, decode_horizon=horizon, resident_experts=budget,
                     async_offload=async_offload)
        assert eng.results == base, (budget, horizon, async_offload)
        c = eng.metrics.counters()
        assert c["decode_dispatches"] == c["megasteps"] + c["decode_replays"]


def test_async_issue_commit_and_stale_drop(tiny):
    """``test_offload.py``'s async units on the port: an issue stages without
    touching the live tables, a commit flips them; a miss upload between
    issue and commit drops the batch whole."""
    ces = [p["moe_ce"] for p in tiny[3]["layers"]]
    mgr = T.ExpertOffloadManager(ces, resident_slots=3, ema_decay=0.5)
    counts = np.zeros((2, mgr.num_slots), np.int64)
    counts[:, 2] = 5
    mgr.update_stats(counts)
    targets = mgr.residency_targets()
    ups, nbytes = mgr.issue_async(targets)
    assert ups >= 1 and nbytes > 0 and mgr.resident_slots_of(0)["b1"] == {0}
    assert mgr.issue_async(targets) == (0, 0)
    committed, dropped, cbytes, wait_s = mgr.commit_async()
    assert (committed, dropped, cbytes) == (ups, 0, nbytes) and wait_s >= 0.0
    assert mgr.resident_slots_of(0)["b1"] == {1} and mgr.residency_targets() == ()
    assert mgr.commit_async() == (0, 0, 0, 0.0)
    _assert_rows_resident(mgr, ces)
    mgr = T.ExpertOffloadManager(ces, resident_slots=3, ema_decay=0.5)
    mgr.update_stats(counts)
    ups, _ = mgr.issue_async(mgr.residency_targets())
    miss = np.zeros((4, mgr.num_slots), np.int64)
    miss[0, 2] = 1
    assert mgr.ensure_resident(miss)[0] >= 1
    assert mgr.commit_async() == (0, ups, 0, 0.0)
    assert 1 in mgr.resident_slots_of(0)["b1"]
    _assert_rows_resident(mgr, ces)


def _assert_rows_resident(mgr, ces):
    """Every resident slot's row of the device partitions holds its weights,
    and every layer's map points at it."""
    for l, ce in enumerate(ces):
        for bk in mgr.slot_row:
            rmap = mgr.ces[l].resident_map[bk]
            for s, r in enumerate(mgr.slot_row[bk][l]):
                if r < 0:
                    continue
                assert int(rmap[s]) == r
                for name, parts in ce.arrays[bk].items():
                    for key, t in parts.items():
                        assert torch.equal(mgr.ces[l].arrays[bk][name][key][r], t[s])


# ------------------------------------------------------ byte-identical pieces
def test_split_budget_is_the_reference(tiny):
    for counts in ([1, 2, 1], [2, 2], [6, 50, 8], [1, 59, 4], [3], [10, 1, 1, 20]):
        n = sum(counts)
        me = types.SimpleNamespace(meta=[types.SimpleNamespace(count=c) for c in counts],
                                   num_slots=n)
        for budget in range(0, n + 3):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the clamp warning, tested elsewhere
                assert T.ExpertOffloadManager._split_budget(me, budget) == \
                    J.ExpertOffloadManager._split_budget(me, budget), (counts, budget)


@pytest.mark.parametrize("bits,to_bits", [(2, 1), (3, 2), (4, 2)])
def test_degrade_expert_row_is_the_reference(bits, to_bits):
    rng = np.random.default_rng(bits)
    row = {}
    for name, (k, n) in (("w_gate", (64, 24)), ("w_up", (64, 24)), ("w_down", (32, 40))):
        q = rng.integers(0, 1 << bits, size=(k, n)).astype(np.uint8)
        packed = jpack_bits(q, bits, axis=0)
        parts = ({"hi": np.asarray(packed[0]), "lo": np.asarray(packed[1])} if bits == 3
                 else {"data": np.asarray(packed)})
        parts.update(scale=rng.normal(size=(k // 32, n)).astype(np.float32),
                     zero=rng.normal(size=(k // 32, n)).astype(np.float32))
        row[name] = parts
    got, want = T.degrade_expert_row(row, bits, to_bits), jdegrade(row, bits, to_bits)
    assert set(got) == set(want)
    for name in want:
        assert set(got[name]) == set(want[name])
        for key, a in want[name].items():
            b = got[name][key]
            assert b.dtype == np.asarray(a).dtype and b.tobytes() == np.asarray(a).tobytes()
    with pytest.raises(ValueError):
        T.degrade_expert_row(row, bits, bits)


def test_residency_targets_and_upload_bytes_are_the_reference(tiny):
    """After the same EMAs, both managers want the same slots, place them in
    the same rows and upload the same bytes."""
    _, _, params_j, params_t = tiny
    jm = J.ExpertOffloadManager(params_j["blocks"]["moe_ce"], resident_slots=3, ema_decay=0.5)
    tm = T.ExpertOffloadManager([p["moe_ce"] for p in params_t["layers"]], resident_slots=3,
                                ema_decay=0.5)
    rng = np.random.default_rng(0)
    for step in range(6):
        counts = rng.integers(0, 4, size=(2, tm.num_slots))
        for mgr in (jm, tm):
            mgr.update_stats(counts)
        assert tm.residency_targets() == jm.residency_targets()
        assert tm.prefetch() == jm.prefetch()
        for bk in jm.slot_row:
            assert np.array_equal(tm.slot_row[bk], jm.slot_row[bk])
            assert np.array_equal(tm.row_slot[bk], jm.row_slot[bk])
    assert tm.resident_bytes == jm.resident_bytes


# ------------------------------------------------------ the tier-store format
def _spill_dirs(tiny, tmp_path):
    _, _, params_j, params_t = tiny
    jm = J.ExpertOffloadManager(params_j["blocks"]["moe_ce"], resident_slots=3)
    tm = T.ExpertOffloadManager([p["moe_ce"] for p in params_t["layers"]], resident_slots=3)
    dj, dt = tmp_path / "ref", tmp_path / "port"
    JStore(jm.host, offload_dir=str(dj))
    T.TieredExpertStore(tm.host, offload_dir=str(dt))
    return jm.host, dj, dt


def _assert_same_spill(dj, dt):
    """The two spill directories hold the same files, byte for byte."""
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    for name in names:
        if name == "manifest.json":
            assert json.loads((dj / name).read_text()) == json.loads((dt / name).read_text())
        else:
            assert (dj / name).read_bytes() == (dt / name).read_bytes(), name


def test_tier_store_format_both_ways(tiny, tmp_path):
    """The port's spill is read by the reference's ``reopen`` and the
    reference's by the port's, with equal rows and CRCs; the files are the
    same bytes."""
    host, dj, dt = _spill_dirs(tiny, tmp_path)
    _assert_same_spill(dj, dt)
    for reader, d in ((JStore, dt), (T.TieredExpertStore, dj)):
        st = reader.reopen(str(d))
        other = (T.TieredExpertStore if reader is JStore else JStore).reopen(str(d))
        for bk, tree in host.items():
            leaves = jax.tree.leaves(tree)
            for l in range(leaves[0].shape[0]):
                for s in range(leaves[0].shape[1]):
                    want = jax.tree.map(lambda a: np.asarray(a[l, s]), tree)
                    got = st.row(bk, l, s)
                    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
                        assert w.dtype == g.dtype and np.array_equal(w, g)
                    assert st.crc(bk, l, s) == other.crc(bk, l, s)
        assert st.disk_bytes == other.disk_bytes


def test_tier_store_flipped_byte_fails_closed_both_ways(tiny, tmp_path):
    """A byte stomped in a spilled leaf fails closed on fetch in each package,
    whichever package wrote the directory."""
    _, dj, dt = _spill_dirs(tiny, tmp_path)
    for d in (dj, dt):
        bad = tmp_path / f"{d.name}_bad"
        shutil.copytree(d, bad)
        victim = sorted(p for p in bad.iterdir() if p.suffix == ".npy")[0]
        raw = bytearray(victim.read_bytes())
        raw[-64:] = bytes(64)
        victim.write_bytes(bytes(raw))
        bk = victim.name.split("__")[0]
        for store, failed in ((JStore, J.ExpertUploadFailed),
                              (T.TieredExpertStore, T.ExpertUploadFailed)):
            st = store.reopen(str(bad))
            count = len(st.disk[bk]["w_gate"]["scale"][0])
            with pytest.raises(failed):
                for l in range(2):
                    for s in range(count):
                        st.row(bk, l, s)
