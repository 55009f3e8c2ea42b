"""Request-lifecycle tracing and expert-routing telemetry (port of
``repro/serving/trace.py``).

A :class:`SpanTracer` records typed span / instant / counter / flow events
over the request lifecycle (enqueue → admit → prefill chunks → decode
megasteps → release, plus the controller's plans, sheds, faults and typed
terminations) on per-slot tracks with per-request flow ids.

**Two exports, one contract.** Chrome trace-event JSON
(:meth:`SpanTracer.chrome_trace`, for Perfetto) and a JSONL event log
(:meth:`SpanTracer.write_jsonl`). Every event separates deterministic
fields (seq, name, phase, category, track, flow id, args) from wall-clock
ones (``ts_us``/``dur_us``); the wall-clock-free projection
(:meth:`SpanTracer.deterministic_jsonl`) of two replays of one trace is
bit-identical, and the port's engine gives the reference engine's
projection on the same trace.

**Levels.** ``off`` records nothing, ``spans`` records lifecycle spans,
instants and flows, ``full`` adds per-step counter events and the
expert-routing telemetry.

**Metrics as a consumer.** Lifecycle facts reach
:class:`~repro_torch.serving.metrics.ServingMetrics` through
:meth:`SpanTracer.lifecycle`, whose consumers (:class:`MetricsConsumer`)
are called at every level, so ``counters()`` does not depend on the level.

Schema validation is a CLI too::

    PYTHONPATH=src python -m repro_torch.serving.trace FILE...
"""
from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

__all__ = [
    "TRACE_LEVELS",
    "SpanTracer",
    "NULL_TRACER",
    "MetricsConsumer",
    "ExpertRoutingTelemetry",
    "gini",
    "validate_events",
    "validate_chrome_trace",
]

TRACE_LEVELS: Tuple[str, ...] = ("off", "spans", "full")
_LEVEL = {name: i for i, name in enumerate(TRACE_LEVELS)}

# wall-clock keys — stripped by the deterministic projection, required
# (where applicable) by the schema; everything else in an event must be
# replay-deterministic
_WALL_KEYS = ("ts_us", "dur_us")
_PHASES = frozenset({"X", "i", "C", "s", "t", "f"})
_ARG_TYPES = (str, int, float, bool, type(None))


class SpanTracer:
    """Structured span/instant/counter/flow recorder for one engine.

    Events live in :attr:`events` in record order (deterministic, since
    the engine's control flow is deterministic per served trace). A
    span's event is recorded at *exit* — children therefore precede
    their parent in the buffer, which both exports tolerate (Chrome
    nests by ts/dur; the JSONL consumer has ``seq``).
    """

    def __init__(self, level: str = "off", consumers: Iterable = ()):
        if level not in _LEVEL:
            raise ValueError(
                f"trace level {level!r} not in {TRACE_LEVELS}"
            )
        self.level_name = level
        self.level = _LEVEL[level]
        self.consumers = list(consumers)
        self.events: List[Dict] = []
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------- state
    @property
    def enabled(self) -> bool:
        """Spans/instants/flows are recorded."""
        return self.level >= _LEVEL["spans"]

    @property
    def full(self) -> bool:
        """Counter events + routing telemetry are recorded too."""
        return self.level >= _LEVEL["full"]

    def reset(self) -> None:
        """Drop recorded events and re-anchor the clock (e.g. after a
        warmup pass). Consumers and level are kept."""
        self.events.clear()
        self._t0 = time.perf_counter()

    def now_us(self) -> float:
        """Wall-clock microseconds since tracer creation/reset."""
        return (time.perf_counter() - self._t0) * 1e6

    def _record(self, ev: Dict) -> None:
        ev["seq"] = len(self.events)
        self.events.append(ev)

    # ------------------------------------------------------------ record
    def complete(self, name: str, *, track: str, cat: str,
                 start_us: float, end_us: Optional[float] = None,
                 args: Optional[Dict] = None) -> None:
        """Record one complete ("X") span from an explicit start time —
        the building block for spans whose args are only known at exit
        (e.g. an upload's row/byte counts)."""
        if not self.enabled:
            return
        end = self.now_us() if end_us is None else end_us
        self._record({
            "ph": "X", "name": name, "cat": cat, "track": track,
            "args": dict(args or {}),
            "ts_us": round(start_us, 3),
            "dur_us": round(max(end - start_us, 0.0), 3),
        })

    @contextlib.contextmanager
    def span(self, name: str, *, track: str, cat: str, **args):
        """Context-managed span; recorded as one "X" event at exit."""
        if not self.enabled:
            yield
            return
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, track=track, cat=cat, start_us=t0,
                          args=args)

    def instant(self, name: str, *, track: str, cat: str, **args) -> None:
        if not self.enabled:
            return
        self._record({
            "ph": "i", "name": name, "cat": cat, "track": track,
            "args": args, "ts_us": round(self.now_us(), 3),
        })

    def counter(self, name: str, *, track: str, **values) -> None:
        """Gauge samples (Chrome "C" events) — ``full`` level only."""
        if not self.full:
            return
        self._record({
            "ph": "C", "name": name, "cat": "gauge", "track": track,
            "args": {k: float(v) for k, v in values.items()},
            "ts_us": round(self.now_us(), 3),
        })

    def flow(self, phase: str, rid: int, *, track: str) -> None:
        """Per-request flow events: ``"s"`` at enqueue, ``"t"`` at every
        lifecycle hop (admit / preempt / resume), ``"f"`` at release —
        Perfetto draws the arrows that stitch one request's journey
        across queue and slot tracks."""
        if not self.enabled:
            return
        if phase not in ("s", "t", "f"):
            raise ValueError(f"flow phase must be s/t/f, got {phase!r}")
        self._record({
            "ph": phase, "name": "request", "cat": "request",
            "track": track, "id": int(rid),
            "ts_us": round(self.now_us(), 3),
        })

    def lifecycle(self, kind: str, *, track: str, **fields) -> None:
        """One structured lifecycle fact (admit / release / preempt /
        swap_in / enqueue …). Consumers are dispatched **always** —
        :class:`ServingMetrics` book-keeps through this path, so its
        deterministic counters cannot depend on the trace level — while
        the instant event is only recorded when tracing is enabled."""
        for c in self.consumers:
            c.on_lifecycle(kind, fields)
        if self.enabled:
            self.instant(kind, track=track, cat="lifecycle", **fields)

    # ------------------------------------------------------------ export
    def deterministic_events(self) -> List[Dict]:
        """The wall-clock-free projection: identical replays of the same
        trace must produce *bit-identical* output (list and dict order
        included — events are in record order, args in insertion order)."""
        return [
            {k: v for k, v in ev.items() if k not in _WALL_KEYS}
            for ev in self.events
        ]

    def deterministic_jsonl(self) -> str:
        return "\n".join(
            json.dumps(ev, sort_keys=True)
            for ev in self.deterministic_events()
        )

    def write_jsonl(self, path: str, deterministic: bool = False) -> None:
        """One JSON object per line; ``deterministic=True`` writes the
        wall-clock-free projection (the replay-comparable artifact)."""
        events = (
            self.deterministic_events() if deterministic else self.events
        )
        with open(path, "w") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")

    def _track_ids(self) -> Dict[str, int]:
        """track name → Chrome tid, in first-appearance order (which is
        deterministic because event order is)."""
        ids: Dict[str, int] = {}
        for ev in self.events:
            t = ev["track"]
            if t not in ids:
                ids[t] = len(ids) + 1
        return ids

    @staticmethod
    def _sort_index(track: str) -> int:
        """Stable Perfetto track ordering: engine first, then the queue,
        slot tracks by index, pool/experts at the bottom."""
        if track == "engine":
            return 0
        if track == "queue":
            return 1
        if track.startswith("slot"):
            try:
                return 10 + int(track[4:])
            except ValueError:
                return 10
        return {"pool": 900, "experts": 901}.get(track, 500)

    def chrome_trace(self, extra: Optional[Dict] = None) -> Dict:
        """Chrome trace-event JSON (the dict; dump it to a ``.json`` file
        and open in Perfetto / chrome://tracing). ``extra`` lands under
        ``otherData`` — e.g. the bit-misallocation report rides along
        inside the trace artifact."""
        ids = self._track_ids()
        out: List[Dict] = [{
            "ph": "M", "pid": 1, "tid": 0, "name": "process_name",
            "args": {"name": "repro_torch.serving"},
        }]
        for track, tid in ids.items():
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_name", "args": {"name": track}})
            out.append({"ph": "M", "pid": 1, "tid": tid,
                        "name": "thread_sort_index",
                        "args": {"sort_index": self._sort_index(track)}})
        for ev in self.events:
            base = {
                "ph": ev["ph"], "name": ev["name"], "cat": ev["cat"],
                "pid": 1, "tid": ids[ev["track"]], "ts": ev["ts_us"],
            }
            if ev["ph"] == "X":
                base["dur"] = ev["dur_us"]
                base["args"] = ev["args"]
            elif ev["ph"] == "i":
                base["s"] = "t"
                base["args"] = ev["args"]
            elif ev["ph"] == "C":
                base["args"] = ev["args"]
            else:  # flow s/t/f
                base["id"] = ev["id"]
                if ev["ph"] == "f":
                    base["bp"] = "e"
            out.append(base)
        doc = {"traceEvents": out, "displayTimeUnit": "ms"}
        if extra:
            doc["otherData"] = extra
        return doc

    def write_chrome(self, path: str, extra: Optional[Dict] = None) -> None:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(extra), fh)


#: Shared disabled tracer — the default for components constructed
#: outside an engine (scheduler/kvcache/offload unit tests); every hook
#: early-returns and no consumer is attached.
NULL_TRACER = SpanTracer("off")


class MetricsConsumer:
    """Routes lifecycle trace events into :class:`ServingMetrics` — the
    metrics become a consumer of the event stream instead of a parallel
    bookkeeping path. Holds a *getter* rather than the metrics object so
    callers that reset ``engine.metrics`` (benchmark warmups) keep
    feeding the live instance."""

    def __init__(self, get_metrics: Callable):
        self._get = get_metrics

    def on_lifecycle(self, kind: str, f: Dict) -> None:
        m = self._get()
        if kind == "admit":
            m.record_admission(
                f["rid"], f["slot"], f["step"], f["active_before"],
                f["queue_depth"], resumed=f.get("resumed", False),
                tenant=f.get("tenant", "default"),
                priority=f.get("priority", 0),
                wait_steps=f.get("wait_steps", -1),
            )
        elif kind == "release":
            m.record_release(f["rid"], f["slot"], f["step"])
        elif kind == "preempt":
            m.record_preemption(
                f["rid"], f["slot"], f["step"], f["mode"],
                swap_bytes=f.get("swap_bytes", 0),
                tenant=f.get("tenant", "default"),
                for_rid=f.get("for_rid", -1),
                for_tenant=f.get("for_tenant", ""),
            )
        elif kind == "shed":
            m.record_shed(
                f["rid"], f["step"], tenant=f.get("tenant", "default"),
                priority=f.get("priority", 0),
                wait_steps=f.get("wait_steps", 0),
            )
        elif kind == "plan":
            m.record_plan(
                f.get("actions", 0),
                admits=f.get("admits", 0),
                preempts=f.get("preempts", 0),
                grows=f.get("grows", 0),
                prefix_evictions=f.get("prefix_evictions", 0),
                sheds=f.get("sheds", 0),
                expert_uploads=f.get("expert_uploads", 0),
            )
        elif kind == "swap_in":
            m.record_swap_in(f["nbytes"])
        elif kind == "prefix_hit":
            m.record_prefix_hit(
                f["tokens_saved"], full=f.get("full", False)
            )
        elif kind == "prefix_miss":
            m.record_prefix_miss()
        elif kind == "cow_copy":
            m.record_cow_copy()
        elif kind == "fault":
            m.record_fault(f["site"])
        elif kind == "retry":
            m.record_upload_retry()
        elif kind == "degrade":
            m.record_degrade()
        elif kind == "swap_fallback":
            m.record_swap_fallback()
        elif kind == "tier_fetch":
            m.record_tier_fetch(f["tier"], f.get("nbytes", 0))
        elif kind == "cancel":
            m.record_cancel()
        elif kind == "deadline":
            m.record_deadline()
        elif kind == "poisoned":
            m.record_poisoned()
        # other kinds (enqueue, first_token, …) carry no metric state


# --------------------------------------------------------------- telemetry
def gini(x) -> float:
    """Gini coefficient of a non-negative load vector — 0 for perfectly
    balanced expert traffic, → 1 as a few experts absorb everything."""
    x = np.sort(np.asarray(x, np.float64))
    n, s = x.size, float(x.sum())
    if n == 0 or s == 0.0:
        return 0.0
    cum = np.cumsum(x) / s
    return float((n + 1 - 2 * cum.sum()) / n)


class ExpertRoutingTelemetry:
    """Per-(layer, expert-slot) dispatch accounting over the
    ``slot_counts`` every decode/prefill program already reports.

    All inputs are device-computed and deterministic per served trace,
    so everything here (histogram, drift, Gini, report) belongs to the
    deterministic side of the tracing contract.
    """

    def __init__(self, ema_decay: float = 0.9):
        self.ema_decay = float(ema_decay)
        self.hist: Optional[np.ndarray] = None  # [L, S] int64 totals
        self.ema: Optional[np.ndarray] = None  # [L, S] per-layer dist EMA
        self.steps = 0
        self.last_drift = 0.0
        self.last_gini = 0.0

    def update(self, counts) -> Optional[Dict[str, float]]:
        """Fold one logical step's ``[L, num_slots]`` dispatch counts in.
        Returns the refreshed gauges — ``routing_drift`` (mean over
        layers of the total-variation distance between this step's
        routing distribution and the running EMA) and ``routing_gini``
        (mean per-layer Gini of the cumulative histogram) — or ``None``
        for empty counts."""
        counts = np.asarray(counts)
        if counts.size == 0 or counts.ndim != 2:
            return None
        counts = counts.astype(np.int64)
        if self.hist is None:
            self.hist = np.zeros(counts.shape, np.int64)
            self.ema = np.full(counts.shape, 1.0 / counts.shape[1])
        self.hist += counts
        self.steps += 1
        tot = counts.sum(axis=1, keepdims=True)
        # layers that dispatched nothing this step contribute no drift
        p = np.where(tot > 0, counts / np.maximum(tot, 1), self.ema)
        self.last_drift = float(
            np.mean(0.5 * np.abs(p - self.ema).sum(axis=1))
        )
        d = self.ema_decay
        self.ema = d * self.ema + (1.0 - d) * p
        self.last_gini = float(
            np.mean([gini(row) for row in self.hist])
        )
        return {
            "routing_drift": self.last_drift,
            "routing_gini": self.last_gini,
        }

    def bit_misallocation_report(self, meta,
                                 degraded: Optional[Dict] = None
                                 ) -> Optional[Dict]:
        """Join observed routing frequency against the PMQ bit
        assignment (``meta`` = :class:`repro_torch.core.compressed_moe
        .BucketMeta` tuple). Per (layer, slot): observed dispatch count,
        frequency, frequency rank (0 = hottest, stable on ties) and the
        slot's allocated bit-width; per layer the Pearson correlation
        between frequency and bits (positive = bits follow observed
        significance — the paper's §3.2 story holding at serve time) and
        the reallocation candidates: ``hot_low_bit`` slots carry an
        above-uniform share at the minimum width, ``cold_high_bit``
        slots a below-uniform share at the maximum width.

        ``degraded`` (optional) maps ``(layer, slot) → served bits`` for
        experts pinned to a lower rung of the precision ladder after
        persistent upload failures: each
        entry gains a ``served_bits`` column (= allocated bits when not
        degraded) and the report a top-level ``degraded_experts`` list."""
        if self.hist is None:
            return None
        degraded = dict(degraded or {})
        num_layers, num_slots = self.hist.shape
        bits = np.zeros(num_slots, np.int64)
        for m in meta:
            bits[m.start:m.start + m.count] = m.bits
        lo, hi = int(bits.min()), int(bits.max())
        uniform = 1.0 / num_slots
        layers: List[Dict] = []
        corrs: List[float] = []
        for l in range(num_layers):
            h = self.hist[l]
            tot = int(h.sum())
            freq = h / tot if tot else np.zeros(num_slots)
            order = np.argsort(-h, kind="stable")
            rank = np.empty(num_slots, np.int64)
            rank[order] = np.arange(num_slots)
            corr = None
            if tot and lo != hi and float(np.std(freq)) > 0.0:
                corr = float(np.corrcoef(freq, bits.astype(np.float64))[0, 1])
                corrs.append(corr)
            hot_low = [int(s) for s in range(num_slots)
                       if freq[s] > uniform and bits[s] == lo]
            cold_high = [int(s) for s in range(num_slots)
                         if freq[s] < uniform and bits[s] == hi]
            layers.append({
                "layer": l,
                "total_dispatch": tot,
                "freq_bits_corr": corr,
                "hot_low_bit": hot_low if lo != hi else [],
                "cold_high_bit": cold_high if lo != hi else [],
                "entries": [
                    {"slot": int(s), "bits": int(bits[s]),
                     "served_bits": int(degraded.get((l, s), bits[s])),
                     "count": int(h[s]), "freq": float(freq[s]),
                     "freq_rank": int(rank[s])}
                    for s in range(num_slots)
                ],
            })
        return {
            "steps": self.steps,
            "num_layers": num_layers,
            "num_slots": num_slots,
            "bits_per_slot": [int(b) for b in bits],
            "mean_freq_bits_corr": (
                float(np.mean(corrs)) if corrs else None
            ),
            "degraded_experts": [
                {"layer": int(l), "slot": int(s),
                 "from_bits": int(bits[s]) if s < num_slots else None,
                 "to_bits": int(tb)}
                for (l, s), tb in sorted(degraded.items())
            ],
            "layers": layers,
        }


# -------------------------------------------------------------- validation
def _fail(msg: str, ev: Dict) -> None:
    raise ValueError(f"trace schema: {msg}: {json.dumps(ev, sort_keys=True)[:200]}")


def validate_events(events: Iterable[Dict]) -> int:
    """Validate JSONL-form events (the tracer's native record shape).
    Returns the number of events checked; raises ``ValueError`` on the
    first violation."""
    n = 0
    prev_seq = -1
    for ev in events:
        n += 1
        for key, typ in (("ph", str), ("name", str), ("cat", str),
                         ("track", str), ("seq", int)):
            if not isinstance(ev.get(key), typ):
                _fail(f"missing/bad {key!r}", ev)
        if ev["ph"] not in _PHASES:
            _fail(f"phase {ev['ph']!r} not in {sorted(_PHASES)}", ev)
        if ev["seq"] <= prev_seq:
            _fail("seq not strictly increasing", ev)
        prev_seq = ev["seq"]
        if not isinstance(ev.get("ts_us"), (int, float)):
            _fail("missing wall-clock ts_us", ev)
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur_us"), (int, float)) or ev["dur_us"] < 0:
                _fail("X event needs dur_us >= 0", ev)
        if ev["ph"] in ("s", "t", "f"):
            if not isinstance(ev.get("id"), int):
                _fail("flow event needs an int id", ev)
        elif not isinstance(ev.get("args", {}), dict):
            _fail("args must be a dict", ev)
        else:
            for k, v in ev.get("args", {}).items():
                if not isinstance(k, str) or not isinstance(v, _ARG_TYPES):
                    _fail(f"arg {k!r} must be a JSON scalar", ev)
    return n


def validate_chrome_trace(doc: Dict) -> int:
    """Validate a Chrome trace-event JSON document (what
    :meth:`SpanTracer.write_chrome` emits / Perfetto opens). Returns
    the number of events checked; raises ``ValueError`` on violation."""
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("trace schema: document needs a traceEvents list")
    n = 0
    for ev in doc["traceEvents"]:
        n += 1
        if not isinstance(ev, dict):
            _fail("event must be an object", {"got": str(type(ev))})
        ph = ev.get("ph")
        if ph not in _PHASES | {"M"}:
            _fail(f"phase {ph!r}", ev)
        for key in ("name", "pid", "tid"):
            if key not in ev:
                _fail(f"missing {key!r}", ev)
        if ph == "M":
            if ev["name"] not in ("process_name", "thread_name",
                                  "thread_sort_index"):
                _fail("unknown metadata event", ev)
            continue
        if not isinstance(ev.get("ts"), (int, float)):
            _fail("missing ts", ev)
        if ph == "X" and (not isinstance(ev.get("dur"), (int, float))
                          or ev["dur"] < 0):
            _fail("X event needs dur >= 0", ev)
        if ph in ("s", "t", "f") and not isinstance(ev.get("id"), int):
            _fail("flow event needs an int id", ev)
    return n


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m repro_torch.serving.trace FILE...`` — validate trace
    artifacts (``.json`` Chrome documents / ``.jsonl`` event logs)."""
    import argparse
    import glob as globmod

    p = argparse.ArgumentParser(
        description="validate serving trace artifacts against the schema"
    )
    p.add_argument("paths", nargs="+",
                   help=".trace.json (Chrome) or .jsonl (event log) files;"
                        " globs ok")
    args = p.parse_args(argv)
    files: List[str] = []
    for pat in args.paths:
        hits = sorted(globmod.glob(pat))
        files.extend(hits if hits else [pat])
    failed = False
    for path in files:
        try:
            with open(path) as fh:
                if path.endswith(".jsonl"):
                    n = validate_events(
                        json.loads(line) for line in fh if line.strip()
                    )
                else:
                    n = validate_chrome_trace(json.load(fh))
            print(f"{path}: OK ({n} events)")
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"{path}: FAIL — {e}")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
