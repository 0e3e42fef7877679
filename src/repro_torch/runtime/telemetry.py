"""Unified telemetry plane (DESIGN.md §2.11).

The reference's ``repro/runtime/telemetry.py``, with the same counter, gauge,
histogram, record and span names, so the two packages emit the same keys.
Two parts differ: ``ChunkProfiler`` opens ``torch.profiler`` windows, not
``jax.profiler`` ones, and the per-chunk cost attribution
(``CostAttributor``, ``TelemetryConfig(hlo_attribution=True)``) reads a
recorded trace of the chunk's own execution (``launch/hlo_analysis.py``),
not compiled XLA HLO, which eager PyTorch does not have: the service runs
the first chunk of each shape under the trace, and nothing runs twice.

One registry for every observability surface the runtime grew piecemeal:

* **Labeled counters / gauges** — monotone totals (drops by category,
  exchange ship/drop counts, the assembler's conservation ledger) and
  point-in-time levels (watermark, exchange capacity, backfill ratio).
* **Deterministic log-bucketed histograms** — latency distributions with
  geometric bucket bounds fixed at construction, so two histograms built
  from the same observations are bit-equal and *merge exactly*: bucket
  counts are integer sums, the running total is kept in integer
  nanoseconds, and min/max merge by min/max.  Merge is associative and
  conservation-respecting (pinned by tests/test_telemetry.py).
* **Bounded structured record logs** — the chunk-record ring, decision
  trace, fired faults, migrations: ordered lists of JSON documents.
* **Rate-limited events** — the once-per-run log lines ("watermark
  policy dropped …") become structured events that still emit through
  the caller's logger with the exact legacy message, but carry a
  occurrence count and a per-registry emission limit instead of
  hand-rolled "logged once" flags.
* **Span tracing** — Chrome-trace / Perfetto-compatible JSONL covering
  the whole service pipeline (source pull → interval assembly →
  admission → chunk dispatch → device execute → commit →
  ``controller.decide`` → snapshot publish → ``reshard.apply``).

**Replay-safety contract** (the §2.11 hard invariant): telemetry is
observability only.  The tracer reads a clock *only when a trace sink is
attached*; span data and histograms never feed ``controller.decide``;
a tracing-enabled run is bitwise identical to a tracing-off run —
including crash → restore → replay.  The only sanctioned timing→control
bridge is the *advisory* channel (``runtime/controller.AdvisoryTiming``):
timing-tier hints are logged and recorded here but never applied while
snapshots are on.

The registry snapshot is versioned (``SCHEMA`` / ``SCHEMA_VERSION``);
``stats_view`` renders the legacy ``StreamService.stats`` dict from a
snapshot so the old surface survives as a compatibility view.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..kernels.runtime import NULL_SPAN as _NULL_SPAN
from ..kernels.runtime import SPANS, span  # noqa: F401  (re-exported)

log = logging.getLogger(__name__)

SCHEMA = "repro.telemetry"
SCHEMA_VERSION = 1

# default latency-histogram geometry: 4 buckets per octave from 1 µs,
# 30 octaves (~18 min) before the overflow bucket — wide enough for a
# cold-compile chunk, fine enough for sub-ms percentile reads
HIST_LO_S = 1e-6
HIST_GROWTH = 2.0 ** 0.25
HIST_BUCKETS = 120

_LabelKey = Tuple[Tuple[str, Any], ...]


def _label_key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted(labels.items()))


# ---------------------------------------------------------------------------
# histograms
# ---------------------------------------------------------------------------
class Histogram:
    """Log-bucketed histogram with deterministic bucketing + exact merge.

    Bucket *i* covers ``(bound[i-1], bound[i]]`` with
    ``bound[i] = lo * growth**i`` (bucket 0 additionally absorbs
    everything ``<= lo``, the last bucket is the overflow).  The bounds
    are a pure function of ``(lo, growth, n_buckets)``, so any two
    histograms with the same geometry bucket identically and merging is
    per-bucket integer addition — associative and lossless.  The value
    total is kept in integer nanoseconds (``total_ns``) so merged sums
    are exact, not float-order-dependent.
    """

    __slots__ = ("lo", "growth", "n_buckets", "_bounds", "counts",
                 "count", "total_ns", "vmin", "vmax")

    def __init__(self, lo: float = HIST_LO_S, growth: float = HIST_GROWTH,
                 n_buckets: int = HIST_BUCKETS):
        assert lo > 0 and growth > 1.0 and n_buckets >= 1
        self.lo = float(lo)
        self.growth = float(growth)
        self.n_buckets = int(n_buckets)
        self._bounds = self.lo * self.growth ** np.arange(self.n_buckets)
        self.counts = np.zeros(self.n_buckets + 1, np.int64)
        self.count = 0
        self.total_ns = 0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def geometry(self) -> Tuple[float, float, int]:
        return (self.lo, self.growth, self.n_buckets)

    def observe(self, value: float) -> None:
        self.observe_many([value])

    def observe_many(self, values) -> None:
        a = np.asarray(values, np.float64).ravel()
        if a.size == 0:
            return
        idx = np.searchsorted(self._bounds, a, side="left")
        np.add.at(self.counts, idx, 1)
        self.count += int(a.size)
        self.total_ns += int(np.rint(a * 1e9).astype(np.int64).sum())
        self.vmin = min(self.vmin, float(a.min()))
        self.vmax = max(self.vmax, float(a.max()))

    @property
    def mean_s(self) -> float:
        return (self.total_ns / 1e9 / self.count) if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Deterministic percentile read: the upper bound of the bucket
        holding the q-th ranked observation, clipped to the observed
        [min, max] — exact to within one bucket's width."""
        if self.count == 0:
            return float("nan")
        rank = max(1.0, q / 100.0 * self.count)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank, side="left"))
        est = self._bounds[min(i, self.n_buckets - 1)]
        return float(min(max(est, self.vmin), self.vmax))

    def merge(self, other: "Histogram") -> "Histogram":
        assert self.geometry() == other.geometry(), \
            (f"histogram geometry mismatch: {self.geometry()} != "
             f"{other.geometry()} — exact merge requires identical buckets")
        self.counts = self.counts + other.counts
        self.count += other.count
        self.total_ns += other.total_ns
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def to_dict(self) -> Dict:
        nz = np.nonzero(self.counts)[0]
        return dict(
            lo=self.lo, growth=self.growth, n_buckets=self.n_buckets,
            counts={str(int(i)): int(self.counts[i]) for i in nz},
            count=int(self.count), total_ns=int(self.total_ns),
            min=(None if self.count == 0 else self.vmin),
            max=(None if self.count == 0 else self.vmax))

    @staticmethod
    def from_dict(d: Dict) -> "Histogram":
        h = Histogram(lo=float(d["lo"]), growth=float(d["growth"]),
                      n_buckets=int(d["n_buckets"]))
        for i, c in d.get("counts", {}).items():
            h.counts[int(i)] = int(c)
        h.count = int(d["count"])
        h.total_ns = int(d["total_ns"])
        if h.count:
            h.vmin = float(d["min"])
            h.vmax = float(d["max"])
        return h


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
class Telemetry:
    """Thread-safe metrics registry: counters, gauges, histograms,
    bounded record logs and rate-limited events, snapshotted behind the
    versioned schema.  One instance per service run (merged views come
    from :meth:`merge`); a process-wide instance serves code paths with
    no run context (:func:`get_default`)."""

    def __init__(self, record_cap: int = 4096):
        self._lock = threading.RLock()
        self.record_cap = int(record_cap)
        self._counters: Dict[str, Dict[_LabelKey, float]] = {}
        self._gauges: Dict[str, Dict[_LabelKey, float]] = {}
        self._hists: Dict[str, Histogram] = {}
        self._records: Dict[str, List[Any]] = {}
        self._events: Dict[str, Dict[str, int]] = {}

    # -- counters / gauges -------------------------------------------------
    def count(self, name: str, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0) + n

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = value

    def counter_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0)

    # -- histograms --------------------------------------------------------
    def histogram(self, name: str, lo: float = HIST_LO_S,
                  growth: float = HIST_GROWTH,
                  n_buckets: int = HIST_BUCKETS) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(lo, growth, n_buckets)
            return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def observe_many(self, name: str, values) -> None:
        a = np.asarray(values, np.float64).ravel()
        if a.size:
            self.histogram(name).observe_many(a)

    # -- structured record logs --------------------------------------------
    def ensure_records(self, name: str) -> None:
        with self._lock:
            self._records.setdefault(name, [])

    def record(self, name: str, **fields) -> None:
        self.record_doc(name, fields)

    def record_doc(self, name: str, doc: Any) -> None:
        with self._lock:
            lst = self._records.setdefault(name, [])
            lst.append(doc)
            if len(lst) > self.record_cap:
                del lst[: len(lst) - self.record_cap]

    def records(self, name: str) -> List[Any]:
        with self._lock:
            return list(self._records.get(name, ()))

    # -- rate-limited structured events ------------------------------------
    def event(self, name: str, msg: str, *args, logger=None,
              level: int = logging.WARNING, limit: int = 1) -> bool:
        """Count an occurrence of ``name``; emit ``msg % args`` through
        ``logger`` for the first ``limit`` occurrences (``limit=-1``:
        always).  Returns whether this occurrence was emitted — the
        replacement for the hand-rolled "logged once per run" flags."""
        with self._lock:
            st = self._events.setdefault(
                name, dict(count=0, emitted=0, limit=int(limit)))
            st["count"] += 1
            emit = st["limit"] < 0 or st["emitted"] < st["limit"]
            if emit:
                st["emitted"] += 1
        if emit and logger is not None:
            logger.log(level, msg, *args)
        return emit

    # -- merge / snapshot --------------------------------------------------
    def merge(self, other: "Telemetry") -> "Telemetry":
        """Fold ``other`` into this registry: counters and event counts
        add, histograms merge exactly, records concatenate (cap kept),
        gauges take ``other``'s value (latest wins)."""
        with self._lock, other._lock:
            for name, series in other._counters.items():
                mine = self._counters.setdefault(name, {})
                for k, v in series.items():
                    mine[k] = mine.get(k, 0) + v
            for name, series in other._gauges.items():
                self._gauges.setdefault(name, {}).update(series)
            for name, h in other._hists.items():
                if name in self._hists:
                    self._hists[name].merge(h)
                else:
                    self._hists[name] = Histogram.from_dict(h.to_dict())
            for name, lst in other._records.items():
                for doc in lst:
                    self.record_doc(name, doc)
            for name, st in other._events.items():
                mine = self._events.setdefault(
                    name, dict(count=0, emitted=0, limit=st["limit"]))
                mine["count"] += st["count"]
                mine["emitted"] += st["emitted"]
        return self

    def snapshot(self) -> Dict:
        """The versioned schema document (JSON-serializable)."""
        with self._lock:
            return {
                "schema": SCHEMA,
                "schema_version": SCHEMA_VERSION,
                "counters": [
                    dict(name=name, labels=dict(k), value=v)
                    for name, series in sorted(self._counters.items())
                    for k, v in sorted(series.items())],
                "gauges": [
                    dict(name=name, labels=dict(k), value=v)
                    for name, series in sorted(self._gauges.items())
                    for k, v in sorted(series.items())],
                "histograms": {name: h.to_dict()
                               for name, h in sorted(self._hists.items())},
                "events": [dict(name=name, **st)
                           for name, st in sorted(self._events.items())],
                "records": {name: list(lst)
                            for name, lst in self._records.items()},
            }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, default=_json_default)


def _json_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o)}")


_DEFAULT: Optional[Telemetry] = None
_DEFAULT_LOCK = threading.Lock()


def get_default() -> Telemetry:
    """The process-wide registry — for code paths outside a service run
    (the batch drivers' overflow accounting, ad-hoc counters)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = Telemetry()
        return _DEFAULT


# ---------------------------------------------------------------------------
# snapshot accessors (consumed by benchmarks/report over saved JSON too)
# ---------------------------------------------------------------------------
def counter_value(snap: Dict, name: str, default: float = 0, **labels):
    want = dict(labels)
    for c in snap.get("counters", ()):
        if c["name"] == name and dict(c.get("labels", {})) == want:
            return c["value"]
    return default


def gauge_value(snap: Dict, name: str, default: float = 0, **labels):
    want = dict(labels)
    for g in snap.get("gauges", ()):
        if g["name"] == name and dict(g.get("labels", {})) == want:
            return g["value"]
    return default


def has_gauge(snap: Dict, name: str) -> bool:
    return any(g["name"] == name for g in snap.get("gauges", ()))


def record_entries(snap: Dict, name: str) -> List[Any]:
    return list(snap.get("records", {}).get(name, ()))


def has_records(snap: Dict, name: str) -> bool:
    return name in snap.get("records", {})


def counters_with_prefix(snap: Dict, prefix: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for c in snap.get("counters", ()):
        if c["name"].startswith(prefix) and not c.get("labels"):
            out[c["name"][len(prefix):]] = c["value"]
    return out


def histogram_from(snap: Dict, name: str) -> Optional[Histogram]:
    d = snap.get("histograms", {}).get(name)
    return None if d is None else Histogram.from_dict(d)


def load_snapshot(path: str) -> Dict:
    with open(path) as f:
        snap = json.load(f)
    assert snap.get("schema") == SCHEMA, f"not a telemetry snapshot: {path}"
    assert int(snap.get("schema_version", 0)) <= SCHEMA_VERSION, \
        (f"telemetry snapshot {path} has schema_version "
         f"{snap.get('schema_version')} > supported {SCHEMA_VERSION}")
    return snap


# ---------------------------------------------------------------------------
# the legacy stats dict as a view over the schema
# ---------------------------------------------------------------------------
def stats_view(snap: Dict) -> Dict:
    """Render ``StreamService.stats``' legacy shape from a registry
    snapshot — the compatibility view: every consumer of the old merged
    dict keeps working while the registry is the source of truth."""
    def C(name, **labels):
        return counter_value(snap, name, **labels)

    def G(name, default=0.0):
        return gauge_value(snap, name, default)

    assembly = dict(arrived=0, assembled=0, dropped=0, pending=0,
                    rerouted=0, emitted=0)
    assembly.update({k: int(v) for k, v in
                     counters_with_prefix(snap, "assembly.").items()})
    stats: Dict[str, Any] = dict(
        arrived=int(C("service.arrived")),
        processed=int(C("service.processed")),
        replayed=int(C("service.replayed")),
        late_rerouted=int(C("service.late_rerouted")),
        drops=dict(
            watermark=int(C("service.drops", kind="watermark")),
            admission=int(C("service.drops", kind="admission")),
            exchange=int(C("service.drops", kind="exchange"))),
        unprocessed=int(C("service.unprocessed")),
        snapshots=[int(r["step"]) for r in record_entries(snap, "snapshots")],
        watermark=int(G("service.watermark")),
        crashed=bool(G("service.crashed")),
        assembly=assembly,
        source=dict(
            pulls=int(C("source.pulls")),
            retries=int(C("source.retries")),
            deadline_misses=int(C("source.deadline_misses")),
            backoff_s=float(C("source.backoff_s")),
            backfill_ratio=float(G("source.backfill_ratio")),
            alarm_threshold=float(G("source.alarm_threshold")),
            alarm=bool(G("source.alarm"))),
        chunks=[dict(r) for r in record_entries(snap, "chunks")],
    )
    ctl = record_entries(snap, "controller")
    if ctl:
        stats["controller"] = dict(
            dict(ctl[0]),
            decisions=[dict(d) for d in record_entries(snap, "decisions")])
        adv = record_entries(snap, "advisory")
        if adv:
            stats["controller"]["advisory"] = [dict(h) for h in adv]
    err = record_entries(snap, "error")
    if err:
        stats["error"] = dict(err[0])
    if has_records(snap, "faults"):
        stats["faults"] = record_entries(snap, "faults")
    if has_gauge(snap, "exchange.capacity"):
        stats["exchange"] = dict(
            dropped=int(C("exchange.dropped")),
            shipped=int(C("exchange.shipped")),
            capacity=int(G("exchange.capacity")),
            escalations=int(G("exchange.escalations")),
            slack=float(G("exchange.slack")))
        pl = record_entries(snap, "placement")
        placement = (dict(pl[0]) if pl
                     else dict(shard_events=[], imbalance=1.0, owners=[]))
        placement["migrations"] = [dict(m) for m
                                   in record_entries(snap, "migrations")]
        placement["moved_rows"] = int(sum(
            m.get("moved", 0) for m in placement["migrations"]))
        stats["placement"] = placement
    return stats


def empty_stats() -> Dict:
    """The schema-valid zero record ``StreamService.stats`` returns
    before any run (the old ``None`` footgun, fixed)."""
    return stats_view(Telemetry().snapshot())


# ---------------------------------------------------------------------------
# span tracing (Chrome trace event format / Perfetto JSON)
# ---------------------------------------------------------------------------
# the pipeline stages a service trace must cover (CI validation list);
# "reshard.apply" joins when an elastic run actually migrates
PIPELINE_STAGES = ("source.pull", "admission", "assembly", "chunk.submit",
                   "chunk.dispatch", "chunk.execute", "chunk.commit",
                   "snapshot.publish")


class TraceWriter:
    """Incremental Chrome-trace JSON array writer.  Events stream out
    one-per-line so a crashed run leaves a readable prefix (the format's
    closing ``]`` is optional for trace viewers and for
    :func:`validate_trace`); :meth:`close` makes the file strict JSON."""

    def __init__(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f = open(path, "w")
        self._f.write("[")
        self._first = True
        self._lock = threading.Lock()
        self._n = 0

    def emit(self, ev: Dict) -> None:
        line = json.dumps(ev, separators=(",", ":"), default=_json_default)
        with self._lock:
            if self._f.closed:
                return
            self._f.write(("\n" if self._first else ",\n") + line)
            self._first = False
            self._n += 1
            if self._n % 32 == 0:
                self._f.flush()

    def flush(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.write("\n]\n")
                self._f.close()


# spans the port emits beyond the reference's: the stages that tile a
# chunk's life between the shared ones, the dispatch's parts
# (core/scheduler.py), and the clock event that maps the trace onto
# ``time.monotonic_ns``.  Every one but ``trace.clock`` also lands as a
# ``span.<name>`` histogram.
PORT_ONLY_SPANS = ("trace.clock", "chunk.fill", "chunk.wait", "chunk.hold",
                   "dispatch.compute", "dispatch.restructure",
                   "dispatch.scan", "dispatch.intervals")


class _Span:
    """A ``ph="X"`` complete event; ``set(**args)`` attaches arguments
    any time before exit (cost attribution lands this way).  It records
    ``parent``, the open span it nests in on its thread, and, where opened
    with ``cpu=True``, ``cpu_us``, the thread's CPU time inside it;
    ``t0``/``t1`` keep its stamps for the stages that meet it."""

    __slots__ = ("_tr", "name", "cat", "args", "t0", "t1", "_cpu", "_cpu0",
                 "_up")

    def __init__(self, tracer, name, cat, args, cpu=False):
        self._tr = tracer
        self.name = name
        self.cat = cat
        self.args = dict(args)
        self._cpu = cpu

    def set(self, **kw) -> "_Span":
        self.args.update(kw)
        return self

    def __enter__(self) -> "_Span":
        self._up, SPANS.open = SPANS.open, self
        if self._up is not None:
            self.args["parent"] = self._up.name
        if self._cpu:
            # 0 where the thread has used no CPU time yet: not the flag
            self._cpu0 = time.thread_time_ns()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic_ns()
        if self._cpu:
            self.args["cpu_us"] = (time.thread_time_ns() - self._cpu0) / 1e3
        SPANS.open = self._up
        self._tr._emit_complete(self.name, self.cat, self.t0, self.t1,
                                self.args)
        return False


class NullTracer:
    """Tracing off: never reads a clock, never allocates — the replay
    path's proof that telemetry is pure observability."""

    enabled = False

    def span(self, name, cat="pipeline", **args):
        return _NULL_SPAN

    def bound(self):
        return _NULL_SPAN

    def complete_ns(self, name, t0_ns, t1_ns, track=None, cat="pipeline",
                    **args):
        pass

    def close(self):
        pass


NULL_TRACER = NullTracer()


class Tracer:
    """Span emitter over a :class:`TraceWriter`.  Timestamps come from
    ``time.monotonic_ns`` anchored at construction, which the first event,
    ``trace.clock``, records (``args.epoch_monotonic_ns``): a span's
    monotonic time is that plus its ``ts``.  Span durations also land in
    the registry as ``span.<name>`` histograms (observability only —
    nothing on the decision path reads them)."""

    enabled = True

    def __init__(self, writer: TraceWriter, registry: Optional[Telemetry]
                 = None, process_name: str = "repro-stream-service"):
        self._w = writer
        self._reg = registry
        self.pid = os.getpid()
        self.epoch_ns = time.monotonic_ns()
        # ``time.perf_counter`` stamps (the admission's) onto this clock
        self._perf_ns = self.epoch_ns - time.perf_counter_ns()
        self._tids: Dict[Any, int] = {}
        self._lanes: Dict[str, List[int]] = {}
        self._tlock = threading.Lock()
        self._w.emit(dict(name="process_name", ph="M", ts=0, pid=self.pid,
                          tid=0, args=dict(name=process_name)))
        self._w.emit(dict(name="trace.clock", cat="clock", ph="X", ts=0,
                          dur=0, pid=self.pid, tid=self._tid(),
                          args=dict(epoch_monotonic_ns=self.epoch_ns)))

    def _tid(self, track: Optional[str] = None) -> int:
        """The calling thread's track, or the named ``track``."""
        key = threading.get_ident() if track is None else track
        with self._tlock:
            tid = self._tids.get(key)
            if tid is None:
                tid = self._tids[key] = len(self._tids) + 1
                self._w.emit(dict(
                    name="thread_name", ph="M", ts=0, pid=self.pid, tid=tid,
                    args=dict(name=(threading.current_thread().name
                                    if track is None else track))))
        return tid

    def _lane(self, track: str, t0_ns: int, t1_ns: int) -> str:
        """The first lane of ``track`` whose events all end by ``t0_ns``:
        ``track``, then ``track 2``, ... (events of one track never
        overlap, as a trace viewer nests those of one thread)."""
        with self._tlock:
            ends = self._lanes.setdefault(track, [])
            j = next((j for j, e in enumerate(ends) if e <= t0_ns),
                     len(ends))
            if j == len(ends):
                ends.append(0)
            ends[j] = max(t0_ns, t1_ns)
        return track if j == 0 else f"{track} {j + 1}"

    def span(self, name: str, cat: str = "pipeline", cpu: bool = False,
             **args) -> _Span:
        return _Span(self, name, cat, args, cpu)

    @contextlib.contextmanager
    def bound(self):
        """Bind this tracer to the entering thread: the engine's
        ``kernels/runtime.span`` emits here."""
        prev, SPANS.tracer = SPANS.tracer, self
        try:
            yield
        finally:
            SPANS.tracer = prev

    def perf_ns(self, t_s: float) -> int:
        """A ``time.perf_counter`` stamp on this tracer's clock."""
        return int(t_s * 1e9) + self._perf_ns

    def _emit_complete(self, name, cat, t0_ns, t1_ns, args,
                       track: Optional[str] = None) -> None:
        ev = dict(name=name, cat=cat, ph="X",
                  ts=(t0_ns - self.epoch_ns) / 1e3,
                  dur=max((t1_ns - t0_ns) / 1e3, 0.0),
                  pid=self.pid, tid=self._tid(track))
        if args:
            ev["args"] = args
        self._w.emit(ev)
        if self._reg is not None:
            self._reg.observe("span." + name, (t1_ns - t0_ns) / 1e9)

    def complete_ns(self, name: str, t0_ns: int, t1_ns: int,
                    track: Optional[str] = None, cat: str = "pipeline",
                    **args) -> None:
        """Emit a complete event between two ``time.monotonic_ns`` stamps
        the caller already took for its own accounting, so tracing adds no
        clock read of its own: on the calling thread's track, or on a lane
        of the named ``track`` for a stage that runs from one thread's
        stamp to another's (neighbours may overlap; ``_lane``)."""
        if track is not None:
            track = self._lane(track, t0_ns, t1_ns)
        self._emit_complete(name, cat, t0_ns, t1_ns, args, track=track)

    def close(self) -> None:
        self._w.close()


@dataclass(frozen=True)
class TelemetryConfig:
    """Opt-in observability surfaces for one service run.  Everything
    defaults off; any combination is replay-safe (DESIGN.md §2.11)."""

    trace_path: str = ""        # Perfetto/Chrome JSONL sink; "" = no tracing
    profile_dir: str = ""       # torch.profiler per-chunk windows; "" = off
    hlo_attribution: bool = False  # per-chunk cost on execute spans
    record_cap: int = 4096      # bound on every structured record log


def make_tracer(tcfg: Optional[TelemetryConfig],
                registry: Optional[Telemetry] = None):
    if tcfg is None or not tcfg.trace_path:
        return NULL_TRACER
    return Tracer(TraceWriter(tcfg.trace_path), registry)


# ---------------------------------------------------------------------------
# profiling hooks (opt-in; never on the replay path)
# ---------------------------------------------------------------------------
class ChunkProfiler:
    """Per-chunk ``torch.profiler`` windows: one run-scoped profile with a
    ``service_chunk`` range per dispatched chunk, each closed by a profiler
    step.  ``torch.profiler`` records the thread that starts it, so the
    service starts and stops the window on its executor thread, the one
    that dispatches chunks.  ``stop`` writes a Chrome trace to
    ``profile_dir/service_chunks.<pid>.<n>.json``.  Fully inert unless
    ``profile_dir`` is set; failures degrade to a one-time warning, never to
    a run error."""

    def __init__(self, profile_dir: str = ""):
        self.profile_dir = profile_dir
        self.active = False
        self.trace_path = ""
        self._prof = None
        self._runs = 0

    def start(self) -> None:
        if not self.profile_dir:
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self.active = True
        except Exception as e:
            log.warning("torch.profiler start failed (%s: %s) — profiling "
                        "disabled for this run", type(e).__name__, e)

    def chunk(self, step: int):
        if not self.active:
            return _NULL_SPAN
        return _ProfiledChunk(self._prof, int(step))

    def stop(self) -> None:
        if not self.active:
            return
        self.active = False
        try:
            self._prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            self._runs += 1
            self.trace_path = os.path.join(
                self.profile_dir,
                f"service_chunks.{os.getpid()}.{self._runs}.json")
            self._prof.export_chrome_trace(self.trace_path)
        except Exception as e:
            log.warning("torch.profiler stop failed (%s: %s)",
                        type(e).__name__, e)


class _ProfiledChunk:
    """One chunk's ``service_chunk`` range; its exit steps the profiler."""

    __slots__ = ("_prof", "_step", "_rf")

    def __init__(self, prof, step: int):
        self._prof, self._step = prof, step

    def __enter__(self):
        from torch.profiler import record_function
        self._rf = record_function("service_chunk",
                                   args=f"step_num={self._step}")
        self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self._rf.__exit__(*exc)
        self._prof.step()
        return False


# Peak rates by device, for the achieved-vs-peak fractions.  The H100 row
# is NVIDIA's data sheet for the SXM part at its 700 W limit: HBM3 at 3.35
# TB/s, 67 TFLOP/s float32 outside the tensor cores (the engine's kernels
# and ops are float32 and integer), NVLink 4 at 450 GB/s each direction.
# The "cpu" row is a modest host, for runs on the CPU.
DEVICE_PEAKS = {
    "H100": dict(peak_flops=67e12, hbm_bw=3.35e12, link_bw=450e9),
    "cpu": dict(peak_flops=1e12, hbm_bw=40e9, link_bw=20e9),
}


def device_peaks(device) -> Dict[str, float]:
    """The ``DEVICE_PEAKS`` row of ``device``: "cpu", or the card whose
    ``torch.cuda.get_device_name`` names a row; KeyError for another
    card."""
    import torch
    dev = torch.device(device)
    if dev.type == "cpu":
        return dict(DEVICE_PEAKS["cpu"])
    name = torch.cuda.get_device_name(dev)
    for key, row in DEVICE_PEAKS.items():
        if key != "cpu" and key in name:
            return dict(row)
    raise KeyError(f"no peak rates for {name!r}")


class CostAttributor:
    """Opt-in per-chunk cost attribution (``hlo_attribution=True``): the
    first chunk of each shape key (variant, slack, owners, K) runs under a
    program trace (``DualModeEngine.chunk_cost``), and its flops, bytes and
    wire bytes annotate every execute span of that shape with
    achieved-vs-peak fractions.  The traced chunk is the real one: nothing
    runs twice and no state is copied.  Attribution never breaks a run: a
    failure is logged once and the spans carry no cost."""

    def __init__(self, n_devices: int = 1, device="cpu"):
        self.n_devices = max(int(n_devices), 1)
        self.device = device
        self._peaks: Optional[Dict[str, float]] = None
        self._warned = False

    def _warn(self, what: str, e: Exception) -> None:
        if not self._warned:
            self._warned = True
            log.warning("per-chunk cost attribution failed in %s (%s: %s) — "
                        "execute spans will carry no cost args", what,
                        type(e).__name__, e)

    def run_chunk(self, engine, values, batched, ts0, variant=None):
        """``engine.run_stream_chunk`` run once under a program trace:
        ``(its four results, cost)``; cost is the trace's ``analyze``
        dict, or None where the trace or the analysis failed."""
        from ..launch.hlo_analysis import analyze
        out, trace = engine.chunk_cost(values, batched, ts0, variant=variant)
        try:
            return out, analyze(trace, self.n_devices)
        except Exception as e:       # attribution never breaks a run
            self._warn("the analysis", e)
            return out, None

    def peaks(self) -> Dict[str, float]:
        if self._peaks is None:
            self._peaks = device_peaks(self.device)
        return self._peaks

    def annotate(self, cost: Dict, dur_s: float) -> Dict:
        """Achieved-vs-peak annotation for one executed chunk window ({}
        where the device has no peak rates)."""
        try:
            pk = self.peaks()
        except KeyError as e:
            self._warn("the peak table", e)
            return {}
        dur = max(float(dur_s), 1e-12)
        flops = float(cost.get("dot_flops", 0.0))
        byts = float(cost.get("bytes_written", 0.0))
        wire = float(cost.get("wire_bytes_per_device", 0.0))
        fracs = dict(
            frac_compute=flops / dur / pk["peak_flops"],
            frac_memory=byts / dur / pk["hbm_bw"],
            frac_link=wire / dur / pk["link_bw"])
        bound = max(fracs, key=fracs.get)
        return dict(
            flops=flops, bytes_written=byts, wire_bytes_per_device=wire,
            gflops_s=flops / dur / 1e9, gbytes_s=byts / dur / 1e9,
            bound=bound.replace("frac_", ""), **fracs)


# ---------------------------------------------------------------------------
# trace validation (the CI telemetry-smoke contract)
# ---------------------------------------------------------------------------
_VALID_PH = {"X", "i", "I", "C", "M", "B", "E"}


def _parse_trace(path: str) -> List[Dict]:
    with open(path) as f:
        raw = f.read()
    body = raw.strip()
    if body.startswith("["):
        body = body[1:]
    if body.rstrip().endswith("]"):
        body = body.rstrip()[:-1]
    events = []
    for i, line in enumerate(body.splitlines(), 1):
        line = line.strip().rstrip(",")
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except ValueError as e:
            raise ValueError(f"{path}:{i}: invalid trace event JSON: {e}")
    return events


def validate_trace(path: str, require_stages: Sequence[str] = ()
                   ) -> Tuple[bool, str, Dict]:
    """Validate a trace file against the Chrome trace event schema:
    every event needs ``name``/``ph``/``ts``/``pid``/``tid`` with sane
    types, ``X`` events need a non-negative ``dur``, ``M`` events a
    ``args.name``.  ``require_stages`` additionally demands a complete
    span for each named pipeline stage.  Returns ``(ok, why, info)``."""
    try:
        events = _parse_trace(path)
    except (OSError, ValueError) as e:
        return False, str(e), dict(n_events=0, stages=[])
    if not events:
        return False, "empty trace", dict(n_events=0, stages=[])
    for i, ev in enumerate(events):
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            return False, f"event {i}: missing name", {}
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            return False, f"event {i} ({ev['name']}): bad ph {ph!r}", {}
        if not isinstance(ev.get("ts"), (int, float)) or ev["ts"] < 0:
            return False, f"event {i} ({ev['name']}): bad ts", {}
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                return False, f"event {i} ({ev['name']}): bad {k}", {}
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                return False, f"event {i} ({ev['name']}): X needs dur", {}
        if ph == "M" and not (ev.get("args") or {}).get("name"):
            return False, f"event {i}: M needs args.name", {}
    stages = sorted({ev["name"] for ev in events
                     if ev.get("ph") == "X"
                     and ev.get("cat") in ("pipeline", "ckpt")})
    missing = [s for s in require_stages if s not in stages]
    info = dict(n_events=len(events), stages=stages)
    if missing:
        return False, f"missing pipeline stages: {missing}", info
    return True, "ok", info


def stage_summary(path: str) -> List[Dict]:
    """Per-stage duration table from a trace file (count, total, mean,
    p50/p99 in ms) — the ``report.py --trace`` view."""
    events = _parse_trace(path)
    by: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            by.setdefault(ev["name"], []).append(float(ev["dur"]))
    rows = []
    for name in sorted(by):
        durs = np.asarray(by[name], np.float64) / 1e3   # µs -> ms
        rows.append(dict(
            stage=name, count=int(durs.size),
            total_ms=float(durs.sum()), mean_ms=float(durs.mean()),
            p50_ms=float(np.percentile(durs, 50)),
            p99_ms=float(np.percentile(durs, 99))))
    rows.sort(key=lambda r: -r["total_ms"])
    return rows


def _main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="validate a Perfetto/Chrome trace emitted by the "
                    "service telemetry plane")
    p.add_argument("trace", help="trace JSONL path")
    p.add_argument("--require-stages", default="",
                   help="comma-separated span names that must be present")
    p.add_argument("--summary", action="store_true",
                   help="print the per-stage duration table")
    args = p.parse_args(argv)
    stages = [s for s in args.require_stages.split(",") if s]
    ok, why, info = validate_trace(args.trace, require_stages=stages)
    print(f"{args.trace}: {'OK' if ok else 'INVALID'} ({why}); "
          f"{info.get('n_events', 0)} events, "
          f"stages={info.get('stages', [])}")
    if ok and args.summary:
        for r in stage_summary(args.trace):
            print(f"  {r['stage']:<20} n={r['count']:>5} "
                  f"total={r['total_ms']:>10.2f}ms p50={r['p50_ms']:.3f}ms "
                  f"p99={r['p99_ms']:.3f}ms")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(_main())
