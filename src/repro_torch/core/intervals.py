"""Punctuation-interval assembly from an unbounded out-of-order source.

A copy of the reference's ``repro/core/intervals.py``, which is numpy only:
the same arrival order, the same intervals, the same ledger.

The batch drivers (``scheduler.run_stream``, ``sharded_stream``) consume a
pre-shaped ``[n_intervals, interval, ...]`` event stream; a *continuous*
service (``runtime/service.py``) instead receives arrival batches in
**arrival order**, each row tagged with an integer **event time**.  The
``IntervalAssembler`` re-sequences arrivals into event-time order and cuts
punctuation intervals under a watermark policy (DESIGN.md §2.6):

* the watermark advances per arrival batch to
  ``max(event_time seen) - allowed_lateness`` and is monotone;
* a row is *late* iff its event time is below the watermark at arrival.
  Late rows are either **rerouted** — resequenced at the current watermark,
  i.e. into the earliest interval still open — or **dropped**; both are
  counted, never silent;
* a pending row is *sealed* once its effective time is at or below the
  watermark: every future arrival sequences strictly after it (on-time
  rows sit at or above the watermark, rerouted rows are clamped to it and
  carry a later arrival sequence).  Each time ``interval`` sealed rows
  accumulate, one punctuation interval is emitted in (effective time,
  arrival sequence) order.

Conservation law (pinned by the hypothesis suite): every arrived row is
emitted exactly once, counted dropped, or still pending —
``arrived == assembled + watermark_dropped + pending``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_NEG_INF = np.iinfo(np.int64).min // 4


@dataclasses.dataclass(frozen=True)
class WatermarkPolicy:
    """Out-of-order handling: reorder window + late-row disposition."""

    allowed_lateness: int = 0       # event-time units behind the max seen
    late: str = "reroute"           # "reroute" into the next interval | "drop"

    def __post_init__(self):
        assert self.late in ("reroute", "drop"), self.late
        assert self.allowed_lateness >= 0, self.allowed_lateness


@dataclasses.dataclass
class IntervalInfo:
    """Per-interval accounting emitted alongside the event columns."""

    index: int                  # emission index (assembler-local)
    watermark: int              # watermark when the interval was sealed
    event_time: np.ndarray      # i64[interval] original event times
    seq: np.ndarray             # i64[interval] arrival sequence numbers
    enqueue_s: np.ndarray       # f64[interval] host enqueue timestamps
    n_late: int                 # rerouted rows that landed in this interval


class IntervalAssembler:
    """Cut watermarked punctuation intervals from arrival-order batches."""

    def __init__(self, interval: int,
                 policy: Optional[WatermarkPolicy] = None):
        assert interval > 0
        self.interval = int(interval)
        self.policy = policy or WatermarkPolicy()
        # pending rows as chunk dicts; consolidated to one chunk at pop time
        self._chunks: List[Dict] = []
        self._seq = 0
        self._wm = int(_NEG_INF)
        self._closed = False
        self.arrived = 0
        self.assembled = 0
        self.watermark_dropped = 0
        self.late_rerouted = 0
        self.emitted = 0
        self.watermarks: List[int] = []   # per emitted interval (monotone)

    @property
    def watermark(self) -> int:
        return self._wm

    @property
    def pending(self) -> int:
        return int(sum(c["eff"].shape[0] for c in self._chunks))

    def push(self, events: Dict[str, np.ndarray], event_time,
             enqueue_s: float = 0.0) -> None:
        """Admit one arrival batch (columns + event-time + enqueue stamp)."""
        assert not self._closed, "push after close()"
        event_time = np.asarray(event_time, np.int64)
        n = int(event_time.shape[0])
        if n == 0:
            return
        self.arrived += n
        wm = self._wm
        late = event_time < wm
        # the watermark advances from the *unfiltered* batch: a late row
        # still proves time has passed at the source
        new_wm = max(wm, int(event_time.max()) - self.policy.allowed_lateness)
        cols = {k: np.asarray(v) for k, v in events.items()}
        if self.policy.late == "drop" and late.any():
            self.watermark_dropped += int(late.sum())
            keep = ~late
            cols = {k: v[keep] for k, v in cols.items()}
            event_time, late = event_time[keep], late[keep]
            n = int(event_time.shape[0])
        else:
            self.late_rerouted += int(late.sum())
        if n:
            # reroute: clamp the sort key to the watermark — the row joins
            # the earliest interval a future arrival could still join
            eff = np.where(late, wm, event_time)
            seq = np.arange(self._seq, self._seq + n, dtype=np.int64)
            self._chunks.append(dict(
                cols=cols, eff=eff, seq=seq, time=event_time, late=late,
                enq=np.full(n, float(enqueue_s))))
        self._seq += n
        self._wm = new_wm

    def close(self) -> None:
        """End of stream: every pending row becomes sealed."""
        self._closed = True

    def pop_ready(self) -> List[Tuple[Dict[str, np.ndarray], IntervalInfo]]:
        """Emit every complete interval of sealed rows, in stream order."""
        if not self._chunks:
            return []
        ch = self._consolidate()
        eff, seq = ch["eff"], ch["seq"]
        sealed = (np.ones(eff.shape[0], bool) if self._closed
                  else eff <= self._wm)
        k = int(sealed.sum()) // self.interval
        if k == 0:
            return []
        sidx = np.flatnonzero(sealed)
        order = np.lexsort((seq[sidx], eff[sidx]))
        take = sidx[order][: k * self.interval]
        out = []
        for i in range(k):
            sl = take[i * self.interval : (i + 1) * self.interval]
            info = IntervalInfo(
                index=self.emitted + i, watermark=self._wm,
                event_time=ch["time"][sl], seq=seq[sl],
                enqueue_s=ch["enq"][sl], n_late=int(ch["late"][sl].sum()))
            out.append(({kk: v[sl] for kk, v in ch["cols"].items()}, info))
            self.watermarks.append(self._wm)
        self.emitted += k
        self.assembled += k * self.interval
        keep = np.ones(eff.shape[0], bool)
        keep[take] = False
        if keep.any():
            self._chunks = [dict(
                cols={kk: v[keep] for kk, v in ch["cols"].items()},
                eff=eff[keep], seq=seq[keep], time=ch["time"][keep],
                late=ch["late"][keep], enq=ch["enq"][keep])]
        else:
            self._chunks = []
        return out

    def _consolidate(self) -> Dict:
        if len(self._chunks) > 1:
            cat = lambda key: np.concatenate([c[key] for c in self._chunks])
            cols = {k: np.concatenate([c["cols"][k] for c in self._chunks])
                    for k in self._chunks[0]["cols"]}
            self._chunks = [dict(cols=cols, eff=cat("eff"), seq=cat("seq"),
                                 time=cat("time"), late=cat("late"),
                                 enq=cat("enq"))]
        return self._chunks[0]

    def conservation_ok(self) -> bool:
        return self.arrived == (self.assembled + self.watermark_dropped
                                + self.pending)

    @property
    def ledger(self) -> Dict[str, int]:
        """The full accounting record — the conservation law's terms plus
        the reroute count.  Merged into ``StreamService.stats`` so the
        balance stays checkable across every injected fault (crashed runs
        included): a fault may strand or drop rows, never lose them from
        the ledger."""
        return dict(arrived=self.arrived, assembled=self.assembled,
                    dropped=self.watermark_dropped, pending=self.pending,
                    rerouted=self.late_rerouted, emitted=self.emitted)

    def assert_conserved(self) -> None:
        assert self.conservation_ok(), self.ledger

    def publish(self, tele, prefix: str = "assembly") -> None:
        """Publish the conservation ledger into a telemetry registry as
        ``<prefix>.<term>`` counters (DESIGN.md §2.11).  ``tele`` is
        duck-typed (anything with ``count``) — the core layer defines
        the hook, the runtime injects the registry, so no core module
        ever imports the runtime package."""
        for k, v in self.ledger.items():
            tele.count(f"{prefix}.{k}", int(v))


class ReplaySource:
    """Deterministic replayable arrival process.

    The whole arrival sequence — event payloads, event times, and the
    out-of-order arrival permutation — is a pure function of ``seed``
    (the streaming analogue of ``runtime/ft.py``'s step-keyed batches):
    after a crash, re-iterating the source replays the identical arrival
    order, which makes punctuation-aligned recovery bitwise exact.

    ``jitter`` bounds arrival displacement: row *i* arrives within
    ``jitter`` positions of its event-time order, so a
    ``WatermarkPolicy(allowed_lateness >= jitter)`` reassembles the exact
    in-order stream (``in_order_events`` — the monolithic-driver input
    the service is bit-compared against).
    """

    def __init__(self, gen_events, n_events: int, *, seed: int = 0,
                 arrival_batch: int = 64, jitter: int = 0,
                 gen_kwargs: Optional[dict] = None):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed)]))
        events = {k: np.asarray(v) for k, v in
                  gen_events(rng, int(n_events), **(gen_kwargs or {})).items()}
        self.in_order_events = events
        t = np.arange(int(n_events), dtype=np.int64)
        if jitter > 0:
            order = np.argsort(t + rng.uniform(0.0, float(jitter),
                                               int(n_events)), kind="stable")
        else:
            order = t
        self._events = {k: v[order] for k, v in events.items()}
        self._time = t[order]
        self.n_events = int(n_events)
        self.arrival_batch = int(arrival_batch)
        self.jitter = int(jitter)

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        for i in range(0, self.n_events, self.arrival_batch):
            j = min(i + self.arrival_batch, self.n_events)
            yield ({k: v[i:j] for k, v in self._events.items()},
                   self._time[i:j])


class PhasedReplaySource(ReplaySource):
    """A deterministic multi-phase *workload storm*: the event stream is
    the concatenation of per-phase ``gen_events`` outputs (same generator,
    different kwargs — e.g. a key-skew flip followed by a multi-partition
    burst), drawn from ONE seeded rng stream so the whole storm is a pure
    function of ``(seed, phases)``.  Event times stay globally monotone
    across phase boundaries and the arrival jitter permutation applies to
    the concatenated stream, so everything ``ReplaySource`` guarantees
    (bounded displacement, exact ``in_order_events``, replayability for
    crash → restore → replay) holds for the storm too.

    ``phases``: sequence of ``(n_events, gen_kwargs)``.  ``phase_bounds``
    exposes the cumulative event-count boundaries, so callers (the storm
    benchmark) can map a punctuation interval to its phase:
    interval *i* covers events ``[i*interval, (i+1)*interval)``.
    """

    def __init__(self, gen_events, phases, *, seed: int = 0,
                 arrival_batch: int = 64, jitter: int = 0):
        phases = [(int(n), dict(kw)) for n, kw in phases]
        assert phases and all(n > 0 for n, _ in phases), phases

        def gen(rng, n_total, **_):
            parts = [gen_events(rng, n, **kw) for n, kw in phases]
            keys = list(parts[0])
            assert all(list(p) == keys for p in parts), \
                "every phase must emit the same event columns"
            return {k: np.concatenate([np.asarray(p[k]) for p in parts])
                    for k in keys}

        super().__init__(gen, sum(n for n, _ in phases), seed=seed,
                         arrival_batch=arrival_batch, jitter=jitter)
        self.phases = phases
        self.phase_bounds = np.cumsum([n for n, _ in phases])

    def phase_of_interval(self, interval_idx: int, interval: int) -> int:
        """Phase index of the interval's FIRST event (intervals straddling
        a boundary count toward the earlier phase)."""
        ev = interval_idx * interval
        return int(np.searchsorted(self.phase_bounds, ev, side="right"))
