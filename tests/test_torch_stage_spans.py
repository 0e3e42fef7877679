"""Where a service chunk's time goes: the port's stage spans.

Held here, on GS (the fused associative driver, staged and megakernel
rungs) and SL (the lockstep walk) service runs on the CPU:

1. ``chunk.fill``, ``.submit``, ``.wait``, ``.dispatch``, ``.hold`` and
   ``.commit`` tile each chunk's life: each meets the next on one stamp,
   and together they run from the chunk's first admission to its commit's
   end.
2. No two spans of one track partially overlap: each such stage takes
   lanes of its own.  The engine's ``dispatch.*`` spans nest inside
   ``chunk.dispatch`` on its thread, with ``parent`` set, and the dispatch
   alone carries the thread's CPU time.
3. ``chunk.dispatch``'s ``swept`` and ``residue`` args are the
   ``EngineStats`` of ``run_stream_chunk`` over the same chunks.
4. With tracing off nothing reads a clock through the telemetry module,
   nor does a batch ``run_stream``, which has no tracer bound.
"""
import time
import types

import numpy as np
import pytest

from repro_torch.apps import ALL_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime import telemetry as tt
from repro_torch.runtime.service import (ServiceConfig, StreamService,
                                         ts_base_for)

STAGES = ("chunk.fill", "chunk.submit", "chunk.wait", "chunk.dispatch",
          "chunk.hold", "chunk.commit")
INTERVAL, K = 16, 2
# app, restructure rung, store and event arguments: SL over 30 records at
# theta 0.99 reaches the residue sweep
CASES = {
    "gs": ("gs", "auto", {}, {}),
    "gs-megakernel": ("gs", "megakernel", {}, {}),
    "sl": ("sl", "auto", dict(n_keys=30), dict(n_keys=30, theta=0.99)),
}


def _engine(case):
    app_name, rung, store_kw, _ = CASES[case]
    app = ALL_APPS[app_name]
    return DualModeEngine(app, app.make_store(device="cpu", **store_kw),
                          EngineConfig(restructure_method=rung),
                          device="cpu")


def _source(case):
    app_name, _, _, gen_kw = CASES[case]
    return ReplaySource(ALL_APPS[app_name].gen_events, 128, seed=11,
                        arrival_batch=13, jitter=5, gen_kwargs=gen_kw)


def _run(case, trace_path=None):
    tcfg = tt.TelemetryConfig(trace_path=trace_path) if trace_path else None
    eng = _engine(case)
    rec = StreamService(eng, ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=K,
        watermark=WatermarkPolicy(allowed_lateness=5),
        telemetry=tcfg)).run(_source(case))
    return eng, rec


def _traced(case, tmp_path):
    path = str(tmp_path / "trace.json")
    eng, rec = _run(case, path)
    events = [ev for ev in tt._parse_trace(path) if ev.get("ph") == "X"]
    return eng, rec, events


def _ns(us: float) -> int:
    """A trace time (us since the tracer's epoch) in whole ns."""
    return round(us * 1e3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_tile_each_chunk(case, tmp_path):
    _, rec, events = _traced(case, tmp_path)
    by_chunk = {}
    for ev in events:
        if ev["name"] in STAGES:
            by_chunk.setdefault(ev["args"]["chunk"], []).append(ev)
    assert sorted(by_chunk) == list(range(len(rec.outputs) // K))
    for ci, evs in by_chunk.items():
        assert sorted(ev["name"] for ev in evs) == sorted(STAGES), ci
        st = {ev["name"]: ev for ev in evs}
        assert {ev["args"]["g0"] for ev in evs} == {ci * K}
        for a, b in zip(STAGES, STAGES[1:]):
            assert _ns(st[a]["ts"] + st[a]["dur"]) == _ns(st[b]["ts"]), \
                (ci, a, b)
        first, last = st["chunk.fill"], st["chunk.commit"]
        total = _ns(last["ts"] + last["dur"]) - _ns(first["ts"])
        assert sum(_ns(st[n]["dur"]) for n in STAGES) == total
        # the fill starts at the first admission: the oldest event of the
        # chunk's first interval waited from there to the commit's stamp,
        # which lies inside chunk.commit (1 us for the clocks' offset)
        oldest_us = float(np.max(rec.latencies[ci * K])) * 1e6
        assert last["ts"] - first["ts"] - 1 <= oldest_us
        assert oldest_us <= last["ts"] + last["dur"] - first["ts"] + 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_two_spans_of_one_track_overlap(case, tmp_path):
    # a trace viewer nests the events of one tid; fill, wait and hold run
    # from one thread's stamp to another's, so each takes lanes of its own.
    # ``chunk.execute`` (the reference's: dispatch to commit, over the next
    # chunk's dispatch on the executor's track) is left as it is
    _, _, events = _traced(case, tmp_path)
    by_tid = {}
    for ev in events:
        if ev["name"] != "chunk.execute":
            by_tid.setdefault(ev["tid"], []).append(
                (_ns(ev["ts"]), _ns(ev["ts"] + ev["dur"]), ev["name"]))
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e[0], -e[1]))
        for i, (a0, a1, a) in enumerate(evs):
            for b0, b1, b in evs[i + 1:]:
                if b0 >= a1:
                    break
                assert b1 <= a1, (tid, a, b)    # b starts inside a: nests
    tracks = {ev["name"]: set() for ev in events
              if ev["name"] in ("chunk.fill", "chunk.wait", "chunk.hold")}
    for ev in events:
        if ev["name"] in tracks:
            tracks[ev["name"]].add(ev["tid"])
    assert len(tracks) == 3
    for a in tracks:
        for b in tracks:
            assert a == b or not tracks[a] & tracks[b]


@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_parts_nest_inside_the_dispatch(case, tmp_path):
    eng, _, events = _traced(case, tmp_path)
    dispatches = [ev for ev in events if ev["name"] == "chunk.dispatch"]
    parts = [ev for ev in events if ev["name"].startswith("dispatch.")]
    want = ["dispatch.compute", "dispatch.intervals", "dispatch.restructure"]
    if case == "gs":
        want.append("dispatch.scan")    # the coefficient scans
    for d in dispatches:
        inside = [p for p in parts if p["tid"] == d["tid"]
                  and d["ts"] <= p["ts"]
                  and p["ts"] + p["dur"] <= d["ts"] + d["dur"]]
        assert sorted(p["name"] for p in inside) == sorted(want)
        for p in inside:
            assert p["args"]["parent"] == "chunk.dispatch"
        (rs,) = [p for p in inside if p["name"] == "dispatch.restructure"]
        assert rs["args"]["rung"] == eng.last_rung
    assert len(parts) == len(want) * len(dispatches)
    # thread CPU time is read on the dispatch alone
    assert all(d["args"]["cpu_us"] >= 0 for d in dispatches)
    assert [ev["name"] for ev in events
            if "cpu_us" in ev.get("args", {})] == \
        ["chunk.dispatch"] * len(dispatches)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lockstep_args_are_the_engine_stats(case, tmp_path):
    _, rec, events = _traced(case, tmp_path)
    args = {ev["args"]["chunk"]: ev["args"] for ev in events
            if ev["name"] == "chunk.dispatch"}
    # the same chunks through run_stream_chunk on a fresh engine: the
    # service's chunks are the in-order stream's, K intervals each
    eng = _engine(case)
    ev_all = _source(case).in_order_events
    vals = eng.init_store.values
    want = {}
    for ci in range(len(rec.outputs) // K):
        lo, hi = ci * K * INTERVAL, (ci + 1) * K * INTERVAL
        batched = events_to_torch(
            {k: v[lo:hi].reshape((K, INTERVAL) + v.shape[1:])
             for k, v in ev_all.items()}, "cpu")
        _, _, vals, st = eng.run_stream_chunk(
            vals, batched, ts_base_for(ci * K, INTERVAL))
        want[ci] = (st["engine"].swept, st["engine"].residue)
    assert {ci: (a["swept"], a["residue"]) for ci, a in args.items()} == want
    if case == "sl":
        assert sum(r for _, r in want.values()) > 0   # the residue sweep ran


def test_cpu_time_from_a_thread_clock_that_reads_zero(tmp_path, monkeypatch):
    # a thread that has not run a tick of its own reads 0 (the executor's
    # first dispatch on a card's host): its dispatch still carries cpu_us
    reads = iter([0, 5_000])
    monkeypatch.setattr(tt, "time", types.SimpleNamespace(
        monotonic_ns=time.monotonic_ns, perf_counter_ns=time.perf_counter_ns,
        thread_time_ns=lambda: next(reads)))
    tr = tt.Tracer(tt.TraceWriter(str(tmp_path / "trace.json")))
    with tr.span("chunk.dispatch", cpu=True) as sp:
        pass
    tr.close()
    assert sp.args["cpu_us"] == 5.0


class _CountingClock:
    """The ``time`` module, counting each read of a clock."""

    CLOCKS = ("monotonic", "monotonic_ns", "perf_counter", "perf_counter_ns",
              "thread_time", "thread_time_ns", "process_time",
              "process_time_ns", "time", "time_ns")

    def __init__(self):
        self.reads = 0

    def __getattr__(self, name):
        fn = getattr(time, name)
        if name not in self.CLOCKS:
            return fn

        def counted(*a):
            self.reads += 1
            return fn(*a)
        return counted


@pytest.mark.parametrize("case", ["gs", "sl"])
def test_an_untraced_run_reads_no_clock(case, tmp_path, monkeypatch):
    clock = _CountingClock()
    monkeypatch.setattr(tt, "time", clock)
    _run(case)
    eng = _engine(case)
    ev = _source(case).in_order_events
    eng.run_stream(eng.init_store.values, ev, INTERVAL)
    assert clock.reads == 0
    assert tt.span("dispatch.compute") is tt._NULL_SPAN
    _run(case, str(tmp_path / "trace.json"))     # the stand-in is the one read
    assert clock.reads > 0
