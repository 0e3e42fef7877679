"""Service driver: ``StreamService`` under an open-loop load.

A load generator on a thread of its own offers the cell's events in
batches of ``arrival_batch`` at Poisson arrival times, at the fixed rate
``rate_events_per_s``, whatever the service does.  The schedule is drawn
from the seed: as many batches as the rate fills in ``seconds``, rounded up
to whole chunks of ``chunk_intervals`` intervals, their gaps scaled so that
the mean rate is exactly the cell's.  Each event is due when its batch is;
its latency runs from that time to the commit of its interval, so a stall
counts against every event it delays.  After the last batch the service
drains what was offered.

Set-up ends with a run of ``warmup_chunks`` chunks of the pool's head,
unpaced, whose results are dropped; the window's run starts from the
initial state.  A traced run writes the service's spans and profiles the
device from ``profile_from`` of the window to its end.
"""
from __future__ import annotations

import json
import math
import os
import queue
import sys
import tempfile
import threading
import time

import numpy as np

from tsbench.harness import DeviceTrace, device_window, trace_us


class OpenLoop:
    """Hands batch ``i`` to the service's source at ``due[i]`` (a
    ``time.perf_counter`` time) and records how late it did so."""

    def __init__(self, pool: dict, batch: int, due: np.ndarray):
        self.pool, self.batch, self.due = pool, batch, due
        self.late = np.zeros(len(due))
        self._q = queue.Queue()
        self.thread = threading.Thread(target=self._offer, daemon=True,
                                       name="tsbench-load")

    def _offer(self) -> None:
        b = self.batch
        for i, d in enumerate(self.due):
            now = time.perf_counter()
            while now < d:
                time.sleep(d - now)
                now = time.perf_counter()
            cols = {k: v[i * b: (i + 1) * b] for k, v in self.pool.items()}
            self._q.put((cols, np.arange(i * b, (i + 1) * b,
                                         dtype=np.int64)))
            self.late[i] = time.perf_counter() - d
        self._q.put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            yield item


def _unpaced(pool: dict, batch: int, n_events: int):
    for lo in range(0, n_events, batch):
        yield ({k: v[lo: lo + batch] for k, v in pool.items()},
               np.arange(lo, lo + batch, dtype=np.int64))


def schedule(seed: int, rate: float, seconds: float, batch: int,
             per_chunk: int) -> np.ndarray:
    """Due times (s from the window's start) of the window's batches."""
    n = per_chunk * math.ceil(rate * seconds / batch / per_chunk)
    gaps = np.random.default_rng(seed).exponential(1.0, n)
    t = np.cumsum(gaps)
    return t * (n * batch / rate / t[-1])


def _service(run, eng, telemetry=None):
    from repro_torch.core.intervals import WatermarkPolicy
    from repro_torch.runtime.service import ServiceConfig, StreamService
    c = run.cell
    return StreamService(eng, ServiceConfig(
        punct_interval=int(c["interval"]),
        chunk_intervals=int(c["chunk_intervals"]),
        queue_intervals=int(c["queue_intervals"]), admission=c["admission"],
        watermark=WatermarkPolicy(allowed_lateness=0), telemetry=telemetry))


def run(run) -> None:
    cell = run.cell
    interval, batch = int(cell["interval"]), int(cell["arrival_batch"])
    k = int(cell["chunk_intervals"])
    if (interval * k) % batch:
        raise ValueError("a chunk must hold whole arrival batches")
    rate = float(cell["rate_events_per_s"])
    rel = schedule(run.seed, rate, run.seconds, batch, interval * k // batch)
    n_events = len(rel) * batch
    state = run.initial_state()
    run.initial_state_host = state.cpu().numpy()
    pool = run.events(n_events)
    eng = run.engine(state)
    run.extra["engine"] = eng
    init = eng.init_store.values
    n_warm = min(n_events, int(cell["warmup_chunks"]) * k * interval)
    _service(run, eng).run(_unpaced(pool, batch, n_warm), values=init)
    if run.trace:
        DeviceTrace.warm_up()
    run.sync()

    tmp = tempfile.TemporaryDirectory(prefix="tsbench_spans_")
    telemetry = None
    if run.trace:
        from repro_torch.runtime.telemetry import TelemetryConfig
        telemetry = TelemetryConfig(
            trace_path=os.path.join(tmp.name, "spans.jsonl"))
    svc = _service(run, eng, telemetry)
    t_start = time.perf_counter() + 0.01
    load = OpenLoop(pool, batch, t_start + rel)
    t_end = t_start + rel[-1]
    prof = _Profiler(t_start + float(cell["profile_from"]) * rel[-1],
                     t_end) if run.trace else None
    load.thread.start()
    if prof is not None:
        prof.thread.start()
    run.e2e["setup_s"] = t_start - run.t0
    t_call_ns = time.monotonic_ns()
    try:
        rec = svc.run(load, values=init)
    finally:
        if prof is not None:
            prof.done.set()
            prof.thread.join()
        load.thread.join(timeout=60.0)

    commit = np.array([c["commit_s"] for c in sorted(
        rec.commits, key=lambda c: c["interval"])])
    n_done = len(commit) * interval
    lat = (np.repeat(commit, interval)
           - np.repeat(t_start + rel, batch)[:n_done])
    run.e2e["latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    fifth = max(1, n_done // 5)
    print(f"service: offered {n_events} events at {rate:.0f}/s over "
          f"{rel[-1]:.3f} s; committed {n_done}, "
          f"{n_done / (commit[-1] - t_start):.0f} events/s; latency p50 "
          f"first fifth {np.median(lat[:fifth]) * 1e3:.3f} ms, last fifth "
          f"{np.median(lat[-fifth:]) * 1e3:.3f} ms, p95 "
          f"{run.e2e['latency_p95_ms']:.3f} ms, max {lat.max() * 1e3:.3f} "
          f"ms", file=sys.stderr)
    run.extra["late_s"] = load.late
    run.attempted, run.committed = n_events, n_done
    keys = rec.outputs[0].keys()
    run.program_outputs = {k: np.concatenate([o[k] for o in rec.outputs])
                           for k in keys}
    run.program_state = np.asarray(rec.final_values)[: run.n_slots, 0]
    step = 1 << 20
    run.blocks = [{k: v[lo: lo + step] for k, v in pool.items()}
                  for lo in range(0, n_events, step)]

    if run.trace:
        with open(telemetry.trace_path) as f:
            spans = [ev for ev in json.load(f) if ev.get("ph") == "X"]
        run.extra["spans"] = spans
        p = prof.result
        if p is None:
            raise RuntimeError("the window ended before the profiler "
                               "started: raise seconds or profile_from")
        host = [(ev["name"], trace_us(p, t_call_ns + int(ev["ts"] * 1e3)),
                 float(ev["dur"]), ("span", ev["tid"])) for ev in spans]
        w0_us, w1_us = trace_us(p, prof.w0), trace_us(p, prof.w1)
        run.profile = device_window(p, w0_us, w1_us, host_spans=host)
        chunks = sum(1 for name, s0, _, _ in host
                     if name == "chunk.dispatch" and w0_us <= s0 < w1_us)
        run.profiled = dict(intervals=chunks * k, events_per_scan=k * interval)
    tmp.cleanup()


class _Profiler:
    """Profiles the device from ``at`` to ``until`` (perf_counter times),
    on a thread of its own that starts and stops the profiler (it records
    the thread that starts it).  It stops at the window's end, while the
    service's executor still runs, not after that thread has ended; ``done``
    cuts it short."""

    def __init__(self, at: float, until: float):
        self.at, self.until = at, until
        self.done = threading.Event()
        self.result = None
        self.w0 = self.w1 = None
        self.thread = threading.Thread(target=self._work, daemon=True,
                                       name="tsbench-profile")

    def _work(self) -> None:
        if self.done.wait(max(0.0, self.at - time.perf_counter())):
            return
        tr = DeviceTrace()
        tr.start()
        self.w0 = time.monotonic_ns()
        self.done.wait(max(0.0, self.until - time.perf_counter()))
        self.w1 = time.monotonic_ns()
        self.result = tr.stop()


def release(run) -> None:
    run.extra.pop("engine", None)
