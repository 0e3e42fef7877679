"""service.dispatch_device_idle_pct: the share of the service's
``chunk.dispatch`` wall time in the profiled stretch in which no kernel,
copy or memset ran on the card, in % (torch.profiler).

Each span is laid on the device trace's clock through the trace's
``trace.clock`` event: its ``time.monotonic_ns`` stamp is the event's
``epoch_monotonic_ns`` plus the span's ``ts``.  The run keeps the device
operations but not the anchor that maps that clock onto the trace's
(``harness.DeviceTrace``), so the reader takes one anew: one short
profiler session of the host alone (no device activity), in which a
marked range and a ``time.monotonic_ns`` read meet.  Its host events are
on the clock of the run's trace, which Kineto keeps from one session to
the next in a process.  The profiled stretch runs from the first device
operation's start to the last's end."""
import bisect
import json
import os
import tempfile
import time

from tsbench.harness import _union


def _offset_us():
    """Trace us minus monotonic us, from one host-only profiler session."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("tsbench.anchor"):
            anchor_ns = time.monotonic_ns()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="tsbench_anchor_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    (ts,) = [float(ev["ts"]) for ev in events
             if ev.get("name") == "tsbench.anchor" and ev.get("ph") == "X"]
    return ts - anchor_ns / 1e3


def read(run):
    p = run.profile
    if p is None or run.device == "cpu" or not p["ops"]:
        return None
    spans = run.extra.get("spans", ())
    clock = [ev for ev in spans if ev["name"] == "trace.clock"]
    if not clock:
        return None
    epoch = int(clock[0]["args"]["epoch_monotonic_ns"])
    off = _offset_us()
    busy = _union([(s, e) for _, s, e, _ in p["ops"]])
    starts = [s for s, _ in busy]
    before = [0.0]                  # busy time before each busy interval
    for s, e in busy:
        before.append(before[-1] + e - s)

    def busy_until(t):
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0.0
        return before[i] + min(t, busy[i][1]) - busy[i][0]

    lo, hi = busy[0][0], busy[-1][1]
    wall = busy_in = 0.0
    for ev in spans:
        if ev["name"] != "chunk.dispatch":
            continue
        s = off + epoch / 1e3 + ev["ts"]
        t0, t1 = max(lo, s), min(hi, s + ev["dur"])
        if t1 <= t0:
            continue
        wall += t1 - t0
        busy_in += busy_until(t1) - busy_until(t0)
    return 100.0 * (1.0 - busy_in / wall) if wall > 0 else None
