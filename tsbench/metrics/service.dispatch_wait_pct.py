"""service.dispatch_wait_pct: the share of the service's ``chunk.dispatch``
wall time in which the executor thread used no CPU, in %: 100 x (1 - the
spans' thread CPU time (``cpu_us``) over their duration), summed over the
chunks whose dispatch ended before the profiler started.  The rest is
waiting, on the GIL or on a device read.  The profiled stretch, and the
drain after it, are left out: there the profiler's own work on the host
holds the GIL against the executor.

The profiler starts ``profile_from`` of the window's schedule after the
window's start (``drivers/service.py``).  On the spans' clock the window
starts at the first chunk's first admission (the earliest ``chunk.fill``)
less the first batch's due time, both from the run's seed."""
from tsbench.drivers.service import schedule


def read(run):
    spans = run.extra.get("spans", ())
    d = [ev for ev in spans if ev["name"] == "chunk.dispatch"]
    fills = [ev["ts"] for ev in spans if ev["name"] == "chunk.fill"]
    if not d or not fills or any("cpu_us" not in ev.get("args", {})
                                 for ev in d):
        return None
    c = run.cell
    interval, batch = int(c["interval"]), int(c["arrival_batch"])
    rel = schedule(run.seed, float(c["rate_events_per_s"]), run.seconds,
                   batch, interval * int(c["chunk_intervals"]) // batch)
    t_prof = min(fills) + (float(c["profile_from"]) * rel[-1] - rel[0]) * 1e6
    d = [ev for ev in d if ev["ts"] + ev["dur"] <= t_prof]
    wall = sum(ev["dur"] for ev in d)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(ev["args"]["cpu_us"] for ev in d) / wall)
