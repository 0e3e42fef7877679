"""driver.loop_ms: the median duration of the fused driver's
``dispatch.intervals`` span (core/scheduler.py, inside the service's
``chunk.dispatch``: the per-interval loop over a chunk's K intervals, or
the megakernel's one call), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "dispatch.intervals"]
    return statistics.median(d) if d else None
