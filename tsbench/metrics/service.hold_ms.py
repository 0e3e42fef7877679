"""service.hold_ms: the median duration of the service's ``chunk.hold``
span (its Tracer, runtime/service.py: from the end of a chunk's dispatch
to the start of its commit, which waits for the next chunk to be in
flight), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.hold"]
    return statistics.median(d) if d else None
