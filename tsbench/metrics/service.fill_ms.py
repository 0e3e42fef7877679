"""service.fill_ms: the median duration of the service's ``chunk.fill``
span (its Tracer, runtime/service.py: from the first admission of a
chunk's first interval to the start of its ``chunk.submit``), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.fill"]
    return statistics.median(d) if d else None
