"""service.wait_ms: the median duration of the service's ``chunk.wait``
span (its Tracer, runtime/service.py: from the end of a chunk's submit,
through the executor's work queue, to the start of its dispatch), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.wait"]
    return statistics.median(d) if d else None
