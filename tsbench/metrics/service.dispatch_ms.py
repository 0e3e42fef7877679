"""service.dispatch_ms: the median duration of the service's
``chunk.dispatch`` span (its Tracer, runtime/service.py: one chunk of K
intervals through ``run_stream_chunk``), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.dispatch"]
    return statistics.median(d) if d else None
