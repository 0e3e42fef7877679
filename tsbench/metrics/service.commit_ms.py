"""service.commit_ms: the median duration of the service's ``chunk.commit``
span (its Tracer, runtime/service.py: post-processing, the device-to-host
reads of a chunk's outputs and its record), in ms."""
import statistics


def read(run):
    d = [ev["dur"] / 1e3 for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.commit"]
    return statistics.median(d) if d else None
