"""lockstep.rounds_per_interval: the lockstep rounds the walk ran (those
with an active op) over the intervals dispatched, summed over the window's
chunks: the ``swept`` and ``k`` args of the service's ``chunk.dispatch``
spans (the chunk's ``EngineStats.swept``, host ints; runtime/service.py)."""


def read(run):
    d = [ev.get("args", {}) for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.dispatch"]
    if not d or any("swept" not in a for a in d):
        return None
    k = sum(a["k"] for a in d)
    return sum(a["swept"] for a in d) / k if k else None
