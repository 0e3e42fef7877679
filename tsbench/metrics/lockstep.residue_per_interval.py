"""lockstep.residue_per_interval: the ops the lockstep walk left to the
sequential residue sweep over the intervals dispatched, summed over the
window's chunks: the ``residue`` and ``k`` args of the service's
``chunk.dispatch`` spans (the chunk's ``EngineStats.residue``, host ints;
runtime/service.py)."""


def read(run):
    d = [ev.get("args", {}) for ev in run.extra.get("spans", ())
         if ev["name"] == "chunk.dispatch"]
    if not d or any("residue" not in a for a in d):
        return None
    k = sum(a["k"] for a in d)
    return sum(a["residue"] for a in d) / k if k else None
