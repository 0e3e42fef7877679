"""driver.prologue_ms: the fused driver's work before its interval loop in
a chunk, median over the service's chunks, in ms: the durations of the
``dispatch.compute``, ``dispatch.restructure`` and ``dispatch.scan`` spans
(core/scheduler.py) that lie inside one ``chunk.dispatch`` span on its
thread, summed."""
import statistics

PARTS = ("dispatch.compute", "dispatch.restructure", "dispatch.scan")


def read(run):
    spans = run.extra.get("spans", ())
    parts = [ev for ev in spans if ev["name"] in PARTS]
    if not parts:
        return None
    per = []
    for d in spans:
        if d["name"] != "chunk.dispatch":
            continue
        t0, t1 = d["ts"], d["ts"] + d["dur"]
        per.append(sum(p["dur"] for p in parts if p["tid"] == d["tid"]
                       and t0 <= p["ts"] and p["ts"] + p["dur"] <= t1) / 1e3)
    return statistics.median(per) if per else None
