"""lockstep.launches_per_interval: the kernels the card ran in the profiled
calls over the intervals they hold (torch.profiler's kernel events; copies
and memsets are not launches)."""


def read(run):
    p = run.profile
    n = run.profiled.get("intervals", 0)
    if p is None or not n:
        return None
    k = sum(1 for op in p["ops"] if op[3] == "kernel")
    return k / n if k else None
