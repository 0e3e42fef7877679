"""device.idle_pct.service: the share of the profiled stretch of the
service's window (from ``profile_from`` of it to its end) in which no
kernel, copy or memset ran on the card, in % (torch.profiler)."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0 or not p["ops"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
