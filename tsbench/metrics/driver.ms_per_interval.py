"""driver.ms_per_interval: the median over the window's ``run_stream``
calls of a call's wall time (the harness's span around it, synchronised)
divided by its intervals, in ms.  Calls under the profiler are left out."""
import statistics


def read(run):
    per = [s / n * 1e3 for name, s, n in run.spans if name == "run_stream"]
    return statistics.median(per) if per else None
