"""loadgen.late_ms_p95: how far behind its schedule the open-loop generator
handed a batch to the service's source, 95th percentile over the window's
batches, in ms (host clock).  A late batch is still timed from when it was
due, so this is the part of the latency the harness itself adds."""
import numpy as np


def read(run):
    late = run.extra.get("late_s")
    if late is None or len(late) == 0:
        return None
    return float(np.percentile(late, 95)) * 1e3
