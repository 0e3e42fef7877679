"""segscan_affine_roofline: the affine segmented scan's share of its
roofline in the traced stretch, in %: the least time its work could take
on the card (bytes over the memory bandwidth or operations over the float32
rate, whichever is larger, at the peaks of ``peaks.json``) over the device
time of its launches (``segscan_kernel<false, ...>`` in the trace).  The
work is reckoned from the cell's inputs: a launch scans every access of
the events it covers (a call's, or a service chunk's), by
``cost/segscan_affine.py``."""
import json
from pathlib import Path

from tsbench.cost.segscan_affine import cost

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def read(run):
    import torch
    p = run.profile
    if p is None or run.device == "cpu":
        return None
    ks = [op for op in p["ops"] if op[3] == "kernel"
          and "segscan_kernel<false" in op[0]]
    if not ks:
        return None
    peak = json.loads(PEAKS.read_text())["devices"].get(
        torch.cuda.get_device_name(0).lower())
    if peak is None:
        return None
    rows = run.profiled["events_per_scan"] * int(run.config["ops"])
    nbytes, flops = cost(rows, int(run.config["width"]))
    least = len(ks) * max(nbytes / peak["bytes_per_s"],
                          flops / peak["flops_f32"])
    spent = sum(e - s for _, s, e, _ in ks) / 1e6
    return 100.0 * least / spent
