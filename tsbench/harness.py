"""What every cell shares: the files named in BENCHMARK.json, the inputs
made from the seed, the device trace, and the comparison that decides
``correct``.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``).  The
app a configuration names picks ``traffic/<app>.py`` (the generator) and
``reference/<app>.py`` (the plain reference).  Each per-layer metric is read
by ``metrics/<metric>.py``.  Everything is found by name, so a new cell,
configuration or metric is a new file.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(rel: str) -> dict:
    with open(HERE / rel) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def module(kind: str, name: str):
    """``tsbench.<kind>.<name>`` (a driver, generator, reference or cost)."""
    return importlib.import_module(f"tsbench.{kind}.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded by path: a metric's name has dots."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tsbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(names) -> list:
    """Loaded modules whose top-level name is jax's, flax's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Run:
    """One run of one cell: its settings, the program under test, and what
    the window and the trace collected for the metric readers."""

    def __init__(self, cell_name: str, seed: int, seconds: float,
                 trace: bool, device: str, t0: float, overrides=None):
        self.cell_name = cell_name
        self.cell = load(f"workloads/{cell_name}.json")
        self.cell.update(overrides or {})
        self.config = load(f"configs/{self.cell['config']}.json")
        self.seed, self.seconds = int(seed), float(seconds)
        self.trace, self.device, self.t0 = bool(trace), device, t0
        self.e2e = {}              # end-to-end metric -> value
        self.spans = []            # (name, seconds, intervals) of the harness
        self.profile = None        # DeviceTrace.read() of the traced window
        self.profiled = {}         # events and intervals the trace covers
        self.extra = {}            # driver-specific readings for readers
        self.attempted = 0
        self.committed = 0
        self.program_outputs = None
        self.program_state = None
        self.blocks = []           # the stream the window ran, in order
        self.initial_state_host = None   # float32 [S], the stream's start

    # -- inputs from the seed ---------------------------------------------
    @property
    def n_slots(self) -> int:
        return int(sum(self.config["tables"]))

    def generator(self, stream: int):
        """A torch generator on the run's device for input ``stream`` of
        the seed: 0 the state, 1 the events."""
        import torch
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 4 + stream) % (2 ** 63))
        return g

    def initial_state(self):
        """float32 [S] drawn uniformly from the configuration's range."""
        import torch
        lo, hi = self.config["init"]
        g = self.generator(0)
        return torch.rand(self.n_slots, generator=g,
                          device=self.device) * (hi - lo) + lo

    def events(self, n_events: int) -> dict:
        """``n_events`` events of the cell's traffic, on the host, in page-
        locked memory where the device is a card (numpy views)."""
        import torch
        gen = module("traffic", self.config["app"])
        ev = gen.generate(self.generator(1), int(n_events),
                          config=self.config, traffic=self.cell["traffic"])
        pin = self.device != "cpu"
        out = {}
        for k, v in ev.items():
            host = torch.empty(v.shape, dtype=v.dtype, pin_memory=pin)
            host.copy_(v)
            out[k] = host.numpy()
        return out

    def engine(self, state):
        """The port's engine on the run's device, over ``state``."""
        import torch
        from repro_torch.apps import ALL_APPS
        from repro_torch.core.scheduler import DualModeEngine, EngineConfig
        from repro_torch.core.types import make_store
        width = int(self.config["width"])
        init = torch.zeros((self.n_slots + 1, width), dtype=torch.float32,
                           device=self.device)
        init[: self.n_slots, 0] = state
        store = make_store(self.config["tables"], width, init=init,
                           device=self.device)
        return DualModeEngine(ALL_APPS[self.config["app"]], store,
                              EngineConfig(**self.config["engine"]),
                              device=self.device)

    def sync(self) -> None:
        import torch
        if self.device != "cpu":
            torch.cuda.synchronize()


# -- the device trace -----------------------------------------------------
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# the runtime's and the driver's calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                "cudaLaunchCooperativeKernel")


class DeviceTrace:
    """``torch.profiler`` over a stretch of the run.  ``start`` records an
    anchor that maps ``time.monotonic_ns`` onto the trace's clock, so the
    harness's and the program's host spans can be laid over the device's
    operations."""

    def __init__(self):
        self.prof = None
        self.anchor_ns = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    @classmethod
    def warm_up(cls) -> None:
        """Start the profiler's machinery once (it takes seconds the first
        time in a process) so that it does not stall the window."""
        with cls._profile():
            pass

    def start(self) -> None:
        from torch.profiler import record_function
        self.prof = self._profile()
        self.prof.start()
        with record_function("tsbench.anchor"):
            self.anchor_ns = time.monotonic_ns()

    def stop(self) -> dict:
        """Stop, and return the trace's device operations and host events
        (name, start us, duration us, thread) and the anchor's time."""
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="tsbench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        dev, host, anchor = [], [], None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            item = (ev.get("name", ""), float(ev["ts"]),
                    float(ev.get("dur", 0.0)), ev.get("tid"))
            if cat in DEVICE_CATS:
                dev.append(item + (cat,))
            elif cat in HOST_CATS:
                host.append(item)
                if ev.get("name") == "tsbench.anchor":
                    anchor = float(ev["ts"])
        return dict(device=dev, host=host, anchor_us=anchor,
                    anchor_ns=self.anchor_ns)


def trace_us(profile: dict, mono_ns: int) -> float:
    """A ``time.monotonic_ns`` stamp on the trace's clock."""
    return profile["anchor_us"] + (mono_ns - profile["anchor_ns"]) / 1e3


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_window(profile: dict, w0_us: float, w1_us: float,
                  host_spans=()) -> dict:
    """Busy and idle time of the device inside [w0, w1] (trace us): the
    union of its operations, the operations that took most time, and the
    idle gaps by what the host was doing (the innermost host event over the
    gap's middle; ``host_spans`` adds the program's own spans).  ``ops``
    are the operations that start inside the window, whole."""
    ops = [(n, s, s + d, cat) for n, s, d, _, cat in profile["device"]
           if w0_us <= s < w1_us]
    launches = sum(1 for n, s, *_ in profile["host"]
                   if w0_us <= s < w1_us and n.startswith(LAUNCH_CALLS))
    kernels = sum(1 for op in ops if op[3] == "kernel")
    print(f"trace: {launches} kernel launches on the host, {kernels} kernels "
          f"on the device, {len(ops)} device operations", file=sys.stderr)
    if kernels < launches // 2:
        raise RuntimeError(
            f"the device trace lost its kernels: the host launched "
            f"{launches}, the trace holds {kernels}; its busy time and "
            f"kernel counts would read wrong")
    busy = _union([(s, min(e, w1_us)) for _, s, e, _ in ops])
    busy_us = sum(e - s for s, e in busy)
    by_op = {}
    for n, s, e, _ in ops:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
    gaps, t = [], w0_us
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1_us:
        gaps.append((t, w1_us))
    label = _innermost(list(profile["host"]) + list(host_spans),
                       [(a + b) / 2 for a, b in gaps])
    by_gap = {}
    for (a, b), name in zip(gaps, label):
        by_gap[name] = by_gap.get(name, 0.0) + (b - a) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_us / 1e6, window_s=(w1_us - w0_us) / 1e6,
                ops=ops, breakdown=dict(device_ops=top(by_op),
                                        idle_gaps=top(by_gap)))


def _innermost(events, points) -> list:
    """For each point, the name of the innermost host event over it on any
    thread, the shortest where threads differ ("no host event" where none
    is).  Events of one thread nest, so a stack per thread sweeps them."""
    events = sorted(events, key=lambda e: e[1])
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = ["no host event"] * len(points)
    stacks, j = {}, 0
    for i in order:
        p = points[i]
        while j < len(events) and events[j][1] <= p:
            n, s, d, tid = events[j][:4]
            st = stacks.setdefault(tid, [])
            while st and st[-1][1] < s:
                st.pop()
            st.append((n, s + d, d))
            j += 1
        best = None
        for st in stacks.values():
            while st and st[-1][1] < p:
                st.pop()
            if st and (best is None or st[-1][2] < best[2]):
                best = st[-1]
        if best is not None:
            out[i] = best[0]
    return out


# -- correct ---------------------------------------------------------------
def compare(kinds: dict, got: dict, want: dict, got_state, want_state,
            missing: int) -> dict:
    """The numbers compared, by the reference's output kinds: per output a
    ``<name>_gap`` (largest |got - want| / max(1, |want|)) or a
    ``<name>_wrong`` (count of events that differ), the state's gap, and
    the events offered that were never answered."""
    out = {}
    for name, kind in kinds.items():
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.shape[0] > b.shape[0]:
            raise ValueError(f"{name}: {a.shape[0]} answers for "
                             f"{b.shape[0]} events")
        b = b[: a.shape[0]]       # the rest are counted as missing
        if kind == "gap":
            a, b = a.astype(np.float64), b.astype(np.float64)
            gap = np.abs(a - b) / np.maximum(1.0, np.abs(b))
            out[f"{name}_gap"] = float(gap.max()) if gap.size else 0.0
            if gap.size and not np.isfinite(a).all():
                out[f"{name}_gap"] = float("inf")
        else:
            out[f"{name}_wrong"] = int(np.count_nonzero(a != b))
    a = np.asarray(got_state, np.float64)
    b = np.asarray(want_state, np.float64)
    gap = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    out["state_gap"] = (float(gap.max()) if np.isfinite(a).all()
                        else float("inf"))
    out["missing"] = int(missing)
    return out


def reference_run(run: Run, dtype: str = "float32"):
    """The plain reference over the stream the window ran."""
    ref = module("reference", run.config["app"])
    return ref.run(run.initial_state_host, run.blocks, dtype=dtype,
                   device=run.device)


def check(run: Run) -> dict:
    """{number: (value, limit)} for the run, against the reference."""
    ref = module("reference", run.config["app"])
    want, want_state = reference_run(run)
    nums = compare(ref.OUTPUTS, run.program_outputs, want,
                   run.program_state, want_state,
                   run.attempted - run.committed)
    limits = run.config["limits"]
    return {k: (v, limits[k]) for k, v in nums.items()}


def device_info(run: Run) -> dict:
    import torch
    if run.device == "cpu":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                count=int(run.cell.get("chips", 1)),
                memory_peak_bytes=int(torch.cuda.max_memory_allocated()))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, overrides=None) -> dict:
    """One run of ``cell``: set-up, the window, the metrics, the check.
    Returns the result line (without the check of loaded modules)."""
    import torch
    run = Run(cell, seed, seconds, trace, device, t0, overrides)
    if device != "cpu":
        torch.cuda.init()
    driver = module("drivers", run.cell["driver"])
    driver.run(run)                     # set-up and the window
    from repro_torch.kernels.runtime import LAUNCHES
    print(f"kernel launches: {dict(LAUNCHES)}", file=sys.stderr)
    dev = device_info(run)
    bench = benchmark()
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if cell not in m.get("workloads", [cell]):
                continue
            v = metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
        if run.profile is not None:
            dev["busy_s"] = run.profile["busy_s"]
            dev["window_s"] = run.profile["window_s"]
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if cell in m.get("workloads", [cell]) and m["name"] in run.e2e:
                metrics[m["name"]] = dict(value=float(run.e2e[m["name"]]),
                                          unit=m["unit"])
    driver.release(run)                 # the program's state, before the check
    if device != "cpu":
        torch.cuda.empty_cache()
    checks = check(run)
    correct = all(v <= lim for v, lim in checks.values())
    out = dict(correct=correct, attempted=int(run.attempted),
               failed=int(run.attempted - run.committed), metrics=metrics,
               device=dev)
    if trace and run.profile is not None:
        out["breakdown"] = run.profile["breakdown"]
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    return out
