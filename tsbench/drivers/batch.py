"""Batch driver: ``DualModeEngine.run_stream(fused=True)`` fed back to back.

Each call takes ``intervals_per_call`` punctuation intervals of
``interval`` events, and the state one call returns is the next call's
input.  The events come from a pool of ``pool_calls`` calls made from the
seed in set-up; a window that outruns it takes the pool again from its
start, over the state the window has reached.  Set-up ends with one call at
the window's shapes, whose results are dropped; the window then runs from
the initial state until ``seconds`` have passed, and its rate is every
event of every call over the wall time of all of them, synchronised at both
ends.  A traced run then runs ``profile_calls`` more calls under the
profiler.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from tsbench.harness import DeviceTrace, device_window, trace_us


def run(run) -> None:
    cell = run.cell
    interval, per_call = int(cell["interval"]), int(cell["intervals_per_call"])
    n_call = interval * per_call
    n_pool = int(cell["pool_calls"])
    state = run.initial_state()
    run.initial_state_host = state.cpu().numpy()
    pool = run.events(n_call * n_pool)
    eng = run.engine(state)
    run.extra["engine"] = eng

    def block(c):
        lo = (c % n_pool) * n_call
        return {k: v[lo: lo + n_call] for k, v in pool.items()}

    def call(values, c, span="run_stream"):
        t = time.perf_counter()
        outs, values = eng.run_stream(values, block(c), interval, fused=True)
        run.sync()
        run.spans.append((span, time.perf_counter() - t, per_call))
        calls.append(outs)
        run.blocks.append(block(c))
        return values
    init = eng.init_store.values
    eng.run_stream(init, block(0), interval, fused=True)      # warm-up
    if run.trace:
        DeviceTrace.warm_up()
    run.sync()
    calls = []
    values = init
    t_start = time.perf_counter()
    setup_s = t_start - run.t0
    while time.perf_counter() - t_start < run.seconds:
        values = call(values, len(calls))
    window_s = time.perf_counter() - t_start
    run.e2e = dict(events_per_s=len(calls) * n_call / window_s,
                   setup_s=setup_s)
    per = sorted(s for name, s, _ in run.spans if name == "run_stream")
    print(f"batch: {len(calls)} calls of {n_call} events in {window_s:.3f} "
          f"s (the pool {len(calls) / n_pool:.2f} times); a call "
          f"{per[0]:.4f} / {per[len(per) // 2]:.4f} / {per[-1]:.4f} s "
          f"(least / median / most)", file=sys.stderr)

    if run.trace:
        tr = DeviceTrace()
        tr.start()
        w0 = time.monotonic_ns()
        first = len(calls)
        for _ in range(int(cell["profile_calls"])):
            values = call(values, len(calls), "run_stream.profiled")
        w1 = time.monotonic_ns()
        prof = tr.stop()
        run.profile = device_window(prof, trace_us(prof, w0),
                                    trace_us(prof, w1))
        run.profiled = dict(intervals=(len(calls) - first) * per_call,
                            events_per_scan=n_call)

    run.attempted = run.committed = len(calls) * n_call
    keys = calls[0][0].keys()
    run.program_outputs = {k: np.concatenate([o[k] for outs in calls
                                              for o in outs]) for k in keys}
    run.program_state = values[: run.n_slots, 0].cpu().numpy()


def release(run) -> None:
    run.extra.pop("engine", None)
