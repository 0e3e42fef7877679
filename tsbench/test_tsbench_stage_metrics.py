"""The readers of the service's stage spans: a traced CPU run of each
service cell reports them, the device's share is left out without a card,
a trace without the spans (an older program's) gives nothing rather than
raising, the device share meets a count by hand, and its anchor comes from
a host-only profiler session."""
import math
import time
import types

import pytest

from tsbench import harness
from tsbench.test_tsbench_faults import SEED, TINY

SPAN_METRICS = ["service.fill_ms", "service.wait_ms", "service.hold_ms",
                "driver.prologue_ms", "driver.loop_ms",
                "service.dispatch_wait_pct"]
LOCKSTEP = ["lockstep.rounds_per_interval", "lockstep.residue_per_interval"]
DEVICE = "service.dispatch_device_idle_pct"


@pytest.mark.parametrize("cell", ["gs-paper.service", "sl-ledger.service"])
def test_a_traced_run_reports_the_stage_metrics(cell):
    # long enough that chunks dispatch before the profiler starts, which
    # service.dispatch_wait_pct reads
    out = harness.run_cell(cell, SEED, 0.3, True, "cpu", time.perf_counter(),
                           dict(TINY[cell], profile_from=0.8))
    assert out["correct"], out["checks"]
    m = out["metrics"]
    want = SPAN_METRICS + (LOCKSTEP if cell.startswith("sl") else [])
    assert set(want) <= set(m), sorted(m)
    for name in ("service.fill_ms", "service.hold_ms", "driver.loop_ms"):
        assert m[name]["value"] > 0, name
    assert 0 <= m["service.dispatch_wait_pct"]["value"] <= 100
    # the CPU has no device trace: the share is left out, not 0
    assert DEVICE not in m


def _fake_run(spans, ops=((0.0, 10.0),)):
    profile = dict(ops=[("k", s, e, "kernel") for s, e in ops])
    return types.SimpleNamespace(device="cuda", profile=profile,
                                 extra=dict(spans=spans))


def test_readers_of_a_trace_without_the_stages_give_nothing():
    old = [dict(name="chunk.dispatch", ts=1.0, dur=5.0, tid=1,
                args=dict(g0=0, k=8)),
           dict(name="chunk.commit", ts=7.0, dur=1.0, tid=1,
                args=dict(g0=0, k=8))]
    for name in SPAN_METRICS + LOCKSTEP + [DEVICE]:
        assert harness.metric_reader(name).read(_fake_run(old)) is None, name


def test_dispatch_device_idle_share_by_hand(monkeypatch):
    reader = harness.metric_reader(DEVICE)
    # the profiler's clock: trace us = monotonic ns / 1e3 + 1,000
    monkeypatch.setattr(reader, "_offset_us", lambda: 1_000.0)
    epoch_ns = 9_000
    spans = [dict(name="trace.clock", ts=0, dur=0, tid=1,
                  args=dict(epoch_monotonic_ns=epoch_ns)),
             # on the trace's clock: [1,019, 1,029] and [1,049, 1,069]
             dict(name="chunk.dispatch", ts=10.0, dur=10.0, tid=2, args={}),
             dict(name="chunk.dispatch", ts=40.0, dur=20.0, tid=2, args={}),
             # wholly before the first device operation: outside the stretch
             dict(name="chunk.dispatch", ts=-2.0, dur=1.0, tid=2, args={})]
    ops = [(1_010.0, 1_021.0), (1_020.0, 1_024.0), (1_050.0, 1_055.0),
           (1_065.0, 1_080.0)]
    # busy in the dispatches: [1,019, 1,024] + [1,050, 1,055] + [1,065,
    # 1,069] = 14 us of 30
    assert reader.read(_fake_run(spans, ops)) == pytest.approx(
        100.0 * (1 - 14 / 30))


def test_the_anchor_of_a_host_only_profiler_session():
    # the profiler's clock keeps its offset from monotonic from one session
    # to the next in a process (seconds apart where it did not)
    reader = harness.metric_reader(DEVICE)
    a, b = reader._offset_us(), reader._offset_us()
    assert math.isfinite(a) and abs(a - b) < 10_000


def test_dispatch_wait_share_leaves_the_profiled_stretch_out():
    from tsbench.drivers.service import schedule
    reader = harness.metric_reader("service.dispatch_wait_pct")
    cell = dict(TINY["gs-paper.service"], profile_from=0.5)
    rel = schedule(SEED, cell["rate_events_per_s"], 0.05,
                   cell["arrival_batch"],
                   cell["interval"] * cell["chunk_intervals"]
                   // cell["arrival_batch"])
    t_prof = 500.0 + (0.5 * rel[-1] - rel[0]) * 1e6   # first fill at 500 us
    spans = [dict(name="chunk.fill", ts=500.0, dur=10.0, tid=2, args={}),
             dict(name="chunk.dispatch", ts=t_prof - 101.0, dur=100.0, tid=3,
                  args=dict(cpu_us=30.0)),
             dict(name="chunk.dispatch", ts=t_prof - 50.0, dur=100.0, tid=3,
                  args=dict(cpu_us=0.0))]
    run = types.SimpleNamespace(cell=cell, seed=SEED, seconds=0.05,
                                extra=dict(spans=spans))
    assert reader.read(run) == pytest.approx(70.0)
