"""The port's telemetry plane (``repro_torch/runtime/telemetry.py``).

Held here: one service run in each package, with tracing and snapshots on,
emits the same counter, gauge, histogram, record and span names (the port's
adding exactly ``PORT_ONLY_SPANS`` and their histograms), and the same
deterministic counter values; tracing changes no bit of the run;
``ChunkProfiler`` writes a ``torch.profiler`` trace with one
``service_chunk`` range per chunk on the CPU.  The cost attribution
(``hlo_attribution=True``) is held in ``tests/test_torch_cost.py``.
"""
import glob
import json

import numpy as np
import pytest

from repro.apps import ALL_APPS as J_APPS
from repro.core.intervals import ReplaySource as JReplaySource
from repro.core.intervals import WatermarkPolicy as JWatermarkPolicy
from repro.core.scheduler import DualModeEngine as JEngine
from repro.runtime import telemetry as jt
from repro.runtime.service import ServiceConfig as JServiceConfig
from repro.runtime.service import StreamService as JStreamService

from repro_torch.apps import ALL_APPS
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.scheduler import DualModeEngine
from repro_torch.runtime import telemetry as tt
from repro_torch.runtime.service import ServiceConfig, StreamService

from torch_parity import port_store

# wall-clock series: same names, values of their own
TIMED = ("latency.", "span.", "source.backoff_s")


def _port_run(tcfg, app_name="gs", tmp=None, **kw):
    app = ALL_APPS[app_name]
    eng = DualModeEngine(app, app.make_store(device="cpu"), device="cpu")
    cfg = ServiceConfig(punct_interval=16, chunk_intervals=2,
                        watermark=WatermarkPolicy(allowed_lateness=5),
                        telemetry=tcfg, **kw)
    return StreamService(eng, cfg).run(ReplaySource(
        app.gen_events, 96, seed=11, arrival_batch=13, jitter=5))


def _names(snap):
    return dict(
        counters={(c["name"], tuple(sorted(c["labels"].items())))
                  for c in snap["counters"]},
        gauges={(g["name"], tuple(sorted(g["labels"].items())))
                for g in snap["gauges"]},
        histograms=set(snap["histograms"]),
        records=set(snap["records"]),
        events={e["name"] for e in snap["events"]})


def _spans(path):
    return {ev["name"] for ev in tt._parse_trace(path) if ev.get("ph") == "X"}


def test_same_names_as_the_jax_service(tmp_path):
    japp = J_APPS["gs"]
    jstore = japp.make_store()
    jtrace, ttrace = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jrec = JStreamService(JEngine(japp, jstore), JServiceConfig(
        punct_interval=16, chunk_intervals=2, snapshot_every=4,
        ckpt_dir=str(tmp_path / "jck"),
        watermark=JWatermarkPolicy(allowed_lateness=5),
        telemetry=jt.TelemetryConfig(trace_path=jtrace))).run(JReplaySource(
            japp.gen_events, 96, seed=11, arrival_batch=13, jitter=5))
    tapp = ALL_APPS["gs"]
    trec = StreamService(DualModeEngine(tapp, port_store(jstore),
                                        device="cpu"), ServiceConfig(
        punct_interval=16, chunk_intervals=2, snapshot_every=4,
        ckpt_dir=str(tmp_path / "tck"),
        watermark=WatermarkPolicy(allowed_lateness=5),
        telemetry=tt.TelemetryConfig(trace_path=ttrace))).run(ReplaySource(
            tapp.gen_events, 96, seed=11, arrival_batch=13, jitter=5))
    jsnap, tsnap = jrec.telemetry.snapshot(), trec.telemetry.snapshot()
    assert tsnap["schema"] == jsnap["schema"]
    assert tsnap["schema_version"] == jsnap["schema_version"]
    # the port's own spans, and their histograms (not the clock event's)
    want = _names(jsnap)
    want["histograms"] |= {"span." + n for n in tt.PORT_ONLY_SPANS
                           if n != "trace.clock"}
    assert _names(tsnap) == want
    for c in jsnap["counters"]:
        if not c["name"].startswith(TIMED):
            assert tt.counter_value(tsnap, c["name"], **c["labels"]) == \
                c["value"], c
    assert _spans(ttrace) == _spans(jtrace) | set(tt.PORT_ONLY_SPANS)
    ok, why, _ = tt.validate_trace(ttrace, require_stages=tt.PIPELINE_STAGES)
    assert ok, why
    assert set(trec.stats) == set(jrec.stats)
    assert trec.stats["snapshots"] == jrec.stats["snapshots"] == [4]
    assert tt.empty_stats() == jt.empty_stats()


def test_tracing_changes_no_bit(tmp_path):
    ref = _port_run(None)
    rec = _port_run(tt.TelemetryConfig(trace_path=str(tmp_path / "t.json")))
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    for a, b in zip(rec.outputs, ref.outputs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for k in ref.stats:
        if k != "chunks":
            assert rec.stats[k] == ref.stats[k], k
    snap = rec.telemetry.snapshot()
    assert tt.histogram_from(snap, "span.chunk.execute").count == 3
    assert tt.stats_view(snap) == rec.stats


def test_chunk_profiler_writes_a_torch_trace(tmp_path):
    prof_dir = tmp_path / "prof"
    rec = _port_run(tt.TelemetryConfig(profile_dir=str(prof_dir)))
    assert len(rec.outputs) == 6
    (path,) = glob.glob(str(prof_dir / "service_chunks.*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    chunks = [e for e in events if e.get("name") == "service_chunk"]
    assert len(chunks) == 3     # one window per chunk of K = 2


def test_histogram_and_registry_merge_exactly():
    rng = np.random.default_rng(0)
    a, b = rng.exponential(1e-3, 50), rng.exponential(1e-2, 70)
    for mod in (tt, jt):
        h1, h2, h = mod.Histogram(), mod.Histogram(), mod.Histogram()
        h1.observe_many(a)
        h2.observe_many(b)
        h.observe_many(np.concatenate([a, b]))
        assert h1.merge(h2).to_dict() == h.to_dict()
    th, jh = tt.Histogram(), jt.Histogram()
    th.observe_many(a)
    jh.observe_many(a)
    assert th.to_dict() == jh.to_dict()
    assert th.percentile(99) == jh.percentile(99)
