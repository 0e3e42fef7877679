"""The port's streaming service (``repro_torch/runtime/service.py``).

The contracts of ``tests/test_service.py``, held on the port (CPU):

1. **Chunked == monolithic**, bitwise, for every app and its schemes, with
   out-of-order arrivals whose jitter stays inside the watermark window,
   whatever the chunk size and arrival batching.
2. **Watermark and admission accounting**: late rows rerouted or dropped
   and counted; whole arrival batches dropped at a full queue under
   ``admission="drop"``, none under ``"block"``; the conservation law.
3. **The int32-safe timestamp base**, and a chunk call that keeps the
   caller's carry and rejects a base past int32.
4. **Each drop category logged once per run.**

And against the reference: on the same ``ReplaySource`` seed the port's
service gives the JAX service's outputs, final values and drop counters.
"""
import logging

import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.intervals import ReplaySource as JReplaySource
from repro.core.intervals import WatermarkPolicy as JWatermarkPolicy
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig
from repro.runtime.service import ServiceConfig as JServiceConfig
from repro.runtime.service import StreamService as JStreamService

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime.service import (ServiceConfig, StreamService,
                                         ts_base_for)

from torch_parity import np_, port_store


def conservation_ok(stats):
    d = stats["drops"]
    return stats["arrived"] == (stats["processed"] + stats["replayed"]
                                + d["watermark"] + d["admission"]
                                + stats["unprocessed"])


def assert_outputs_identical(svc_outputs, ref_outputs):
    assert len(svc_outputs) == len(ref_outputs) > 0
    for i, (a, b) in enumerate(zip(svc_outputs, ref_outputs)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(
                np.asarray(a[k]), np.asarray(b[k]),
                err_msg=f"output {k} interval {i}")


def engine(app_name, **cfg):
    app = ALL_APPS[app_name]
    return app, DualModeEngine(app, app.make_store(device="cpu"),
                               EngineConfig(**cfg), device="cpu")


def run_service_and_reference(app_name, scheme, *, n_events=80, interval=16,
                              chunk=2, jitter=5, seed=11, **cfg_kw):
    """Service over a jittered arrival stream vs monolithic run_stream on
    the in-order events.  80 events / interval 16 / K=2 covers the tail
    chunk (chunks of 2, 2, 1 intervals)."""
    app, eng = engine(app_name, scheme=scheme, **cfg_kw)
    src = ReplaySource(app.gen_events, n_events, seed=seed,
                       arrival_batch=13, jitter=jitter)
    outs_ref, vals_ref = eng.run_stream(eng.init_store.values,
                                        src.in_order_events, interval)
    cfg = ServiceConfig(punct_interval=interval, chunk_intervals=chunk,
                        watermark=WatermarkPolicy(allowed_lateness=jitter))
    rec = StreamService(eng, cfg).run(src)
    return rec, outs_ref, vals_ref


@pytest.mark.parametrize("app_name,scheme", [
    ("gs", "tstream"),    # segscan fast path
    ("gs", "mvlk"),
    ("gs", "lock"),
    ("tp", "tstream"),    # heterogeneous max tables
    ("sl", "tstream"),    # gated lockstep path
    ("sl", "tstream_lockstep"),
    ("sl", "mvlk"),
    ("ob", "tstream"),    # non-associative lockstep path
    ("ob", "mvlk"),
])
def test_chunked_service_matches_monolithic_bitwise(app_name, scheme):
    reset_launches()
    rec, outs_ref, vals_ref = run_service_and_reference(app_name, scheme)
    np.testing.assert_array_equal(rec.final_values, np_(vals_ref))
    assert_outputs_identical(rec.outputs, outs_ref)
    assert conservation_ok(rec.stats)
    assert rec.stats["drops"] == dict(watermark=0, admission=0, exchange=0)
    assert all(v == 0 for v in LAUNCHES.values())   # the CPU takes twins


@pytest.mark.parametrize("method", ["megakernel", "partition"])
def test_chunked_service_matches_monolithic_on_forced_rungs(method):
    """The megakernel rung commits in place; the staged rung scans the
    chunk's intervals as one stream."""
    rec, outs_ref, vals_ref = run_service_and_reference(
        "gs", "tstream", restructure_method=method)
    np.testing.assert_array_equal(rec.final_values, np_(vals_ref))
    assert_outputs_identical(rec.outputs, outs_ref)


def test_chunk_size_and_arrival_pattern_invariance():
    """Different K and arrival batchings reach the same bits."""
    app, eng = engine("gs")
    mk = lambda b, j: ReplaySource(app.gen_events, 96, seed=4,
                                   arrival_batch=b, jitter=j)
    ref, vals_ref = eng.run_stream(eng.init_store.values,
                                   mk(7, 0).in_order_events, 16)
    for chunk, batch, jitter in ((1, 7, 0), (3, 29, 4), (6, 96, 9)):
        rec = StreamService(eng, ServiceConfig(
            punct_interval=16, chunk_intervals=chunk,
            watermark=WatermarkPolicy(allowed_lateness=jitter))).run(
                mk(batch, jitter))
        np.testing.assert_array_equal(rec.final_values, np_(vals_ref))
        assert_outputs_identical(rec.outputs, ref)


def test_watermark_drop_accounting_and_monotonicity():
    app, eng = engine("gs")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=2, late="drop"))).run(
            ReplaySource(app.gen_events, 256, seed=2, arrival_batch=16,
                         jitter=24))
    assert rec.stats["drops"]["watermark"] > 0
    assert conservation_ok(rec.stats)
    wms = [c["watermark"] for c in rec.commits]
    assert wms == sorted(wms)
    assert len(rec.outputs) * 16 == rec.stats["processed"]


def test_watermark_reroute_accounting():
    app, eng = engine("gs")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=2, late="reroute"))).run(
            ReplaySource(app.gen_events, 256, seed=2, arrival_batch=16,
                         jitter=24))
    assert rec.stats["late_rerouted"] > 0
    assert rec.stats["drops"]["watermark"] == 0
    assert conservation_ok(rec.stats)
    assert sum(c["n_late"] for c in rec.commits) > 0


def test_admission_drop_bounded_queue():
    app, eng = engine("gs")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, chunk_intervals=1, queue_intervals=2,
        admission="drop")).run(
            ReplaySource(app.gen_events, 512, seed=1, arrival_batch=64))
    assert rec.stats["drops"]["admission"] > 0
    assert conservation_ok(rec.stats)


def test_admission_block_never_drops():
    app, eng = engine("gs")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, chunk_intervals=1, queue_intervals=1,
        admission="block")).run(
            ReplaySource(app.gen_events, 256, seed=1, arrival_batch=64))
    assert rec.stats["drops"] == dict(watermark=0, admission=0, exchange=0)
    assert rec.stats["processed"] == 256
    assert conservation_ok(rec.stats)


def test_max_intervals_and_latency_record():
    app, eng = engine("gs")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, chunk_intervals=2)).run(
            ReplaySource(app.gen_events, 160, seed=6, arrival_batch=32),
            max_intervals=4)
    assert len(rec.outputs) == 4
    lat = rec.latency_s()
    assert lat.shape == (4 * 16,)
    assert np.all(lat >= 0)
    pct = rec.latency_percentiles((50, 99))
    assert pct["p50"] <= pct["p99"]
    assert rec.sustained_events_per_s() > 0
    assert conservation_ok(rec.stats)
    assert rec.stats["unprocessed"] > 0
    # one record per chunk, with the stacked engine stats read back
    assert [c["k"] for c in rec.chunk_records] == [2, 2]
    assert all(c["max_chain"] > 0 and c["n_chains"] > 0
               for c in rec.chunk_records)


def test_ts_base_int32_safe_forever():
    """The timestamp base equals g*interval below the wrap and stays inside
    int32 arbitrarily far in."""
    for interval in (16, 512, 4096):
        wrap = 2 ** 30 // interval
        for g in (0, 1, 1000, wrap - 1):
            assert ts_base_for(g, interval) == g * interval
        for g in (wrap, 3 * wrap + 17, 2 ** 40):
            base = ts_base_for(g, interval)
            assert 0 <= base < 2 ** 30
            assert base + interval <= 2 ** 31 - 1
            assert ts_base_for(g, interval) % interval == 0


def test_chunk_call_keeps_the_carry_and_the_int32_base():
    """``run_stream_chunk`` copies the carry (the megakernel commits in
    place), stacks the K intervals' stats, gives the same bits at a wrapped
    base as at 0 (timestamps order ops within an interval only), and
    refuses a base whose timestamps would pass int32."""
    app, eng = engine("gs", restructure_method="megakernel")
    stream = app.gen_events(np.random.default_rng(3), 64)
    batched = events_to_torch({k: v.reshape((4, 16) + v.shape[1:])
                               for k, v in stream.items()}, "cpu")
    values = eng.init_store.values.clone()
    before = values.clone()
    res0, ebs0, v0, st = eng.run_stream_chunk(values, batched, 0)
    assert torch.equal(values, before)
    assert eng.last_rung == "megakernel"
    assert st["engine"].max_chain.shape == (4,)
    far = ts_base_for(2 ** 40, 16)
    res1, _, v1, _ = eng.run_stream_chunk(values, batched, far)
    assert torch.equal(v0, v1)
    for k in res0:
        assert torch.equal(res0[k], res1[k])
    outs, vals = eng.run_stream(before, stream, 16)
    assert torch.equal(vals, v0)
    assert_outputs_identical(eng.post_outputs(res0, ebs0, 4), outs)
    with pytest.raises(ValueError, match="int32"):
        eng.run_stream_chunk(values, batched, 2 ** 31 - 32)


def test_plan_variants():
    app, eng = engine("sl")
    assert eng.ensure_variant() is None
    assert eng.ensure_variant(scheme="tstream") is None
    key = eng.ensure_variant(scheme="lock", restructure_method="partition")
    assert key == ("lock", "partition")
    assert eng.ensure_variant("lock", "partition") == key
    stream = app.gen_events(np.random.default_rng(1), 48)
    batched = events_to_torch({k: v.reshape((3, 16) + v.shape[1:])
                               for k, v in stream.items()}, "cpu")
    res, ebs, vals, st = eng.run_stream_chunk(eng.init_store.values, batched,
                                              0, variant=key)
    _, other = engine("sl", scheme="lock", restructure_method="partition")
    outs, want = other.run_stream(other.init_store.values, stream, 16)
    assert torch.equal(vals, want)
    assert_outputs_identical(eng.post_outputs(res, ebs, 3), outs)
    assert not eng.reshardable
    with pytest.raises(NotImplementedError, match="chunk_cost"):
        eng.chunk_lowered_text(vals, batched)


def test_each_drop_category_logged_once_per_run(caplog):
    app, eng = engine("gs")
    with caplog.at_level(logging.INFO, logger="repro_torch.runtime.service"):
        rec_a = StreamService(eng, ServiceConfig(
            punct_interval=16, chunk_intervals=2,
            watermark=WatermarkPolicy(allowed_lateness=1, late="drop"))).run(
                ReplaySource(app.gen_events, 256, seed=9, arrival_batch=16,
                             jitter=32))
        rec_b = StreamService(eng, ServiceConfig(
            punct_interval=16, chunk_intervals=1, queue_intervals=2,
            admission="drop")).run(
                ReplaySource(app.gen_events, 512, seed=9, arrival_batch=64))
    assert rec_a.stats["drops"]["watermark"] > 0
    assert rec_b.stats["drops"]["admission"] > 0
    for needle in ("watermark policy dropped", "admission control dropped"):
        hits = [r for r in caplog.records if needle in r.getMessage()]
        assert len(hits) == 1, f"{needle!r} logged {len(hits)} times"


# ---------------------------------------------------------------------------
# against the JAX service
# ---------------------------------------------------------------------------
JAX_CASES = {
    # name: (app, scheme, n_events, source kwargs, service kwargs)
    "gs/jitter": ("gs", "tstream", 80, dict(arrival_batch=13, jitter=5),
                  dict(chunk_intervals=2, lateness=5)),
    "sl/jitter": ("sl", "tstream", 80, dict(arrival_batch=13, jitter=5),
                  dict(chunk_intervals=2, lateness=5)),
    "ob/jitter": ("ob", "tstream", 80, dict(arrival_batch=13, jitter=5),
                  dict(chunk_intervals=3, lateness=5)),
    "gs/watermark_drops": ("gs", "tstream", 192,
                           dict(arrival_batch=16, jitter=24),
                           dict(chunk_intervals=2, lateness=2, late="drop")),
    "gs/admission_drops": ("gs", "tstream", 384, dict(arrival_batch=64),
                           dict(chunk_intervals=1, queue_intervals=2,
                                admission="drop")),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_service_matches_the_jax_service(case):
    app_name, scheme, n, src_kw, svc_kw = JAX_CASES[case]
    svc_kw = dict(svc_kw)
    wm = dict(allowed_lateness=svc_kw.pop("lateness", 0),
              late=svc_kw.pop("late", "reroute"))

    japp = J_APPS[app_name]
    jstore = japp.make_store()
    jeng = JEngine(japp, jstore, JConfig(scheme=scheme))
    jrec = JStreamService(jeng, JServiceConfig(
        punct_interval=16, watermark=JWatermarkPolicy(**wm), **svc_kw)).run(
            JReplaySource(japp.gen_events, n, seed=5, **src_kw))

    tapp = ALL_APPS[app_name]
    eng = DualModeEngine(tapp, port_store(jstore),
                         EngineConfig(scheme=scheme), device="cpu")
    rec = StreamService(eng, ServiceConfig(
        punct_interval=16, watermark=WatermarkPolicy(**wm), **svc_kw)).run(
            ReplaySource(tapp.gen_events, n, seed=5, **src_kw))

    np.testing.assert_array_equal(rec.final_values, jrec.final_values)
    assert len(rec.outputs) == len(jrec.outputs) > 0
    exact = app_name in ("sl", "ob")
    for i, (a, b) in enumerate(zip(rec.outputs, jrec.outputs)):
        for k in b:
            if exact:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]),
                                              err_msg=f"{case}: {k}[{i}]")
            else:   # the apps' reductions associate differently in torch
                np.testing.assert_allclose(
                    np.asarray(a[k], np.float64),
                    np.asarray(b[k], np.float64), rtol=1e-5, atol=1e-5,
                    err_msg=f"{case}: {k}[{i}]")
    for key in ("arrived", "processed", "replayed", "late_rerouted",
                "drops", "unprocessed", "watermark", "assembly"):
        assert rec.stats[key] == jrec.stats[key], key
    if case.endswith("_drops"):     # the case drops what it is named for
        assert rec.stats["drops"][case.split("/")[1][:-6]] > 0
    assert rec.stats["source"]["pulls"] == jrec.stats["source"]["pulls"]
    assert [c["interval"] for c in rec.commits] == \
        [c["interval"] for c in jrec.commits]
