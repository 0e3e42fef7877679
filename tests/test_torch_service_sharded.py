"""The streaming service on a sharded engine, held against the JAX package.

The cases of the reference's ``tests/service_worker.py`` on the port (CPU,
8 shards as a tensor axis):

1. The chunk API on a sharded engine: ``run_stream_chunk`` returns the
   reference's exchange stats, leaves the carry it was given as it was, and
   two chained chunks equal one ``run_stream``.
2. The K-chunked service over the sharded driver equals the monolithic
   sharded ``run_stream`` and the port's single-device run bit for bit, and
   the JAX single-device ``run_stream`` (the JAX sharded driver gives no
   output on the installed JAX): state bitwise, outputs bitwise for SL and
   to 1e-5 for GS (torch associates GS's post-processing reductions
   differently).  Its exchange stats land in the merged record.
3. Crash -> restore -> replay on the sharded driver reproduces the
   uninterrupted run bit for bit.
4. Exchange overflow under a starved slack is counted, logged once per run,
   and with ``escalate_overflow`` the slack is widened at a punctuation
   boundary.
5. A traced elastic run (a live migration under the ``reshard.apply``
   span) is bitwise identical to the same run untraced.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch.apps import ALL_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.intervals import (PhasedReplaySource, ReplaySource,
                                        WatermarkPolicy)
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.service import ServiceConfig, StreamService
from repro_torch.runtime.telemetry import (PIPELINE_STAGES, TelemetryConfig,
                                           stage_summary, validate_trace)

from torch_parity import assert_outputs_close, port_store

INTERVAL = 32
JITTER = 4
EXCHANGE_KEYS = {"dropped", "shipped", "max_fill", "capacity",
                 "exchanged_rows_per_device", "shard_load", "slot_load"}


def mk_source(app, n_events=192, seed=5):
    return ReplaySource(app.gen_events, n_events, seed=seed,
                        arrival_batch=19, jitter=JITTER)


def sharded(app_name, slack=8.0, jstore=None, **cfg):
    app = ALL_APPS[app_name]
    store = (app.make_store(device="cpu") if jstore is None
             else port_store(jstore))
    return DualModeEngine(app, store, EngineConfig(**cfg), device="cpu",
                          mesh=ShardMesh((8,), ("dev",), device="cpu"),
                          exchange_slack=slack)


def service_cfg(**kw):
    return ServiceConfig(punct_interval=INTERVAL, chunk_intervals=2,
                         watermark=WatermarkPolicy(allowed_lateness=JITTER),
                         **kw)


def assert_outputs_identical(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{what} {k} interval {i}")


@pytest.mark.parametrize("app_name", ["gs", "sl"])
def test_sharded_chunk_api(app_name):
    app = ALL_APPS[app_name]
    eng = sharded(app_name)
    stream = app.gen_events(np.random.default_rng(2), 4 * INTERVAL)
    outs, vals = eng.run_stream(eng.init_store.values, stream, INTERVAL)
    carry = eng.carry_in(eng.init_store.values)
    before = tuple(c.clone() for c in carry)
    got = []
    for c in range(2):
        part = {k: v[c * 2 * INTERVAL:(c + 1) * 2 * INTERVAL].reshape(
            (2, INTERVAL) + v.shape[1:]) for k, v in stream.items()}
        res, ebs, nxt, st = eng.run_stream_chunk(
            carry, events_to_torch(part, "cpu"), c * 2 * INTERVAL)
        if c == 0:
            assert all(map(torch.equal, carry, before)), \
                "the chunk wrote its carry"
        assert set(st) == {"exchange"}
        assert EXCHANGE_KEYS <= set(st["exchange"])
        xs = st["exchange"]
        assert tuple(xs["dropped"].shape) == (2,) and int(
            xs["dropped"].sum()) == 0
        assert int(xs["shipped"].sum()) == int(
            xs["shard_load"].sum()) > 0
        assert tuple(xs["slot_load"].shape) == (eng.init_store.n_slots,)
        got += eng.post_outputs(res, ebs, 2)
        carry = nxt
    assert torch.equal(eng.carry_out(carry), vals)
    assert_outputs_identical(got, outs, "chunked vs run_stream")
    with pytest.raises(ValueError, match="plan variants"):
        eng.run_stream_chunk(carry, events_to_torch(part, "cpu"), 0,
                             variant=("lock", "auto"))
    with pytest.raises(ValueError, match="divide evenly"):
        StreamService(eng, ServiceConfig(punct_interval=36))


@pytest.mark.parametrize("app_name", ["gs", "sl"])
def test_sharded_service_chunked(app_name):
    japp, app = J_APPS[app_name], ALL_APPS[app_name]
    jstore = japp.make_store()
    events = mk_source(app).in_order_events
    j_outs, j_vals = JEngine(japp, jstore, JConfig()).run_stream(
        jstore.values, {k: jnp.asarray(v) for k, v in events.items()},
        INTERVAL, fused=True)
    one = DualModeEngine(app, port_store(jstore), device="cpu")
    outs_1, vals_1 = one.run_stream(one.init_store.values, events, INTERVAL)
    eng = sharded(app_name, jstore=jstore)
    outs_m, vals_m = eng.run_stream(eng.init_store.values, events, INTERVAL)

    rec = StreamService(eng, service_cfg()).run(mk_source(app))
    for what, outs, vals in (("one device", outs_1, vals_1),
                             ("sharded monolithic", outs_m, vals_m)):
        np.testing.assert_array_equal(rec.final_values, vals.numpy(),
                                      err_msg=what)
        assert_outputs_identical(rec.outputs, outs, what)
    np.testing.assert_array_equal(rec.final_values, np.asarray(j_vals))
    if app_name == "sl":
        assert_outputs_identical(rec.outputs, j_outs, "vs JAX")
    else:
        assert_outputs_close(rec.outputs, j_outs, "vs JAX")
    xch = rec.stats["exchange"]
    assert xch["shipped"] == sum(r["x_ship"] for r in rec.chunk_records) > 0
    assert xch["dropped"] == rec.stats["drops"]["exchange"] == 0
    assert xch["capacity"] > 0 and xch["slack"] == 8.0
    assert xch["escalations"] == 0
    place = rec.stats["placement"]
    assert place["migrations"] == [] and place["moved_rows"] == 0
    assert sum(place["shard_events"]) == xch["shipped"]
    assert place["owners"] == []


@pytest.mark.parametrize("app_name", ["gs", "sl"])
def test_sharded_service_crash_resume(app_name, tmp_path):
    app = ALL_APPS[app_name]
    eng = sharded(app_name)
    ref = StreamService(eng, service_cfg()).run(mk_source(app))
    cfg = service_cfg(snapshot_every=2, ckpt_dir=str(tmp_path))
    svc = StreamService(eng, cfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        svc.run(mk_source(app), crash_after_interval=3)
    crashed = svc.last_run
    assert crashed.snapshots
    rec = StreamService(eng, cfg).resume(mk_source(app))
    snap = rec.stats["replayed"] // INTERVAL
    assert snap == crashed.snapshots[-1]
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[snap:], "post-resume")
    assert_outputs_identical(crashed.outputs,
                             ref.outputs[:len(crashed.outputs)], "pre-crash")


def test_exchange_overflow_is_accounted(caplog):
    app = ALL_APPS["gs"]
    eng = sharded("gs", slack=1.0)
    cfg = service_cfg(escalate_overflow=2, escalate_factor=2.0)
    with caplog.at_level(logging.INFO, logger="repro_torch.runtime.service"):
        rec = StreamService(eng, cfg).run(mk_source(app, n_events=320,
                                                    seed=9))
    dropped = rec.stats["drops"]["exchange"]
    assert dropped > 0
    assert dropped == rec.stats["exchange"]["dropped"] == sum(
        r["x_drop"] for r in rec.chunk_records)
    xch = rec.stats["exchange"]
    assert xch["escalations"] >= 1 and xch["slack"] > 1.0
    assert eng._sharded.exchange_slack == xch["slack"]
    slack_knobs = [d for d in rec.decisions if d["knob"] == "slack"]
    assert len(slack_knobs) == xch["escalations"]
    # widened at a punctuation boundary after the drop was seen
    first_drop = min(r["g0"] for r in rec.chunk_records if r["x_drop"])
    assert all(d["g"] > first_drop for d in slack_knobs)
    msgs = [r.getMessage() for r in caplog.records]
    assert sum("sharded exchange overflow dropped" in m for m in msgs) == 1
    assert sum("exchange slack" in m for m in msgs) == xch["escalations"]
    assert rec.stats["processed"] == 10 * INTERVAL and not rec.stats["crashed"]


def test_traced_elastic_run_is_bitwise(tmp_path):
    app = ALL_APPS["gs"]
    src = PhasedReplaySource(
        app.gen_events, [(4 * INTERVAL, {}),
                         (8 * INTERVAL, dict(theta=2.5, align_mod=8)),
                         (4 * INTERVAL, {})],
        seed=7, arrival_batch=37, jitter=JITTER)
    ctl = ControllerConfig(window=4, sustain=2, cooldown=4,
                           slack_widen=False, reshard_imbalance=3.0,
                           reshard_max_moves=24)
    trace = str(tmp_path / "trace.json")
    runs = [StreamService(sharded("gs"), service_cfg(
        controller=ctl, telemetry=tele)).run(src)
        for tele in (None, TelemetryConfig(trace_path=trace))]
    bare, traced = runs
    assert traced.migrations and len(traced.migrations) == len(
        bare.migrations)
    np.testing.assert_array_equal(traced.final_values, bare.final_values)
    assert_outputs_identical(traced.outputs, bare.outputs, "traced vs bare")
    assert traced.decisions == bare.decisions
    ok, why, info = validate_trace(trace, require_stages=tuple(
        s for s in PIPELINE_STAGES if s != "snapshot.publish"))
    assert ok, why
    spans = {r["stage"]: r["count"] for r in stage_summary(trace)}
    assert spans["reshard.apply"] == len(traced.migrations)
