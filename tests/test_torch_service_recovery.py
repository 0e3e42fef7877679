"""Recovery and the fault plane on the port's service (CPU).

The single-device contracts of ``tests/test_service_recovery.py`` and
``tests/test_faults.py``, held on the port:

1. **crash → restore → replay is bitwise**: punctuation-aligned snapshots
   and a replayable source make the resumed run equal the uninterrupted
   one (final state, every post-resume output, the crashed prefix), on the
   associative path and on the lockstep path with the abort repass, across
   several snapshots.
2. **The chaos sweep**: under every seeded fault schedule the service
   completes or crashes with balanced accounting, and replay is bitwise.
3. **Fallback**: a corrupted latest snapshot never escapes ``resume``.
4. **Source retry**, the **watchdog** (hang detected, emergency snapshot,
   bitwise resume), an **executor exception** with no leaked threads, and a
   crash between a controller decision and the snapshot that records it.
"""
import threading

import numpy as np
import pytest

from repro_torch.apps import ALL_APPS
from repro_torch.ckpt import checkpoint_steps, read_manifest_meta
from repro_torch.core.intervals import (PhasedReplaySource, ReplaySource,
                                        WatermarkPolicy)
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.faults import (CONTROLLER_DECIDE, EXECUTOR_HANG,
                                        SOURCE_PULL, Fault, FaultPlane,
                                        InjectedCrashError,
                                        TransientSourceError,
                                        corrupt_snapshot, random_schedule)
from repro_torch.runtime.service import (ExecutorHungError, ServiceConfig,
                                         StragglerPolicy, StreamService)

INTERVAL = 16
N_EVENTS = 160      # 10 intervals -> 5 chunks of K=2 -> snapshots at 4, 8
JITTER = 3
WM = WatermarkPolicy(allowed_lateness=JITTER)


def conservation_ok(stats):
    d = stats["drops"]
    return stats["arrived"] == (stats["processed"] + stats["replayed"]
                                + d["watermark"] + d["admission"]
                                + stats["unprocessed"])


def assert_ledger_balanced(stats):
    a = stats["assembly"]
    assert a["arrived"] == a["assembled"] + a["dropped"] + a["pending"], a


def assert_outputs_identical(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k],
                                          err_msg=f"output {k} interval {i}")


def mk_source(app):
    return ReplaySource(app.gen_events, N_EVENTS, seed=7, arrival_batch=11,
                        jitter=JITTER)


def mk_engine(app_name="gs", **cfg):
    app = ALL_APPS[app_name]
    return app, DualModeEngine(app, app.make_store(device="cpu"),
                               EngineConfig(**cfg), device="cpu")


def plain_cfg(**kw):
    return ServiceConfig(punct_interval=INTERVAL, chunk_intervals=2,
                         watermark=WM, **kw)


def chaos_cfg(ckpt_dir, **kw):
    base = dict(punct_interval=INTERVAL, chunk_intervals=2,
                snapshot_every=4 if ckpt_dir else 0,
                ckpt_dir=str(ckpt_dir) if ckpt_dir else None, watermark=WM,
                source_retries=2, retry_backoff_s=0.01,
                watchdog_factor=4.0, watchdog_min_s=1.0,
                watchdog_grace_s=20.0,
                straggler=StragglerPolicy(deadline_s=0.5))
    base.update(kw)
    return ServiceConfig(**base)


# ---------------------------------------------------------------------------
# 1. crash -> restore -> replay
# ---------------------------------------------------------------------------
def crash_restore_replay(app_name, tmp_path, *, crash_after=7,
                         snapshot_every=4, **cfg):
    app, eng = mk_engine(app_name, **cfg)
    ref = StreamService(eng, plain_cfg()).run(mk_source(app))
    svc_cfg = plain_cfg(snapshot_every=snapshot_every, ckpt_dir=str(tmp_path))
    svc = StreamService(eng, svc_cfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        svc.run(mk_source(app), crash_after_interval=crash_after)
    crashed = svc.last_run
    assert crashed.stats["crashed"] and conservation_ok(crashed.stats)
    assert crashed.snapshots
    assert len(crashed.outputs) > crashed.snapshots[-1]

    rec = StreamService(eng, svc_cfg).resume(mk_source(app))
    snap = rec.stats["replayed"] // INTERVAL
    assert snap == crashed.snapshots[-1]
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[snap:])
    assert_outputs_identical(crashed.outputs,
                             ref.outputs[: len(crashed.outputs)])
    assert conservation_ok(rec.stats)
    return rec


def test_crash_restore_replay_assoc_path(tmp_path):
    crash_restore_replay("gs", tmp_path)


def test_crash_restore_replay_megakernel_rung(tmp_path):
    crash_restore_replay("gs", tmp_path, restructure_method="megakernel")


def test_crash_restore_replay_lockstep_abort_repass(tmp_path):
    """The gated lockstep path with the abort repass: replay reproduces the
    exact abort pattern too."""
    crash_restore_replay("sl", tmp_path, abort_repass=True)


def test_recovery_spanning_multiple_snapshots(tmp_path):
    rec = crash_restore_replay("sl", tmp_path, crash_after=9,
                               snapshot_every=2, abort_repass=True)
    assert rec.stats["replayed"] // INTERVAL == 8


def test_resume_without_snapshot_raises(tmp_path):
    app, eng = mk_engine()
    svc = StreamService(eng, plain_cfg(snapshot_every=2,
                                       ckpt_dir=str(tmp_path / "empty")))
    with pytest.raises(FileNotFoundError):
        svc.resume(ReplaySource(app.gen_events, 64, seed=0))


def test_recovery_rejects_dropping_admission(tmp_path):
    with pytest.raises(AssertionError, match="admission"):
        plain_cfg(snapshot_every=2, ckpt_dir=str(tmp_path),
                  admission="drop")
    app, eng = mk_engine()
    svc = StreamService(eng, plain_cfg(admission="drop"))
    with pytest.raises(ValueError, match="skip_intervals"):
        svc.run(ReplaySource(app.gen_events, 64, seed=0), skip_intervals=2)


# ---------------------------------------------------------------------------
# 2. the chaos sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app_name,scheme,seed", [
    ("gs", "tstream", 0), ("gs", "tstream", 1), ("gs", "tstream", 2),
    ("gs", "tstream", 3), ("gs", "tstream", 4),
    ("sl", "tstream", 1), ("sl", "tstream", 5),
    ("gs", "mvlk", 2), ("gs", "mvlk", 6)])
def test_chaos_schedule(app_name, scheme, seed, tmp_path):
    app, eng = mk_engine(app_name, scheme=scheme)
    ref = StreamService(eng, plain_cfg()).run(mk_source(app))
    plane = FaultPlane(random_schedule(seed, n_pulls=15, n_chunks=5,
                                       n_snapshots=2, hang_s=2.5,
                                       stall_s=0.05))
    cfg = chaos_cfg(tmp_path)
    svc = StreamService(eng, cfg)
    try:
        rec = svc.run(mk_source(app), faults=plane)
    except Exception as e:
        stats = svc.last_run.stats
        assert stats is not None and stats["crashed"], \
            f"crash without structured stats: {type(e).__name__}: {e}"
        assert conservation_ok(stats)
        assert_ledger_balanced(stats)
        assert stats["faults"], "crashed but no fault recorded as fired"
        if svc.last_run.outputs:
            assert_outputs_identical(
                svc.last_run.outputs,
                ref.outputs[: len(svc.last_run.outputs)])
        try:
            rec = StreamService(eng, cfg).resume(mk_source(app))
        except FileNotFoundError:   # crashed before any valid snapshot
            rec = StreamService(eng, cfg).run(mk_source(app))
    snap = rec.stats["replayed"] // INTERVAL
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[snap:])
    assert conservation_ok(rec.stats)
    assert_ledger_balanced(rec.stats)


# ---------------------------------------------------------------------------
# 3. fallback past a corrupted latest snapshot
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["torn_manifest", "corrupt_leaf",
                                  "truncate_leaf", "debris"])
def test_resume_falls_back_past_corrupt_latest(tmp_path, kind):
    app, eng = mk_engine()
    ref = StreamService(eng, plain_cfg()).run(mk_source(app))
    cfg = plain_cfg(snapshot_every=4, ckpt_dir=str(tmp_path))
    svc = StreamService(eng, cfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        svc.run(mk_source(app), crash_after_interval=8)
    assert svc.last_run.snapshots == [4, 8]
    corrupt_snapshot(str(tmp_path / "step_00000008"), kind)
    rec = StreamService(eng, cfg).resume(mk_source(app))
    expect_from = 8 if kind == "debris" else 4
    assert rec.stats["replayed"] // INTERVAL == expect_from
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[expect_from:])


def test_keep_last_prunes_after_publish(tmp_path):
    app, eng = mk_engine()
    cfg = plain_cfg(snapshot_every=2, ckpt_dir=str(tmp_path), keep_last=2)
    rec = StreamService(eng, cfg).run(mk_source(app))
    assert rec.snapshots == [2, 4, 6, 8, 10]
    assert checkpoint_steps(str(tmp_path)) == [10, 8]
    rec2 = StreamService(eng, cfg).resume(mk_source(app))
    assert rec2.stats["replayed"] // INTERVAL == 10
    np.testing.assert_array_equal(rec2.final_values, rec.final_values)


# ---------------------------------------------------------------------------
# 4. source retry, watchdog, executor exception, controller crash
# ---------------------------------------------------------------------------
def test_source_retry_recovers_transient_faults():
    app, eng = mk_engine()
    ref = StreamService(eng, plain_cfg()).run(mk_source(app))
    plane = FaultPlane([Fault(SOURCE_PULL, 1, "raise"),
                        Fault(SOURCE_PULL, 5, "raise"),
                        Fault(SOURCE_PULL, 6, "raise")])
    cfg = chaos_cfg(None, source_retries=2, retry_backoff_s=0.001)
    rec = StreamService(eng, cfg).run(mk_source(app), faults=plane)
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs)
    assert rec.stats["source"]["retries"] == 3
    assert len(plane.fired) == 3


def test_source_retry_exhaustion_crashes_with_stats():
    app, eng = mk_engine()
    plane = FaultPlane([Fault(SOURCE_PULL, 3, "raise"),
                        Fault(SOURCE_PULL, 4, "raise")])
    svc = StreamService(eng, chaos_cfg(None, source_retries=1,
                                       retry_backoff_s=0.001))
    with pytest.raises(TransientSourceError):
        svc.run(mk_source(app), faults=plane)
    stats = svc.last_run.stats
    assert stats["crashed"]
    assert stats["error"]["type"] == "TransientSourceError"
    assert conservation_ok(stats)
    assert_ledger_balanced(stats)


def test_watchdog_detects_hang_and_recovers_bitwise(tmp_path):
    app, eng = mk_engine()
    ref = StreamService(eng, plain_cfg()).run(mk_source(app))
    plane = FaultPlane([Fault(EXECUTOR_HANG, 2, "hang", duration_s=60.0)])
    cfg = chaos_cfg(tmp_path, watchdog_min_s=0.5, watchdog_grace_s=2.0)
    svc = StreamService(eng, cfg)
    with pytest.raises(ExecutorHungError):
        svc.run(mk_source(app), faults=plane)
    stats = svc.last_run.stats
    err = stats["error"]
    assert err["type"] == "ExecutorHungError" and not err["hung_thread"]
    assert err["emergency_snapshot"] == 6
    assert svc.last_run.snapshots == [4, 6]
    assert len(svc.last_run.outputs) == 6
    assert conservation_ok(stats)
    assert_ledger_balanced(stats)
    rec = StreamService(eng, cfg).resume(mk_source(app))
    assert rec.stats["replayed"] // INTERVAL == 6
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[6:])


def test_executor_exception_surfaces_with_no_leaked_threads(tmp_path):
    app, eng = mk_engine()
    plane = FaultPlane([Fault("executor.crash", 1, "crash")])
    svc = StreamService(eng, chaos_cfg(tmp_path))
    with pytest.raises(InjectedCrashError):
        svc.run(mk_source(app), faults=plane)
    stats = svc.last_run.stats
    assert stats["crashed"] and stats["error"]["type"] == "InjectedCrashError"
    assert not stats["error"]["hung_thread"]
    assert conservation_ok(stats)
    assert_ledger_balanced(stats)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("stream-service")], \
        "leaked a service thread"


def test_controller_decide_crash_recovers_bitwise(tmp_path):
    """Crash between a controller decision and the snapshot that would
    record it: the decision is recomputed after restore, and the resumed
    adaptive run equals the uninterrupted one, decision trace included."""
    app = ALL_APPS["gs"]
    mk_storm = lambda: PhasedReplaySource(app.gen_events, [
        (4 * INTERVAL, dict(theta=0.2)),
        (8 * INTERVAL, dict(theta=2.5)),
        (4 * INTERVAL, dict(theta=0.2)),
    ], seed=7, arrival_batch=2 * INTERVAL, jitter=JITTER)
    _, eng = mk_engine()
    ctl = ControllerConfig(window=2, sustain=2, cooldown=2,
                           degrade_scheme="lock", degrade_chain_frac=0.6)
    cfg = chaos_cfg(tmp_path / "ctl", controller=ctl)
    ref = StreamService(eng, chaos_cfg(None, controller=ctl)).run(mk_storm())
    assert any(d["knob"] == "scheme" for d in ref.decisions), ref.decisions

    plane = FaultPlane([Fault(site=CONTROLLER_DECIDE, at=0, kind="crash")])
    svc = StreamService(eng, cfg)
    with pytest.raises(InjectedCrashError, match="decision boundary"):
        svc.run(mk_storm(), faults=plane)
    crashed = svc.last_run
    assert crashed.decisions and crashed.decisions[0] == ref.decisions[0]
    for step in crashed.snapshots:
        meta = read_manifest_meta(cfg.ckpt_dir, step)
        assert all(d["g"] < step for d in meta["controller"]["trace"])
    rec = StreamService(eng, cfg).resume(mk_storm())
    assert rec.decisions == ref.decisions
    snap = rec.stats["replayed"] // INTERVAL
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert_outputs_identical(rec.outputs, ref.outputs[snap:])
