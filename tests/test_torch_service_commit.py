"""When the service commits a chunk: as soon as it has run, before the
next chunk's dispatch, whatever the load.

Held here on the CPU, on GS (the "auto" and "megakernel" rungs), SL (the
lockstep walk, reaching the residue sweep) and the sharded driver:

1. Under a paced source, whose arrivals wait until the service has
   committed every chunk it was handed: each ``chunk.commit`` ends before
   the next ``chunk.dispatch`` starts, the six stage spans still tile each
   chunk, and outputs and final state are bitwise those of an unpaced run
   and of one monolithic ``run_stream`` over the same events.
2. Under a backlog, an engine whose chunk returns only once the next chunk
   sits in the work queue, each chunk still commits before the next
   dispatch, in order, bitwise as the paced run.
3. A crash injected at a commit resumes from the snapshot bitwise into the
   uninterrupted run.
"""
import queue
import threading
import time
import types

import numpy as np
import pytest

from repro_torch.apps import ALL_APPS
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime import service as service_mod
from repro_torch.runtime import telemetry as tt
from repro_torch.runtime.service import ServiceConfig, StreamService

STAGES = ("chunk.fill", "chunk.submit", "chunk.wait", "chunk.dispatch",
          "chunk.hold", "chunk.commit")
K = 2
# app, restructure rung, store and event arguments, interval, shards: SL
# over 30 records at theta 0.99 reaches the residue sweep; the sharded
# driver needs an interval that its 8 shards divide
CASES = {
    "gs": ("gs", "auto", {}, {}, 16, 0),
    "gs-megakernel": ("gs", "megakernel", {}, {}, 16, 0),
    "sl": ("sl", "auto", dict(n_keys=30), dict(n_keys=30, theta=0.99), 16,
           0),
    "gs-sharded": ("gs", "auto", {}, {}, 32, 8),
}


def _interval(case):
    return CASES[case][4]


def _engine(case):
    app_name, rung, store_kw, _, _, shards = CASES[case]
    app = ALL_APPS[app_name]
    mesh = dict(mesh=ShardMesh((shards,), ("dev",), device="cpu"),
                exchange_slack=8.0) if shards else {}
    return DualModeEngine(app, app.make_store(device="cpu", **store_kw),
                          EngineConfig(restructure_method=rung),
                          device="cpu", **mesh)


def _source(case, n_intervals=8):
    app_name, _, _, gen_kw, interval, _ = CASES[case]
    return ReplaySource(ALL_APPS[app_name].gen_events,
                        n_intervals * interval, seed=11, arrival_batch=13,
                        jitter=5, gen_kwargs=gen_kw)


def _cfg(case, trace_path=None, **kw):
    tcfg = tt.TelemetryConfig(trace_path=trace_path) if trace_path else None
    return ServiceConfig(punct_interval=_interval(case), chunk_intervals=K,
                         watermark=WatermarkPolicy(allowed_lateness=5),
                         telemetry=tcfg, **kw)


class _Probe:
    """Counts the chunks the service puts on its work queue (through a
    queue class patched into the service module) and the commits of the
    engines it watches (their ``post_outputs``), for sources and engines
    that wait on them."""

    def __init__(self, monkeypatch):
        self.cv = threading.Condition()
        self.queued = 0         # chunks put on a work queue
        self.closed = False     # the end-of-run sentinel was put
        self.committed = 0
        probe = self

        class WorkQueue(queue.Queue):
            def put(self, item, block=True, timeout=None):
                super().put(item, block, timeout)
                with probe.cv:
                    if item is None:
                        probe.closed = True
                    else:
                        probe.queued += 1
                    probe.cv.notify_all()

        monkeypatch.setattr(service_mod, "queue", types.SimpleNamespace(
            Queue=WorkQueue, Empty=queue.Empty, Full=queue.Full))

    def watch(self, eng):
        post = eng.post_outputs

        def post_outputs(*a, **kw):
            out = post(*a, **kw)
            with self.cv:
                self.committed += 1
                self.cv.notify_all()
            return out
        eng.post_outputs = post_outputs
        return eng

    def wait(self, pred, timeout):
        with self.cv:
            return self.cv.wait_for(pred, timeout)


def _paced(src, probe, gap_s=0.002, wait_s=1.0):
    """The source's arrival batches, each after a gap and once every chunk
    handed to the service has committed: arrivals under the knee."""
    for item in src:
        time.sleep(gap_s)
        probe.wait(lambda: probe.committed == probe.queued, wait_s)
        yield item


def _backlogged(eng, probe):
    """Each chunk returns only once the next chunk sits in the work queue
    (or the run has put its end): a backlog behind every chunk."""
    run = eng.run_stream_chunk
    calls = [0]

    def run_stream_chunk(*a, **kw):
        i = calls[0]
        calls[0] += 1
        out = run(*a, **kw)
        assert probe.wait(lambda: probe.queued >= i + 2 or probe.closed,
                          10.0)
        return out
    eng.run_stream_chunk = run_stream_chunk
    return eng


def _spans(path):
    return [ev for ev in tt._parse_trace(path) if ev.get("ph") == "X"]


def _ns(us: float) -> int:
    return round(us * 1e3)


def _by_chunk(events, n_chunks):
    by = {}
    for ev in events:
        if ev["name"] in STAGES:
            by.setdefault(ev["args"]["chunk"], {})[ev["name"]] = ev
    assert sorted(by) == list(range(n_chunks))
    return [by[ci] for ci in range(n_chunks)]


def _assert_tiled(chunks):
    for ci, st in enumerate(chunks):
        assert sorted(st) == sorted(STAGES), ci
        assert {ev["args"]["g0"] for ev in st.values()} == {ci * K}
        for a, b in zip(STAGES, STAGES[1:]):
            assert _ns(st[a]["ts"] + st[a]["dur"]) == _ns(st[b]["ts"]), \
                (ci, a, b)


def _assert_same_outputs(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{k} interval {i}")


def _assert_same_run(got, want_outputs, want_values):
    _assert_same_outputs(got.outputs, want_outputs)
    np.testing.assert_array_equal(got.final_values, np.asarray(want_values))


def _assert_commit_before_next_dispatch(chunks):
    for st, nxt in zip(chunks, chunks[1:]):
        commit = st["chunk.commit"]
        assert _ns(commit["ts"] + commit["dur"]) <= \
            _ns(nxt["chunk.dispatch"]["ts"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_paced_chunks_commit_as_soon_as_run(case, tmp_path, monkeypatch):
    interval = _interval(case)
    unpaced = StreamService(_engine(case), _cfg(case)).run(_source(case))
    eng = _engine(case)
    outs, vals = eng.run_stream(eng.init_store.values,
                                _source(case).in_order_events, interval)

    probe = _Probe(monkeypatch)
    path = str(tmp_path / "trace.json")
    rec = StreamService(probe.watch(_engine(case)), _cfg(case, path)).run(
        _paced(_source(case), probe))
    n_chunks = len(rec.outputs) // K
    assert n_chunks == 4
    chunks = _by_chunk(_spans(path), n_chunks)
    _assert_tiled(chunks)
    _assert_commit_before_next_dispatch(chunks)
    assert [c["interval"] for c in rec.commits] == list(range(2 * n_chunks))

    _assert_same_run(rec, unpaced.outputs, unpaced.final_values)
    _assert_same_run(rec, outs, vals)


@pytest.mark.parametrize("case", ["gs", "sl", "gs-sharded"])
def test_a_backlog_still_commits_at_once(case, tmp_path, monkeypatch):
    probe = _Probe(monkeypatch)
    paced = StreamService(probe.watch(_engine(case)), _cfg(case)).run(
        _paced(_source(case), probe))

    path = str(tmp_path / "trace.json")
    eng = _backlogged(_engine(case), probe)
    rec = StreamService(eng, _cfg(case, path)).run(_source(case))
    n_chunks = len(rec.outputs) // K
    assert n_chunks == 4
    chunks = _by_chunk(_spans(path), n_chunks)
    _assert_tiled(chunks)
    # the next chunk was queued before each commit, and waited for it
    _assert_commit_before_next_dispatch(chunks)
    commits = sorted(chunks, key=lambda st: st["chunk.commit"]["ts"])
    assert [st["chunk.commit"]["args"]["chunk"] for st in commits] == \
        list(range(n_chunks))
    assert [c["interval"] for c in rec.commits] == list(range(2 * n_chunks))
    _assert_same_run(rec, paced.outputs, paced.final_values)


def test_a_crash_at_a_commit_resumes_bitwise(tmp_path, monkeypatch):
    case = "gs"
    ref = StreamService(_engine(case), _cfg(case)).run(
        _source(case, n_intervals=10))
    probe = _Probe(monkeypatch)
    cfg = _cfg(case, snapshot_every=4, ckpt_dir=str(tmp_path))
    svc = StreamService(probe.watch(_engine(case)), cfg)
    with pytest.raises(RuntimeError, match="injected failure"):
        svc.run(_paced(_source(case, n_intervals=10), probe),
                crash_after_interval=5)
    crashed = svc.last_run
    # intervals 4 and 5 committed as soon as they ran, and the crash fired
    # there, before the snapshot at 8
    assert [c["interval"] for c in crashed.commits] == list(range(6))
    assert crashed.snapshots == [4]

    rec = StreamService(probe.watch(_engine(case)), cfg).resume(
        _paced(_source(case, n_intervals=10), probe))
    assert rec.stats["replayed"] == 4 * _interval(case)
    _assert_same_run(rec, ref.outputs[4:], ref.final_values)
    _assert_same_outputs(crashed.outputs, ref.outputs[:6])
