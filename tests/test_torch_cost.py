"""The port's cost attribution (``repro_torch/launch/hlo_analysis.py``,
``runtime/telemetry.CostAttributor``, ``DualModeEngine.chunk_cost``).

Held here:

* under ``ProgramTrace``, ``ShardMesh`` collectives give the ``coll_bytes``
  and ``wire_bytes_per_device`` of the reference's ``analyze_hlo`` applied
  to the same per-device shapes and groups (its ring formulas), and a
  traced backward pass records ``all_to_all``'s gradient exchange;
* each kernel's ``cost()`` equals what ``chip_smoke.py`` computed for its
  bound before the formulas moved into the kernels' ``ops.py`` (golden
  numbers from that code, on the inputs built here);
* a wrapper call under the trace counts once, at its ``cost()``, and none
  of its twin's aten ops;
* ``chunk_cost`` of a GS chunk on the ``partition`` and ``megakernel``
  rungs and of a TP chunk (both segscans) counts each kernel call once, at
  its wrapper's ``cost()``, with no aten op inside a call, and returns the
  chunk's own results;
* a service run with ``hlo_attribution=True`` is bitwise identical to one
  without, crash -> restore -> replay included (the reference's invariant,
  ``tests/test_telemetry.py``), single-device and sharded, and every
  execute span carries ``CostAttributor.annotate``'s fields.
"""
import importlib

import numpy as np
import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.apps import ALL_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.blotter import build_opbatch
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.restructure import restructure
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.kernels.hash_probe import ops as hp_ops
from repro_torch.kernels.hash_probe.ref import build_table, hash_probe_ref
from repro_torch.kernels.megakernel import ops as mk_ops
from repro_torch.kernels.radix_partition import ops as rp_ops
from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
from repro_torch.kernels.segscan import ops as ss_ops
from repro_torch.kernels.segscan.ref import segscan_affine_ref
from repro_torch.launch.hlo_analysis import ProgramTrace, analyze, breakdown
from repro_torch.runtime import telemetry as tt
from repro_torch.runtime.service import ServiceConfig, StreamService

torch.set_num_threads(1)

ANNOTATE = {"flops", "bytes_written", "wire_bytes_per_device", "gflops_s",
            "gbytes_s", "bound", "frac_compute", "frac_memory", "frac_link"}
_HLO_DT = {torch.float32: "f32", torch.int32: "s32", torch.bool: "pred"}


def _reference(colls):
    """analyze_hlo over one HLO instruction per collective: (kind,
    per-device shape, dtype, group size)."""
    lines = ["ENTRY %main.1 (p: f32[4]) -> f32[4] {"]
    for i, (kind, shape, dt, g) in enumerate(colls):
        s = f"{_HLO_DT[dt]}[{','.join(str(d) for d in shape)}]{{0}}"
        groups = ",".join(str(j) for j in range(g))
        lines.append(f"  %c{i} = {s} {kind}({s} %p), "
                     f"replica_groups={{{{{groups}}}}}")
    lines.append("}")
    return analyze_hlo("\n".join(lines), 8)


def test_collectives_match_reference_ring_formulas():
    mesh = ShardMesh((2, 4), ("data", "model"), device="cpu")
    x = torch.randn(8, 8, 3)                     # every shard's [8, 3]
    ids = torch.arange(8 * 4, dtype=torch.int32).reshape(8, 4)
    with ProgramTrace() as tr:
        mesh.all_to_all((x,), ("data", "model"), 0, 0, dim=0)   # g = 8
        mesh.all_to_all((x.reshape(8, 4, 6),), "model", 0, 0, dim=0)
        mesh.all_gather((x,), "model", 0, dim=0)                 # [4, 8, 3]
        mesh.psum((x,), "data", dim=0)
        mesh.pmax((ids,), ("data", "model"), dim=0)
        mesh.pmin((x,), "model", dim=0)
        mesh.psum((x,), (), dim=0)               # a group of one: nothing
    got = analyze(tr, 8)
    want = _reference([
        ("all-to-all", (8, 3), torch.float32, 8),
        ("all-to-all", (4, 6), torch.float32, 4),
        ("all-gather", (4, 8, 3), torch.float32, 4),
        ("all-reduce", (8, 3), torch.float32, 2),
        ("all-reduce", (4,), torch.int32, 8),
        ("all-reduce", (8, 3), torch.float32, 4)])
    assert got["coll_bytes"] == dict(want["coll_bytes"])
    assert got["wire_bytes_per_device"] == pytest.approx(
        want["wire_bytes_per_device"], rel=1e-12)
    # the tensor ops that carry the collectives out are not recorded
    assert [r.name for r in tr.ops] == ["all-to-all"] * 2 + [
        "all-gather"] + ["all-reduce"] * 3


def test_all_to_all_gradient_is_recorded():
    mesh = ShardMesh((2, 4), ("data", "model"), device="cpu")
    x = torch.randn(8, 8, 3, requires_grad=True)
    with ProgramTrace() as tr:
        (y,) = mesh.all_to_all((x,), ("data", "model"), 0, 0, dim=0)
        (g,) = torch.autograd.grad((y * torch.arange(3.0)).sum(), [x])
    kinds = [k for k, _, _ in tr.collectives]
    assert kinds == ["all-to-all", "all-to-all"]
    # the exchange is its own inverse: the gradient is the exchanged
    # cotangent
    (want,) = mesh.all_to_all((torch.ones(8, 8, 1) * torch.arange(3.0),),
                              ("data", "model"), 0, 0, dim=0)
    assert torch.equal(g, want)


# -- the kernels' cost(): golden numbers from chip_smoke.py's own code --------
def _gs_chunk(method, k=4, interval=64, seed=3):
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    ev = app.gen_events(np.random.default_rng(seed), k * interval)
    ev = {n: v.reshape((k, interval) + v.shape[1:]) for n, v in ev.items()}
    return app, store, events_to_torch(ev, "cpu")


def test_kernel_costs_equal_chip_smokes_counts():
    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 37, (3, 50), generator=g, dtype=torch.int32)
    assert rp_ops.cost(keys, 37) == (1644.0, 150.0)
    assert rp_ops.cost(keys[0], 37) == (4.0 * (2 * 50 + 37), 50.0)
    x = torch.zeros(100, 4)
    assert ss_ops.cost(x, "affine") == (6500.0, 1200.0)
    assert ss_ops.cost(x, "max") == (3300.0, 400.0)
    with pytest.raises(ValueError):
        ss_ops.cost(x, "min")

    app, store, ev = _gs_chunk("megakernel")
    ts = torch.arange(4, dtype=torch.int32) * 64
    ops, _ = build_opbatch(app, store, ev, ts)
    sops, ch = restructure(ops, store.pad_uid, rowmajor_ts=True, light=True,
                           method="megakernel", use_kernels=False,
                           geometry=False)
    assert mk_ops.cost(store.values, sops, ch, store.pad_uid, 4) == (
        149148.0, 48052.0)

    rng = np.random.default_rng(1)
    uids = rng.choice(5000, 300, replace=False).astype(np.int32)
    table = torch.from_numpy(build_table(uids, 64))
    q = torch.from_numpy(rng.choice(uids, 1000).astype(np.int32))
    assert hp_ops.cost(q, table, hash_probe_ref(q, table)) == (10048.0,
                                                                8597.0)
    # a key not in the table probes every way of every bucket
    miss = torch.tensor([5001], dtype=torch.int32)
    slots = hash_probe_ref(miss, table)
    assert int(slots[0]) == -1
    assert hp_ops.cost(miss, table, slots)[1] == 3 + 2 * 4 + 4 * 8


def test_wrapper_counts_once_at_its_cost_and_hides_its_twin():
    g = torch.Generator().manual_seed(1)
    keys = torch.randint(0, 9, (2, 40), generator=g, dtype=torch.int32)
    a, b = torch.rand(30, 2, generator=g), torch.rand(30, 2, generator=g)
    flags = torch.rand(30, generator=g) < 0.3
    with ProgramTrace() as twin:
        radix_partition_rank_ref(keys, 9)
        segscan_affine_ref(flags, a, b)
    assert len(twin.ops) > 10 and not twin.kernels
    with ProgramTrace() as tr:
        rp_ops.radix_partition_rank(keys, 9)
        ss_ops.segscan_affine(a, b, flags)
        ss_ops.segscan_max(a, flags)
    assert tr.kernels == [
        ("radix_partition",) + rp_ops.cost(keys, 9),
        ("segscan_affine",) + ss_ops.cost(a, "affine"),
        ("segscan_max",) + ss_ops.cost(a, "max")]
    assert [r.name for r in tr.ops] == [
        "kernel:radix_partition", "kernel:segscan_affine",
        "kernel:segscan_max"]
    cost = analyze(tr)
    assert cost["kernels"]["segscan_max"] == dict(calls=1, bytes=30 + 8 * 60,
                                                  ops=60.0)
    assert cost["bytes_written"] == sum(k[1] for k in tr.kernels)
    assert [row[1] for row in breakdown(tr, 2)] == [
        "kernel:segscan_affine", "kernel:radix_partition"]  # by bytes


WRAPPERS = [(rp_ops, "radix_partition_rank", "radix_partition",
             lambda a, kw: rp_ops.cost(a[0], a[1])),
            (ss_ops, "segscan_affine", "segscan_affine",
             lambda a, kw: ss_ops.cost(a[0], "affine")),
            (ss_ops, "segscan_max", "segscan_max",
             lambda a, kw: ss_ops.cost(a[0], "max")),
            (mk_ops, "fused_chain_eval", "megakernel",
             lambda a, kw: mk_ops.cost(a[0], a[1], a[2], a[3],
                                       kw["a_lut"].numel()))]


def _spy_wrappers(monkeypatch):
    """Record each wrapper call of the engine (kernel, cost) and how many
    trace records it added."""
    restr, sched = (importlib.import_module(f"repro_torch.core.{m}")
                    for m in ("restructure", "scheduler"))
    calls = []
    for mod, attr, kernel, cost in WRAPPERS:
        real = getattr(mod, attr)

        def spy(*args, _real=real, _kernel=kernel, _cost=cost, **kw):
            from repro_torch.kernels.runtime import active_trace
            tr = active_trace()
            with tr.opaque():           # before the call: it may commit
                want = _cost(args, kw)
            before = len(tr.ops)
            out = _real(*args, **kw)
            calls.append((_kernel, want, len(tr.ops) - before))
            return out
        for m in (restr, sched, mod):
            if hasattr(m, attr):
                monkeypatch.setattr(m, attr, spy)
    return calls


@pytest.mark.parametrize("app_name,method,kernels", [
    ("gs", "partition", {"radix_partition", "segscan_affine"}),
    ("gs", "megakernel", {"radix_partition", "megakernel"}),
    ("tp", "partition", {"radix_partition", "segscan_affine",
                         "segscan_max"})])
def test_chunk_cost_counts_each_kernel_call_once(app_name, method, kernels,
                                                 monkeypatch):
    app = ALL_APPS[app_name]
    store = app.make_store(device="cpu")
    ev = app.gen_events(np.random.default_rng(4), 3 * 48)
    batched = events_to_torch({k: v.reshape((3, 48) + v.shape[1:])
                               for k, v in ev.items()}, "cpu")
    eng = DualModeEngine(app, store, EngineConfig(restructure_method=method),
                         device="cpu")
    want = eng.run_stream_chunk(store.values, batched, 0)
    calls = _spy_wrappers(monkeypatch)
    out, trace = eng.chunk_cost(store.values, batched, 0)
    assert {k for k, _, _ in calls} == kernels
    assert trace.kernels == [(k,) + c for k, c, _ in calls]
    assert [added for _, _, added in calls] == [1] * len(calls), calls
    cost = analyze(trace)
    assert {k: v["calls"] for k, v in cost["kernels"].items()} == {
        k: sum(1 for c in calls if c[0] == k) for k in kernels}
    assert cost["bytes_written"] > sum(k[1] for k in trace.kernels)
    assert cost["wire_bytes_per_device"] == 0 and not cost["coll_bytes"]
    # the traced chunk is the real one
    assert torch.equal(out[2], want[2])
    for k in want[0]:
        assert torch.equal(out[0][k], want[0][k]), k


# -- the service ---------------------------------------------------------------
def _service(app_name, tcfg, tmp_path=None, sharded=False, **kw):
    app = ALL_APPS[app_name]
    mesh = ShardMesh((4,), ("dev",), device="cpu") if sharded else None
    eng = DualModeEngine(app, app.make_store(device="cpu"),
                         EngineConfig(restructure_method="megakernel"),
                         device="cpu", mesh=mesh,
                         **(dict(exchange_slack=4.0) if sharded else {}))
    cfg = ServiceConfig(punct_interval=16, chunk_intervals=2,
                        watermark=WatermarkPolicy(allowed_lateness=5),
                        telemetry=tcfg, **kw)
    return StreamService(eng, cfg)


def _source(app_name):
    return ReplaySource(ALL_APPS[app_name].gen_events, 96, seed=11,
                        arrival_batch=13, jitter=5)


def _execute_spans(path):
    return [e for e in tt._parse_trace(path)
            if e.get("ph") == "X" and e["name"] == "chunk.execute"]


def _identical(rec, ref):
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert len(rec.outputs) == len(ref.outputs)
    for a, b in zip(rec.outputs, ref.outputs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("app_name,sharded", [("gs", False), ("tp", False),
                                              ("gs", True)])
def test_attribution_changes_no_bit(app_name, sharded, tmp_path):
    ref = _service(app_name, None, sharded=sharded).run(_source(app_name))
    path = str(tmp_path / "t.json")
    rec = _service(app_name, tt.TelemetryConfig(
        trace_path=path, hlo_attribution=True), sharded=sharded).run(
            _source(app_name))
    _identical(rec, ref)
    for k in ref.stats:
        if k != "chunks":
            assert rec.stats[k] == ref.stats[k], k
    spans = _execute_spans(path)
    assert len(spans) == len(ref.outputs) // 2
    for sp in spans:
        assert ANNOTATE <= set(sp["args"]), sp["args"]
        assert sp["args"]["bytes_written"] > 0
        assert sp["args"]["frac_memory"] > 0
    wire = spans[0]["args"]["wire_bytes_per_device"]
    assert (wire > 0) == sharded           # the sharded exchange's all-to-all


def test_attribution_crash_restore_replay_bitwise(tmp_path):
    ref = _service("gs", None).run(_source("gs"))
    kw = dict(snapshot_every=2, ckpt_dir=str(tmp_path / "ckpt"))
    crash = str(tmp_path / "crash.json")
    svc = _service("gs", tt.TelemetryConfig(trace_path=crash,
                                            hlo_attribution=True), **kw)
    with pytest.raises(RuntimeError):
        svc.run(_source("gs"), crash_after_interval=3)
    assert svc.last_run.snapshots
    resume = str(tmp_path / "resume.json")
    rec = _service("gs", tt.TelemetryConfig(trace_path=resume,
                                            hlo_attribution=True),
                   **kw).resume(_source("gs"))
    snap = rec.stats["replayed"] // 16
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    assert len(rec.outputs) == len(ref.outputs[snap:])
    for a, b in zip(rec.outputs, ref.outputs[snap:]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for path in (crash, resume):
        spans = _execute_spans(path)
        assert spans and all(ANNOTATE <= set(s["args"]) for s in spans)


def test_attribution_failure_leaves_spans_bare(tmp_path, monkeypatch, caplog):
    """A failing trace is logged once; the run and its spans go on."""
    import repro_torch.launch.hlo_analysis as ha

    def broken(self, func, args, out):
        raise RuntimeError("boom")
    monkeypatch.setattr(ha.ProgramTrace, "_record", broken)
    ref = _service("gs", None).run(_source("gs"))
    path = str(tmp_path / "t.json")
    rec = _service("gs", tt.TelemetryConfig(
        trace_path=path, hlo_attribution=True)).run(_source("gs"))
    _identical(rec, ref)
    for sp in _execute_spans(path):
        assert not ANNOTATE & set(sp["args"])
    warned = [r for r in caplog.records
              if "cost attribution failed" in r.getMessage()]
    assert len(warned) == 1


def test_peaks_and_annotate():
    assert tt.device_peaks("cpu") == tt.DEVICE_PEAKS["cpu"]
    ca = tt.CostAttributor(device="cpu")
    a = ca.annotate(dict(dot_flops=2e9, bytes_written=4e9,
                         wire_bytes_per_device=0.0), 0.5)
    assert set(a) == ANNOTATE
    assert a["gbytes_s"] == 8.0 and a["frac_memory"] == 8e9 / 40e9
    assert a["bound"] == "memory"
    h100 = tt.DEVICE_PEAKS["H100"]
    assert (h100["hbm_bw"], h100["peak_flops"], h100["link_bw"]) == (
        3.35e12, 67e12, 450e9)
