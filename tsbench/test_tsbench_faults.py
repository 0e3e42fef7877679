"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card: ``correct`` holds for the program as it is and comes out
false with the timed path broken underneath.  The cells run on one chip,
so there is no exchange between chips to leave out."""
import time

import numpy as np
import pytest
import torch

from repro_torch.core.scheduler import DualModeEngine
from tsbench import harness

TINY = {
    "gs-paper.batch": dict(interval=50, intervals_per_call=4, pool_calls=2),
    "gs-paper.batch-8k": dict(interval=80, intervals_per_call=2,
                              pool_calls=2),
    "sl-ledger.batch": dict(interval=50, intervals_per_call=4, pool_calls=2),
}
TINY["gs-paper.service"] = TINY["sl-ledger.service"] = dict(
    interval=50, chunk_intervals=2, queue_intervals=4, arrival_batch=25,
    rate_events_per_s=4000, warmup_chunks=1)
SEED = 2 ** 31 + 17


def _run(cell, trace=False):
    return harness.run_cell(cell, SEED, 0.05, trace, "cpu",
                            time.perf_counter(), TINY[cell])


def _flip_first(outs):
    """The first interval's first answer, altered where it is produced."""
    o = dict(outs[0])
    key = "ok" if "sum" not in o else "sum"
    o[key] = np.array(o[key], copy=True)
    o[key][0] = (not o[key][0]) if key == "ok" else o[key][0] + 1.0
    return [o] + list(outs[1:])


def _batch_fault(kind):
    real = DualModeEngine.run_stream

    def run_stream(self, values, events, interval, fused=True):
        if kind == "state_unchanged":
            outs, _ = real(self, values, events, interval, fused)
            return outs, torch.as_tensor(values).clone()
        if kind == "half_left_out":
            n = len(next(iter(events.values())))
            half = {k: np.asarray(v)[: n // 2] for k, v in events.items()}
            outs, values = real(self, values, half, interval, fused)
            return outs + outs, values
        outs, values = real(self, values, events, interval, fused)
        return _flip_first(outs), values
    return "run_stream", run_stream


def _service_fault(kind):
    if kind == "answer_altered":
        real_post = DualModeEngine.post_outputs

        def post_outputs(self, res_all, ebs_all, n_intervals):
            return _flip_first(real_post(self, res_all, ebs_all,
                                         n_intervals))
        return "post_outputs", post_outputs
    real = DualModeEngine.run_stream_chunk

    def run_stream_chunk(self, values, batched, ts0, variant=None):
        if kind == "state_unchanged":
            res, ebs, _, st = real(self, values, batched, ts0, variant)
            return res, ebs, values.clone(), st
        k = next(iter(batched.values())).shape[0]
        half = {n: v[: k // 2] for n, v in batched.items()}
        res, ebs, values, st = real(self, values, half, ts0, variant)
        twice = lambda d: {n: torch.cat([v, v]) for n, v in d.items()}
        return twice(res), twice(ebs), values, st
    return "run_stream_chunk", run_stream_chunk


@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_program_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    listed = [m["name"] for m in harness.benchmark()["end_to_end"]
              if cell in m.get("workloads", [cell])]
    assert "setup_s" in out["metrics"]
    assert set(out["metrics"]) <= set(listed)
    assert all(m["value"] > 0 for m in out["metrics"].values())


@pytest.mark.parametrize("name", ["driver.ms_per_interval",
                                  "device.idle_pct.batch"])
def test_batch_readers(name):
    """The batch cells' readers (the cells are not in BENCHMARK.json yet)."""
    run = harness.Run("gs-paper.batch", SEED, 1.0, True, "cpu", 0.0)
    run.spans = [("run_stream", 0.2, 100), ("run_stream", 0.3, 100),
                 ("run_stream", 0.5, 100), ("run_stream.profiled", 9, 100)]
    run.profile = dict(busy_s=0.25, window_s=1.0, ops=[("k", 0, 1, "kernel")])
    want = {"driver.ms_per_interval": 3.0, "device.idle_pct.batch": 75.0}
    assert harness.metric_reader(name).read(run) == pytest.approx(want[name])


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
@pytest.mark.parametrize("cell", ["gs-paper.batch", "sl-ledger.batch",
                                  "gs-paper.service", "sl-ledger.service"])
def test_a_broken_path_is_not_correct(cell, kind, monkeypatch):
    fault = _service_fault if cell.endswith("service") else _batch_fault
    name, fn = fault(kind)
    monkeypatch.setattr(DualModeEngine, name, fn)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_a_traced_run_reads_its_host_spans():
    out = _run("gs-paper.service", trace=True)
    assert out["correct"]
    m = out["metrics"]
    assert m["service.commit_ms"]["value"] > 0
    assert m["loadgen.late_ms_p95"]["value"] >= 0
    # the CPU has no device trace: its metrics are left out, not 0
    assert "device.idle_pct.service" not in m


@pytest.mark.parametrize("kernels", [True, False])
def test_a_trace_that_lost_its_kernels_is_refused(kernels):
    host = [("cudaLaunchKernel", 10.0 * i, 1.0, 1) for i in range(4)]
    dev = [("Memcpy DtoH", 5.0, 1.0, None, "gpu_memcpy")]
    if kernels:
        dev += [("k", 10.0 * i + 2, 3.0, None, "kernel") for i in range(4)]
    prof = dict(device=dev, host=host, anchor_us=0.0, anchor_ns=0)
    if not kernels:
        with pytest.raises(RuntimeError, match="lost its kernels"):
            harness.device_window(prof, 0.0, 40.0)
        return
    w = harness.device_window(prof, 0.0, 40.0)
    assert w["busy_s"] == pytest.approx(13e-6)
    assert w["window_s"] == pytest.approx(40e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY))
def test_each_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell(cell, SEED, 2.0, True, "cuda",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
