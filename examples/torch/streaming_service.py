"""Continuous streaming service on the GS app, on the PyTorch port
(DESIGN.md §2.6; reference: ``examples/streaming_service.py``).

Runs the GS workload through ``StreamService`` on the CUDA card: an
out-of-order replayable source, watermarked interval assembly,
chunked execution over the fused driver (each chunk committed as soon as
it has run), punctuation-aligned snapshots, and — with
``--inject-restart`` — a crash/restore/replay drill that asserts the
recovered run is bitwise identical to the uninterrupted one.

With ``--corrupt-latest`` on top, the newest snapshot is damaged on disk
after the crash (torn-write simulation): ``resume`` must fall back to the
previous *valid* snapshot — never leak an exception — and still
reproduce the uninterrupted run bitwise (DESIGN.md §2.7).

With ``--storm`` the source becomes a deterministic multi-phase workload
storm (calm -> hot-key skew -> multi-partition burst -> calm) and the
adaptive control plane (DESIGN.md §2.9) is switched on: the controller
degrades tstream -> lock under the sustained conflict storm and probes
back (single-device), or ramps the exchange slack from a starved start
(sharded).  ``--trace-out`` writes the decision trace as JSONL; with
``--inject-restart`` the drill additionally asserts the recovered run's
decision trace equals the uninterrupted one.

``--devices N`` runs the sharded driver on an N-shard ``ShardMesh`` whose
shards sit on the visible cards, as the reference's ``--devices N`` puts
them on N devices: one shard a card where N cards are present, else in the
largest number G of groups, G at most the card count and dividing N, one
group a card; on the CPU, one group.  ``--perfetto-out`` writes the
pipeline's span trace (schema-checked after the run), ``--profile-dir``
adds ``torch.profiler`` per-chunk windows, and ``--hlo-cost`` annotates
the execute spans with each chunk's cost (``CostAttributor``).

    PYTHONPATH=src python examples/torch/streaming_service.py
    PYTHONPATH=src python examples/torch/streaming_service.py --inject-restart
    PYTHONPATH=src python examples/torch/streaming_service.py \\
        --inject-restart --corrupt-latest  # recovery past a corrupted snapshot
    PYTHONPATH=src python examples/torch/streaming_service.py --devices 4 \\
        --inject-restart        # sharded service, a shard on each of 4 cards
    PYTHONPATH=src python examples/torch/streaming_service.py --storm \\
        --inject-restart --trace-out trace.jsonl   # adaptive storm drill
    ... --device cpu            # on the CPU
"""
import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.apps import ALL_APPS
from repro_torch.core.intervals import (PhasedReplaySource, ReplaySource,
                                        WatermarkPolicy)
from repro_torch.core.mesh import ShardMesh, card_groups
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.faults import corrupt_snapshot
from repro_torch.runtime.service import ServiceConfig, StreamService
from repro_torch.runtime.telemetry import (PIPELINE_STAGES, TelemetryConfig,
                                           stage_summary, validate_trace)


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--intervals", type=int, default=12,
                    help="punctuation intervals to run")
    ap.add_argument("--interval", type=int, default=64,
                    help="events/interval")
    ap.add_argument("--chunk", type=int, default=2,
                    help="intervals per dispatch")
    ap.add_argument("--jitter", type=int, default=8,
                    help="arrival jitter (<= watermark lateness)")
    ap.add_argument("--inject-restart", action="store_true",
                    help="crash mid-run, restore the snapshot, assert "
                         "bitwise recovery")
    ap.add_argument("--corrupt-latest", action="store_true",
                    help="with --inject-restart: corrupt the newest snapshot "
                         "before resuming — recovery must fall back to the "
                         "previous valid one")
    ap.add_argument("--devices", type=int, default=0,
                    help="run the sharded driver on N shards, spread over "
                         "the visible cards")
    ap.add_argument("--storm", action="store_true",
                    help="multi-phase workload storm + adaptive control "
                         "plane")
    ap.add_argument("--trace-out", default="",
                    help="write the controller decision trace as JSONL")
    ap.add_argument("--perfetto-out", default="",
                    help="write a Chrome-trace/Perfetto span trace of the "
                         "pipeline (DESIGN.md §2.11) + a sibling "
                         "<path>.telemetry.json registry snapshot; the "
                         "trace is schema-validated after the run")
    ap.add_argument("--profile-dir", default="",
                    help="with --perfetto-out: torch.profiler per-chunk "
                         "windows into this directory")
    ap.add_argument("--hlo-cost", action="store_true",
                    help="with --perfetto-out: annotate execute spans with "
                         "each chunk's flops/bytes + roofline fractions")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    return ap.parse_args(argv)


def outputs_identical(a_list, b_list):
    return len(a_list) == len(b_list) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
        for a, b in zip(a_list, b_list) for k in a)


def main(argv=None):
    """Run the demo; returns ``dict(ref=..., svc=..., rec=...)`` (the
    uninterrupted run, the crashed one and the resumed one; the last two
    None without ``--inject-restart``)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    app = ALL_APPS["gs"]
    store = app.make_store(device=dev)
    iv = args.interval
    controller = None
    if args.storm:
        # calm -> hot-key skew storm -> multi-partition burst -> calm; at
        # least 4 intervals per phase so sustained triggers can fire
        per = max(4, args.intervals // 4) * iv

        def mk():
            return PhasedReplaySource(app.gen_events, [
                (per, dict(theta=0.2)),
                (per, dict(theta=2.5)),
                (per, dict(theta=0.2, n_partitions=16, mp_ratio=0.9,
                           mp_len=8)),
                (per, dict(theta=0.2)),
            ], seed=42, arrival_batch=2 * iv, jitter=args.jitter)
        controller = ControllerConfig(
            window=2, sustain=2, cooldown=2,
            degrade_scheme="lock", degrade_chain_frac=0.6,
            slack_widen=True, slack_factor=2.0, fill_widen=0.9)
    else:
        n_events = iv * args.intervals

        def mk():
            return ReplaySource(app.gen_events, n_events, seed=42,
                                arrival_batch=max(1, iv // 4),
                                jitter=args.jitter)
    mesh = None
    if args.devices:
        mesh = ShardMesh((args.devices,), ("dev",),
                         devices=card_groups(args.devices, dev))
        print(f"mesh: {args.devices} shards in {mesh.n_groups} group(s): "
              + ", ".join(f"group {g} on {d}"
                          for g, d in enumerate(mesh.devices)))
    # storm: start the sharded exchange starved (slack 1.5) so the
    # controller's widening decisions actually have work to do
    eng = DualModeEngine(app, store, EngineConfig(scheme="tstream"),
                         device=dev, mesh=mesh,
                         exchange_slack=1.5 if args.storm else 8.0)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        cfg = ServiceConfig(
            punct_interval=iv, chunk_intervals=args.chunk,
            snapshot_every=2 * args.chunk, ckpt_dir=ckpt_dir,
            controller=controller,
            watermark=WatermarkPolicy(allowed_lateness=args.jitter))
        # uninterrupted reference: no snapshots (and none left behind for
        # the restart drill to accidentally resume from).  Tracing rides
        # on the *reference* run, so the restart drill's bitwise assertion
        # doubles as the replay-safety proof: a traced run reproduces the
        # untraced recovery bit-for-bit (DESIGN.md §2.11).
        tcfg = None
        if args.perfetto_out:
            tcfg = TelemetryConfig(trace_path=args.perfetto_out,
                                   profile_dir=args.profile_dir,
                                   hlo_attribution=args.hlo_cost)
        ref_cfg = ServiceConfig(
            punct_interval=iv, chunk_intervals=args.chunk,
            controller=controller, telemetry=tcfg,
            watermark=WatermarkPolicy(allowed_lateness=args.jitter))
        ref = StreamService(eng, ref_cfg).run(mk())
        if args.perfetto_out:
            snap_path = args.perfetto_out + ".telemetry.json"
            ref.telemetry.dump(snap_path)
            want = [s for s in PIPELINE_STAGES if s != "snapshot.publish"]
            ok, why, info = validate_trace(args.perfetto_out,
                                           require_stages=want)
            assert ok, f"invalid Perfetto trace: {why}"
            print(f"  perfetto trace -> {args.perfetto_out} "
                  f"({info['n_events']} events, "
                  f"stages: {', '.join(sorted(info['stages']))})")
            print(f"  telemetry snapshot -> {snap_path}")
            for r in stage_summary(args.perfetto_out):
                print(f"    {r['stage']:<16s} x{r['count']:<4d} "
                      f"mean {r['mean_ms']:8.3f} ms   "
                      f"p99 {r['p99_ms']:8.3f} ms")
        pct = ref.latency_percentiles((50, 99))
        print(f"service: {len(ref.outputs)} intervals × {iv} "
              f"events on {dev}, {args.devices or 1} shard(s)")
        print(f"  latency p50 {pct['p50'] * 1e3:.2f} ms   "
              f"p99 {pct['p99'] * 1e3:.2f} ms   "
              f"sustained {ref.sustained_events_per_s():,.0f} ev/s")
        print(f"  stats: {ref.stats}")
        if args.storm:
            for d in ref.decisions:
                print(f"  decision @g={d['g']:>3} {d['knob']}: "
                      f"{d['old']} -> {d['new']} ({d['reason']})")
            assert ref.decisions, \
                "storm drill made no adaptive decisions — no storm?"
            if args.devices:
                assert any(d["knob"] == "slack" for d in ref.decisions)
            else:
                schemes = [(d["old"], d["new"]) for d in ref.decisions
                           if d["knob"] == "scheme"]
                assert ("tstream", "lock") in schemes, \
                    "storm never degraded the scheme"
                assert ("lock", "tstream") in schemes, \
                    "controller never probed back after the storm"
        if args.trace_out:
            with open(args.trace_out, "w") as f:
                for d in ref.decisions:
                    f.write(json.dumps(d) + "\n")
            print(f"  decision trace -> {args.trace_out} "
                  f"({len(ref.decisions)} decisions)")

        if not args.inject_restart:
            print("streaming service demo OK ✓")
            return dict(ref=ref, svc=None, rec=None)

        if args.storm and args.devices:
            # the ref run's slack escalations mutated the shared engine:
            # reset the exchange to the storm's starved starting point so
            # the restart drill begins from the same initial plan
            eng._sharded.set_exchange_slack(1.5)
        crash_at = 2 * len(ref.outputs) // 3
        svc = StreamService(eng, cfg)
        try:
            svc.run(mk(), crash_after_interval=crash_at)
            raise SystemExit("injected crash did not fire")
        except RuntimeError as e:
            print(f"  {e} (snapshots at {svc.last_run.snapshots})")
        newest = svc.last_run.snapshots[-1]
        if args.corrupt_latest:
            assert len(svc.last_run.snapshots) >= 2, \
                "corrupt-latest drill needs a fallback snapshot"
            what = corrupt_snapshot(
                os.path.join(ckpt_dir, f"step_{newest:08d}"),
                "truncate_leaf")
            print(f"  corrupted snapshot @{newest}: {what}")
        rec = StreamService(eng, cfg).resume(mk())
        if args.storm:
            assert rec.decisions == ref.decisions, \
                (f"replayed decision trace differs:\n  {rec.decisions}\n  "
                 f"!= {ref.decisions}")
            print(f"  replayed decision trace matches "
                  f"({len(rec.decisions)} decisions) ✓")
        snap = rec.stats["replayed"] // iv
        if args.corrupt_latest:
            assert snap < newest, \
                "resume used the corrupted snapshot instead of falling back"
            print(f"  resume fell back past corrupted @{newest} "
                  f"to valid @{snap} ✓")
        print(f"  restored snapshot @{snap}, replayed "
              f"{rec.stats['replayed']} events, re-executed "
              f"{len(rec.outputs)} intervals")
        assert np.array_equal(rec.final_values, ref.final_values), \
            "final state differs after recovery"
        assert outputs_identical(rec.outputs, ref.outputs[snap:]), \
            "post-resume outputs differ"
        assert outputs_identical(svc.last_run.outputs,
                                 ref.outputs[: len(svc.last_run.outputs)]), \
            "pre-crash outputs differ"
        print("recovery bit-identity OK ✓ (crash → restore → replay "
              "reproduced the uninterrupted run bitwise)")
        return dict(ref=ref, svc=svc.last_run, rec=rec)


if __name__ == "__main__":
    main()
