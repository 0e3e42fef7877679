#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py [--seed N]

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed as set-up).
3. Kernel phase: at the main paths' shapes, holds each kernel against its
   plain-PyTorch twin on the card (radix_partition, the megakernel,
   hash_probe and segscan_max bitwise; segscan_affine to rtol = atol =
   1e-5; a second segscan call equal to the first) and times both
   with CUDA events; runs each kernel at 64 threads per block and at every
   block size the search can return (``kernels/autotune.candidates``),
   which must change no bit; and prints the rung that
   ``restructure_method="auto"`` resolves to at these shapes.  The
   megakernel is timed on the whole stream in one call (GS: 200 intervals;
   sharded GS: 200 intervals of 4 shards), held against its stream twin
   and a loop of its per-interval twin, and on one interval (alone and
   batched over 4 shards).
4. End-to-end phase, single device: ``DualModeEngine.run_stream(fused=True)``
   on the card for GS (10,000 keys, theta 0.6, megakernel rung: one
   megakernel call, three launches, for the stream) and TP (100 segments,
   theta 0.2, partition rung), 200 intervals of 500 events each.  The
   final state is held against the port's CPU run of the same seeded
   stream (GS bitwise, TP rtol 1e-5) and the post-processed outputs to
   rtol = atol = 1e-5; a small stream is held against the sequential
   ``lock`` oracle on the CPU.  Both apps also run once on the default
   ``"auto"`` rung, held to the forced rung's card run to 1e-5.
5. Sharded phase: the sharded fused driver on a ``ShardMesh`` on the card,
   same streams: GS on 4 shards, ``shared_nothing``, megakernel rung (one
   megakernel call for every shard's stream), with and without the
   hash-probe route (the two bitwise equal in state, outputs and exchange
   stats, and bitwise equal to the single-device megakernel run); TP on a
   (2, 2) socket x core mesh, ``shared_per_socket``, partition rung, and GS
   ``shared_everything`` on 4 shards, partition rung, 20 intervals, each
   held to the single-device card run of the same rung to rtol = atol =
   1e-5 (the CUDA segscan's association depends on where a chain lies
   among its tiles).  No run may drop an op.
6. Capacity phase, the runs that one block's shared memory once failed on
   the card: GS at 4,000 events (40,000 rows) an interval, 10 intervals,
   under "auto" (the "packed" rung: the megakernel's block cannot hold
   such an interval) and a forced megakernel (the staged "partition"
   rung), each with no megakernel launch and its state bitwise equal to
   its CPU run; sharded GS, 4 x ``shared_nothing``, forced megakernel, 5
   intervals of 8,000 events (40,000 received rows a shard), no op
   dropped, held to the single-device card run to 1e-5; and a GS-shaped
   store of 100,000 records (100,001 partition buckets), 20 intervals of
   500 events, forced "partition" and forced megakernel, each bitwise
   with its CPU run; that store's megakernel call is also timed alone.
7. Lockstep phase: SL (10,000 accounts + 10,000 assets, theta 0.6, half
   transfers) and OB (10,000 items, the 6:1:1 bid / alter / top mix), 200
   intervals of 500 events, through the lockstep path: forced "partition"
   (one radix_partition launch a run, nothing else) and "auto" (the
   packed rung, no launch), and SL's abort repass on a stream with every
   amount x 100.  Each run's state, outputs and per-op pre/post/success
   are bitwise with the port's CPU run of the same stream ("auto" also
   with the forced run); its ``e2e`` line gives the lockstep rounds swept
   against the sum of the intervals' longest chains.  Before the driven
   phases, SL and OB on 4 x 64 events under tstream, tstream_lockstep,
   mvlk and pat match the sequential lock schedule, and nolock on the card
   equals its CPU run bit for bit.
8. Sharded lockstep phase: the sharded driver's lockstep schedule on 4
   shards, ``shared_nothing``: SL under forced "partition" and "auto", SL's
   abort repass on the overdrawn stream, the overdrawn stream under
   ``max_dep_levels=0`` (every gated chain left to the residue sweep; its
   first 20 intervals), and OB under forced "partition".  Each run's state,
   outputs and per-op pre/post/success are bitwise with the single-device
   card run of the same rung and stream, no op is dropped, and the run
   launches radix_partition for the owner bucketing (and the restructure
   on "partition") and nothing else; its ``e2e sharded`` line gives
   events/s and the rounds swept.
9. Service phase: ``StreamService`` over a replayed, jittered arrival
   stream of the same 200 x 500 events, 8 intervals a chunk, for GS on the
   megakernel rung (one megakernel call, three launches, a chunk), TP on
   the partition rung (one radix_partition and one launch of each segscan
   a chunk) and SL on the lockstep path (one radix_partition a chunk),
   each after a warm-up service run: outputs and final state against
   ``run_stream`` on the card (GS and SL bitwise, TP to rtol = atol = 1e-5:
   a chunk puts chains at other segscan tile offsets than the whole
   stream), and a crash -> resume -> replay run with snapshots to a
   temporary directory bitwise with the clean service run.  Its ``e2e
   service`` line gives the sustained events/s, the punctuation latency
   p50/p99 (enqueue to commit, ``ServiceRun``) and the launches a chunk.
10. Sharded service phase: ``StreamService`` on a 4 x ``shared_nothing``
   engine under a reshard-only controller, over a storm of 500-event
   intervals (calm, Zipf theta 2.5 with every hot key on one residue of 4,
   calm: GS 40, 80 and 40 intervals, SL 16, 32 and 16) in arrival batches
   of 500 with jitter 50, 8 intervals a chunk, slack 4: GS on the
   megakernel rung (10,000 records) and SL on the lockstep path (10,000
   accounts + 10,000 assets, forced "partition").  Each run must migrate
   live at least once (moved rows > 0) with no op dropped, launch 2
   radix_partition a chunk (GS also one megakernel call) and one more a
   migration, and be bitwise with the single-device card ``run_stream`` of
   the in-order events; for GS a crash at ``reshard.apply``, resume and
   replay must be bitwise with the uninterrupted elastic run, on its plan.
   Its ``e2e sharded service`` line gives sustained events/s, latency
   p50/p99, migrations, moved rows and launches a chunk.
11. Baseline phase: the replicate-everything ``evaluate_sharded`` on one GS
   interval (500 events, 5,000 ops, 10,000 records) under each layout on 4
   shards, forced "partition" (one radix_partition and one segscan_affine
   launch), bitwise with the single-device staged evaluation on the card;
   its ``e2e baseline`` line gives its wall time from built ops and from
   the interval's events beside the fused sharded driver's chunk time
   (``run_stream_chunk``: state and per-op results on the device, no output
   copy) for the same interval and layout.
12. Substrate phase, the training and serving layer on the card:
   ``StreamingPipeline(PipelineConfig())`` ingests 200 intervals of 64
   documents (one segscan_affine launch each, timed alone at its shape),
   its stats state and outputs bitwise with the port's CPU run and the
   doc-count lane summing to 12,800 (``e2e pipeline``); minicpm-2b at its
   published widths cut to 2 layers trains 20 steps through ``TrainLoop``
   (bf16 params, AdamW f32, batch 8 x 128 from ``batch_for_step``, WSD,
   remat "dots"), checkpoints every 10 steps in a temporary directory; a
   crash at 15 resumed from 10 ends bitwise equal (params, optimizer state,
   losses) to the uninterrupted run, and step 0's loss agrees with the
   port's CPU loss on the same params within 2e-2 (``e2e train minicpm-2b``:
   steps/s, tokens/s, model FLOP share against 989 TFLOP/s dense bf16);
   granite-34b, 2 layers: the serve launcher's quota transactions on the
   engine, then batch 4, prompt 16, gen 16 through ``decode_step``, each
   step's float32 logits against ``forward`` to 2e-2 (``e2e serve
   granite-34b``: tokens/s in f32 and bf16); mamba2-2.7b, 2 layers, f32:
   256 decode steps against the 256-token ``ssd_chunked`` prefill to 5e-2
   (``e2e serve mamba2-2.7b``).
13. Launch-layer phase, at published widths cut in depth only:
   moonshot-v1-16b-a3b, 2 layers (one dense, one MoE: 64 experts top-6, 2
   shared), on a (2, 4) ``make_host_mesh`` on the card (8 EP shards):
   ``moe_forward_ep`` against ``moe_forward`` at capacity factor 16 (5e-4),
   and at 1.25 the card's kept mask and dropped-choice count bitwise with
   the CPU's; then 20 steps of ``build_train_step`` (batch 8 x 512, bf16
   params and AdamW state) with steps/s, tokens/s, the model FLOP share and
   one profiled step (``e2e ep`` lines).  minicpm-2b, 2 layers, float32:
   ``build_decode_step`` on ``MeshSpec({"data": 1, "model": 16})`` pads 36
   heads to 48, each step's logits within 2e-4 of the unpadded decode, with
   tokens/s of both and decode_32k's per-device KV-cache bytes from
   ``cache_specs`` (``e2e serve padded``).  The dry run on the host:
   minicpm-2b x train_4k and deepseek-v3-671b x decode_32k (multi pod)
   (``dryrun`` lines).  The GS service (K = 8, megakernel) over 40
   intervals with ``hlo_attribution=True``: bitwise with the run without,
   every execute span carrying its cost fields, no fraction of the peak
   above 1.05 (``e2e service attribution``).
14. Every driven run of phases 4 to 11 follows one uncounted warm-up run of
   the same engine and stream, sets the launch counters to 0 just before it
   and reads them just after; every kernel must have launched, and each
   run must take the rung its plan names (``DualModeEngine.last_rung``).
   Each run prints an ``e2e`` line (wall s, events/s, launches, exchange
   stats); those of phases 4, 5 and 7 also a ``profile`` line: the device's
   busy share of one more, profiled run.  The warm-up runs record the
   launch shapes of radix_partition and the segscans, each timed alone in
   a ``shape`` line with its bound and share of the bound; each of their
   radix_partition calls (every path the kernel picks by shape) is held
   bitwise against its twin and at 64, 512, 1024 and every candidate of
   the search's threads per block (``hold`` lines).
15. Examples phase: the five programs of ``examples/torch`` on the card at
   their reference defaults (quickstart, toll_processing, ledger_serving,
   streaming_service, train_100m at 300 steps of the 8-layer d = 768
   model), the service also with ``--inject-restart --corrupt-latest``,
   ``--storm --inject-restart``, ``--storm --devices 4 --inject-restart``
   and ``--perfetto-out --profile-dir --hlo-cost``: each prints its ✓
   lines, and an ``example`` line gives its wall time.
16. Autotune phase: the wrappers of segscan_affine, segscan_max,
   radix_partition and hash_probe ask ``kernels/autotune`` for their
   threads per block on every unforced call; each key's first call
   benches its candidates.  For every key the runs above decided, an
   ``autotune`` line gives the kernel, bucket, candidates, timings_us,
   winner and source (a microbench), and the winner and the default timed
   alone on the inputs of that call, held bit for bit to each other and to
   the twin (segscan_affine to the twin within 1e-5); then the
   ``--dump`` profile and the total bench time.
17. Prints one JSON line of kernel numbers, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA card it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
L2_BYTES = 50e6            # a launch shape whose bytes fit here is timed warm

N_INTERVALS = 200
INTERVAL = 500


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events).

    A sleep kernel holds the stream while the host enqueues the calls, so
    the events time the device work back to back and not the host's Python
    between launches.  Returns (device ms per call, host ms of one call
    waited for with a synchronize).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(4.0 * iters * host_s + 0.01, 5.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_s * 1e3


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the f32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|, with equal elements (infinities too) counting 0."""
    a, b = a.double().cpu(), b.double().cpu()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def assert_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if not torch.equal(a.cpu(), b.cpu()):
        raise AssertionError(f"{what}: not bitwise equal (max abs err "
                             f"{max_err(a, b)})")


def assert_close(a, b, what: str, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=tol, atol=tol,
                               err_msg=what)


def streams(seed: int):
    from repro_torch.apps import ALL_APPS
    n = N_INTERVALS * INTERVAL
    gs = ALL_APPS["gs"].gen_events(np.random.default_rng(seed), n)
    tp = ALL_APPS["tp"].gen_events(np.random.default_rng(seed + 1), n)
    return {"gs": gs, "tp": tp}


def plans(stream, dev):
    """The main path's kernel inputs, built with the plain path on the card."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.convert import events_to_torch
    from repro_torch.core.blotter import build_opbatch
    from repro_torch.core.engines import tstream_scan_plan
    from repro_torch.core.restructure import restructure
    from repro_torch.core.scheduler import EngineConfig, fused_rung

    out = {}
    for name, method in (("gs", "megakernel"), ("tp", "partition")):
        app = ALL_APPS[name]
        store = app.make_store(device=dev)
        ev = {k: v.reshape((N_INTERVALS, INTERVAL) + v.shape[1:])
              for k, v in stream[name].items()}
        ts = torch.arange(N_INTERVALS, dtype=torch.int32, device=dev) * INTERVAL
        ops, _ = build_opbatch(app, store, events_to_torch(ev, dev), ts)
        keys = torch.where(ops.valid, ops.uid,
                           torch.full_like(ops.uid, store.pad_uid))
        pres = restructure(ops, store.pad_uid, rowmajor_ts=True, light=True,
                           method=method, use_kernels=False,
                           geometry=name == "tp")
        out[name] = dict(app=app, store=store, keys=keys, pres=pres)
        n, k = keys.shape[-1], store.pad_uid + 1
        auto = fused_rung(store, n, app=app, cfg=EngineConfig())
        print(f"auto rung {name}: {n} rows per interval over {k} buckets "
              f"resolve to {auto!r}; the main path forces {method!r} "
              "(\"auto\" reads the cpu rows of LADDER_BOUNDS/MEGA_BOUNDS and "
              "the card's shared memory)")
        if name == "tp":
            out[name]["plan"] = tstream_scan_plan(store, ops, app.funs,
                                                  prestructured=pres,
                                                  use_kernels=False)
        else:
            out[name]["ops"] = ops
            out[name]["events"] = ev
    out["shard"] = shard_inputs(out["gs"], dev)
    return out


def shard_inputs(gs, dev):
    """The sharded GS path's kernel inputs (4 shards, shared_nothing), built
    with the plain path on the card: the hash probe's table and its queries
    (every op's uid, 1,000,000 for the stream), and the megakernel's stream
    of every shard's received rows."""
    from repro_torch.convert import events_to_torch
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.core.restructure import restructure
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig

    cfg = EngineConfig(restructure_method="megakernel", use_kernels=False,
                       use_hash_probe_route=True)
    eng = DualModeEngine(gs["app"], gs["store"], cfg, device=dev,
                         mesh=ShardMesh((4,), ("dev",), device=dev))
    sh = eng._sharded
    rops, _, _, cap, _ = sh.route(events_to_torch(gs["events"], dev))
    lpad = sh.own.per
    sops, ch = restructure(rops, lpad, rowmajor_ts=True, light=True,
                           method="partition", use_kernels=False,
                           geometry=False)
    values = sh.carry_in(gs["store"].values).reshape(4, lpad + 1, -1)
    print(f"sharded gs: 4 shards x {rops.uid.shape[-1]} received rows per "
          f"interval (capacity {cap} per bucket), {lpad + 1} slots per block; "
          f"probe table {list(sh.probe.table.shape)}")
    return dict(table=sh.probe.table,
                queries=gs["ops"].uid.reshape(-1).contiguous(),
                values=values, sops=sops, ch=ch, lpad=lpad)


def work(kernel, x, k=None):
    """(bytes, operations) of a radix_partition or segscan call on ``x``
    (keys [bn, n] over k buckets, or coefficient rows [n, W]): the
    kernels' own ``cost()``, the formula the cost attribution reads too."""
    if kernel == "radix_partition":
        from repro_torch.kernels.radix_partition.ops import cost
        return cost(x, k)
    from repro_torch.kernels.segscan.ops import cost
    return cost(x, kernel[len("segscan_"):])


def kernel_phase(p) -> dict:
    """Each kernel against its twin on the card, at the main path's shapes."""
    from repro_torch.core.engines import simple_affine_luts
    from repro_torch.core.types import tree_index
    from repro_torch.kernels.megakernel.ops import fused_chain_eval
    from repro_torch.kernels.megakernel.ref import fused_chain_eval_ref
    from repro_torch.kernels.radix_partition.ops import radix_partition_rank
    from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
    from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max
    from repro_torch.kernels.segscan.ref import (segscan_affine_ref,
                                                 segscan_max_ref)

    rows = {}

    # radix_partition: GS [200, 5000] over 10,001 buckets, TP [200, 2000]
    # over 201; bitwise.  Numbers summed over the two calls of a run.
    rad = dict(ms=0.0, plain_ms=0.0, bytes=0.0, ops=0.0, err=0.0)
    for name in ("gs", "tp"):
        keys, k = p[name]["keys"], p[name]["store"].pad_uid + 1
        r1, c1 = radix_partition_rank(keys, k)
        r0, c0 = radix_partition_rank_ref(keys, k)
        torch.cuda.synchronize()
        assert_equal(r1, r0, f"radix_partition rank ({name})")
        assert_equal(c1, c0, f"radix_partition counts ({name})")
        ms, host = cuda_ms(lambda: radix_partition_rank(keys, k), 20)
        plain, _ = cuda_ms(lambda: radix_partition_rank_ref(keys, k), 5)
        print(f"kernel radix_partition[{name}] keys={list(keys.shape)} K={k}: "
              f"max_abs_err=0 ms={ms} plain_ms={plain} host_ms={host}")
        nb, n_ops = work("radix_partition", keys, k)
        rad["ms"] += ms
        rad["plain_ms"] += plain
        rad["bytes"] += nb
        rad["ops"] += n_ops
    rows["radix_partition"] = dict(
        replaces="src/repro/kernels/radix_partition/kernel.py:78",
        source="src/repro_torch/csrc/radix_partition.cu", ms=rad["ms"],
        plain_ms=rad["plain_ms"], err=rad["err"],
        bound=bound(rad["bytes"], rad["ops"]))

    # segscan affine / max: TP's flattened stream [400,000, 32]; affine to
    # 1e-5, max bitwise
    plan = p["tp"]["plan"]
    w = plan.af.shape[-1]
    flags = plan.ch.seg_start.reshape(-1).contiguous()
    a = plan.af.reshape(-1, w).contiguous()
    b = plan.bf.reshape(-1, w).contiguous()
    m = plan.mx.reshape(-1, w).contiguous()
    n = a.shape[0]
    A1, B1 = segscan_affine(a, b, flags)
    A0, B0 = segscan_affine_ref(flags, a, b)
    M1 = segscan_max(m, flags)
    M0 = segscan_max_ref(flags, m)
    torch.cuda.synchronize()
    for what, x, y in (("A", A1, A0), ("B", B1, B0)):
        assert_close(x.cpu().numpy(), y.cpu().numpy(), f"segscan {what}")
    assert_equal(M1, M0, "segscan M")
    # the carry across tiles is chained in a fixed order: a second call
    # gives the same bits
    A2, B2 = segscan_affine(a, b, flags)
    for what, x, y in (("A", A2, A1), ("B", B2, B1),
                       ("M", segscan_max(m, flags), M1)):
        assert_equal(x, y, f"segscan {what}, second call vs first")
    print("segscan: affine within 1e-5 of its twin, max bitwise; a second "
          "call of each equals the first bit for bit")
    for name, fn, ref, err in (
            ("segscan_affine", lambda: segscan_affine(a, b, flags),
             lambda: segscan_affine_ref(flags, a, b),
             max(max_err(A1, A0), max_err(B1, B0))),
            ("segscan_max", lambda: segscan_max(m, flags),
             lambda: segscan_max_ref(flags, m), max_err(M1, M0))):
        ms, host = cuda_ms(fn, 20)
        plain, _ = cuda_ms(ref, 3)
        bnd = bound(*work(name, a))
        print(f"kernel {name} rows={n} W={w}: max_abs_err={err} ms={ms} "
              f"plain_ms={plain} host_ms={host} bound_ms={bnd[0]} "
              f"share_of_bound={bnd[0] / ms}")
        rows[name] = dict(
            replaces=("src/repro/kernels/segscan/kernel.py:130"
                      if name == "segscan_affine" else
                      "src/repro/kernels/segscan/kernel.py:151"),
            source="src/repro_torch/csrc/segscan.cu", ms=ms, plain_ms=plain,
            err=err, bound=bnd)

    # megakernel: GS's whole stream in one call (200 x 5,000 rows, W = 1,
    # 10,001 slots), then sharded GS's; bitwise.  The JSON row is GS's.
    store = p["gs"]["store"]
    sops_all, ch_all = p["gs"]["pres"]
    a_lut, b_lut = simple_affine_luts(p["gs"]["app"].funs, store.device)
    rows["megakernel"] = stream_megakernel(
        "gs", store.values, sops_all, ch_all, store.pad_uid, a_lut, b_lut)
    sh = p["shard"]
    rows["megakernel"]["sharded"] = stream_megakernel(
        "sharded gs", sh["values"], sh["sops"], sh["ch"], sh["lpad"], a_lut,
        b_lut)
    one = slice(0, 1)
    sops, ch = tree_index(sops_all, one), tree_index(ch_all, one)
    rows["megakernel"]["interval"] = interval_megakernel(
        "interval", store.values, sops, ch, store.pad_uid, a_lut, b_lut)
    rows["megakernel"]["batched"] = interval_megakernel(
        "batched 4 shards", sh["values"], tree_index(sh["sops"], one),
        tree_index(sh["ch"], one), sh["lpad"], a_lut, b_lut)
    rows["hash_probe"] = hash_probe_row(p["shard"])
    block_size_check(p, plan, (sops_all, ch_all, a_lut, b_lut))
    return rows


def phase_ms(fn, iters, names) -> dict:
    """Device ms per call of each named kernel over ``iters`` calls of
    ``fn``, from torch.profiler ("not measured" if it sees none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        t = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key)
        out[name] = t / 1e3 / iters if t > 0 else "not measured"
    return out


def stream_megakernel(label, values, sops, ch, pad_uid, a_lut, b_lut) -> dict:
    """The megakernel on a whole stream in one call: bitwise against its
    stream twin and a loop of its per-interval twin; timed per call."""
    from repro_torch import LAUNCHES
    from repro_torch.core.types import tree_index
    from repro_torch.kernels.megakernel.ops import cost as mega_cost
    from repro_torch.kernels.megakernel.ops import fused_chain_eval
    from repro_torch.kernels.megakernel.ref import (fused_chain_eval_ref,
                                                    fused_chain_stream_ref)

    before = LAUNCHES["megakernel"]
    res1, v1, _ = fused_chain_eval(values.clone(), sops, ch, pad_uid,
                                   a_lut=a_lut, b_lut=b_lut)
    per_call = LAUNCHES["megakernel"] - before
    res0, v0, _ = fused_chain_stream_ref(values.clone(), sops, ch, pad_uid,
                                         a_lut=a_lut, b_lut=b_lut)
    torch.cuda.synchronize()
    assert_equal(v1, v0, f"megakernel[stream {label}] values")
    for k in res0:
        assert_equal(res1[k], res0[k], f"megakernel[stream {label}] {k}")
    v = values.clone()
    for i in range(sops.uid.shape[0]):
        chi = tree_index(ch, i)
        r, v, _ = fused_chain_eval_ref(v, tree_index(sops, i), chi, pad_uid,
                                       a_lut=a_lut, b_lut=b_lut)
        for k in r:
            assert_equal(res1[k][i], chi.untake(r[k]),
                         f"megakernel[stream {label}] {k}, interval {i}, vs "
                         "the per-interval twin")
    assert_equal(v1, v, f"megakernel[stream {label}] values vs the "
                 "per-interval twin")
    scratch = values.clone()
    ms, host = cuda_ms(lambda: fused_chain_eval(
        scratch, sops, ch, pad_uid, a_lut=a_lut, b_lut=b_lut), 20)
    plain, _ = cuda_ms(lambda: fused_chain_stream_ref(
        values, sops, ch, pad_uid, a_lut=a_lut, b_lut=b_lut), 3)
    nbytes, n_ops = mega_cost(values, sops, ch, pad_uid, a_lut.numel())
    bnd = bound(nbytes, n_ops)
    phases = phase_ms(lambda: fused_chain_eval(
        scratch, sops, ch, pad_uid, a_lut=a_lut, b_lut=b_lut), 10,
        ("scan_kernel", "carry_kernel", "apply_kernel"))
    print(f"kernel megakernel[stream {label}] intervals x problems x rows = "
          f"{list(sops.uid.shape)} W={values.shape[-1]} slots="
          f"{values.shape[-2]}: max_abs_err=0 (stream twin and per-interval "
          f"twin) ms={ms} plain_ms={plain} host_ms={host} bytes={nbytes} "
          f"ops={n_ops} bound_ms={bnd[0]} ({bnd[1]}) launches_per_call="
          f"{per_call} phases_ms={phases}")
    return dict(replaces="src/repro/kernels/megakernel/kernel.py:119",
                source="src/repro_torch/csrc/megakernel.cu", ms=ms,
                plain_ms=plain, err=0.0, bound=bnd, launches_per_call=per_call)


def interval_megakernel(label, values, sops, ch, pad_uid, a_lut,
                        b_lut) -> dict:
    """The megakernel on one interval (K = 1), as the merging sharded
    layouts call it: bitwise against the per-interval twin; timed."""
    from repro_torch.core.types import tree_index
    from repro_torch.kernels.megakernel.ops import cost as mega_cost
    from repro_torch.kernels.megakernel.ops import fused_chain_eval
    from repro_torch.kernels.megakernel.ref import fused_chain_eval_ref

    res1, v1, _ = fused_chain_eval(values.clone(), sops, ch, pad_uid,
                                   a_lut=a_lut, b_lut=b_lut)
    s0, c0 = tree_index(sops, 0), tree_index(ch, 0)
    res0, v0, _ = fused_chain_eval_ref(values.clone(), s0, c0, pad_uid,
                                       a_lut=a_lut, b_lut=b_lut)
    torch.cuda.synchronize()
    assert_equal(v1, v0, f"megakernel[{label}] values")
    for k in res0:
        assert_equal(res1[k][0], c0.untake(res0[k]), f"megakernel[{label}] {k}")
    scratch = values.clone()
    ms, host = cuda_ms(lambda: fused_chain_eval(
        scratch, sops, ch, pad_uid, a_lut=a_lut, b_lut=b_lut), 50)
    plain, _ = cuda_ms(lambda: fused_chain_eval_ref(
        values, s0, c0, pad_uid, a_lut=a_lut, b_lut=b_lut), 10)
    bnd = bound(*mega_cost(values, sops, ch, pad_uid, a_lut.numel()))
    print(f"kernel megakernel[{label}] problems x rows = "
          f"{list(sops.uid.shape[1:])} W={values.shape[-1]}: max_abs_err=0 "
          f"ms={ms} plain_ms={plain} host_ms={host} bound_ms={bnd[0]}")
    return dict(ms=ms, plain_ms=plain, bound=bnd)


def hash_probe_row(sh) -> dict:
    """hash_probe at GS's probe shape: every op's uid of the 200 x 500 event
    stream (1,000,000 queries) against the 2,500 x 8 table; bitwise."""
    from repro_torch.kernels.hash_probe.ops import cost, hash_probe
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref

    table, q = sh["table"], sh["queries"]
    s1 = hash_probe(q, table)
    s0 = hash_probe_ref(q, table)
    torch.cuda.synchronize()
    assert_equal(s1, s0, "hash_probe slots")
    if bool((s0 < 0).any()):
        raise AssertionError("hash_probe: a uid of the store was not found")
    ms, host = cuda_ms(lambda: hash_probe(q, table), 50)
    plain, _ = cuda_ms(lambda: hash_probe_ref(q, table), 5)
    n = q.shape[0]
    # the operations this data needs (the kernel's cost(): the hash, each
    # probe's bucket index, the compares), counted against the f32 rate
    nbytes, n_ops = cost(q, table, s0)
    bnd = bound(nbytes, n_ops)
    print(f"kernel hash_probe queries={n} table={list(table.shape)}: "
          f"max_abs_err=0 ms={ms} plain_ms={plain} host_ms={host} "
          f"bytes={nbytes} ops={n_ops} bound_ms={bnd[0]} share_of_bound="
          f"{bnd[0] / ms}")
    return dict(replaces="src/repro/kernels/hash_probe/kernel.py:62",
                source="src/repro_torch/csrc/hash_probe.cu", ms=ms,
                plain_ms=plain, err=0.0, bound=bnd)


def block_size_check(p, plan, mega) -> None:
    """Each kernel at block sizes other than the one it launched with, as
    ``EngineConfig.kernel_block_params`` or the search set them: 64 and
    every candidate the search can return (``kernels/autotune.candidates``)
    at these shapes; no bit may change.  radix_partition here at GS's shape
    (the block sort); every driven run's radix calls, at every path, go
    through ``hold_radix`` too."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.hash_probe.ops import hash_probe
    from repro_torch.kernels.megakernel.ops import fused_chain_eval
    from repro_torch.kernels.radix_partition.ops import radix_partition_rank
    from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max

    keys, k = p["gs"]["keys"], p["gs"]["store"].pad_uid + 1
    sh = p["shard"]
    w = plan.af.shape[-1]
    flags = plan.ch.seg_start.reshape(-1).contiguous()
    a = plan.af.reshape(-1, w).contiguous()
    b = plan.bf.reshape(-1, w).contiguous()
    m = plan.mx.reshape(-1, w).contiguous()
    sops, ch, a_lut, b_lut = mega
    store = p["gs"]["store"]
    base = dict(radix=radix_partition_rank(keys, k),
                affine=segscan_affine(a, b, flags), max=(segscan_max(m, flags),),
                mega=fused_chain_eval(store.values.clone(), sops, ch,
                                      store.pad_uid, a_lut=a_lut,
                                      b_lut=b_lut)[:2],
                mega_sharded=fused_chain_eval(
                    sh["values"].clone(), sh["sops"], sh["ch"], sh["lpad"],
                    a_lut=a_lut, b_lut=b_lut)[:2],
                probe=(hash_probe(sh["queries"], sh["table"]),))
    sizes = {64}
    for kernel in autotune.KERNELS:
        sizes |= set(autotune.candidates(kernel, n=keys.shape[-1]))
        sizes |= set(autotune.candidates(kernel, n=keys.shape[-1],
                                         staged=False))
    for threads in sorted(sizes):
        got = dict(radix=radix_partition_rank(keys, k, threads=threads),
                   affine=segscan_affine(a, b, flags, threads=threads),
                   max=(segscan_max(m, flags, threads=threads),),
                   mega=fused_chain_eval(store.values.clone(), sops, ch,
                                         store.pad_uid, a_lut=a_lut,
                                         b_lut=b_lut, threads=threads)[:2],
                   mega_sharded=fused_chain_eval(
                       sh["values"].clone(), sh["sops"], sh["ch"],
                       sh["lpad"], a_lut=a_lut, b_lut=b_lut,
                       threads=threads)[:2],
                   probe=(hash_probe(sh["queries"], sh["table"],
                                     threads=threads),))
        for name, outs in got.items():
            for i, (x, y) in enumerate(zip(outs, base[name])):
                pairs = ([(x[j], y[j]) for j in y] if isinstance(y, dict)
                         else [(x, y)])
                for u, v in pairs:
                    assert_equal(u, v, f"{name} output {i} at {threads} "
                                 "threads per block")
    print("block sizes: radix_partition, segscan_affine, segscan_max, the "
          "megakernel (GS's stream and sharded GS's) and hash_probe at "
          f"{sorted(sizes)} threads per block equal their first runs bit "
          "for bit")


# The sharded runs: label, app, rung, layout, mesh shape, axis names,
# hash-probe route, intervals.
SHARDED = (
    ("gs/shared_nothing/probe", "gs", "megakernel", "shared_nothing", (4,),
     ("dev",), True, N_INTERVALS),
    ("gs/shared_nothing", "gs", "megakernel", "shared_nothing", (4,),
     ("dev",), False, N_INTERVALS),
    ("tp/shared_per_socket", "tp", "partition", "shared_per_socket", (2, 2),
     ("socket", "core"), False, N_INTERVALS),
    ("gs/shared_everything", "gs", "partition", "shared_everything", (4,),
     ("dev",), False, 20),
)


def engine(app_name, method, dev, *, mesh=None, layout="shared_nothing",
           probe=False, n_keys=None, slack=2.0, **cfg_kw):
    """An engine on ``dev``; ``n_keys`` sizes a GS store other than the
    app's 10,000 records; ``slack`` is a sharded engine's exchange slack;
    ``cfg_kw`` sets more of its EngineConfig."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig
    app = ALL_APPS[app_name]
    cfg = EngineConfig(restructure_method=method, use_hash_probe_route=probe,
                       **cfg_kw)
    store = (app.make_store(device=dev) if n_keys is None else
             app.make_store(n_keys, device=dev))
    return DualModeEngine(app, store, cfg, device=dev, mesh=mesh,
                          layout=layout, exchange_slack=slack)


def timed(eng, stream, interval=INTERVAL):
    """One ``run_stream`` on the engine's device: host clock around it, with
    a synchronize before and after on the card."""
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, values = eng.run_stream(eng.init_store.values, stream, interval,
                                  fused=True)
    if cuda:
        torch.cuda.synchronize()
    return outs, values.cpu(), time.perf_counter() - t0


def run(app_name, method, stream, dev):
    return timed(engine(app_name, method, dev), stream)


# The call sites of the kernels whose launch shapes differ between runs:
# (module, attribute, kernel) for shape_times.
CALL_SITES = (("repro_torch.core.restructure", "radix_partition_rank",
               "radix_partition"),
              ("repro_torch.core.ownership", "radix_partition_rank",
               "radix_partition"),
              ("repro_torch.kernels.segscan.ops", "segscan_affine",
               "segscan_affine"),
              ("repro_torch.kernels.segscan.ops", "segscan_max",
               "segscan_max"))


def recording(fn):
    """Run ``fn()`` with the CALL_SITES wrapped to record each call's
    arguments and result; returns ``[(kernel, wrapper, args, kwargs,
    result), ...]``, each result cloned as the call returned it."""
    import importlib
    calls, saved = [], []
    for mod_name, attr, kernel in CALL_SITES:
        mod = importlib.import_module(mod_name)
        real = getattr(mod, attr)
        saved.append((mod, attr, real))

        def rec(*args, _real=real, _kernel=kernel, **kw):
            out = _real(*args, **kw)
            calls.append((_kernel, _real, args, kw,
                          tuple(t.clone() for t in out)
                          if isinstance(out, tuple) else out.clone()))
            return out
        setattr(mod, attr, rec)
    try:
        fn()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return calls


def shape_times(label, calls, card) -> None:
    """Time each recorded kernel call alone (CUDA events, stream held) at
    the shape the run launched it with, beside its bound, its share of the
    bound and whether its bytes fit the L2 cache: such a shape, timed back
    to back, reads its inputs from L2 and may beat the HBM bound."""
    for kernel, fn, args, kw, _ in calls:
        x = args[0]
        if kernel == "radix_partition":
            what = f"keys={list(x.shape)} K={args[1]}"
            nbytes, n_ops = work(kernel, x, args[1])
        else:
            what = f"rows={x.shape[0]} W={x.shape[1]}"
            nbytes, n_ops = work(kernel, x)
        bnd = bound(nbytes, n_ops)
        ms, _ = cuda_ms(lambda: fn(*args, **kw), 20)
        print(f"shape {kernel}[{label}] {what}: ms={ms} bound_ms={bnd[0]} "
              f"({bnd[1]}) share_of_bound={bnd[0] / ms} bytes={nbytes}"
              + (" fits_l2" if nbytes <= L2_BYTES else "") + f" | {card}")


def hold_radix(label, calls) -> None:
    """Every radix_partition call of a run, at the shape the run launched
    it with: its result bitwise against the twin on the same keys, and the
    kernel at 64, 512 and 1024 threads per block and at every candidate the
    search can return for the call equal to it.  The shape picks the
    kernel's path (a warp per row, one counter pass, or the block sort), so
    the driven runs hold each path they take."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
    shapes = []
    for kernel, fn, args, kw, out in calls:
        if kernel != "radix_partition" or not args[0].numel():
            continue
        rank, counts = out
        keys, k = args[0], args[1]
        r0, c0 = radix_partition_rank_ref(keys, k)
        what = f"radix_partition[{label}] keys={list(keys.shape)} K={k}"
        assert_equal(rank, r0, f"{what}: rank vs twin")
        assert_equal(counts, c0, f"{what}: counts vs twin")
        for threads in sorted({64, 512, 1024} | set(autotune.candidates(
                "radix_partition", n=keys.shape[-1]))):
            r1, c1 = fn(keys, k, **{**kw, "threads": threads})
            assert_equal(r1, rank, f"{what}: rank at {threads} threads")
            assert_equal(c1, counts, f"{what}: counts at {threads} threads")
        shapes.append(f"{list(keys.shape)} K={k}")
    if shapes:
        print(f"hold radix_partition[{label}]: {'; '.join(shapes)} bitwise "
              "with the twin, and at 64, 512, 1024 and every candidate of "
              "the search's threads per block")


def counted(eng, stream, launches, label=None, card="", interval=INTERVAL):
    """A driven run: launch counters to 0 just before, read just after.

    An uncounted run of the same engine and stream goes first, so the timed
    run finds the CUDA modules of its kernels loaded (they load lazily, at
    a kernel's first launch) and the allocator warm, as a long-running
    engine would.  With a ``label``, that run records the launch shapes of
    radix_partition and the segscans, which are then timed alone.  Its
    recorded calls that launch (non-empty inputs) must number what its
    launch counts say, so a call site missing from CALL_SITES fails.  Its
    radix_partition calls are held against the twin (``hold_radix``)."""
    from repro_torch import LAUNCHES, reset_launches
    reset_launches()
    calls = recording(lambda: timed(eng, stream, interval))
    for kernel in {k for _, _, k in CALL_SITES}:
        seen = sum(1 for k, _, args, _, _ in calls
                   if k == kernel and args[0].numel())
        if seen != LAUNCHES[kernel]:
            raise AssertionError(
                f"{kernel}: {LAUNCHES[kernel]} launches but {seen} recorded "
                "calls; a call site is missing from CALL_SITES")
    hold_radix(label or "run", calls)
    if label is not None:
        shape_times(label, calls, card)
    reset_launches()
    outs, values, wall = timed(eng, stream, interval)
    got = dict(LAUNCHES)
    for k, v in got.items():
        launches[k] += v
    if not torch.isfinite(values).all():
        raise AssertionError("non-finite final state")
    return outs, values, wall, got


def profiled(eng, stream, label) -> None:
    """One more run under torch.profiler: the device's busy share of the
    wall time and the kernels that take it (the profiler's own cost
    lengthens the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = timed(eng, stream)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy <= 0:
        print(f"profile {label}: wall_s={wall} device time not measured "
              "(the profiler saw no CUDA activity)")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile {label}: wall_s={wall} device_busy_s={busy} "
          f"busy_share={busy / wall} top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in top))


def profile_call(label, fn) -> None:
    """``fn()`` once more under torch.profiler: the device's busy share of
    its wall time and the kernels that take it (the profiler's own cost
    lengthens the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    if busy <= 0:
        print(f"profile {label}: wall_s={wall} device time not measured "
              "(the profiler saw no CUDA activity)")
        return
    launches = sum(e.count for e in dev)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile {label}: wall_s={wall} device_busy_s={busy} "
          f"busy_share={busy / wall} device_ops={launches} top: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
              f"x{e.count}" for e in top))


def check_outputs(outs, ref, what, n_intervals, bitwise=False,
                  interval=INTERVAL) -> None:
    if len(outs) != n_intervals or len(ref) != n_intervals:
        raise AssertionError(f"{what}: {len(outs)} intervals out")
    for i, (o, oc) in enumerate(zip(outs, ref)):
        for k in oc:
            if o[k].shape != (interval,):
                raise AssertionError(f"{what} {k}: shape {o[k].shape}")
            if bitwise and not np.array_equal(o[k], oc[k]):
                raise AssertionError(f"{what} interval {i} {k}: not bitwise "
                                     "equal")
            assert_close(o[k], oc[k], f"{what} interval {i} {k}")


def check_scans(label, app_name, method, got) -> None:
    """One launch of each segscan the rung runs per ``run_stream``: the
    staged and "auto" rungs scan the whole stream once (max only for TP's
    max tables); the megakernel rung runs none."""
    staged = method != "megakernel"
    want = dict(segscan_affine=int(staged),
                segscan_max=int(staged and app_name == "tp"))
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{label}: segscan launches {got}, expected "
                             f"{want}")


def check_rung(eng, rung, label) -> None:
    if eng.last_rung != rung:
        raise AssertionError(f"{label}: the run took the {eng.last_rung!r} "
                             f"rung, expected {rung!r}")


def end_to_end(stream, card, cuda, launches) -> dict:
    """The single-device driver on the card, forced rungs and "auto"."""
    cpu = torch.device("cpu")
    single = {}
    for app_name, method in (("gs", "megakernel"), ("tp", "partition")):
        eng = engine(app_name, method, cuda)
        outs, values, wall, got = counted(eng, stream[app_name], launches,
                                          f"{app_name} rung={method}", card)
        print(f"e2e {app_name} rung={method} intervals={N_INTERVALS}x"
              f"{INTERVAL}: wall_s={wall} events_per_s="
              f"{N_INTERVALS * INTERVAL / wall} launches={got} card={card}")
        check_scans(f"{app_name} rung={method}", app_name, method, got)
        check_rung(eng, method, f"{app_name} rung={method}")
        if method == "megakernel" and got["megakernel"] != 3:
            raise AssertionError(f"{app_name}: {got['megakernel']} megakernel "
                                 "launches, expected one call (3 launches)")
        single[app_name, method] = (outs, values)
        outs_c, values_c, wall_c = run(app_name, method, stream[app_name], cpu)
        print(f"e2e {app_name} cpu reference: wall_s={wall_c}")
        if app_name == "gs":
            assert_equal(values, values_c, "gs final state vs CPU run")
        else:
            assert_close(values, values_c, "tp final state vs CPU run")
        check_outputs(outs, outs_c, app_name, N_INTERVALS)
        print(f"e2e {app_name}: state and outputs agree with the CPU run "
              f"(state max abs err {max_err(values, values_c)})")
        profiled(eng, stream[app_name], app_name)

    # the default rung, which a user who sets nothing gets
    for app_name, forced in (("gs", "megakernel"), ("tp", "partition")):
        eng = engine(app_name, "auto", cuda)
        outs, values, wall, got = counted(eng, stream[app_name], launches,
                                          f"{app_name} rung=auto", card)
        print(f"e2e {app_name} rung=auto intervals={N_INTERVALS}x{INTERVAL}: "
              f"wall_s={wall} events_per_s={N_INTERVALS * INTERVAL / wall} "
              f"launches={got} card={card}")
        check_scans(f"{app_name} rung=auto", app_name, "auto", got)
        check_rung(eng, "packed", f"{app_name} rung=auto")
        ref_outs, ref_values = single[app_name, forced]
        assert_close(values, ref_values, f"{app_name} auto vs {forced}: state")
        check_outputs(outs, ref_outs, f"{app_name} auto", N_INTERVALS)
        print(f"e2e {app_name} rung=auto: agrees with the {forced} run "
              f"(state max abs err {max_err(values, ref_values)})")
        profiled(eng, stream[app_name], f"{app_name} rung=auto")
    return single


def sharded_phase(stream, card, cuda, single, launches) -> None:
    """The sharded fused driver on a ShardMesh on the card."""
    from repro_torch.core.mesh import ShardMesh
    results = {}
    for label, app_name, method, layout, shape, names, probe, n_i in SHARDED:
        st = {k: np.asarray(v)[: n_i * INTERVAL]
              for k, v in stream[app_name].items()}
        eng = engine(app_name, method, cuda,
                     mesh=ShardMesh(shape, names, device=cuda), layout=layout,
                     probe=probe)
        outs, values, wall, got = counted(eng, st, launches,
                                          f"sharded {label}", card)
        ex = eng.last_exchange_stats
        print(f"e2e sharded {label} mesh={shape} rung={method} "
              f"intervals={n_i}x{INTERVAL}: wall_s={wall} events_per_s="
              f"{n_i * INTERVAL / wall} launches={got} "
              f"dropped={int(np.sum(ex['dropped']))} "
              f"shipped={int(np.sum(ex['shipped']))} "
              f"max_fill={int(np.max(ex['max_fill']))} "
              f"capacity={int(ex['capacity'])} exchanged_rows_per_device="
              f"{int(ex['exchanged_rows_per_device'])} "
              f"shard_load={ex['shard_load'].tolist()} card={card}")
        if int(np.sum(ex["dropped"])) != 0:
            raise AssertionError(f"sharded {label}: the exchange dropped ops")
        check_rung(eng, method, f"sharded {label}")
        want = dict(radix_partition=2, hash_probe=int(probe),
                    megakernel=3 if method == "megakernel" else 0,
                    segscan_affine=0 if method == "megakernel" else 1,
                    segscan_max=1 if app_name == "tp" else 0)
        if got != want:
            raise AssertionError(f"sharded {label}: launches {got}, "
                                 f"expected {want}")
        # the single-device run of the same rung on the card
        if n_i == N_INTERVALS:
            ref_outs, ref_values = single[app_name, method]
        else:
            ref_outs, ref_values, _ = timed(engine(app_name, method, cuda),
                                            st)
        if method == "megakernel":
            assert_equal(values, ref_values, f"sharded {label} state vs "
                         "single device")
        else:
            assert_close(values, ref_values, f"sharded {label} state vs "
                         "single device")
        check_outputs(outs, ref_outs, f"sharded {label}", n_i,
                      bitwise=method == "megakernel")
        bar = "bitwise" if method == "megakernel" else "rtol = atol = 1e-5"
        print(f"e2e sharded {label}: state and outputs agree with the "
              f"single-device card run ({bar}; state max abs err "
              f"{max_err(values, ref_values)})")
        results[label] = (outs, values, ex)
        profiled(eng, st, f"sharded {label}")

    # the probe route and the direct gather route identically
    o1, v1, e1 = results["gs/shared_nothing/probe"]
    o0, v0, e0 = results["gs/shared_nothing"]
    assert_equal(v1, v0, "gs probe route vs gather: state")
    check_outputs(o1, o0, "gs probe route vs gather", N_INTERVALS,
                  bitwise=True)
    for k in e0:
        if not np.array_equal(e1[k], e0[k]):
            raise AssertionError(f"gs probe route vs gather: stats {k}")
    print("e2e sharded gs: the hash-probe route gives the same bits as the "
          "direct gather (state, outputs, exchange stats)")


# The megakernel's capacity (C1): GS at 4,000 events (40,000 rows) an
# interval, where the "auto" band engages the megakernel but its block holds
# no interval; sharded GS at 8,000 events, over 32,768 received rows a shard.
BAND_INTERVAL, BAND_INTERVALS = 4000, 10
SHARD_BAND_INTERVAL, SHARD_BAND_INTERVALS = 8000, 5
# A key space beyond the old partition's shared-memory cap (C2): a GS-shaped
# store of 100,000 records (100,001 slots with the pad).
WIDE_KEYS, WIDE_INTERVALS = 100_000, 20


def wide_gs_events(seed: int, n_events: int, n_keys: int) -> dict:
    """GS events over ``n_keys`` records, drawn in bulk: Zipf(0.6) keys as
    ``apps/gs.gen_events`` draws them, with a row that repeats a key drawn
    again (ten distinct keys a transaction), half reads."""
    from repro_torch.apps import gs
    from repro_torch.apps.common import zipf_probs
    rng = np.random.default_rng(seed)
    p = zipf_probs(n_keys, 0.6)
    keys = rng.choice(n_keys, size=(n_events, gs.TXN_LEN), p=p)
    while True:
        srt = np.sort(keys, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            break
        keys[dup] = rng.choice(n_keys, size=(int(dup.sum()), gs.TXN_LEN),
                               p=p)
    return dict(keys=keys.astype(np.int32),
                is_read=rng.random(n_events) < 0.5,
                values=rng.uniform(1.0, 100.0, (n_events, gs.TXN_LEN)
                                   ).astype(np.float32))


def wide_megakernel(st, dev, card) -> None:
    """The wide store's megakernel call (20 x 5,000 rows over 100,001
    slots) alone: bitwise against its twins, timed beside its bound."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.convert import events_to_torch
    from repro_torch.core.blotter import build_opbatch
    from repro_torch.core.engines import simple_affine_luts
    from repro_torch.core.restructure import restructure
    app = ALL_APPS["gs"]
    store = app.make_store(WIDE_KEYS, device=dev)
    n_i = len(st["keys"]) // INTERVAL
    ev = {k: np.asarray(v)[: n_i * INTERVAL].reshape(
        (n_i, INTERVAL) + np.asarray(v).shape[1:]) for k, v in st.items()}
    ts = torch.arange(n_i, dtype=torch.int32, device=dev) * INTERVAL
    ops, _ = build_opbatch(app, store, events_to_torch(ev, dev), ts)
    sops, ch = restructure(ops, store.pad_uid, rowmajor_ts=True, light=True,
                           method="partition", use_kernels=False,
                           geometry=False)
    a_lut, b_lut = simple_affine_luts(app.funs, dev)
    r = stream_megakernel("gs wide", store.values, sops, ch, store.pad_uid,
                          a_lut, b_lut)
    print(f"kernel megakernel[gs wide]: ms={r['ms']} plain_ms="
          f"{r['plain_ms']} bound_ms={r['bound'][0]} ({r['bound'][1]}) "
          f"launches_per_call={r['launches_per_call']} | {card}")


def capacity_phase(stream, card, cuda, launches, seed) -> None:
    """The runs that the shared memory of one block once failed on the
    card: each completes, takes the rung the plan picks and holds its CPU
    run (GS's READ and PUT compose exactly on every rung: state bitwise)."""
    from repro_torch.core.mesh import ShardMesh
    cpu = torch.device("cpu")
    gs_band = {k: np.asarray(v)[: BAND_INTERVALS * BAND_INTERVAL]
               for k, v in stream["gs"].items()}
    wide = wide_gs_events(seed + 2, WIDE_INTERVALS * INTERVAL, WIDE_KEYS)
    # label, method, stream, interval, n_keys, rung, launches
    runs = (
        ("gs band rung=auto", "auto", gs_band, BAND_INTERVAL, None, "packed",
         dict(radix_partition=0, megakernel=0, segscan_affine=1)),
        ("gs band rung=megakernel", "megakernel", gs_band, BAND_INTERVAL,
         None, "partition",
         dict(radix_partition=1, megakernel=0, segscan_affine=1)),
        ("gs wide rung=partition", "partition", wide, INTERVAL, WIDE_KEYS,
         "partition", dict(radix_partition=1, megakernel=0,
                           segscan_affine=1)),
        ("gs wide rung=megakernel", "megakernel", wide, INTERVAL, WIDE_KEYS,
         "megakernel", dict(radix_partition=1, megakernel=3,
                            segscan_affine=0)))
    for label, method, st, interval, n_keys, rung, want in runs:
        n_i = len(st["keys"]) // interval
        eng = engine("gs", method, cuda, n_keys=n_keys)
        outs, values, wall, got = counted(eng, st, launches, label, card,
                                          interval)
        print(f"e2e {label} intervals={n_i}x{interval} slots="
              f"{eng.init_store.values.shape[0]}: wall_s={wall} events_per_s="
              f"{n_i * interval / wall} launches={got} rung={eng.last_rung} "
              f"card={card}")
        check_rung(eng, rung, label)
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        outs_c, values_c, _ = timed(engine("gs", method, cpu, n_keys=n_keys),
                                    st, interval)
        assert_equal(values, values_c, f"{label}: final state vs CPU run")
        check_outputs(outs, outs_c, label, n_i, interval=interval)
        print(f"e2e {label}: state bitwise and outputs within 1e-5 of the "
              "CPU run")
        if label == "gs wide rung=megakernel":
            wide_megakernel(st, cuda, card)

    # sharded GS, 4 x shared_nothing, forced megakernel, beyond the capacity
    label = "sharded gs band/shared_nothing"
    st = {k: np.asarray(v)[: SHARD_BAND_INTERVALS * SHARD_BAND_INTERVAL]
          for k, v in stream["gs"].items()}
    eng = engine("gs", "megakernel", cuda,
                 mesh=ShardMesh((4,), ("dev",), device=cuda))
    outs, values, wall, got = counted(eng, st, launches, label, card,
                                      SHARD_BAND_INTERVAL)
    ex = eng.last_exchange_stats
    rows = int(ex["exchanged_rows_per_device"])
    print(f"e2e {label} mesh=(4,) rung={eng.last_rung} intervals="
          f"{SHARD_BAND_INTERVALS}x{SHARD_BAND_INTERVAL}: wall_s={wall} "
          f"events_per_s={SHARD_BAND_INTERVALS * SHARD_BAND_INTERVAL / wall} "
          f"launches={got} dropped={int(np.sum(ex['dropped']))} "
          f"received_rows_per_shard={rows} capacity={int(ex['capacity'])} "
          f"card={card}")
    if int(np.sum(ex["dropped"])) != 0:
        raise AssertionError(f"{label}: the exchange dropped ops")
    if rows <= 1 << 15:
        raise AssertionError(f"{label}: {rows} received rows per shard, not "
                             "beyond the megakernel band's 32,768")
    check_rung(eng, "partition", label)
    want = dict(radix_partition=2, hash_probe=0, megakernel=0,
                segscan_affine=1, segscan_max=0)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    ref_outs, ref_values, _ = timed(engine("gs", "megakernel", cuda), st,
                                    SHARD_BAND_INTERVAL)
    assert_close(values, ref_values, f"{label} state vs single device")
    check_outputs(outs, ref_outs, label, SHARD_BAND_INTERVALS,
                  interval=SHARD_BAND_INTERVAL)
    print(f"e2e {label}: state and outputs agree with the single-device card "
          f"run (rtol = atol = 1e-5; state max abs err "
          f"{max_err(values, ref_values)})")


def oracle_check(cuda) -> None:
    """A small stream on the card against the sequential lock schedule on
    the CPU: GS and TP on their forced rungs; SL and OB under tstream,
    tstream_lockstep, mvlk and pat (state and outputs to 1e-5, as the
    reference holds its schemes); nolock on the card bitwise with its own
    CPU run."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig
    runs = [(a, EngineConfig(restructure_method=m))
            for a, m in (("gs", "megakernel"), ("tp", "partition"))]
    runs += [(a, EngineConfig(scheme=sch)) for a in ("sl", "ob")
             for sch in ("tstream", "tstream_lockstep", "mvlk", "pat")]
    for app_name, cfg in runs:
        app = ALL_APPS[app_name]
        stream = app.gen_events(np.random.default_rng(7), 256)
        got = DualModeEngine(app, app.make_store(device=cuda), cfg,
                             device=cuda)
        ref = DualModeEngine(app, app.make_store(device="cpu"),
                             EngineConfig(scheme="lock"), device="cpu")
        o1, v1 = got.run_stream(got.init_store.values, stream, 64)
        o0, v0 = ref.run_stream(ref.init_store.values, stream, 64)
        what = f"{app_name} {cfg.scheme} vs lock oracle"
        assert_close(v1.cpu(), v0, f"{what}: state")
        check_outputs(o1, o0, what, 4, interval=64)
        print(f"oracle {app_name} {cfg.scheme} rung="
              f"{cfg.restructure_method}: 4 x 64 events on the card match "
              "the sequential lock schedule")
    for app_name in ("sl", "ob"):
        app = ALL_APPS[app_name]
        stream = app.gen_events(np.random.default_rng(7), 256)
        outs = []
        for d in (cuda, torch.device("cpu")):
            eng = DualModeEngine(app, app.make_store(device=d),
                                 EngineConfig(scheme="nolock"), device=d)
            outs.append(eng.run_stream(eng.init_store.values, stream, 64))
        (o1, v1), (o0, v0) = outs
        assert_equal(v1, v0, f"{app_name} nolock: state vs CPU run")
        check_outputs(o1, o0, f"{app_name} nolock", 4, bitwise=True,
                      interval=64)
        print(f"oracle {app_name} nolock: the card's run equals the CPU run "
              "bit for bit (no oracle: nolock is incorrect by design)")


# The lockstep apps at their published sizes (paper §VI-A): SL over 10,000
# accounts and 10,000 assets (theta 0.6, half transfers), OB over 10,000
# items (the 6:1:1 bid / alter / top mix), 200 intervals of 500 events.
LOCKSTEP_APPS = ("sl", "ob")
PROFILE_INTERVALS = 20


def per_op_results(eng, stream) -> dict:
    """Per-op pre/post/success of the engine's fused driver on ``stream``
    (what ``run_stream`` post-processes), on the host."""
    from repro_torch.convert import events_to_torch
    from repro_torch.core.scheduler import _fused_impl
    n_i = len(next(iter(stream.values()))) // INTERVAL
    ev = {k: np.asarray(v)[: n_i * INTERVAL].reshape(
        (n_i, INTERVAL) + np.asarray(v).shape[1:]) for k, v in stream.items()}
    res, _, _, _, _ = _fused_impl(
        eng.init_store.values.clone(), events_to_torch(ev, eng.device), 0,
        app=eng.app, cfg=eng.cfg, store=eng.init_store)
    return {k: v.cpu() for k, v in res.items()}


def lockstep_run(app_name, method, st, card, cuda, launches, rung, **cfg_kw):
    """One counted run of the lockstep path on the card: the rung, the
    launches (one radix_partition on the partition rung, nothing else), and
    an ``e2e`` line with the rounds swept against the chains' lengths."""
    label = f"{app_name} rung={method}" + "".join(
        f" {k}={v}" for k, v in cfg_kw.items())
    eng = engine(app_name, method, cuda, **cfg_kw)
    outs, values, wall, got = counted(eng, st, launches, label, card)
    check_rung(eng, rung, label)
    want = {k: 0 for k in got}
    want["radix_partition"] = int(rung == "partition")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    stats = eng.last_stats
    if any(s.path != "lockstep" for s in stats):
        raise AssertionError(f"{label}: not the lockstep path")
    swept = sum(s.swept for s in stats)
    rounds = sum(int(s.rounds) for s in stats)
    max_len = sum(int(s.max_chain) for s in stats)
    residue = sum(s.residue for s in stats)
    aborted = sum(int(np.sum(o["rejected"])) for o in outs)
    print(f"e2e {label} intervals={len(stats)}x{INTERVAL}: wall_s={wall} "
          f"events_per_s={len(stats) * INTERVAL / wall} launches={got} "
          f"rounds_swept={swept} max_len_sum={max_len} "
          f"rounds_reported={rounds} residue_ops={residue} "
          f"rejected={aborted} card={card}")
    return eng, outs, values, aborted


def lockstep_phase(card, cuda, launches, seed) -> dict:
    """SL and OB through the lockstep path on the card, forced "partition"
    and "auto", and SL's abort repass on an overdrawn stream: each bitwise
    with the port's CPU run of the same stream (state, outputs, per-op
    pre/post/success).  Returns the streams and, by label, each forced
    run's (state, outputs, per-op results) for the sharded phase."""
    from repro_torch.apps import ALL_APPS
    cpu = torch.device("cpu")
    n = N_INTERVALS * INTERVAL
    t0 = time.perf_counter()
    data = {a: ALL_APPS[a].gen_events(np.random.default_rng(seed + 3 + i), n)
            for i, a in enumerate(LOCKSTEP_APPS)}
    over = dict(data["sl"])
    over["amount"] = (over["amount"] * 100).astype(np.float32)
    print(f"data lockstep: seed {seed}, {n} events each of SL and OB, in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = [(a, data[a], {}) for a in LOCKSTEP_APPS]
    runs.append(("sl", over, dict(abort_repass=True)))
    single = {}
    for app_name, st, cfg_kw in runs:
        eng, outs, values, aborted = lockstep_run(
            app_name, "partition", st, card, cuda, launches, "partition",
            **cfg_kw)
        label = app_name + (" abort_repass" if cfg_kw else "")
        if not cfg_kw:
            # the walk launches ~100 small kernels an interval: profile a
            # window of the stream, which the profiler digests in seconds
            head = {k: np.asarray(v)[: PROFILE_INTERVALS * INTERVAL]
                    for k, v in st.items()}
            profiled(eng, head, f"{label} rung=partition (first "
                     f"{PROFILE_INTERVALS} intervals)")
        cpu_eng = engine(app_name, "partition", cpu, **cfg_kw)
        outs_c, values_c, wall_c = timed(cpu_eng, st)
        assert_equal(values, values_c, f"{label}: final state vs CPU run")
        check_outputs(outs, outs_c, label, N_INTERVALS, bitwise=True)
        res1, res0 = per_op_results(eng, st), per_op_results(cpu_eng, st)
        for k in res0:
            assert_equal(res1[k], res0[k], f"{label}: per-op {k} vs CPU run")
        single[label] = (values, outs, res1)
        print(f"e2e {label}: state, outputs and per-op pre/post/success "
              f"bitwise with the CPU run (cpu wall_s={wall_c})")
        if cfg_kw:
            if aborted <= 0:
                raise AssertionError(f"{label}: no transaction aborted")
            print(f"e2e {label}: {aborted} transfers aborted and masked on "
                  "the repass")
            continue
        # the default rung, which a user who sets nothing gets
        _, outs_a, values_a, _ = lockstep_run(app_name, "auto", st, card,
                                              cuda, launches, "packed")
        assert_equal(values_a, values, f"{app_name} auto vs partition: state")
        check_outputs(outs_a, outs, f"{app_name} auto vs partition",
                      N_INTERVALS, bitwise=True)
        print(f"e2e {app_name} rung=auto: bitwise with the partition run")
    print(f"lockstep phase: {time.perf_counter() - t0:.1f} s")
    return dict(data=data, over=over, single=single)


N_SHARDS = 4
RESIDUE_INTERVALS = 20


def sharded_per_op(eng, stream, n_i) -> dict:
    """Per-op pre/post/success of the sharded driver, back in flat per-op
    layout ``[n_intervals, N]`` (the reverse exchange's output), on the
    host."""
    from repro_torch.convert import events_to_torch
    sh = eng._sharded
    ev = {k: np.asarray(v)[: n_i * INTERVAL].reshape(
        (n_i, INTERVAL) + np.asarray(v).shape[1:]) for k, v in stream.items()}
    res = sh._blocks_impl(sh.carry_in(eng.init_store.values),
                          events_to_torch(ev, eng.device), 0)[0]
    return {k: v.cpu() for k, v in res.items()}


def sharded_lockstep_phase(lock, card, cuda, launches) -> None:
    """The sharded driver's lockstep schedule on the card (4 shards,
    shared_nothing): each run bitwise with the single-device card run of
    the same rung and stream (state, outputs, per-op pre/post/success), no
    op dropped."""
    from repro_torch.core.mesh import ShardMesh
    t0 = time.perf_counter()
    data, over, single = lock["data"], lock["over"], lock["single"]
    head = {k: np.asarray(v)[: RESIDUE_INTERVALS * INTERVAL]
            for k, v in over.items()}
    # the residue branch's single-device reference (its own config)
    eng = engine("sl", "partition", cuda, max_dep_levels=0)
    outs_r, vals_r, _ = timed(eng, head)
    single["sl residue"] = (vals_r, outs_r, per_op_results(eng, head))
    runs = (("sl", "partition", data["sl"], {}, "sl", "partition"),
            ("sl", "auto", data["sl"], {}, "sl", "packed"),
            ("sl", "partition", over, dict(abort_repass=True),
             "sl abort_repass", "partition"),
            ("sl", "partition", head, dict(max_dep_levels=0), "sl residue",
             "partition"),
            ("ob", "partition", data["ob"], {}, "ob", "partition"))
    for app_name, method, st, cfg_kw, ref, rung in runs:
        label = f"sharded {app_name} rung={method}" + "".join(
            f" {k}={v}" for k, v in cfg_kw.items())
        eng = engine(app_name, method, cuda,
                     mesh=ShardMesh((N_SHARDS,), ("dev",), device=cuda),
                     **cfg_kw)
        outs, values, wall, got = counted(eng, st, launches, label, card)
        check_rung(eng, rung, label)
        want = {k: 0 for k in got}
        want["radix_partition"] = 1 + int(rung == "partition")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        xs = eng.last_exchange_stats
        dropped = int(np.sum(xs["dropped"]))
        if dropped:
            raise AssertionError(f"{label}: {dropped} ops dropped")
        n_i = len(outs)
        print(f"e2e {label} mesh=({N_SHARDS},) intervals={n_i}x{INTERVAL}: "
              f"wall_s={wall} events_per_s={n_i * INTERVAL / wall} "
              f"launches={got} rounds_swept={int(xs['swept'])} "
              f"residue_ops={int(xs['residue'])} dropped={dropped} "
              f"shipped={int(np.sum(xs['shipped']))} max_fill="
              f"{int(np.max(xs['max_fill']))} capacity={int(xs['capacity'])}"
              f" card={card}")
        ref_values, ref_outs, ref_res = single[ref]
        assert_equal(values, ref_values, f"{label}: state vs single device")
        check_outputs(outs, ref_outs, label, n_i, bitwise=True)
        res = sharded_per_op(eng, st, n_i)
        for k in ref_res:
            assert_equal(res[k], ref_res[k],
                         f"{label}: per-op {k} vs single device")
        if cfg_kw.get("max_dep_levels") == 0 and int(xs["residue"]) <= 0:
            raise AssertionError(f"{label}: no op reached the residue")
        print(f"e2e {label}: state, outputs and per-op pre/post/success "
              "bitwise with the single-device card run")
        if method == "partition" and not cfg_kw:
            profiled(eng, {k: np.asarray(v)[: PROFILE_INTERVALS * INTERVAL]
                           for k, v in st.items()},
                     f"{label} (first {PROFILE_INTERVALS} intervals)")
    print(f"sharded lockstep phase: {time.perf_counter() - t0:.1f} s")


SERVICE_CHUNK = 8
SERVICE_JITTER = 50
SERVICE_PROFILE_INTERVALS = 40


def service_shapes(label, run, card) -> None:
    """Run ``run()`` (a service run) recording its kernel calls: each
    launch shape of radix_partition and the segscans once, held and timed
    alone (``hold`` and ``shape`` lines), and the first megakernel chunk
    call (of the single-device or the sharded driver) held against its
    stream twin and timed beside its bound."""
    import repro_torch.core.scheduler as sched
    import repro_torch.core.sharded_stream as sharded
    from repro_torch.kernels.megakernel.ops import cost as mega_cost
    from repro_torch.kernels.megakernel.ref import fused_chain_stream_ref
    mega = []
    real = sched.fused_chain_eval

    def rec(values, sops, ch, pad_uid, **kw):
        if not mega:
            mega.append((values.clone(), sops, ch, pad_uid, kw))
        out = real(values, sops, ch, pad_uid, **kw)
        if len(mega) == 1:
            mega.append(tuple(out[:2]))
        return out
    sched.fused_chain_eval = sharded.fused_chain_eval = rec
    try:
        calls = recording(run)
    finally:
        sched.fused_chain_eval = sharded.fused_chain_eval = real
    seen, first = set(), []
    for c in calls:
        kernel, args = c[0], c[2]
        key = (kernel, tuple(args[0].shape),
               args[1] if kernel == "radix_partition" else None)
        if args[0].numel() and key not in seen:
            seen.add(key)
            first.append(c)
    hold_radix(label, first)
    shape_times(label, first, card)
    if not mega:
        return
    (values, sops, ch, pad_uid, kw), (res1, v1) = mega
    res0, v0, _ = fused_chain_stream_ref(values.clone(), sops, ch, pad_uid,
                                         a_lut=kw["a_lut"], b_lut=kw["b_lut"])
    assert_equal(v1, v0, f"megakernel[{label}] values vs stream twin")
    for k in res0:
        assert_equal(res1[k], res0[k], f"megakernel[{label}] {k}")
    scratch = values.clone()
    ms, _ = cuda_ms(lambda: real(scratch, sops, ch, pad_uid, **kw), 20)
    n_luts = kw["a_lut"].numel()
    bnd = bound(*mega_cost(values, sops, ch, pad_uid, n_luts))
    print(f"shape megakernel[{label}] intervals x rows = "
          f"{list(sops.uid.shape)} W={values.shape[-1]} slots="
          f"{values.shape[-2]}" + (f" per shard x {values.shape[0]}"
                                   if values.dim() == 3 else "")
          + f": bitwise with the stream twin; ms={ms} "
          f"bound_ms={bnd[0]} ({bnd[1]}) share_of_bound={bnd[0] / ms} "
          f"| {card}")


def service_profile(label, eng, source, cfg) -> None:
    """Service runs under their own ``ChunkProfiler`` (a torch.profiler
    window on the executor thread, a ``service_chunk`` range per chunk):
    the device's busy share of the second run's wall time, from the
    kernel, copy and memset events of the trace it writes."""
    import tempfile
    from repro_torch.runtime.service import StreamService
    from repro_torch.runtime.telemetry import TelemetryConfig
    with tempfile.TemporaryDirectory() as d:
        # a first profiled run starts the profiler's own machinery, which
        # takes seconds once per process: the second one is read
        for run in range(2):
            out = os.path.join(d, str(run))
            svc = StreamService(eng, cfg(telemetry=TelemetryConfig(
                profile_dir=out)))
            t0 = time.perf_counter()
            rec = svc.run(source())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        paths = [os.path.join(out, f) for f in os.listdir(out)]
        events = []
        for path in paths:
            with open(path) as f:
                events += json.load(f)["traceEvents"]
    dev_us = sum(e.get("dur", 0) for e in events if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset"))
    chunks = sum(1 for e in events if e.get("name") == "service_chunk")
    n = len(rec.outputs)
    if dev_us <= 0:
        print(f"profile {label} (first {n} intervals): wall_s={wall} "
              f"service_chunk ranges={chunks}; device time not measured "
              "(the trace holds no kernel events)")
        return
    print(f"profile {label} (first {n} intervals): wall_s={wall} "
          f"device_busy_s={dev_us / 1e6} busy_share={dev_us / 1e6 / wall} "
          f"service_chunk ranges={chunks} ({len(paths)} trace file)")


def service_phase(stream, lock, single, card, cuda, launches) -> None:
    """The streaming service on the card, one app per path: against
    ``run_stream`` on the card, and a crash -> resume -> replay run."""
    import tempfile
    from repro_torch import LAUNCHES, reset_launches
    from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
    from repro_torch.runtime.service import ServiceConfig, StreamService
    t0 = time.perf_counter()
    n = N_INTERVALS * INTERVAL
    n_chunks = N_INTERVALS // SERVICE_CHUNK
    snap_every = 5 * SERVICE_CHUNK
    crash_after = 3 * snap_every + SERVICE_CHUNK + 2
    sl_values, sl_outs, _ = lock["single"]["sl"]
    runs = (("gs", "megakernel", stream["gs"], single["gs", "megakernel"],
             dict(megakernel=3, radix_partition=1)),
            ("tp", "partition", stream["tp"], single["tp", "partition"],
             dict(radix_partition=1, segscan_affine=1, segscan_max=1)),
            ("sl", "partition", lock["data"]["sl"], (sl_outs, sl_values),
             dict(radix_partition=1)))
    for app_name, method, st, (ref_outs, ref_values), per_chunk in runs:
        label = f"service {app_name} rung={method}"
        eng = engine(app_name, method, cuda)
        source = lambda: ReplaySource(lambda rng, _n: st, n, seed=7,
                                      arrival_batch=INTERVAL,
                                      jitter=SERVICE_JITTER)
        cfg = lambda **kw: ServiceConfig(
            punct_interval=INTERVAL, chunk_intervals=SERVICE_CHUNK,
            watermark=WatermarkPolicy(allowed_lateness=SERVICE_JITTER), **kw)
        service_shapes(label, lambda: StreamService(eng, cfg()).run(source()),
                       card)                             # warm-up
        reset_launches()
        rec = StreamService(eng, cfg()).run(source())
        got = dict(LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        want = {k: per_chunk.get(k, 0) * n_chunks for k in got}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        if rec.stats["processed"] != n or len(rec.outputs) != N_INTERVALS:
            raise AssertionError(f"{label}: processed "
                                 f"{rec.stats['processed']} of {n} events")
        drops = rec.stats["drops"]
        if any(drops.values()):
            raise AssertionError(f"{label}: drops {drops}")
        values = torch.from_numpy(rec.final_values)
        if app_name == "tp":
            assert_close(values, ref_values, f"{label}: state vs run_stream")
            check_outputs(rec.outputs, ref_outs, label, N_INTERVALS)
        else:
            assert_equal(values, ref_values, f"{label}: state vs run_stream")
            check_outputs(rec.outputs, ref_outs, label, N_INTERVALS,
                          bitwise=True)
        pct = rec.latency_percentiles((50, 99))
        print(f"e2e {label} chunk={SERVICE_CHUNK} intervals={N_INTERVALS}x"
              f"{INTERVAL} jitter={SERVICE_JITTER}: sustained_events_per_s="
              f"{rec.sustained_events_per_s()} latency_p50_s={pct['p50']} "
              f"latency_p99_s={pct['p99']} chunks={len(rec.chunk_records)}"
              f" launches={got} launches_per_chunk="
              f"{ {k: v / n_chunks for k, v in got.items() if v} } "
              f"state max abs err vs run_stream "
              f"{max_err(values, ref_values)} card={card}")
        # crash -> resume -> replay, snapshots every 5 chunks
        with tempfile.TemporaryDirectory() as d:
            scfg = cfg(snapshot_every=snap_every, ckpt_dir=d)
            try:
                StreamService(eng, scfg).run(
                    source(), crash_after_interval=crash_after)
                raise AssertionError(f"{label}: the injected crash did not "
                                     "fire")
            except RuntimeError as e:
                if "injected failure" not in str(e):
                    raise
            res = StreamService(eng, scfg).resume(source())
        snap = res.stats["replayed"] // INTERVAL
        if snap != 3 * snap_every:
            raise AssertionError(f"{label}: resumed at {snap}, expected "
                                 f"{3 * snap_every}")
        assert_equal(torch.from_numpy(res.final_values), values,
                     f"{label}: resumed state vs the clean run")
        check_outputs(res.outputs, rec.outputs[snap:], label + " resumed",
                      N_INTERVALS - snap, bitwise=True)
        print(f"e2e {label}: crash after interval {crash_after} -> resume "
              f"from the snapshot at {snap} -> replay: bitwise with the "
              "clean run")
        n_head = SERVICE_PROFILE_INTERVALS * INTERVAL
        head = {k: np.asarray(v)[:n_head] for k, v in st.items()}
        service_profile(label, eng, lambda: ReplaySource(
            lambda rng, _n: head, n_head, seed=7, arrival_batch=INTERVAL,
            jitter=SERVICE_JITTER), cfg)
    print(f"service phase: {time.perf_counter() - t0:.1f} s")


# The elastic sharded service (ROADMAP A9.2): a storm of 500-event intervals,
# calm, hot (Zipf theta 2.5 with every hot key on one residue of the shard
# count, so one shard's owner bucket takes the hot phase) and calm, replayed
# in arrival batches of 500 with jitter 50, on 4 x shared_nothing under a
# reshard-only controller (the reference's tests/reshard_worker.py
# controller).  A slack of the shard count sizes each bucket for all of a
# shard's ops, so the hot phase cannot drop one.  GS runs 40, 80 and 40
# intervals; SL 16, 32 and 16, since its hot phase chains most transfers on
# a few accounts and the lockstep walk runs at a few thousand events/s there
# (on one device too); its migration still lands in the hot phase.
HOT = dict(theta=2.5, align_mod=N_SHARDS)
STORMS = {"gs": ((40, {}), (80, HOT), (40, {})),
          "sl": ((16, {}), (32, HOT), (16, {}))}
STORM_SLACK = float(N_SHARDS)


def storm_controller():
    from repro_torch.runtime.controller import ControllerConfig
    return ControllerConfig(window=4, sustain=2, cooldown=4,
                            slack_widen=False, reshard_imbalance=3.0,
                            reshard_max_moves=24)


def sharded_service_phase(card, cuda, launches, seed) -> None:
    """The service on a 4-shard shared_nothing engine on the card: GS on
    the megakernel rung, SL on the lockstep path (forced "partition").  Each
    run migrates live at least once with no op dropped, its state and
    outputs bitwise with the single-device card ``run_stream`` of the
    in-order events; for GS a crash at ``reshard.apply``, resume and replay
    are bitwise with the uninterrupted elastic run, on its plan."""
    import tempfile
    from repro_torch import LAUNCHES, reset_launches
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.intervals import PhasedReplaySource, WatermarkPolicy
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.runtime.faults import (RESHARD_APPLY, Fault, FaultPlane,
                                            InjectedCrashError)
    from repro_torch.runtime.service import ServiceConfig, StreamService
    t0 = time.perf_counter()
    cfg = lambda **kw: ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=SERVICE_CHUNK,
        watermark=WatermarkPolicy(allowed_lateness=SERVICE_JITTER),
        controller=storm_controller(), **kw)
    for app_name, method, per_chunk in (
            ("gs", "megakernel", dict(radix_partition=2, megakernel=3)),
            ("sl", "partition", dict(radix_partition=2))):
        label = f"sharded service {app_name} rung={method}"
        storm = STORMS[app_name]
        n_i = sum(k for k, _ in storm)
        n_chunks = n_i // SERVICE_CHUNK
        src = PhasedReplaySource(
            ALL_APPS[app_name].gen_events,
            [(k * INTERVAL, kw) for k, kw in storm], seed=seed + 21,
            arrival_batch=INTERVAL, jitter=SERVICE_JITTER)
        ref_outs, ref_values, ref_wall = timed(engine(app_name, method, cuda),
                                               src.in_order_events)
        fresh = lambda: engine(
            app_name, method, cuda, slack=STORM_SLACK,
            mesh=ShardMesh((N_SHARDS,), ("dev",), device=cuda))
        service_shapes(label, lambda: StreamService(fresh(), cfg()).run(src),
                       card)                             # warm-up
        eng = fresh()
        reset_launches()
        rec = StreamService(eng, cfg()).run(src)
        got = dict(LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        check_rung(eng, method, label)
        place = rec.stats["placement"]
        migs = place["migrations"]
        if not migs or place["moved_rows"] <= 0:
            raise AssertionError(f"{label}: no live migration ({place})")
        want = {k: per_chunk.get(k, 0) * n_chunks for k in got}
        want["radix_partition"] += len(migs)   # one for each migration
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")
        drops = rec.stats["drops"]
        if any(drops.values()) or rec.stats["processed"] != n_i * INTERVAL:
            raise AssertionError(f"{label}: drops {drops}, processed "
                                 f"{rec.stats['processed']}")
        values = torch.from_numpy(rec.final_values)
        assert_equal(values, ref_values, f"{label}: state vs single device")
        check_outputs(rec.outputs, ref_outs, label, n_i, bitwise=True)
        pct = rec.latency_percentiles((50, 99))
        print(f"e2e {label} mesh=({N_SHARDS},) chunk={SERVICE_CHUNK} "
              f"intervals={n_i}x{INTERVAL} storm={[k for k, _ in storm]} "
              f"jitter={SERVICE_JITTER}: sustained_events_per_s="
              f"{rec.sustained_events_per_s()} latency_p50_s={pct['p50']} "
              f"latency_p99_s={pct['p99']} migrations={len(migs)} "
              f"moved_rows={place['moved_rows']} migration_boundaries="
              f"{[m['g'] for m in migs]} moved={[m['moved'] for m in migs]} "
              f"apply_s={[m['apply_s'] for m in migs]} imbalance="
              f"{place['imbalance']} shard_events={place['shard_events']} "
              f"capacity={rec.stats['exchange']['capacity']} launches={got} "
              f"launches_per_chunk="
              f"{ {k: v / n_chunks for k, v in got.items() if v} } "
              f"single_device_run_stream_events_per_s="
              f"{n_i * INTERVAL / ref_wall} card={card}")
        print(f"e2e {label}: state and outputs bitwise with the "
              "single-device card run_stream, no op dropped")
        if app_name != "gs":
            continue
        service_profile(label, fresh(), lambda: src, cfg)
        # crash at reshard.apply -> resume -> replay, snapshots every 5 chunks
        with tempfile.TemporaryDirectory() as d:
            snap_every = 5 * SERVICE_CHUNK
            ref = StreamService(fresh(), cfg(
                snapshot_every=snap_every,
                ckpt_dir=os.path.join(d, "ref"))).run(src)
            scfg = cfg(snapshot_every=snap_every,
                       ckpt_dir=os.path.join(d, "go"))
            svc = StreamService(fresh(), scfg)
            try:
                svc.run(src, faults=FaultPlane([Fault(
                    site=RESHARD_APPLY, at=0, kind="crash")]))
                raise AssertionError(f"{label}: the injected crash at "
                                     "reshard.apply did not fire")
            except InjectedCrashError:
                pass
            crashed = svc.last_run
            res = StreamService(fresh(), scfg).resume(src)
        snap = res.stats["replayed"] // INTERVAL
        if not crashed.migrations or snap != crashed.snapshots[-1]:
            raise AssertionError(f"{label}: crashed after "
                                 f"{crashed.migrations}, resumed at {snap}")
        if res.stats["controller"]["plan"] != ref.stats["controller"]["plan"]:
            raise AssertionError(f"{label}: the resumed plan differs")
        assert_equal(torch.from_numpy(ref.final_values), values,
                     f"{label}: snapshotting run vs the clean run")
        assert_equal(torch.from_numpy(res.final_values), values,
                     f"{label}: resumed state vs the uninterrupted run")
        check_outputs(res.outputs, ref.outputs[snap:], label + " resumed",
                      n_i - snap, bitwise=True)
        check_outputs(crashed.outputs, ref.outputs[:len(crashed.outputs)],
                      label + " before the crash", len(crashed.outputs),
                      bitwise=True)
        print(f"e2e {label}: crash at reshard.apply (boundary "
              f"{crashed.migrations[0]['g']}) -> resume from the snapshot at "
              f"{snap} -> replay: bitwise with the uninterrupted elastic "
              "run, on its plan")
    print(f"sharded service phase: {time.perf_counter() - t0:.1f} s")


BASELINE_LAYOUTS = (("shared_nothing", (N_SHARDS,), ("dev",)),
                    ("shared_per_socket", (2, N_SHARDS // 2),
                     ("socket", "core")),
                    ("shared_everything", (N_SHARDS,), ("dev",)))


def host_s(fn, reps: int = 5) -> float:
    """Median host-clock seconds of ``fn()`` waited for on the card."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return float(np.median(out))


def baseline_phase(stream, card, cuda, launches) -> None:
    """The replicate-everything baseline (``core/sharded.evaluate_sharded``)
    on one GS interval under each layout on 4 shards, forced "partition":
    bitwise with the single-device staged evaluation on the card, beside the
    fused sharded driver's chunk time (``run_stream_chunk``, no output
    copy) for the same interval and layout."""
    from repro_torch import LAUNCHES, reset_launches
    from repro_torch.apps import ALL_APPS
    from repro_torch.convert import events_to_torch
    from repro_torch.core.blotter import build_opbatch
    from repro_torch.core.engines import eval_tstream_scan
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.core.sharded import evaluate_sharded
    t0 = time.perf_counter()
    app = ALL_APPS["gs"]
    store = app.make_store(device=cuda)
    ev = {k: np.asarray(v)[:INTERVAL] for k, v in stream["gs"].items()}
    ev_t = events_to_torch(ev, cuda)
    ops, _ = build_opbatch(app, store, ev_t, 0)
    _, want, _ = eval_tstream_scan(store, ops, app.funs, rowmajor_ts=True,
                                   restructure_method="partition")
    for layout, shape, names in BASELINE_LAYOUTS:
        label = f"baseline gs {layout}"
        mesh = ShardMesh(shape, names, device=cuda)
        fn = lambda: evaluate_sharded(store, ops, app.funs, mesh, layout,
                                      restructure_method="partition")
        calls = recording(fn)                            # warm-up
        hold_radix(label, calls)
        shape_times(label, calls, card)
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = dict(LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        expect = {k: 0 for k in counts}
        expect.update(radix_partition=1, segscan_affine=1)
        if counts != expect:
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{expect}")
        assert_equal(got, want[:-1], f"{label}: state vs single device")
        # the fused driver's side: one chunk of the same interval on the
        # device, state only (no output copy to the host)
        eng = engine("gs", "partition", cuda, mesh=mesh, layout=layout)
        carry = eng.carry_in(eng.init_store.values)
        batched = events_to_torch({k: v[None] for k, v in ev.items()}, cuda)
        chunk = lambda: eng.run_stream_chunk(carry, batched, 0)
        if int(chunk()[3]["exchange"]["dropped"].sum()):
            raise AssertionError(f"{label}: the fused chunk dropped ops")
        fused = host_s(chunk)
        base = host_s(fn)
        # the baseline from the same device-resident events
        from_events = host_s(lambda: evaluate_sharded(
            store, build_opbatch(app, store, ev_t, 0)[0], app.funs, mesh,
            layout, restructure_method="partition"))
        print(f"e2e {label} mesh={shape} ops={ops.uid.shape[-1]} "
              f"records={store.n_slots}: wall_s={wall} median_wall_s={base} "
              f"(ops built, state out) median_from_events_s={from_events} "
              f"(events in, ops built, state out) fused_chunk_s={fused} "
              f"(events in, routed, state and per-op results out) "
              f"baseline_over_fused={from_events / fused} (from events) "
              f"launches={counts} bitwise with the single-device staged "
              f"evaluation card={card}")
    print(f"baseline phase: {time.perf_counter() - t0:.1f} s")


# -- the training and serving substrate (ROADMAP A10.1, A10.2) ---------------
# Dense bf16 peak of one H100 SXM, tensor cores, no sparsity (NVIDIA data
# sheet, at the 700 W limit): the denominator of the model FLOP share.
BF16_PEAK_FLOPS = 989e12
PIPE_INTERVALS = 200
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 20, 10, 15
# the port's CPU loss against the card's for the same bf16 params and
# batch: the reference's bf16 bar
LOSS_BF16_TOL = 2e-2


def cut(name: str, n_layers: int):
    """A published configuration at its widths with ``n_layers`` layers (the
    depth is the one cut: it is listed as reduced)."""
    import dataclasses
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(name), n_layers=n_layers)


def depth(cfg) -> str:
    from repro_torch.configs import ARCHS
    return (f"n_layers {cfg.n_layers} (reduced from "
            f"{ARCHS[cfg.name].n_layers})")


def counts_since(launches) -> dict:
    from repro_torch import LAUNCHES
    got = dict(LAUNCHES)
    for k, v in got.items():
        launches[k] += v
    return {k: v for k, v in got.items() if v}


def pipeline_phase(card, cuda, launches, seed) -> None:
    """``StreamingPipeline(PipelineConfig())`` ingests 200 intervals of 64
    documents on the card: its stats state bitwise with the port's CPU run
    of the same seed, the doc-count lane summing to 12,800, one
    segscan_affine launch an interval."""
    from repro_torch import reset_launches
    from repro_torch.data import (STATS_APP, PipelineConfig,
                                  StreamingPipeline)
    cfg = PipelineConfig()

    def ingest(dev):
        pipe = StreamingPipeline(cfg, device=dev)
        rng = np.random.default_rng(seed)
        outs = [pipe.ingest(rng, cfg.punct_interval)
                for _ in range(PIPE_INTERVALS)]
        return pipe, outs

    t0 = time.perf_counter()
    cpu_pipe, cpu_outs = ingest("cpu")
    calls = recording(lambda: ingest(cuda))          # warm-up, uncounted
    shapes = {tuple(args[0].shape) for _, _, args, _, _ in calls}
    if len(shapes) != 1:
        raise AssertionError(f"pipeline: segscan shapes {shapes}")
    shape_times("pipeline", calls[:1], card)         # every interval's shape
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pipe, outs = ingest(cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    got = counts_since(launches)
    assert_equal(pipe.stats_values, cpu_pipe.stats_values,
                 "pipeline stats_values vs the CPU run")
    for i, (o, oc) in enumerate(zip(outs, cpu_outs)):
        for k in oc:
            if not np.array_equal(o[k], oc[k]):
                raise AssertionError(f"pipeline interval {i} {k}: not "
                                     "bitwise equal to the CPU run")
    n_docs = PIPE_INTERVALS * cfg.punct_interval
    docs = float(pipe.stats_values[:16, 1].sum())
    if docs != n_docs:
        raise AssertionError(f"pipeline doc-count lane sums to {docs}, "
                             f"expected {n_docs}")
    if got.get("segscan_affine") != PIPE_INTERVALS:
        raise AssertionError(f"pipeline launches {got}: expected one "
                             "segscan_affine an interval")
    print(f"e2e pipeline: {PIPE_INTERVALS} x {cfg.punct_interval} docs "
          f"({n_docs * STATS_APP.max_ops} ops) wall_s={wall} docs_per_s="
          f"{n_docs / wall} rung={pipe.engine.last_rung} launches={got} "
          f"stats_values bitwise with the CPU run, doc lane {docs:.0f}, "
          f"mixture {np.round(pipe.mixture_weights(), 4).tolist()} "
          f"card={card}")
    print(f"pipeline phase: {time.perf_counter() - t0:.1f} s")



def train_phase(card, cuda, launches, seed) -> None:
    """minicpm-2b at its published widths, 2 layers: ``TrainLoop`` over 20
    steps of the launcher's step (batches from ``batch_for_step``, AdamW,
    WSD, remat "dots"), checkpoints every 10 steps; a crash at 15 resumed
    from 10 ends bitwise equal to the uninterrupted run; step 0's loss
    within the bf16 bar of the port's CPU loss on the same params."""
    import shutil
    import tempfile
    from repro_torch import reset_launches
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten
    from repro_torch.data import PipelineConfig, StreamingPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import TrainLoop, TrainLoopConfig
    t0 = time.perf_counter()
    cfg = cut("minicpm-2b", 2)
    batch, seq = 8, 128
    pipe = StreamingPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                            batch=batch), device=cuda)
    opt = AdamWConfig(lr=3e-3, state_dtype=torch.float32)
    step = make_train_step(cfg, opt, TRAIN_STEPS)
    step_s = []

    def timed_step(params, state, b):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(params, state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    params0 = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                          device=cuda)
    opt0 = adamw_init(params0, opt)
    # every leaf (param_count() leaves out the norms' weights)
    n_params = sum(p.numel() for _, p in _flatten(params0))

    def loop(ckpt_dir):
        return TrainLoop(TrainLoopConfig(
            ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
            max_steps=TRAIN_STEPS, data_seed=seed, keep_last=1),
            timed_step, lambda i, rng: pipe.batch_for_step(i), params0, opt0)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reset_launches()
        a = loop(os.path.join(tmp, "a"))
        t1 = time.perf_counter()
        a.run()
        wall_a = time.perf_counter() - t1
        got = counts_since(launches)
        steps_a = list(step_s)
        shutil.rmtree(os.path.join(tmp, "a"))
        b = loop(os.path.join(tmp, "b"))
        try:
            b.run(crash_at=TRAIN_CRASH_AT)
            raise AssertionError("the injected crash did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        del b
        c = loop(os.path.join(tmp, "b"))
        t1 = time.perf_counter()
        if not c.try_resume() or c.start_step != TRAIN_CKPT_EVERY:
            raise AssertionError(f"resumed at {c.start_step}, expected "
                                 f"{TRAIN_CKPT_EVERY}")
        load_s = time.perf_counter() - t1
        c.run()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for (path, x), (_, y) in zip(_flatten(dict(p=a.params, o=a.opt_state)),
                                 _flatten(dict(p=c.params, o=c.opt_state))):
        assert_equal(x, y, f"train resume {'/'.join(path)}")
    if c.losses != a.losses[TRAIN_CKPT_EVERY:]:
        raise AssertionError("train resume: losses differ after the resume")
    if not all(np.isfinite(a.losses)):
        raise AssertionError(f"non-finite losses {a.losses}")

    # step 0's loss on the CPU, same bf16 params and batch
    t1 = time.perf_counter()
    b0 = pipe.batch_for_step(0)
    with torch.no_grad():
        cpu_params = _unflatten(params0, iter(
            x.cpu() for _, x in _flatten(params0)))
        cpu_loss = float(loss_fn(cfg, cpu_params,
                                 {k: v.cpu() for k, v in b0.items()},
                                 remat="none"))
    cpu_s = time.perf_counter() - t1
    if abs(a.losses[0] - cpu_loss) > LOSS_BF16_TOL * abs(cpu_loss):
        raise AssertionError(f"step 0 loss {a.losses[0]} on the card, "
                             f"{cpu_loss} on the CPU")
    profile_call("train minicpm-2b step", lambda: step(
        params0, opt0, pipe.batch_for_step(0)))
    steady = steps_a[1:]
    sps = len(steady) / sum(steady)
    tokens = batch * seq
    flop_share = 6.0 * n_params * tokens * sps / BF16_PEAK_FLOPS
    ckpt_bytes = sum(x.numel() * x.element_size() for _, x in _flatten(
        dict(p=a.params, o=a.opt_state)))
    print(f"e2e train minicpm-2b (d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {depth(cfg)}, "
          f"{n_params} params bf16, AdamW f32, batch "
          f"{batch} x seq {seq}, remat dots): {TRAIN_STEPS} steps "
          f"loop_wall_s={wall_a} (2 checkpoints of {ckpt_bytes} B) "
          f"step0_s={steps_a[0]} steps_per_s={sps} (steps 1-19) "
          f"tokens_per_s={sps * tokens} model_flop_share={flop_share} "
          f"(6*N*tokens/s over {BF16_PEAK_FLOPS:.3g} FLOP/s dense bf16, "
          f"NVIDIA data sheet) loss {a.losses[0]:.4f} -> {a.losses[-1]:.4f} "
          f"step0 loss card {a.losses[0]} cpu {cpu_loss} (cpu {cpu_s:.1f} s)"
          f" crash@{TRAIN_CRASH_AT} resume@{TRAIN_CKPT_EVERY} "
          f"(load {load_s:.1f} s) bitwise with the uninterrupted run "
          f"launches={got} card={card}")
    print(f"train phase: {time.perf_counter() - t0:.1f} s")


def serve_phase(card, cuda, launches, seed) -> None:
    """granite-34b at its published widths, 2 layers: the serve launcher's
    quota transactions on the engine, then batch 4, prompt 16, gen 16
    through ``decode_step``; in float32 params every step's logits against
    ``forward`` over the same tokens to 2e-2; tokens/s in float32 and in
    the launcher's bf16."""
    from repro_torch import reset_launches
    from repro_torch.launch.serve import admit, generate
    from repro_torch.models import forward, init_params
    t0 = time.perf_counter()
    cfg = cut("granite-34b", 2)
    batch, plen, glen = 4, 16, 16
    rng = np.random.default_rng(seed)
    admit(batch, plen + glen, np.random.default_rng(seed), cuda)  # warm-up
    reset_launches()
    t1 = time.perf_counter()
    admitted = admit(batch, plen + glen, rng, cuda)
    quota_s = time.perf_counter() - t1
    got = counts_since(launches)
    if not admitted.all():
        raise AssertionError(f"quota: admitted {admitted}")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (batch, plen))
                              .astype(np.int32)).to(cuda)
    rates = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(
            seed), dtype=dtype, device=cuda)
        generate(cfg, params, prompt[:, :2], 1)                  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gen, steps = generate(cfg, params, prompt, glen)
        torch.cuda.synchronize()
        rates[str(dtype).split(".")[-1]] = batch * (plen + glen) / (
            time.perf_counter() - t1)
        if dtype == torch.bfloat16:
            profile_call("serve granite-34b bf16 decode", lambda: generate(
                cfg, params, prompt, glen))
        if dtype == torch.float32:
            with torch.no_grad():
                full = forward(cfg, params, dict(
                    tokens=torch.cat([prompt, gen], 1)), remat="none")
            err = max_err(steps, full)
            assert_close(steps.cpu().numpy(), full.cpu().numpy(),
                         "serve granite-34b decode vs forward", tol=2e-2)
        del params
    print(f"e2e serve granite-34b (d_model {cfg.d_model}, {cfg.n_heads} heads,"
          f" MQA kv {cfg.n_kv_heads}, gelu d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {depth(cfg)}): quota "
          f"{int(admitted.sum())}/{batch} admitted in {quota_s:.4f} s "
          f"launches={got}; batch {batch} prompt {plen} gen {glen}: "
          f"tokens_per_s f32={rates['float32']} bf16={rates['bfloat16']}; "
          f"f32 decode vs forward max_abs_err={err} (bar 2e-2) card={card}")
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")


def mamba_phase(card, cuda, seed) -> None:
    """mamba2-2.7b at its published widths, 2 layers, float32 params:
    prefill of one 256-token chunk through ``ssd_chunked`` against 256
    decode steps of the recurrence, to 5e-2."""
    from repro_torch.models import decode_step, forward, init_cache, init_params
    t0 = time.perf_counter()
    cfg = cut("mamba2-2.7b", 2)
    batch, seq = 2, cfg.ssm_chunk
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         dtype=torch.float32, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        forward(cfg, params, dict(tokens=toks), remat="none")   # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        full = forward(cfg, params, dict(tokens=toks), remat="none")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1
        caches = init_cache(cfg, batch, seq, dtype=torch.float32, device=cuda)
        outs = []
        t1 = time.perf_counter()
        for i in range(seq):
            lg, caches = decode_step(cfg, params, caches, toks[:, i:i + 1], i)
            outs.append(lg)
        dec = torch.cat(outs, 1)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t1
    err = max_err(dec, full)
    assert_close(dec.cpu().numpy(), full.cpu().numpy(),
                 "serve mamba2-2.7b decode vs prefill", tol=5e-2)

    n_prof = min(32, seq)

    def decode_some():
        c = init_cache(cfg, batch, seq, dtype=torch.float32, device=cuda)
        with torch.no_grad():
            for i in range(n_prof):
                _, c = decode_step(cfg, params, c, toks[:, i:i + 1], i)
    profile_call(f"serve mamba2-2.7b {n_prof} decode steps", decode_some)
    print(f"e2e serve mamba2-2.7b (d_model {cfg.d_model}, ssm_state "
          f"{cfg.ssm_state}, head_dim {cfg.ssm_head_dim}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab}, {depth(cfg)}, f32): prefill {batch} x {seq} in {prefill_s} s "
          f"({batch * seq / prefill_s} tokens/s); {seq} decode steps in "
          f"{decode_s} s ({batch * seq / decode_s} tokens/s); decode vs "
          f"prefill max_abs_err={err} (bar 5e-2) card={card}")
    print(f"mamba phase: {time.perf_counter() - t0:.1f} s")


# -- the launch layer (ROADMAP A10.3, A10.4, A8.2) -------------------------
EP_BATCH, EP_SEQ, EP_STEPS = 8, 512, 20
EP_CHECK_BATCH, EP_CHECK_SEQ = 8, 128
SERVE_BATCH, SERVE_CACHE, SERVE_GEN = 4, 64, 16
ATTR_INTERVALS = 40


def ep_phase(card, cuda, seed) -> None:
    """moonshot-v1-16b-a3b at its published widths, 2 layers (one dense,
    one MoE), on a (2, 4) ``make_host_mesh`` on the card: 8 EP shards of 8
    experts.  ``moe_forward_ep`` against ``moe_forward`` at capacity factor
    16 (5e-4); at the default 1.25, on a skewed batch, the card's kept mask
    and dropped-choice count against the CPU's (bitwise) and its output
    within 1e-4 of the largest magnitude; then 20 steps of ``build_train_step`` (batch 8 x
    512, bf16 params, bf16 AdamW state) and the busy share of one profiled
    step."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, init_params, layers, moe_ep
    t0 = time.perf_counter()
    cfg = cut("moonshot-v1-16b-a3b", 2)
    mesh = make_host_mesh(model=4, data=2, device=cuda)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)
    n_params = sum(p.numel() for _, p in _flatten(params))
    moe = {k: v[0].float() for k, v in params["stacks"]["moe"]["ffn"].items()}
    rng = np.random.default_rng(seed)
    # tokens that share an offset (a skewed batch): the router then favours
    # some experts for every token, and capacity 1.25 drops choices
    x = torch.from_numpy((rng.normal(size=(EP_CHECK_BATCH, EP_CHECK_SEQ,
                                           cfg.d_model)) + 1.0
                          ).astype(np.float32))
    ep_shards = 8
    try:
        moe_ep.set_ep_mesh(mesh, ("data",))
        saved, moe_ep.CAPACITY_FACTOR = moe_ep.CAPACITY_FACTOR, 16.0
        try:
            with torch.no_grad():
                got = moe_ep.moe_forward_ep(cfg, moe, x.to(cuda))
                want = layers.moe_forward(cfg, moe, x.to(cuda))
        finally:
            moe_ep.CAPACITY_FACTOR = saved
        err16 = max_err(got, want)
        torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)
        kept, outs = [], []                 # the CPU's, then the card's
        for d in ("cpu", cuda):
            m = make_host_mesh(model=4, data=2, device=d)
            moe_ep.set_ep_mesh(m, ("data",))
            pd = {k: v.to(d) for k, v in moe.items()}
            lay = moe_ep.TokenLayout.of(m, EP_CHECK_BATCH, EP_CHECK_SEQ,
                                        ("data",), "model")
            st = lay.split(x.to(d))
            r = moe_ep.route(cfg, st.reshape(st.shape[0], -1, cfg.d_model),
                             pd["router"], ep_shards,
                             cfg.n_experts // ep_shards)
            with torch.no_grad():
                outs.append(moe_ep.moe_forward_ep(cfg, pd, x.to(d)).cpu())
            kept.append(r.keep.cpu())
        assert_equal(kept[1], kept[0], "EP kept mask, card vs CPU")
        dropped = int((~kept[0]).sum())
        if not dropped:
            raise AssertionError("EP at capacity factor 1.25 dropped no "
                                 "choice: the check needs drops")
        err125 = max_err(outs[1], outs[0])
        if err125 > 1e-4 * float(outs[0].abs().max()):
            raise AssertionError(f"EP card vs CPU: max abs err {err125}")
        print(f"e2e ep check moonshot-v1-16b-a3b MoE layer (64 experts, "
              f"top-6, 2 shared, moe_d_ff {cfg.moe_d_ff}, f32) x "
              f"[{EP_CHECK_BATCH}, {EP_CHECK_SEQ}, {cfg.d_model}] on a (2, 4) "
              f"mesh, {ep_shards} EP shards: CF 16 vs moe_forward max abs err "
              f"{err16}; CF 1.25 kept mask bitwise card vs CPU, dropped "
              f"{dropped} of {kept[0].numel()} choices on both, output "
              f"max abs err {err125}")

        fn, _ = build_train_step(cfg, ShapeCfg("ep", EP_SEQ, EP_BATCH,
                                               "train"), mesh, StepConfig())
        if moe_ep.get_ep_mesh() is not mesh:
            raise AssertionError("build_train_step did not engage EP")
        from repro_torch.optim import adamw_init
        state = adamw_init(params, StepConfig().optimizer)
        tokens = torch.from_numpy(rng.integers(
            0, cfg.vocab, (EP_BATCH, EP_SEQ + 1)).astype(np.int32)).to(cuda)
        batch = dict(tokens=tokens[:, :-1].contiguous(),
                     labels=tokens[:, 1:].contiguous())
        losses, step_s = [], []
        p, st_ = params, state
        for _ in range(EP_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p, st_, loss = fn(p, st_, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            losses.append(float(loss))
        if not all(np.isfinite(losses)) or int(st_["step"]) != EP_STEPS:
            raise AssertionError(f"EP train: losses {losses}, step "
                                 f"{int(st_['step'])}")
        profile_call("ep train moonshot step", lambda: fn(p, st_, batch))
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    sps = (EP_STEPS - 1) / sum(step_s[1:])
    tok = EP_BATCH * EP_SEQ
    active = cfg.active_param_count()
    share = 6.0 * active * tok * sps / BF16_PEAK_FLOPS
    print(f"e2e ep train moonshot-v1-16b-a3b (d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.experts_per_token}, "
          f"{cfg.n_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}, vocab "
          f"{cfg.vocab}, {depth(cfg)}, {n_params} params bf16, {active} "
          f"active, AdamW bf16 state, batch {EP_BATCH} x seq {EP_SEQ}, remat "
          f"full, (2, 4) mesh, {ep_shards} EP shards): step0_s={step_s[0]} "
          f"steps_per_s={sps} (steps 1-{EP_STEPS - 1}) tokens_per_s="
          f"{sps * tok} model_flop_share={share} (6*active*tokens/s over "
          f"{BF16_PEAK_FLOPS:.3g}) loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"card={card}")
    print(f"ep phase: {time.perf_counter() - t0:.1f} s")


def serve_padded_phase(card, cuda, seed) -> None:
    """minicpm-2b at its published widths, 2 layers, float32:
    ``build_decode_step`` on ``MeshSpec({"data": 1, "model": 16})`` pads
    its 36 MHA heads to 48; every step's logits against the unpadded
    ``decode_step`` within 2e-4; tokens/s of both; the per-device KV-cache
    bytes of decode_32k (40 layers) from ``cache_specs`` on the (16, 16)
    mesh, unpadded (36 heads replicated) and padded (3 local)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshSpec, make_production_mesh
    from repro_torch.launch.sharding import cache_specs, per_device_bytes
    from repro_torch.launch.steps import (StepConfig, abstract_cache,
                                          build_decode_step)
    from repro_torch.models import (SHAPE_BY_NAME, ShapeCfg, decode_step,
                                    init_cache, init_params)
    from repro_torch.models.serving import (pad_params_for_serving,
                                            serving_padded)
    t0 = time.perf_counter()
    cfg = cut("minicpm-2b", 2)
    padded = serving_padded(cfg, 16)
    if (cfg.n_heads, padded.n_heads) != (36, 48):
        raise AssertionError(f"heads {cfg.n_heads} -> {padded.n_heads}")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         dtype=torch.float32, device=cuda)
    fn, _ = build_decode_step(cfg, ShapeCfg("serve", SERVE_CACHE,
                                            SERVE_BATCH, "decode"),
                              MeshSpec({"data": 1, "model": 16}),
                              StepConfig())
    pp = pad_params_for_serving(cfg, padded, params)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_GEN)).astype(np.int32)).to(cuda)

    def run(step):
        caches = None
        outs, wall = [], []
        for pos in range(SERVE_GEN):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, caches = step(caches, tokens[:, pos:pos + 1], pos)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t1)
            outs.append(logits)
        return outs, SERVE_BATCH * (SERVE_GEN - 1) / sum(wall[1:])

    def plain(caches, tok, pos):
        caches = caches or init_cache(cfg, SERVE_BATCH, SERVE_CACHE,
                                      dtype=torch.float32, device=cuda)
        with torch.no_grad():
            return decode_step(cfg, params, caches, tok, pos)

    def pad(caches, tok, pos):
        caches = caches or init_cache(padded, SERVE_BATCH, SERVE_CACHE,
                                      dtype=torch.float32, device=cuda)
        return fn(pp, caches, tok, pos)

    run(plain)                                          # warm-up
    want, tps0 = run(plain)
    got, tps1 = run(pad)
    err = max(max_err(a, b) for a, b in zip(got, want))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
    mesh = make_production_mesh()
    shape = SHAPE_BY_NAME["decode_32k"]
    full = get_arch("minicpm-2b")
    kv = {}
    for c in (full, serving_padded(full, 16)):
        cache = abstract_cache(c, shape)
        kv[c.n_heads] = per_device_bytes(
            cache, cache_specs(cache, mesh, shape.global_batch), mesh)
    print(f"e2e serve padded minicpm-2b (d_model {cfg.d_model}, {depth(cfg)},"
          f" f32, batch {SERVE_BATCH}, cache {SERVE_CACHE}, {SERVE_GEN} "
          f"steps) on MeshSpec(data 1, model 16): heads 36 -> 48, logits vs "
          f"unpadded max abs err {err} (bar 2e-4); tokens_per_s unpadded "
          f"{tps0} padded {tps1}; decode_32k KV cache per device on (16, 16) "
          f"(40 layers, cache_specs): 36 heads replicated {kv[36]} B, 48 "
          f"heads 3 local {kv[48]} B ({kv[36] / kv[48]:.1f}x) card={card}")
    print(f"serve padded phase: {time.perf_counter() - t0:.1f} s")


def dryrun_phase() -> None:
    """The dry run (host only, meta tensors): minicpm-2b x train_4k on the
    single pod and deepseek-v3-671b x decode_32k on the multi pod."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import moe_ep
    t0 = time.perf_counter()
    try:
        for arch, shape, mp in (("minicpm-2b", "train_4k", False),
                                ("deepseek-v3-671b", "decode_32k", True)):
            r = run_cell(arch, shape, mp, verbose=False)
            if r["skipped"] or not r["hlo_flops"] > 0:
                raise AssertionError(f"dryrun {arch} x {shape}: {r}")
            print(f"dryrun {arch} x {shape} x "
                  f"{'multi-pod' if mp else 'single-pod'} ({r['n_devices']} "
                  f"devices, host only): trace_s={r['trace_s']} hlo_flops="
                  f"{r['hlo_flops']} (global) argument_bytes_per_device="
                  f"{r['mem']['argument_bytes']} output_bytes_per_device="
                  f"{r['mem']['output_bytes']} wire_bytes_per_device="
                  f"{r['wire_bytes_per_device']} model_params="
                  f"{r['model_params']}")
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s")


def service_attribution_phase(stream, card, cuda, launches) -> None:
    """The GS service phase's configuration (K = 8, megakernel) over 40
    intervals with ``TelemetryConfig(trace_path=..., hlo_attribution=
    True)``: its final state and outputs bitwise with the same run without
    attribution; every execute span carries the cost fields, and no
    fraction of the card's peak reads above 1.05."""
    import tempfile
    from repro_torch import LAUNCHES, reset_launches
    from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
    from repro_torch.runtime import telemetry as tt
    from repro_torch.runtime.service import ServiceConfig, StreamService
    t0 = time.perf_counter()
    n = ATTR_INTERVALS * INTERVAL
    head = {k: np.asarray(v)[:n] for k, v in stream["gs"].items()}
    eng = engine("gs", "megakernel", cuda)
    source = lambda: ReplaySource(lambda rng, _n: head, n, seed=7,
                                  arrival_batch=INTERVAL,
                                  jitter=SERVICE_JITTER)
    cfg = lambda tcfg: ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=SERVICE_CHUNK,
        watermark=WatermarkPolicy(allowed_lateness=SERVICE_JITTER),
        telemetry=tcfg)
    ref = StreamService(eng, cfg(None)).run(source())     # also the warm-up
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        reset_launches()
        rec = StreamService(eng, cfg(tt.TelemetryConfig(
            trace_path=path, hlo_attribution=True))).run(source())
        got = dict(LAUNCHES)
        spans = [e for e in tt._parse_trace(path)
                 if e.get("ph") == "X" and e["name"] == "chunk.execute"]
    for k, v in got.items():
        launches[k] += v
    n_chunks = ATTR_INTERVALS // SERVICE_CHUNK
    if got["megakernel"] != 3 * n_chunks or \
            got["radix_partition"] != n_chunks:
        raise AssertionError(f"attributed service launches {got}")
    assert_equal(torch.from_numpy(rec.final_values),
                 torch.from_numpy(ref.final_values),
                 "attributed service state vs the run without")
    check_outputs(rec.outputs, ref.outputs, "attributed service",
                  ATTR_INTERVALS, bitwise=True)
    fields = {"flops", "bytes_written", "wire_bytes_per_device", "gflops_s",
              "gbytes_s", "bound", "frac_compute", "frac_memory", "frac_link"}
    if len(spans) != n_chunks or not all(fields <= set(e["args"])
                                         for e in spans):
        raise AssertionError(f"execute spans without the cost fields: "
                             f"{[e['args'] for e in spans]}")
    fm = [e["args"]["frac_memory"] for e in spans]
    if max(fm) > 1.05 or max(e["args"]["frac_compute"] for e in spans) > 1.05:
        raise AssertionError(f"a fraction of the peak above 1.05: {fm}")
    a = spans[0]["args"]
    print(f"e2e service attribution gs rung=megakernel chunk={SERVICE_CHUNK}"
          f" intervals={ATTR_INTERVALS}x{INTERVAL}: bitwise with the run "
          f"without attribution; bytes_per_chunk={a['bytes_written']} "
          f"flops_per_chunk={a['flops']} gbytes_s="
          f"{[e['args']['gbytes_s'] for e in spans]} frac_memory={fm} "
          f"bound={a['bound']} launches={got} card={card}")
    print(f"service attribution phase: {time.perf_counter() - t0:.1f} s")


class SearchLog:
    """Wraps ``kernels/autotune.block_rows`` (the wrappers' one lookup) for
    the whole script: per decision key, the launch of the call that first
    asked for it, a partial of the wrapper's launch over that call's own
    tensors, so the autotune phase can hold the winner on the inputs that
    chose it.  Records only; the decision is the search's."""

    def __init__(self):
        self.launches = {}

    def install(self) -> None:
        from repro_torch.kernels import autotune
        real = autotune.block_rows

        def block_rows(kernel, n, **kw):
            param = real(kernel, n, **kw)
            key = (kernel, autotune.shape_bucket(n, kw.get("variant", "")),
                   kw.get("dtype", "float32"), autotune.kind_of(
                       kw.get("device")))
            if kw.get("launch") is not None:
                self.launches.setdefault(key, kw["launch"])
            return param
        autotune.block_rows = block_rows


SEARCHED = ("segscan_affine", "segscan_max", "radix_partition", "hash_probe")


def search_call(kernel, launch):
    """(call(threads), twin(), exact) on the recorded call's inputs."""
    from repro_torch.kernels.hash_probe.ops import hash_probe
    from repro_torch.kernels.hash_probe.ref import hash_probe_ref
    from repro_torch.kernels.radix_partition.ops import radix_partition_rank
    from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
    from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max
    from repro_torch.kernels.segscan.ref import (segscan_affine_ref,
                                                 segscan_max_ref)
    args = launch.args
    if kernel == "segscan_affine":
        flags, a, b = args[:3]
        return (lambda t: segscan_affine(a, b, flags, threads=t),
                lambda: segscan_affine_ref(flags, a, b), False)
    if kernel == "segscan_max":
        flags, m = args[:2]
        return (lambda t: (segscan_max(m, flags, threads=t),),
                lambda: (segscan_max_ref(flags, m),), True)
    if kernel == "radix_partition":
        keys, k = args[0], args[3]
        return (lambda t: radix_partition_rank(keys, k, threads=t),
                lambda: radix_partition_rank_ref(keys, k), True)
    keys, table = args[:2]
    return (lambda t: (hash_probe(keys, table, threads=t),),
            lambda: (hash_probe_ref(keys, table),), True)


def autotune_phase(search, card) -> None:
    """Every decision the driven runs made: a microbenchmark on the card for
    each key, one line each (kernel, bucket, candidates, timings_us, winner,
    source); the winner and the default timed alone (CUDA events) on the
    inputs of the call that made the decision, and held bit for bit to each
    other and to the twin (segscan_affine to the twin within 1e-5, its
    standing bar).  Every searched kernel must have a decision."""
    import contextlib
    import io
    import tempfile
    from repro_torch.kernels import autotune
    t0 = time.perf_counter()
    decisions = autotune.decisions_log()
    seen = set()
    for d in decisions:
        key = (d["kernel"], d["shape_bucket"], d["dtype"], d["device_kind"])
        if d["source"] != "microbench":
            raise AssertionError(f"autotune {key}: source {d['source']!r}, "
                                 "expected a microbench on the card")
        if d["param"] not in d["candidates"]:
            raise AssertionError(f"autotune {key}: winner {d['param']} not "
                                 f"among {d['candidates']}")
        launch = search.launches.get(key)
        if launch is None:
            raise AssertionError(f"autotune {key}: no call recorded")
        call, twin, exact = search_call(d["kernel"], launch)
        winner, default = d["param"], d["candidates"][0]
        got, base, ref = call(winner), call(default), twin()
        torch.cuda.synchronize()
        what = f"autotune {d['kernel']}[{d['shape_bucket']}]"
        got, base, ref = (x if isinstance(x, tuple) else (x,)
                          for x in (got, base, ref))
        for i, (x, y, z) in enumerate(zip(got, base, ref)):
            assert_equal(x, y, f"{what} output {i}: winner vs default")
            if exact:
                assert_equal(x, z, f"{what} output {i}: winner vs twin")
            else:
                assert_close(x.cpu().numpy(), z.cpu().numpy(),
                             f"{what} output {i}: winner vs twin")
        ms_w, _ = cuda_ms(lambda: call(winner), 20)
        ms_d, _ = cuda_ms(lambda: call(default), 20)
        shape = [list(t.shape) for t in launch.args
                 if isinstance(t, torch.Tensor)][:2]
        print(f"autotune {d['kernel']} bucket={d['shape_bucket']} "
              f"dtype={d['dtype']} shape={shape} candidates={d['candidates']}"
              f" timings_us={d['timings_us']} winner={winner} default="
              f"{default} source={d['source']} winner_ms={ms_w} default_ms="
              f"{ms_d} bitwise winner=default" + ("=twin" if exact else
                                                  ", twin within 1e-5")
              + f" | {card}")
        seen.add(d["kernel"])
    missing = [k for k in SEARCHED if k not in seen]
    if missing:
        raise AssertionError(f"no search decision for {missing}")
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(io.StringIO()):
        dump = autotune.main(["--dump", os.path.join(tmp, "autotune.json")])
    print(f"autotune dump: profile={json.dumps(dump['profile'])} "
          f"ladder_bounds={dump['ladder_bounds']} mega_bounds="
          f"{dump['mega_bounds']} decisions={len(dump['decisions'])}")
    print(f"autotune: {len(decisions)} decisions, bench_s="
          f"{autotune.bench_seconds()} (inside the runs that first met each "
          f"key); phase {time.perf_counter() - t0:.1f} s")


EXAMPLES = (
    ("quickstart", []),
    ("toll_processing", []),
    ("ledger_serving", []),
    ("streaming_service", []),
    ("streaming_service", ["--inject-restart", "--corrupt-latest"]),
    ("streaming_service", ["--storm", "--inject-restart"]),
    ("streaming_service", ["--storm", "--devices", "4", "--inject-restart"]),
    ("streaming_service", ["--perfetto-out", "{tmp}/trace.json",
                           "--profile-dir", "{tmp}/prof", "--hlo-cost"]),
    ("train_100m", ["--ckpt-dir", "{tmp}/ckpt_100m"]),
)


def examples_phase(card) -> None:
    """The five programs of ``examples/torch`` on the card at their
    reference defaults (train_100m: 300 steps of the 8-layer d = 768 model,
    checkpoints in a temporary directory), the service also under its
    drills: each must print its ✓ line(s); their wall times."""
    import contextlib
    import importlib.util
    import io
    import tempfile
    t0 = time.perf_counter()
    for name, flags in EXAMPLES:
        path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"example_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp:
            argv = [f.format(tmp=tmp) for f in flags]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        out = buf.getvalue()
        ticks = [ln.strip() for ln in out.splitlines() if "✓" in ln]
        if not ticks:
            raise AssertionError(f"example {name} {flags}: no ✓ line:\n{out}")
        tail = [ln.strip() for ln in out.splitlines()
                if ln.startswith(("[100m]", "service:", "  latency",
                                  "[tp]", "[sl]"))]
        print(f"example {name} {' '.join(flags) or '(defaults)'}: "
              f"wall_s={wall} | " + " | ".join(
                  tail + [t for t in ticks if t not in tail]) + f" | {card}")
    print(f"examples phase: {time.perf_counter() - t0:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    cuda = torch.device("cuda", 0)

    search = SearchLog()
    search.install()
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"({_build.build_dir()})")

    t0 = time.perf_counter()
    stream = streams(args.seed)
    print(f"data: seed {args.seed}, {N_INTERVALS * INTERVAL} events per app "
          f"in {time.perf_counter() - t0:.1f} s")

    rows = kernel_phase(plans(stream, cuda))
    oracle_check(cuda)
    from repro_torch import LAUNCHES
    launches = {k: 0 for k in LAUNCHES}
    single = end_to_end(stream, card, cuda, launches)
    sharded_phase(stream, card, cuda, single, launches)
    capacity_phase(stream, card, cuda, launches, args.seed)
    lock = lockstep_phase(card, cuda, launches, args.seed)
    sharded_lockstep_phase(lock, card, cuda, launches)
    service_phase(stream, lock, single, card, cuda, launches)
    sharded_service_phase(card, cuda, launches, args.seed)
    baseline_phase(stream, card, cuda, launches)
    pipeline_phase(card, cuda, launches, args.seed)
    train_phase(card, cuda, launches, args.seed)
    serve_phase(card, cuda, launches, args.seed)
    mamba_phase(card, cuda, args.seed)
    ep_phase(card, cuda, args.seed)
    serve_padded_phase(card, cuda, args.seed)
    dryrun_phase()
    service_attribution_phase(stream, card, cuda, launches)
    examples_phase(card)
    autotune_phase(search, card)
    missing = sorted(k for k in LAUNCHES if launches[k] <= 0)
    if missing:
        raise AssertionError(f"kernels never launched on the driven paths: "
                             f"{missing} ({launches})")

    for label in ("sharded", "interval", "batched"):
        r = rows["megakernel"].pop(label)
        print(f"kernel megakernel[{label}]: ms={r['ms']} plain_ms="
              f"{r['plain_ms']} bound_ms={r['bound'][0]} ({r['bound'][1]})"
              + (f" launches_per_call={r['launches_per_call']}"
                 if "launches_per_call" in r else "") + f" | {card}")
    kernels = []
    for name, r in rows.items():
        bound_ms, bound_by = r["bound"]
        print(f"kernel {name}: launches={launches[name]} max_abs_err="
              f"{r['err']} ms={r['ms']} plain_ms={r['plain_ms']} bound_ms="
              f"{bound_ms} ({bound_by}) library: none | {card}")
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[name],
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
