#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py [--seed N]
(``--phase NAME`` runs one model-layer phase alone: mamba, ep, partitioned,
partitioned_hybrid, sp, decode_donated, serve_padded or dryrun.)

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
11. Cards phase, the sharded driver over device groups
   (``ShardMesh(..., devices=[...])``): on one card, sharded GS (4 x
   ``shared_nothing``, megakernel rung) and SL (lockstep, "partition"),
   200 x 500 events, with two groups on the card; with two or more cards
   also OB, TP on a (2, 2) ``shared_per_socket`` mesh, GS
   ``shared_everything`` (20 intervals) and the elastic GS service storm of
   phase 10, each with one group a card.  Each run is held to the same run
   with one group on the first card (GS, SL and OB bitwise, TP to rtol =
   atol = 1e-5), drops no op, takes the same rung and launches each kernel
   G times where the one-group run launches it once; its ``e2e cards``
   line gives G, the device of each group, events/s, the drops, the
   launches per group and each card's busy share in one more, profiled run
   of its first intervals, beside the one-group run's.  A machine with one
   card says on its own line that the card-a-group runs did not run.
12. Baseline phase: the replicate-everything ``evaluate_sharded`` on one GS
   interval (500 events, 5,000 ops, 10,000 records) under each layout on 4
   shards, forced "partition" (one radix_partition and one segscan_affine
   launch), bitwise with the single-device staged evaluation on the card;
   its ``e2e baseline`` line gives its wall time from built ops and from
   the interval's events beside the fused sharded driver's chunk time
   (``run_stream_chunk``: state and per-op results on the device, no output
   copy) for the same interval and layout.
13. Substrate phase, the training and serving layer on the card:
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
14. Launch-layer phase, at published widths cut in depth only:
   moonshot-v1-16b-a3b, 2 layers (one dense, one MoE: 64 experts top-6, 2
   shared), on a (2, 4) ``make_host_mesh`` on the card (8 EP shards):
   ``moe_forward_ep`` against ``moe_forward`` at capacity factor 16 (5e-4),
   and at 1.25 the card's kept mask and dropped-choice count bitwise with
   the CPU's; every gradient leaf of the first step finite, at these
   widths and for the smoke config drawn from a CUDA generator with seed 2
   (``c6`` line: C6, NaN gradients through the sigmoid); then 20 steps of
   ``build_train_step`` (batch 8 x 512, bf16 params and AdamW state) with
   steps/s, tokens/s, the model FLOP share and one profiled step (``e2e
   ep`` lines).  Then the same over device groups of the (2, 4) mesh
   through the partitioned step (every leaf, the AdamW state and the batch
   placed, ``launch/sharding.place_params``): two groups on the first
   card, and with two or more cards one group a card (``make_host_mesh``
   spreading the shards; a machine with one card says so on its own
   line).  Each grouped run holds to the one-group run on the first card,
   bitwise, the MoE layer at 1.25 on the skewed batch (output, kept mask,
   drops), step 0's loss and every gradient leaf, and a compressed
   all-reduce over ``data`` of the MoE block's step-0 gradients; its 20
   steps' losses within the bf16 bar of 2e-2 relative of the
   unpartitioned run's, each block still on its card; its ``e2e ep
   groups`` line gives G, the device of each group, steps/s and tokens/s
   beside the unpartitioned run's, and each card's busy share and the peer
   copies' bytes in one profiled step.  The partitioned step (ROADMAP
   A9.6): minicpm-2b at its published widths, 2 layers, bf16 params, f32
   AdamW state, batch 8 x 128, on a (data 2, model 2) mesh in four groups
   (one a card with four cards, else four on the first card, said on its
   own line): step 0's loss and every gradient bitwise with one group;
   each group's bytes at rest equal to ``per_device_bytes``; 20 steps'
   losses, the prefill logits and 16 decode steps' logits within the bf16
   bar of the unpartitioned step's; steps/s, tokens/s, busy share per
   card and peer bytes (``e2e partitioned`` line).  The same for
   zamba2-2.7b at its published widths, one hybrid group (6 layers):
   mamba2 over its SSM heads, the shared attention, the vocab-parallel head
   and cross-entropy, the decode cache at rest as the reference places it
   (``e2e partitioned hybrid``); and deepseek-v3-671b's MLA layer alone at
   its published widths, batch 2 x 128, on the same mesh: forward, every
   gradient and one absorbed decode step bitwise with one group and within
   the bf16 bar of the whole layer (``e2e partitioned mla``).  The
   sequence-sharded carry and donation (``e2e partitioned sp``):
   minicpm-2b, 8 layers, batch 2 x 4,096 (train_4k's length) on the same
   mesh and groups, with ``seq_shard_acts`` on and off: step 0's loss
   bitwise, gradients, 3 steps' losses and params within the bf16 bar;
   per card the bytes at rest of params, moments and gradients, the
   allocation held from the loss to the backward, and each step's peak
   allocation beside the same step without donation.  The donating decode
   (``e2e decode donated``): minicpm-2b, 4 layers, bf16, batch 4 against a
   32,768-deep cache: logits and cache bitwise with ``models.decode_step``,
   the step's peak allocation above what it found under one layer's cache,
   tokens/s beside ``decode_step``'s.  minicpm-2b, 2 layers, float32:
   ``build_decode_step`` on ``MeshSpec({"data": 1, "model": 16})`` pads 36
   heads to 48, each step's logits within 2e-4 of the unpadded decode, with
   tokens/s of both and decode_32k's per-device KV-cache bytes from
   ``cache_specs`` (``e2e serve padded``).  The dry run on the host, one
   shard's program of the partitioned step on the production mesh:
   minicpm-2b x train_4k and deepseek-v3-671b x decode_32k (multi pod),
   per-device FLOPs, collective bytes by kind, wire bytes a device, temp
   and peak bytes a device (``dryrun`` lines; a train cell must show an
   all-gather and a reduce-scatter); and its card cross-check: the
   partitioned phase's train step once on the card under the program
   trace, every shard executing, against the same step traced on the
   one-shard meta mesh, collective records equal as multisets and dot
   FLOPs a device equal to the card's over 4, with the peer-copy bytes the
   records imply for a group a card on four cards (``dryrun card`` line);
   the memory count against the card's allocator: the same train step's
   one-device program and the donated decode of phase 12's configuration,
   each after a warm-up call, and, on four cards, each card's share of the
   partitioned step with a group a card: the meta trace's temp bytes
   within 10% + 64 MiB of the peak allocation above what the call found
   (``dryrun card memory`` lines; card 0, which also holds the joins,
   printed beside cards 1-3).  The GS service (K = 8, megakernel) over 40
   intervals with ``hlo_attribution=True``: bitwise with the run without,
   every execute span carrying its cost fields, no fraction of the peak
   above 1.05 (``e2e service attribution``).
15. Every driven run of phases 4 to 12 follows one uncounted warm-up run of
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
16. Examples phase: the five programs of ``examples/torch`` on the card at
   their reference defaults (quickstart, toll_processing, ledger_serving,
   streaming_service, train_100m at 300 steps of the 8-layer d = 768
   model), the service also with ``--inject-restart --corrupt-latest``,
   ``--storm --inject-restart``, ``--storm --devices 4 --inject-restart``
   and ``--perfetto-out --profile-dir --hlo-cost``: each prints its ✓
   lines, and an ``example`` line gives its wall time.
17. Autotune phase: the wrappers of segscan_affine, segscan_max,
   radix_partition and hash_probe ask ``kernels/autotune`` for their
   threads per block on every unforced call; each key's first call
   benches its candidates.  For every key the runs above decided, an
   ``autotune`` line gives the kernel, bucket, candidates, timings_us,
   winner and source (a microbench), and the winner and the default timed
   alone on the inputs of that call, held bit for bit to each other and to
   the twin (segscan_affine to the twin within 1e-5); then the
   ``--dump`` profile and the total bench time.
18. Prints one JSON line of kernel numbers, the card line again, and last
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


def card_lines() -> list:
    """Every card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()


def card_line() -> str:
    return card_lines()[0]


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
    (rops,), _, _, cap, _ = sh.route(events_to_torch(gs["events"], dev))
    lpad = sh.own.per
    sops, ch = restructure(rops, lpad, rowmajor_ts=True, light=True,
                           method="partition", use_kernels=False,
                           geometry=False)
    (values,) = sh.carry_in(gs["store"].values)
    values = values.reshape(4, lpad + 1, -1)
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


def sync() -> None:
    """Wait for every visible card (a grouped mesh works on several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def timed(eng, stream, interval=INTERVAL):
    """One ``run_stream`` on the engine's device: host clock around it, with
    a synchronize of every card before and after."""
    cuda = eng.device.type == "cuda"
    if cuda:
        sync()
    t0 = time.perf_counter()
    outs, values = eng.run_stream(eng.init_store.values, stream, interval,
                                  fused=True)
    if cuda:
        sync()
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


def lockstep_streams(seed: int) -> dict:
    """SL's and OB's streams of the lockstep phases."""
    from repro_torch.apps import ALL_APPS
    n = N_INTERVALS * INTERVAL
    return {a: ALL_APPS[a].gen_events(np.random.default_rng(seed + 3 + i), n)
            for i, a in enumerate(LOCKSTEP_APPS)}


def lockstep_phase(card, cuda, launches, seed) -> dict:
    """SL and OB through the lockstep path on the card, forced "partition"
    and "auto", and SL's abort repass on an overdrawn stream: each bitwise
    with the port's CPU run of the same stream (state, outputs, per-op
    pre/post/success).  Returns the streams and, by label, each forced
    run's (state, outputs, per-op results) for the sharded phase."""
    cpu = torch.device("cpu")
    n = N_INTERVALS * INTERVAL
    t0 = time.perf_counter()
    data = lockstep_streams(seed)
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


# The sharded driver over device groups (ROADMAP A9.4): label, app, rung,
# layout, mesh shape, axis names, intervals, and whether the run also goes
# on one card in two groups.  With two or more cards every run goes with one
# group a card.
CARD_RUNS = (
    ("gs/shared_nothing", "gs", "megakernel", "shared_nothing", (N_SHARDS,),
     ("dev",), N_INTERVALS, True),
    ("sl/shared_nothing", "sl", "partition", "shared_nothing", (N_SHARDS,),
     ("dev",), N_INTERVALS, True),
    ("ob/shared_nothing", "ob", "partition", "shared_nothing", (N_SHARDS,),
     ("dev",), N_INTERVALS, False),
    ("tp/shared_per_socket", "tp", "partition", "shared_per_socket",
     (2, N_SHARDS // 2), ("socket", "core"), N_INTERVALS, False),
    ("gs/shared_everything", "gs", "partition", "shared_everything",
     (N_SHARDS,), ("dev",), 20, False),
)


def card_busy(fn) -> tuple:
    """``fn()`` once under torch.profiler: (wall s, {card index: busy s}),
    each card's busy time the sum of its kernels' and copies' device time
    (busy None where the profiler saw no CUDA activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = (busy.get(e.device_index, 0.0)
                                    + e.time_range.elapsed_us() / 1e6)
    return wall, (busy or None)


def cards_phase(streams_all, cards, cuda, launches, seed) -> None:
    """The sharded driver over device groups: each run with G groups held
    to the same run with one group on the first card (GS, SL and OB
    bitwise, TP to rtol = atol = 1e-5), no op dropped, each kernel launched
    G times where the one-group run launches it once; on one card GS and
    SL with two groups on it, and with two or more cards every run of
    CARD_RUNS and the elastic GS service storm with one group a card.  Each
    ``e2e cards`` line gives G, the device of each group, events/s, the
    drops, the rung, the launches per group and the busy share of each
    card (one more, profiled run)."""
    from repro_torch.core.mesh import ShardMesh, card_groups
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    setups = [("one card", [cuda, cuda], [r for r in CARD_RUNS if r[7]])]
    if n_cards >= 2:
        setups.append(("a card a group", card_groups(N_SHARDS, cuda),
                       list(CARD_RUNS)))
    else:
        print(f"cards: {n_cards} card visible: the runs with one group a "
              "card need two or more and did not run")
    ones = {}
    for what, devs, runs in setups:
        g = len(devs)
        for label, app_name, method, layout, shape, names, n_i, _ in runs:
            st = {k: np.asarray(v)[: n_i * INTERVAL]
                  for k, v in streams_all[app_name].items()}
            mk = lambda ds: engine(app_name, method, cuda, layout=layout,
                                   mesh=ShardMesh(shape, names, devices=ds))
            if label not in ones:
                eng1 = mk([cuda])
                ones[label] = (eng1, counted(eng1, st, launches))
            eng1, (o1, v1, w1, l1) = ones[label]
            eng = mk(devs)
            outs, values, wall, got = counted(eng, st, launches)
            ex = eng.last_exchange_stats
            dropped = int(np.sum(ex["dropped"]))
            if dropped:
                raise AssertionError(f"cards {label} G={g}: {dropped} ops "
                                     "dropped")
            check_rung(eng, method, f"cards {label} G={g}")
            want = {k: g * v for k, v in l1.items()}
            if got != want:
                raise AssertionError(f"cards {label} G={g}: launches {got}, "
                                     f"expected {want} (G x the one-group "
                                     f"run's {l1})")
            bitwise = app_name != "tp"
            if bitwise:
                assert_equal(values, v1, f"cards {label} G={g}: state")
            else:
                assert_close(values, v1, f"cards {label} G={g}: state")
            check_outputs(outs, o1, f"cards {label} G={g}", n_i,
                          bitwise=bitwise)
            head = {k: v[: PROFILE_INTERVALS * INTERVAL]
                    for k, v in st.items()}
            w_p, busy = card_busy(lambda: timed(eng, head))
            share = ("not measured" if busy is None else
                     {str(d): busy.get(d.index, 0.0) / w_p
                      for d in dict.fromkeys(devs)})
            w1_p, busy1 = card_busy(lambda: timed(eng1, head))
            share1 = ("not measured" if busy1 is None else
                      busy1.get(cuda.index, 0.0) / w1_p)
            per_group = {k: v // g for k, v in got.items() if v}
            print(f"e2e cards {label} G={g} ({what}) devices="
                  f"{[str(d) for d in devs]} rung={method} intervals={n_i}x"
                  f"{INTERVAL}: wall_s={wall} events_per_s="
                  f"{n_i * INTERVAL / wall} dropped={dropped} shipped="
                  f"{int(np.sum(ex['shipped']))} launches={got} "
                  f"launches_per_group={per_group} "
                  f"busy_share_per_card={share} (first {PROFILE_INTERVALS} "
                  f"intervals, profiled wall_s={w_p}) | G=1 on {cuda}: "
                  f"wall_s={w1} events_per_s={n_i * INTERVAL / w1} "
                  f"busy_share={share1} | "
                  + ("bitwise" if bitwise else
                     f"rtol = atol = 1e-5, state max abs err "
                     f"{max_err(values, v1)}") + f" | {cards}")
        if n_cards >= 2 and what == "a card a group":
            cards_service(devs, cards, cuda, launches, seed)
    print(f"cards phase: {time.perf_counter() - t0:.1f} s")


def cards_service(devs, cards, cuda, launches, seed) -> None:
    """The elastic GS service storm (the sharded service phase's) with one
    group a card: at least one live migration, no op dropped, state and
    outputs bitwise with the one-group service and the single-device
    ``run_stream``."""
    from repro_torch import LAUNCHES, reset_launches
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.intervals import PhasedReplaySource, WatermarkPolicy
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.runtime.service import ServiceConfig, StreamService
    g, storm = len(devs), STORMS["gs"]
    n_i = sum(k for k, _ in storm)
    label = "cards service gs rung=megakernel"
    src = PhasedReplaySource(
        ALL_APPS["gs"].gen_events, [(k * INTERVAL, kw) for k, kw in storm],
        seed=seed + 21, arrival_batch=INTERVAL, jitter=SERVICE_JITTER)
    cfg = ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=SERVICE_CHUNK,
        watermark=WatermarkPolicy(allowed_lateness=SERVICE_JITTER),
        controller=storm_controller())
    ref_outs, ref_values, _ = timed(engine("gs", "megakernel", cuda),
                                    src.in_order_events)
    recs = {}
    for ds in ([cuda], devs):
        fresh = lambda: engine("gs", "megakernel", cuda, slack=STORM_SLACK,
                               mesh=ShardMesh((N_SHARDS,), ("dev",),
                                              devices=ds))
        StreamService(fresh(), cfg).run(src)             # warm-up
        reset_launches()
        rec = StreamService(fresh(), cfg).run(src)
        got = dict(LAUNCHES)
        for k, v in got.items():
            launches[k] += v
        place = rec.stats["placement"]
        if not place["migrations"] or any(rec.stats["drops"].values()):
            raise AssertionError(f"{label} G={len(ds)}: migrations "
                                 f"{place['migrations']}, drops "
                                 f"{rec.stats['drops']}")
        values = torch.from_numpy(rec.final_values)
        assert_equal(values, ref_values, f"{label} G={len(ds)}: state vs "
                     "single device")
        check_outputs(rec.outputs, ref_outs, f"{label} G={len(ds)}", n_i,
                      bitwise=True)
        recs[len(ds)] = (rec, got)
    (r1, l1), (rg, lg) = recs[1], recs[g]
    if lg != {k: g * v for k, v in l1.items()}:
        raise AssertionError(f"{label} G={g}: launches {lg}, expected G x "
                             f"the one-group service's {l1}")
    pct, pct1 = (r.latency_percentiles((50, 99)) for r in (rg, r1))
    print(f"e2e {label} G={g} devices={[str(d) for d in devs]} storm="
          f"{[k for k, _ in storm]} chunk={SERVICE_CHUNK}: "
          f"sustained_events_per_s={rg.sustained_events_per_s()} "
          f"latency_p50_s={pct['p50']} latency_p99_s={pct['p99']} "
          f"dropped={rg.stats['drops']['exchange']} migrations="
          f"{len(rg.stats['placement']['migrations'])} moved_rows="
          f"{rg.stats['placement']['moved_rows']} launches={lg} | G=1: "
          f"sustained_events_per_s={r1.sustained_events_per_s()} "
          f"latency_p50_s={pct1['p50']} latency_p99_s={pct1['p99']} "
          f"launches={l1} | bitwise with the single-device run_stream | "
          f"{cards}")


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
    from repro_torch.ckpt.checkpoint import (_flatten, _unflatten,
                                            clone_tree)
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
        # the step donates: each loop starts from its own copy
        return TrainLoop(TrainLoopConfig(
            ckpt_dir=ckpt_dir, ckpt_every=TRAIN_CKPT_EVERY,
            max_steps=TRAIN_STEPS, data_seed=seed, keep_last=1),
            timed_step, lambda i, rng: pipe.batch_for_step(i),
            clone_tree(params0), clone_tree(opt0))

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
    from repro_torch.ckpt.checkpoint import _flatten, clone_tree
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
        c6_check(cfg, params, batch, cuda)
        losses, step_s = [], []
        p, st_ = clone_tree(params), state      # the step donates them
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
        del p, st_
        sps1 = (EP_STEPS - 1) / sum(step_s[1:])
        for devs in ep_group_setups(cuda):
            ep_groups(cfg, params, moe, x, batch, losses, sps1, devs, card,
                      cuda)
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


def c6_check(cfg, params, batch, cuda) -> None:
    """C6 (NaN gradients through ``layers.sigmoid``): every gradient leaf of
    the first step finite, for ``params`` (the phase's, at published
    widths) and for moonshot's smoke config drawn on the card from a CUDA
    generator with seed 2 (where NaN leaves showed before the repair),
    both bf16 under the phase's EP mesh."""
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params, loss_fn
    small = get_arch("moonshot-v1-16b-a3b").smoke()
    sp = init_params(small, torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    toks = torch.randint(0, small.vocab, (8, 33),
                         generator=torch.Generator(device=cuda).manual_seed(2),
                         device=cuda, dtype=torch.int32)
    sb = dict(tokens=toks[:, :-1].contiguous(),
              labels=toks[:, 1:].contiguous())
    out = []
    for label, c, p, b in (("published widths", cfg, params, batch),
                           ("smoke, CUDA generator seed 2", small, sp, sb)):
        leaves = [v.detach().requires_grad_() for _, v in _flatten(p)]
        loss = loss_fn(c, _unflatten(p, iter(leaves)), b)
        grads = torch.autograd.grad(loss, leaves)
        bad = ["/".join(k) for (k, _), g in zip(_flatten(p), grads)
               if not bool(torch.isfinite(g).all())]
        if bad or not bool(torch.isfinite(loss)):
            raise AssertionError(f"C6 {label}: loss {loss.item()}, "
                                 f"non-finite gradient leaves {bad}")
        out.append(f"{label}: loss {loss.item():.4f}, {len(grads)} "
                   f"gradient leaves all finite")
        del leaves, grads, loss
    print(f"c6 moonshot-v1-16b-a3b first step bf16 under EP: "
          f"{'; '.join(out)}")


def card_trace(fn) -> tuple:
    """``fn()`` once under torch.profiler: (wall s, {card index: busy s},
    bytes of the peer copies between cards), each card's busy time the sum
    of its kernels' and copies' device time (None where the profiler saw no
    CUDA activity), the peer bytes from the trace's ``Memcpy PtoP`` events
    (None where the trace gives no copy's bytes)."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="chip_smoke_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    busy, peer, sized = {}, 0, False
    for ev in events:
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        if cat in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "device" in args:
            d = int(args["device"])
            busy[d] = busy.get(d, 0.0) + float(ev.get("dur", 0.0)) / 1e6
        if cat == "gpu_memcpy" and "bytes" in args:
            sized = True
            if "PtoP" in ev.get("name", ""):
                peer += int(args["bytes"])
    return wall, (busy or None), (peer if sized else None)


def ep_group_setups(cuda) -> list:
    """The device groups of the grouped EP runs: two groups on the first
    card, and with two or more cards one group a card (as
    ``make_host_mesh`` spreads a (2, 4) mesh)."""
    from repro_torch.core.mesh import card_groups
    setups = [[cuda, cuda]]
    n = torch.cuda.device_count()
    if n >= 2:
        setups.append(card_groups(8, None))
    else:
        print(f"ep groups: {n} card visible: the run with one group a card "
              "needs two or more and did not run; the two-groups-on-one-"
              "card run stands for it")
    return setups


def ep_groups(cfg, params, moe, x, batch, losses1, sps1, devs, card, cuda):
    """Expert-parallel MoE over the device groups ``devs`` of a (2, 4)
    ``make_host_mesh``, against the same mesh in one group on ``cuda``: the
    MoE layer at capacity factor 1.25 on the skewed batch, its routed
    experts at rest in the groups by the EP rule (output, kept mask,
    dropped count) bitwise; then the partitioned train step
    (``models/partitioned.py``), every leaf, the AdamW state and the batch
    placed by their specs: step 0's loss and every gradient leaf bitwise
    with one group; a compressed all-reduce over ``data`` of the MoE
    block's step-0 gradients (one per shard, scaled) bitwise; 20 steps, every
    loss within the bf16 bar (2e-2 relative) of the unpartitioned step's
    (``ep_phase``'s one-device program), the expert blocks still on their
    cards; steps/s, each card's busy share (card 0's beside the 53.8% of
    PR 25's experts-only placement on four cards) and the peer copies'
    bytes of one profiled step (``e2e ep groups`` line)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (gather_params, param_specs,
                                             place_batch, place_params)
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, moe_ep
    from repro_torch.optim import adamw_init, compressed_psum
    t0 = time.perf_counter()
    g = len(devs)
    one = make_host_mesh(model=4, data=2, device=cuda)
    mesh = (make_host_mesh(model=4, data=2, devices=devs) if len(set(devs))
            == 1 else make_host_mesh(model=4, data=2))
    if list(mesh.devices) != list(devs):
        raise AssertionError(f"make_host_mesh placed {mesh.devices}, "
                             f"expected {devs}")
    label = f"ep groups G={g} devices={[str(d) for d in devs]}"
    shape = ShapeCfg("ep", EP_SEQ, EP_BATCH, "train")

    # the MoE layer at CF 1.25 on the skewed batch, f32, the routed experts
    # at rest by the EP rule and the router and shared experts whole
    layer = []
    for m in (one, mesh):
        moe_ep.set_ep_mesh(m, ("data",))
        placed = place_params({"ffn": moe}, m)["ffn"]
        pm = {k: placed[k] if k in ("wu", "wg", "wd") else v
              for k, v in moe.items()}
        with torch.no_grad():
            y = moe_ep.moe_forward_ep(cfg, pm, x.to(cuda))
            keep = torch.cat([r.keep.to(cuda) for r in
                              moe_ep.route_groups(cfg, pm, x.to(cuda))])
        layer.append((y, keep))
    assert_equal(layer[1][0], layer[0][0], f"{label}: MoE layer output")
    assert_equal(layer[1][1], layer[0][1], f"{label}: kept mask")
    dropped = int((~layer[0][1]).sum())
    if not dropped:
        raise AssertionError(f"{label}: CF 1.25 dropped no choice")

    # step 0's loss and gradients of the partitioned step, then 20 steps
    grads, fns = [], []
    for m in (one, mesh):
        fn, structs = build_train_step(cfg, shape, m, StepConfig())
        ps = param_specs(structs[0], m)
        pm = place_params(params, m, ps)
        loss, gr = fn.plan.loss_and_grads(pm, place_batch(batch, m))
        grads.append((loss, gather_params(gr, m, ps)))
        fns.append((fn, pm, param_specs(structs[1], m)))
        del gr
    (l1, g1), (lg, gg) = grads
    assert_equal(lg, l1, f"{label}: step 0 loss")
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert_equal(a, b, f"{label}: step 0 grad {'/'.join(path)}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{label}: step 0 grad {'/'.join(path)} "
                                 f"is not finite")
    n_leaves = len(_flatten(g1))

    # a compressed all-reduce over data of the MoE block's step-0 grads
    # (the routed experts left out: 8 shards of them take 10 GB), shard s's
    # gradient scaled by 0.5 + s / 8
    block = {"/".join(k): v for k, v in _flatten(g1["stacks"]["moe"])
             if k[-1] not in ("wu", "wg", "wd")}
    scale = torch.arange(8, device=cuda, dtype=torch.float32) / 8 + 0.5
    per_shard = {k: (v[None].float() * scale.view((8,) + (1,) * v.dim())
                     ).to(v.dtype) for k, v in block.items()}
    want = compressed_psum(per_shard, one, "data")
    got = compressed_psum(tuple(dict(zip(per_shard, parts)) for parts in zip(
        *(mesh.split(v) for v in per_shard.values()))), mesh, "data")
    comp_bytes = sum(v.numel() * v.element_size() for v in per_shard.values())
    for part, ref in zip(got, want):
        for k in ref:
            assert_equal(mesh.join(tuple(t[k] for t in part)), ref[k],
                         f"{label}: compressed_psum {k}")
    del grads, g1, gg, per_shard, want, got

    fn, pm, ss = fns[1]
    del fns
    moe_ep.set_ep_mesh(mesh, ("data",))
    st = place_params(adamw_init(params, StepConfig().optimizer), mesh, ss)
    pb = place_batch(batch, mesh)
    losses, step_s = [], []
    for _ in range(EP_STEPS):
        sync()
        t1 = time.perf_counter()
        pm, st, loss = fn(pm, st, pb)
        sync()
        step_s.append(time.perf_counter() - t1)
        losses.append(float(loss))
    if not all(np.isfinite(losses)) or int(st["step"]) != EP_STEPS:
        raise AssertionError(f"{label}: losses {losses}")
    loss_err = max(abs(a - b) for a, b in zip(losses, losses1))
    if any(abs(a - b) > LOSS_BF16_TOL * abs(b) for a, b in zip(losses,
                                                               losses1)):
        raise AssertionError(f"{label}: losses {losses} against {losses1} "
                             f"of the unpartitioned step beyond "
                             f"{LOSS_BF16_TOL}")
    for path, leaf in _flatten(dict(p=pm, m=st["m"], v=st["v"])):
        if path[-1] != "step" and leaf.device != mesh.devices[int(path[-1])]:
            raise AssertionError(f"{label}: {'/'.join(path)} on "
                                 f"{leaf.device}")
    w_p, busy, peer = card_trace(lambda: fn(pm, st, pb))
    share = ("not measured" if busy is None else
             {str(d): busy.get(d.index, 0.0) / w_p
              for d in dict.fromkeys(devs)})
    sps = (EP_STEPS - 1) / sum(step_s[1:])
    tok = EP_BATCH * EP_SEQ
    print(f"e2e {label} moonshot-v1-16b-a3b ({depth(cfg)}, (2, 4) mesh, "
          f"partitioned step: every leaf, the AdamW state and the batch "
          f"placed, 8 EP shards, {n_leaves} param leaves) batch {EP_BATCH} x "
          f"seq {EP_SEQ}: steps_per_s={sps} tokens_per_s={sps * tok} (steps "
          f"1-{EP_STEPS - 1}) step0_s={step_s[0]} | unpartitioned on {cuda}: "
          f"steps_per_s={sps1} tokens_per_s={sps1 * tok} | ratio "
          f"{sps / sps1} | busy_share_per_card={share} (card 0 was 0.538 with "
          f"the experts alone placed, PR 25, four cards) peer_copy_bytes_"
          f"per_step={'not measured' if peer is None else peer} (one "
          f"profiled step, wall_s={w_p}) | bitwise with G=1: MoE layer "
          f"CF 1.25 (dropped {dropped} of {layer[0][1].numel()} choices), "
          f"step 0 loss and {n_leaves} grad leaves (all finite), "
          f"compressed_psum over data of {len(block)} leaves x 8 shards "
          f"({comp_bytes} B) | {EP_STEPS} losses against the unpartitioned "
          f"step's max abs diff {loss_err} (loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}) | every block on its card after "
          f"{EP_STEPS + 1} steps | {card}")
    print(f"ep groups G={g} phase: {time.perf_counter() - t0:.1f} s")


PART_BATCH, PART_SEQ, PART_STEPS, PART_DECODE = 8, 128, 20, 16


def partitioned_groups(cuda) -> list:
    """The device groups of the partitioned phase's (2, 2) mesh: one group a
    card with four or more cards, else four groups on ``cuda`` (said on a
    line of its own)."""
    from repro_torch.core.mesh import card_groups
    n = torch.cuda.device_count()
    if n >= 4:
        return card_groups(4, None)
    print(f"partitioned: {n} card(s) visible: the run with one group a card "
          f"needs four and did not run; four groups on {cuda} stand for it")
    return [cuda] * 4


def widths(cfg) -> str:
    """A model's published widths and its depth, for an ``e2e`` line."""
    if cfg.family == "hybrid":
        return (f"{cfg.name} (d_model {cfg.d_model}, {cfg.ssm_heads} SSM "
                f"heads of {cfg.ssm_head_dim}, d_inner {cfg.d_inner}, state "
                f"{cfg.ssm_state}, {cfg.n_heads} attention heads, d_ff "
                f"{cfg.d_ff}, vocab {cfg.vocab}, {depth(cfg)}")
    return (f"{cfg.name} (d_model {cfg.d_model}, {cfg.n_heads} heads MHA, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {depth(cfg)}")


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 (the repo's bf16 model bar)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def partitioned_phase(card, cuda, seed, name="minicpm-2b", n_layers=2,
                      tag="partitioned", own_noise=False) -> None:
    """minicpm-2b at its published widths (d_model 2,304, 36 MHA heads,
    d_ff 5,760, vocab 122,753), 2 layers (or ``name`` cut to ``n_layers``),
    bf16 params, f32 AdamW state, batch 8 x 128, on a (data 2, model 2)
    mesh in four device groups (``partitioned_groups``), every leaf, the
    AdamW moments, the batch and the decode cache placed by the reference's
    specs: step 0's loss and every gradient leaf bitwise with the same mesh
    in one group on ``cuda``; each group's params and AdamW bytes at rest
    equal to ``per_device_bytes``; 20 train steps, each loss finite and
    within the bf16 bar (2e-2 relative) of the unpartitioned step's (the
    (1, 1) mesh, same params); the prefill logits and 16 decode steps'
    logits, fed the same tokens, within 2e-2 of the largest magnitude of
    the unpartitioned ones; steps/s and tokens/s of both, each card's busy
    share and the peer copies' bytes over one profiled step (``e2e <tag>``
    line).  ``own_noise``: the model's own bf16 rounding moves its logits
    more than 2e-2 (zamba2's mamba2 stack: 12.6% of the largest magnitude
    between the unpartitioned program's bf16 and float32 runs): the prefill
    and decode logits are then held, with float32 params, within 1e-4 of
    the largest magnitude, and in bf16 to the repo's bf16 bar, norm-relative
    max(2e-2, 3 x the unpartitioned bf16 run's distance from its float32
    run)."""
    from repro_torch.ckpt.checkpoint import _flatten, clone_tree
    from repro_torch.launch.mesh import MeshSpec, make_host_mesh
    from repro_torch.launch.sharding import (cache_specs, gather_params,
                                             param_specs, per_device_bytes,
                                             place_batch, place_cache,
                                             place_params)
    from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                          build_prefill_step,
                                          build_train_step, logits_spec)
    from repro_torch.models import ShapeCfg, init_cache, init_params, moe_ep
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    cfg = cut(name, n_layers)
    devs = partitioned_groups(cuda)
    one = make_host_mesh(model=2, data=2, device=cuda)
    mesh = (make_host_mesh(model=2, data=2) if len(set(devs)) > 1 else
            make_host_mesh(model=2, data=2, devices=devs))
    if list(mesh.devices) != list(devs):
        raise AssertionError(f"make_host_mesh placed {mesh.devices}, "
                             f"expected {devs}")
    flat = make_host_mesh(device=cuda)
    g = mesh.n_groups
    label = f"{tag} G={g} devices={[str(d) for d in devs]}"
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)
    step_cfg = StepConfig(optimizer=AdamWConfig(state_dtype=torch.float32))
    shape = ShapeCfg("train", PART_SEQ, PART_BATCH, "train")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        PART_BATCH, PART_SEQ + 1)).astype(np.int32)).to(cuda)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    try:
        # step 0: the partitioned loss and gradients, G groups vs one
        runs = []
        for m in (one, mesh):
            fn, structs = build_train_step(cfg, shape, m, step_cfg)
            ps, ss = param_specs(structs[0], m), param_specs(structs[1], m)
            pm = place_params(params, m, ps)
            loss, grads = fn.plan.loss_and_grads(pm, place_batch(batch, m))
            runs.append((loss, gather_params(grads, m, ps), fn, pm, ps, ss,
                         structs))
            del grads
        (l1, g1, *_), (lg, gg, fn, pm, ps, ss, structs) = runs
        assert_equal(lg, l1, f"{label}: step 0 loss")
        for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
            assert_equal(a, b, f"{label}: step 0 grad {'/'.join(path)}")
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"{label}: grad {'/'.join(path)} not "
                                     f"finite")
        n_leaves = len(_flatten(g1))
        del runs, g1, gg
        st = place_params(adamw_init(params, step_cfg.optimizer), mesh, ss)

        # bytes at rest: each group's against per_device_bytes
        spec_mesh = MeshSpec({"data": 2, "model": 2})
        want = {k: per_device_bytes(t, param_specs(t, spec_mesh), spec_mesh)
                for k, t in (("params", structs[0]), ("m", structs[1]["m"]),
                             ("v", structs[1]["v"]))}
        whole = {k: sum(x.numel() * x.element_size() for _, x in
                        _flatten(t)) for k, t in (
            ("params", structs[0]), ("m", structs[1]["m"]),
            ("v", structs[1]["v"]))}
        rest = {}
        for k, t in (("params", pm), ("m", st["m"]), ("v", st["v"])):
            per = [0] * g
            for path, x in _flatten(t):
                per[int(path[-1])] += x.numel() * x.element_size()
            rest[k] = per
            if per != [want[k]] * g:
                raise AssertionError(f"{label}: {k} bytes at rest {per} "
                                     f"against per_device_bytes {want[k]}")

        # 20 steps against the unpartitioned step
        wfn, _ = build_train_step(cfg, shape, flat, step_cfg)
        losses = {}
        times = {}
        for key, f, p, s_, b in (
                ("whole", wfn, clone_tree(params),
                 adamw_init(params, step_cfg.optimizer), batch),
                ("part", fn, pm, st, place_batch(batch, mesh))):
            ls, ts = [], []
            for _ in range(PART_STEPS):
                sync()
                t1 = time.perf_counter()
                p, s_, loss = f(p, s_, b)
                sync()
                ts.append(time.perf_counter() - t1)
                ls.append(float(loss))
            losses[key], times[key] = ls, ts
            if key == "part":
                pm, st = p, s_
        if not all(np.isfinite(losses["part"])):
            raise AssertionError(f"{label}: losses {losses['part']}")
        loss_err = max(abs(a - b) for a, b in zip(losses["part"],
                                                  losses["whole"]))
        if any(abs(a - b) > LOSS_BF16_TOL * abs(b) for a, b in zip(
                losses["part"], losses["whole"])):
            raise AssertionError(f"{label}: losses {losses['part']} against "
                                 f"{losses['whole']} beyond {LOSS_BF16_TOL}")
        pb = place_batch(batch, mesh)
        w_p, busy, peer = card_trace(lambda: fn(pm, st, pb))
        share = ("not measured" if busy is None else
                 {str(d): busy.get(d.index, 0.0) / w_p
                  for d in dict.fromkeys(devs)})
        del pm, st
        sps = {k: (PART_STEPS - 1) / sum(v[1:]) for k, v in times.items()}

        # prefill and decode against the unpartitioned program
        pshape = ShapeCfg("prefill", PART_SEQ, PART_BATCH, "prefill")
        dshape = ShapeCfg("decode", PART_DECODE, PART_BATCH, "decode")
        lspec = logits_spec(cfg, dshape, mesh, decode=True)

        def serve(p, toks=None):
            """Prefill logits and PART_DECODE decode steps' logits of the
            params ``p``, unpartitioned and partitioned, fed the
            unpartitioned run's greedy tokens (or ``toks``): ([whole
            logits], [partitioned logits], tokens fed, decode wall s)."""
            wpre, _ = build_prefill_step(cfg, pshape, flat)
            wants = [wpre(p, dict(tokens=batch["tokens"]))]
            pre, pst = build_prefill_step(cfg, pshape, mesh)
            gots = [mesh.assemble(pre(place_params(p, mesh, param_specs(
                pst[0], mesh)), dict(tokens=batch["tokens"])),
                logits_spec(cfg, pshape, mesh))]
            wdec, _ = build_decode_step(cfg, dshape, flat)
            dec, (dps, _, _, _) = build_decode_step(cfg, dshape, mesh)
            dparams = place_params(p, mesh, param_specs(dps, mesh))
            dt = p["final_norm"].dtype
            wc = init_cache(cfg, PART_BATCH, PART_DECODE, dtype=dt,
                            device=cuda)
            pc = place_cache(init_cache(cfg, PART_BATCH, PART_DECODE,
                                        dtype=dt, device=cuda), mesh,
                             PART_BATCH)
            dec_s = {"whole": 0.0, "part": 0.0}
            fed = [batch["tokens"][:, :1]]
            for pos in range(PART_DECODE):
                tok = fed[pos] if toks is None else toks[pos]
                sync()
                t1 = time.perf_counter()
                wl, wc = wdec(p, wc, tok, pos)
                sync()
                t2 = time.perf_counter()
                dl, pc = dec(dparams, pc, tok, pos)
                sync()
                dec_s["whole"] += t2 - t1
                dec_s["part"] += time.perf_counter() - t2
                wants.append(wl)
                gots.append(mesh.assemble(dl, lspec))
                fed.append(wl[:, -1].argmax(-1, keepdim=True).to(
                    torch.int32))
            return wants, gots, fed, dec_s

        what = ["prefill"] + [f"decode step {i}" for i in range(PART_DECODE)]
        wants, gots, fed, dec_s = serve(params)
        errs = [max_err(a, b) for a, b in zip(gots, wants)]
        if not own_noise:
            for w, e, b in zip(what, errs, wants):
                if e > LOSS_BF16_TOL * float(b.float().abs().max()):
                    raise AssertionError(f"{label}: {w} logits max abs err "
                                         f"{e}")
            bars = "bar 2e-2 of the largest magnitude"
        else:
            # float32 params: the program itself, within 1e-4 of the
            # largest magnitude; bf16: the repo's bf16 bar, norm-relative
            # max(2e-2, 3 x the unpartitioned bf16 run's distance from its
            # float32 run)
            p32 = _to_f32(params)
            w32, g32, _, _ = serve(p32, fed)
            del p32
            e32 = [max_err(a, b) for a, b in zip(g32, w32)]
            for w, e, b in zip(what, e32, w32):
                if e > 1e-4 * float(b.float().abs().max()):
                    raise AssertionError(f"{label}: float32 {w} logits max "
                                         f"abs err {e}")
            rel = [norm_rel(a, b) for a, b in zip(gots, wants)]
            own = [norm_rel(a, b) for a, b in zip(wants, w32)]
            for w, r, o in zip(what, rel, own):
                if r > max(LOSS_BF16_TOL, 3 * o):
                    raise AssertionError(
                        f"{label}: {w} logits norm-relative err {r} beyond "
                        f"max(2e-2, 3 x {o})")
            bars = (f"norm-relative {max(rel)}, the unpartitioned bf16 run "
                    f"{min(own)}-{max(own)} from its float32 run (bar "
                    f"max(2e-2, 3x that)); float32 params: max abs err "
                    f"{max(e32)}, bar 1e-4 of the largest magnitude "
                    f"{max(float(b.abs().max()) for b in w32)}")
            del w32, g32
        pre_err, dec_err = errs[0], max(errs[1:])
        del wants, gots
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    tok_n = PART_BATCH * PART_SEQ
    gb = lambda n: f"{n} B"
    print(f"e2e {label} {widths(cfg)}, bf16 params, f32 AdamW state, "
          f"remat full) on a (data 2, model 2) mesh batch {PART_BATCH} x "
          f"seq {PART_SEQ}: bytes at rest per group params "
          f"{gb(rest['params'][0])} m {gb(rest['m'][0])} v "
          f"{gb(rest['v'][0])} (= per_device_bytes; whole "
          f"{gb(whole['params'])} / {gb(whole['m'])} / {gb(whole['v'])}) | "
          f"steps_per_s={sps['part']} tokens_per_s={sps['part'] * tok_n} "
          f"against unpartitioned steps_per_s={sps['whole']} tokens_per_s="
          f"{sps['whole'] * tok_n} (steps 1-{PART_STEPS - 1}; ratio "
          f"{sps['part'] / sps['whole']}) step0_s={times['part'][0]} | "
          f"busy_share_per_card={share} peer_copy_bytes_per_step="
          f"{'not measured' if peer is None else peer} (one profiled step, "
          f"wall_s={w_p}) | step 0 loss and {n_leaves} grad leaves bitwise "
          f"with G=1 (all finite) | {PART_STEPS} losses max abs diff "
          f"{loss_err} from the unpartitioned step (loss "
          f"{losses['part'][0]:.4f} -> {losses['part'][-1]:.4f}) | prefill "
          f"logits max abs err {pre_err} | {PART_DECODE} decode steps logits "
          f"max abs err {dec_err}, decode tokens_per_s "
          f"{PART_BATCH * PART_DECODE / dec_s['part']} against "
          f"{PART_BATCH * PART_DECODE / dec_s['whole']} ({bars}) | {card}")
    print(f"{tag} phase: {time.perf_counter() - t0:.1f} s")


def to_cpu(tree):
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten
    return _unflatten(tree, iter(x.cpu() for _, x in _flatten(tree)))


def card_bytes(tree, cards) -> list:
    """The bytes of ``tree``'s tensors on each card of ``cards``."""
    from repro_torch.ckpt.checkpoint import _flatten
    out = {d: 0 for d in cards}
    for _, x in _flatten(tree):
        out[x.device] += x.numel() * x.element_size()
    return [out[d] for d in cards]


def peak_over(fn, cards) -> tuple:
    """``fn()``'s result, and per card the allocation before it and the
    peak allocation while it ran (``torch.cuda.max_memory_allocated``);
    what no one holds any more is collected first."""
    import gc
    gc.collect()
    sync()
    base = [torch.cuda.memory_allocated(d) for d in cards]
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    out = fn()
    sync()
    return out, base, [torch.cuda.max_memory_allocated(d) for d in cards]


SP_LAYERS, SP_BATCH, SP_SEQ, SP_STEPS = 8, 2, 4096, 3


def sp_phase(card, cuda, seed) -> None:
    """The sequence-sharded layer carry (``StepConfig.seq_shard_acts``) and
    the donating train step at the reference's train_4k sequence length:
    minicpm-2b at its published widths, 8 layers, bf16 params, f32 AdamW
    state, batch 2 x 4,096, remat full, on the partitioned phase's (data 2,
    model 2) mesh in four groups (``partitioned_groups``).  With the carry
    sharded and whole: step 0's loss bitwise, every gradient leaf within
    the bf16 bar (2e-2 norm-relative; the backward sums the shards'
    gradients at other points), 3 steps' losses and params within it too;
    per card, the bytes at rest of params, moments and gradients, the
    allocation held from the loss to the backward (the saved carry), and
    the peak allocation of a donated step beside that of the same step
    without donation (the functional ``adamw_update`` on the same
    gradients: a copy of params and moments beside the inputs, as the
    program before donation held) (``e2e partitioned sp`` line)."""
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import (gather_params, param_specs,
                                             place_batch, place_params)
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, init_params, moe_ep
    from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                                   adamw_update_, wsd_schedule)
    t0 = time.perf_counter()
    cfg = cut("minicpm-2b", SP_LAYERS)
    devs = partitioned_groups(cuda)
    mesh = (make_host_mesh(model=2, data=2) if len(set(devs)) > 1 else
            make_host_mesh(model=2, data=2, devices=devs))
    cards = list(dict.fromkeys(mesh.devices))
    label = (f"partitioned sp G={mesh.n_groups} devices="
             f"{[str(d) for d in devs]}")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)
    opt = AdamWConfig(state_dtype=torch.float32)
    shape = ShapeCfg("train_4k", SP_SEQ, SP_BATCH, "train")
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (SP_BATCH, SP_SEQ + 1)).astype(np.int32)).to(cuda)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    runs = {}
    try:
        for sp in (True, False):
            fn, structs = build_train_step(cfg, shape, mesh, StepConfig(
                seq_shard_acts=sp, optimizer=opt))
            if fn.plan.seq_sharded(SP_SEQ) != sp:
                raise AssertionError(f"{label}: seq_sharded is not {sp}")
            ps = param_specs(structs[0], mesh)
            pm = place_params(params, mesh, ps)
            st = place_params(adamw_init(params, opt), mesh,
                              param_specs(structs[1], mesh))
            pb = place_batch(batch, mesh)
            r = dict(rest=[card_bytes(t, cards)
                           for t in (pm, st["m"], st["v"])])
            # the saved activations: held from the loss to the backward
            leaves = [t.detach().requires_grad_() for _, t in _flatten(pm)]
            loss, base, _ = peak_over(lambda: fn.plan.loss(
                _unflatten(pm, iter(leaves)), pb), cards)
            r["saved"] = [torch.cuda.memory_allocated(d) - b
                          for d, b in zip(cards, base)]
            del loss, leaves
            r["loss0"], grads = fn.plan.loss_and_grads(pm, pb)
            # on the host, out of the other run's allocation
            r["grads"] = to_cpu(gather_params(grads, mesh, ps))
            r["rest"].append(card_bytes(grads, cards))
            del grads
            if sp:
                # the step before donation: the same gradients, then new
                # params and moments beside the inputs
                def functional():
                    loss, grads = fn.plan.loss_and_grads(pm, pb)
                    lr = wsd_schedule(st["step"], warmup=2000,
                                      stable=50_000, decay=5_000)
                    with torch.no_grad():
                        return adamw_update(pm, grads, st, opt, lr_scale=lr,
                                            gnorm=fn.plan.global_norm(grads))
                new, r["kept_base"], r["peak_kept"] = peak_over(functional,
                                                                cards)
                del new
            losses, step_s = [], []
            for i in range(SP_STEPS):
                t1 = time.perf_counter()
                (p2, s2, loss), base, peak = peak_over(
                    lambda: fn(pm, st, pb), cards)
                step_s.append(time.perf_counter() - t1)
                if p2 is not pm or s2 is not st:
                    raise AssertionError(f"{label}: the step did not give "
                                         f"back its donated inputs")
                losses.append(float(loss))
                del p2, s2, loss
            r.update(losses=losses, base=base, peak=peak, step_s=step_s,
                     params=to_cpu(gather_params(pm, mesh, ps)))
            if sp:
                # the update alone, the gradients held: new trees beside
                # the inputs (adamw_update) against in place (adamw_update_)
                loss, grads = fn.plan.loss_and_grads(pm, pb)
                gn = fn.plan.global_norm(grads)
                lr = wsd_schedule(st["step"], warmup=2000, stable=50_000,
                                  decay=5_000)
                with torch.no_grad():
                    new, b1, p1 = peak_over(lambda: adamw_update(
                        pm, grads, st, opt, lr_scale=lr, gnorm=gn), cards)
                    del new
                    same, b2, p2 = peak_over(lambda: adamw_update_(
                        pm, grads, st, opt, lr_scale=lr, gnorm=gn), cards)
                r["update"] = ([p - b for p, b in zip(p1, b1)],
                               [p - b for p, b in zip(p2, b2)])
                del grads, same
            runs[sp] = r
            del pm, st, pb
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    on, off = runs[True], runs[False]
    assert_equal(on["loss0"], off["loss0"], f"{label}: step 0 loss, carry "
                 f"sharded vs whole")
    grad_rel = max(norm_rel(a, b) for (_, a), (_, b) in zip(
        _flatten(on["grads"]), _flatten(off["grads"])))
    par = [(a, b) for (_, a), (_, b) in zip(_flatten(on["params"]),
                                            _flatten(off["params"]))]
    par_rel = max(norm_rel(a, b) for a, b in par)
    par_diff = sum(int((a != b).sum()) for a, b in par)
    n_par = sum(a.numel() for a, _ in par)
    loss_err = max(abs(a - b) for a, b in zip(on["losses"], off["losses"]))
    if (grad_rel > LOSS_BF16_TOL or par_rel > LOSS_BF16_TOL
            or loss_err > LOSS_BF16_TOL * abs(off["losses"][-1])
            or not all(np.isfinite(on["losses"]))):
        raise AssertionError(f"{label}: grads {grad_rel}, params {par_rel}, "
                             f"losses {on['losses']} vs {off['losses']}")
    carry = SP_BATCH // 2 * SP_SEQ * cfg.d_model * 2      # one shard, bf16
    sub = lambda xs, ys: [x - y for x, y in zip(xs, ys)]
    gib = lambda xs: "/".join(f"{x / 2**30:.3f}" for x in xs)
    print(f"e2e {label} {widths(cfg)}, bf16 params, f32 AdamW state, "
          f"remat full) batch {SP_BATCH} x seq {SP_SEQ} (train_4k's length)"
          f" | carry sharded vs whole: step 0 loss bitwise ({float(on['loss0'])}"
          f"), gradients max norm-relative {grad_rel}, after {SP_STEPS} "
          f"steps losses max abs diff {loss_err} ({on['losses']}), params "
          f"norm-relative {par_rel} ({par_diff} of {n_par} elements differ)"
          f" | per card {[str(d) for d in cards]} GiB: at rest params "
          f"{gib(on['rest'][0])} m {gib(on['rest'][1])} v "
          f"{gib(on['rest'][2])} grads {gib(on['rest'][3])}; held from the "
          f"loss to the backward sharded {gib(on['saved'])} whole "
          f"{gib(off['saved'])} (the carry a layer and shard: whole "
          f"{carry} B, sharded {carry // 2} B, {SP_LAYERS} layers x 4 "
          f"shards); a step's peak above the allocation before it "
          f"(sharded {gib(on['base'])}, whole {gib(off['base'])}): sharded "
          f"{gib(sub(on['peak'], on['base']))} whole "
          f"{gib(sub(off['peak'], off['base']))}, without donation "
          f"(adamw_update: new params and moments beside the inputs) "
          f"{gib(sub(on['peak_kept'], on['kept_base']))}; the update "
          f"alone, "
          f"gradients held: adamw_update {gib(on['update'][0])} "
          f"adamw_update_ (in place) {gib(on['update'][1])} | steps_per_s "
          f"sharded "
          f"{(SP_STEPS - 1) / sum(on['step_s'][1:])} whole "
          f"{(SP_STEPS - 1) / sum(off['step_s'][1:])} | {card}")
    print(f"sp phase: {time.perf_counter() - t0:.1f} s")


DON_LAYERS, DON_BATCH, DON_CACHE, DON_STEPS = 4, 4, 32768, 16


def donate_decode_phase(card, cuda, seed) -> None:
    """The donating decode step (``build_decode_step``'s ``serve``: the new
    position written into the cache it is given) on one card: minicpm-2b at
    its published widths, 4 layers, bf16, batch 4 against a 32,768-deep
    cache (decode_32k's depth) of random history: its logits and every
    cache leaf bitwise with ``models.decode_step`` (functional: the step on
    a copy of the cache) on the same inputs; the step's peak allocation
    above the allocation before it, under one layer's cache, beside
    decode_step's; tokens/s of both over 16 steps (``e2e decode donated``
    line)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, build_decode_step
    from repro_torch.models import ShapeCfg, decode_step, init_cache, \
        init_params
    t0 = time.perf_counter()
    cfg = cut("minicpm-2b", DON_LAYERS)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)
    serve, _ = build_decode_step(cfg, ShapeCfg(
        "decode_32k", DON_CACHE, DON_BATCH, "decode"),
        make_host_mesh(device=cuda), StepConfig(serving_head_pad=False))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cache = init_cache(cfg, DON_BATCH, DON_CACHE, device=cuda)
    for _, x in _flatten(cache):
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda) * 0.1)
    whole = sum(x.numel() * x.element_size() for _, x in _flatten(cache))
    layer = whole // DON_LAYERS
    toks = torch.randint(0, cfg.vocab, (DON_BATCH, 2 * DON_STEPS + 3),
                         generator=gen, device=cuda, dtype=torch.int32)
    pos0 = DON_CACHE // 2
    with torch.no_grad():
        want, new = decode_step(cfg, params, cache, toks[:, :1], pos0)
    got, out = serve(params, cache, toks[:, :1], pos0)
    if out is not cache:
        raise AssertionError("decode donated: the step did not give back "
                             "its cache")
    assert_equal(got, want, "decode donated: logits")
    for (path, a), (_, b) in zip(_flatten(out), _flatten(new)):
        assert_equal(a, b, f"decode donated: cache {'/'.join(path)}")
    del new
    (_, cache), base, peak = peak_over(
        lambda: serve(params, cache, toks[:, 1:2], pos0 + 1), [cuda])
    extra = peak[0] - base[0]
    if extra >= layer:
        raise AssertionError(f"decode donated: {extra} B above the "
                             f"allocation, one layer's cache is {layer} B")

    def functional():
        with torch.no_grad():
            return decode_step(cfg, params, cache, toks[:, 2:3], pos0 + 2)
    kept, base_f, peak_f = peak_over(functional, [cuda])
    del kept
    rates = {}
    for name, step in (("donated", serve), ("decode_step", lambda *a: (
            decode_step(cfg, *a)))):
        c, wall = cache, []
        for i in range(DON_STEPS):
            sync()
            t1 = time.perf_counter()
            with torch.no_grad():
                _, c = step(params, c, toks[:, 3 + i:4 + i], pos0 + 3 + i)
            sync()
            wall.append(time.perf_counter() - t1)
        rates[name] = DON_BATCH * (DON_STEPS - 1) / sum(wall[1:])
        del c
    print(f"e2e decode donated minicpm-2b (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads MHA, vocab {cfg.vocab}, {depth(cfg)}, bf16) "
          f"batch {DON_BATCH}, cache {DON_CACHE} deep ({whole} B, one layer "
          f"{layer} B) at position {pos0}: logits and every cache leaf "
          f"bitwise with models.decode_step | peak above the allocation "
          f"before the step: donated {extra} B (under one layer's cache), "
          f"decode_step (a copy of the cache first) "
          f"{peak_f[0] - base_f[0]} B | tokens_per_s donated "
          f"{rates['donated']} decode_step {rates['decode_step']} (steps "
          f"1-{DON_STEPS - 1}) | {card}")
    print(f"decode donated phase: {time.perf_counter() - t0:.1f} s")


MLA_BATCH, MLA_SEQ = 2, 128


def partitioned_hybrid_phase(card, cuda, seed) -> None:
    """The partitioned step over the whole zoo's hard cases (ROADMAP A9.6
    follow-ups).  zamba2-2.7b at its published widths (d_model 2,560, 80
    SSM heads of 64, d_inner 5,120, state 64, 32 attention heads, vocab
    32,000), one hybrid group (6 layers), through ``partitioned_phase``:
    mamba2 over its heads, the shared attention block, the vocab-parallel
    head and cross-entropy, and the decode cache at rest as the
    reference's ``cache_specs`` places it (``e2e partitioned hybrid``).
    Then deepseek-v3-671b's MLA attention block alone (``mla_block``)."""
    partitioned_phase(card, cuda, seed, "zamba2-2.7b", 6,
                      "partitioned hybrid", own_noise=True)
    mla_block(card, cuda, seed)


def mla_block(card, cuda, seed) -> None:
    """deepseek-v3-671b's MLA attention layer alone at its published widths
    (d_model 7,168, 128 heads, q_lora 1,536, kv_lora 512, nope 128, rope
    64, v 128), bf16, batch 2 x 128, on the (data 2, model 2) mesh in the
    groups of ``partitioned_groups`` (``Partitioned.attention``: each
    shard's heads of ``wuq``/``wuk``/``wuv``/``wo``, one psum): the output,
    every weight's and the input's gradient of a fixed weighted sum, and one
    absorbed decode step at position 128 of a 256-deep cache (logits-free:
    the layer's output and its new ``ckv``/``kr`` cache) bitwise with one
    group on ``cuda``, and within the bf16 bar (2e-2 of the largest
    magnitude) of the whole layer (``layers.mla_forward``); the forward and
    backward wall of both (``e2e partitioned mla`` line)."""
    from repro_torch.ckpt.checkpoint import _flatten, _unflatten
    from repro_torch.configs import get_arch
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.launch.sharding import (cache_specs, gather_params,
                                             param_specs, place_cache,
                                             place_params)
    from repro_torch.models.layers import mla_forward
    from repro_torch.models.model import _attn_params, _Init
    from repro_torch.models.partitioned import Partitioned, _unstack
    t0 = time.perf_counter()
    cfg = get_arch("deepseek-v3-671b")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    attn = _attn_params(cfg, _Init(gen, torch.bfloat16, cuda))
    b, s, d = MLA_BATCH, MLA_SEQ, cfg.d_model
    bf = torch.bfloat16
    x = torch.randn((b, s, d), generator=gen, device=cuda).to(bf)
    wsum = torch.randn((b, s, d), generator=gen, device=cuda)
    x1 = torch.randn((b, 1, d), generator=gen, device=cuda).to(bf)
    cache = dict(ckv=(torch.randn((1, b, 2 * s, cfg.kv_lora_rank),
                                  generator=gen, device=cuda) * 0.1).to(bf),
                 kr=(torch.randn((1, b, 2 * s, cfg.qk_rope_dim),
                                 generator=gen, device=cuda) * 0.1).to(bf))
    pos = torch.arange(s, device=cuda)[None, :]
    posv = torch.full((1, 1), s, dtype=torch.int32, device=cuda)
    rows = (("data",), None, None)

    def whole():
        leaves = [t.detach().requires_grad_() for _, t in _flatten(attn)]
        xg = x.detach().requires_grad_()
        sync()
        t1 = time.perf_counter()
        out, _ = mla_forward(cfg, _unflatten(attn, iter(leaves)), xg, pos)
        grads = torch.autograd.grad((out.float() * wsum).sum(),
                                    leaves + [xg])
        sync()
        wall = time.perf_counter() - t1
        with torch.no_grad():
            dec, nc = mla_forward(cfg, attn, x1, posv, cache={
                k: v[0] for k, v in cache.items()}, cache_pos=s)
        return dict(out=out.detach(), grads=list(grads), dec=dec,
                    cache=nc, wall=wall)

    def partitioned(devs):
        mesh = ShardMesh((2, 2), ("data", "model"), devices=devs)
        specs = param_specs(dict(lm_head=torch.empty(
            (d, cfg.vocab), device="meta"), attn=attn), mesh)
        plan = Partitioned(cfg, mesh, specs)
        placed = place_params(attn, mesh, specs["attn"])
        leaves = [t.detach().requires_grad_() for _, t in _flatten(placed)]
        tree = _unflatten(placed, iter(leaves))
        dev = lambda i: mesh.devices[i // mesh.per_group]
        xs = [mesh.block_of(x, rows, i).to(dev(i)).detach().requires_grad_()
              for i in range(mesh.size)]
        first = [i for i in range(mesh.size) if plan.model_idx[i] == 0]
        sync()
        t1 = time.perf_counter()
        out, _ = plan.attention(tree, specs["attn"], xs,
                                [pos.to(dev(i)) for i in range(mesh.size)])
        loss = sum((out[i].float() * mesh.block_of(wsum, rows, i).to(
            dev(i))).sum().to(cuda) for i in first)
        grads = torch.autograd.grad(loss, leaves + xs)
        sync()
        wall = time.perf_counter() - t1
        gp = _unflatten(placed, iter(grads[:len(leaves)]))
        with torch.no_grad():
            gp = gather_params({k: mesh.psum_replicas(v, specs["attn"][k])
                                for k, v in gp.items()}, mesh, specs["attn"])
            gx = torch.cat([sum(grads[len(leaves) + j].to(cuda)
                                for j in range(mesh.size)
                                if mesh.coords(j)[0] == r) for r in range(2)])
            cs = cache_specs(dict(dense=cache), mesh, b)["dense"]
            lc = _unstack(place_cache(dict(dense=cache), mesh, b)["dense"],
                          cs, 1)[0]
            plan.batch_entry = ("data",)
            dec, nc = plan.attention(
                tree, specs["attn"],
                [mesh.block_of(x1, rows, i).to(dev(i))
                 for i in range(mesh.size)],
                [posv.to(dev(i)) for i in range(mesh.size)], cache=lc,
                cache_pos=s)
            cat = lambda v: torch.cat([v[i].to(cuda) for i in first])
            return dict(out=cat(out).detach(),
                        grads=[t for _, t in _flatten(gp)] + [gx],
                        dec=cat(dec),
                        cache={k: mesh.assemble(v, lc[1][k])
                               for k, v in nc.items()}, wall=wall)

    devs = partitioned_groups(cuda)
    label = f"partitioned mla G={len(devs)} devices={[str(v) for v in devs]}"
    ref = whole()
    one = partitioned([cuda])
    got = partitioned(devs)
    names = ["/".join(p) for p, _ in _flatten(attn)] + ["x"]
    assert_equal(got["out"], one["out"], f"{label}: forward")
    assert_equal(got["dec"], one["dec"], f"{label}: decode")
    for k in ("ckv", "kr"):
        assert_equal(got["cache"][k], one["cache"][k], f"{label}: cache {k}")
    for n, a, c in zip(names, got["grads"], one["grads"]):
        assert_equal(a, c, f"{label}: grad {n}")
    errs = {}
    pairs = ([("out", got["out"], ref["out"]), ("decode", got["dec"],
                                                ref["dec"])]
             + [(f"cache {k}", got["cache"][k], ref["cache"][k][None])
                for k in ("ckv", "kr")]
             + [(f"grad {n}", a, c) for n, a, c in zip(names, got["grads"],
                                                       ref["grads"])])
    for n, a, c in pairs:
        errs[n] = max_err(a, c.reshape(a.shape))
        if not bool(torch.isfinite(a.float()).all()) or errs[n] > \
                LOSS_BF16_TOL * float(c.float().abs().max()):
            raise AssertionError(f"{label}: {n} max abs err {errs[n]} "
                                 f"against the whole layer")
    print(f"e2e {label} deepseek-v3-671b MLA (d_model {d}, {cfg.n_heads} "
          f"heads, q_lora {cfg.q_lora_rank}, kv_lora {cfg.kv_lora_rank}), "
          f"bf16, batch {b} x {s} on a (data 2, model 2) mesh: forward, "
          f"{len(names)} gradients and one absorbed decode step (output, "
          f"ckv, kr) bitwise with G=1 | max abs err against the whole layer: "
          f"out {errs['out']} decode {errs['decode']} cache ckv "
          f"{errs['cache ckv']} kr {errs['cache kr']} grads max "
          f"{max(v for k, v in errs.items() if k.startswith('grad'))} (bar "
          f"2e-2 of the largest magnitude) | forward+backward wall_s "
          f"{got['wall']} (one group {one['wall']}, whole layer "
          f"{ref['wall']}; first call) | {card}")
    print(f"partitioned mla: {time.perf_counter() - t0:.1f} s")


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


def dryrun_phase(card, cuda, seed) -> None:
    """The dry run (host only, meta tensors) of the partitioned step, one
    shard's program on the production mesh: minicpm-2b x train_4k on the
    single pod and deepseek-v3-671b x decode_32k on the multi pod, each
    with its per-device FLOPs, collective bytes by kind, ring wire bytes a
    device, temp and peak bytes a device beside the card's memory, and
    trace time (a train cell without an all-gather or a reduce-scatter
    fails); then its cross-check on the card (``dryrun_card_check``)."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import moe_ep
    t0 = time.perf_counter()
    card_total = torch.cuda.get_device_properties(cuda).total_memory
    try:
        for arch, shape, mp in (("minicpm-2b", "train_4k", False),
                                ("deepseek-v3-671b", "decode_32k", True)):
            r = run_cell(arch, shape, mp, verbose=False)
            coll = r.get("collective_bytes") or {}
            fits = r["mem"]["peak_bytes"] <= card_total
            if r["skipped"] or not r["hlo_flops"] > 0 or not (
                    r["mem"]["temp_bytes"] > 0) or (
                    shape.startswith("train") and not (
                        coll.get("all-gather") and coll.get("reduce-scatter"))):
                raise AssertionError(f"dryrun {arch} x {shape}: {r}")
            print(f"dryrun {arch} x {shape} x "
                  f"{'multi-pod' if mp else 'single-pod'} ({r['n_devices']} "
                  f"devices, one shard's program of the partitioned step, "
                  f"host only): hlo_flops_per_device={r['hlo_flops']} "
                  f"hlo_bytes_written_per_device={r['hlo_bytes_written']} "
                  f"collective_bytes={json.dumps(coll, sort_keys=True)} "
                  f"wire_bytes_per_device={r['wire_bytes_per_device']} "
                  f"trace_s={r['trace_s']} argument_bytes_per_device="
                  f"{r['mem']['argument_bytes']} output_bytes_per_device="
                  f"{r['mem']['output_bytes']} temp_bytes_per_device="
                  f"{r['mem']['temp_bytes']} peak_bytes_per_device="
                  f"{r['mem']['peak_bytes']} (this card holds {card_total}: "
                  f"{'fits' if fits else 'does not fit'}) model_params="
                  f"{r['model_params']}")
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    dryrun_card_check(card, cuda, seed)
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s")


def joined_peer_bytes(records, n: int) -> float:
    """The bytes the port's collectives copy between cards with n groups
    of one shard each, one on a card: each call joins the other n - 1
    shards' operands on the first card and sends their results back
    (``core/mesh.ShardMesh._stacked``).  ``records``: a program trace's
    ``(kind, one shard's result bytes, group)``; a shard's operand is the
    result over the group for a gather, times it for a reduce-scatter."""
    total = 0.0
    for kind, b, g in records:
        operand = (b / g if kind == "all-gather" else
                   b * g if kind == "reduce-scatter" else b)
        total += (n - 1) * (operand + b)
    return total


MEM_SLACK = 64 << 20                    # cuBLAS workspaces, 512 B rounding


def memory_pair(label, predicted: int, measured: int) -> tuple:
    """The live-bytes count's temp bytes against the card's: (the line's
    text, whether |predicted - measured| <= 10% of measured + 64 MiB)."""
    off = predicted - measured
    ok = abs(off) <= 0.1 * measured + MEM_SLACK
    return (f"{label}: predicted {predicted} measured {measured} (off "
            f"{off}, {off / max(measured, 1):+.2%}, "
            f"{'within' if ok else 'BEYOND'} 10% + 64 MiB)", ok)


def meta_temp(fn, args) -> int:
    """The meta trace's temp bytes of ``fn(*args)``: its peak live bytes
    above the inputs it was called on (``ProgramTrace.hold``)."""
    from repro_torch.launch.hlo_analysis import ProgramTrace
    with ProgramTrace() as trace:
        held = trace.hold(list(args))
        fn(*args)
    return trace.peak_bytes - held


def card_temp(fn, cuda) -> int:
    """``fn()``'s peak allocation on ``cuda`` above what it found."""
    _, base, peak = peak_over(fn, [cuda])
    return peak[0] - base[0]


def one_device_memory(card, cuda, seed) -> list:
    """The live-bytes count against the card's allocator on one card, each
    step after a warm-up call: the partitioned phase's train step as the
    one-device program (minicpm-2b at its widths, 2 layers, bf16 params,
    f32 AdamW, batch 8 x 128) and the donated decode of the decode-donated
    phase (4 layers, batch 4, a 32,768-deep cache), each beside its meta
    trace on the same shapes: ``memory_pair``s."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                          build_train_step)
    from repro_torch.models import ShapeCfg, init_cache, init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    flat = make_host_mesh(device=cuda)
    cfg = cut("minicpm-2b", 2)
    step_cfg = StepConfig(optimizer=AdamWConfig(state_dtype=torch.float32))
    fn, structs = build_train_step(cfg, ShapeCfg(
        "train", PART_SEQ, PART_BATCH, "train"), flat, step_cfg)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(seed),
                         device=cuda)
    state = adamw_init(params, step_cfg.optimizer)
    toks = torch.randint(0, cfg.vocab, (PART_BATCH, PART_SEQ + 1),
                         generator=torch.Generator(device=cuda).manual_seed(
                             seed), device=cuda, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    fn(params, state, batch)
    train = card_temp(lambda: fn(params, state, batch), cuda)
    del params, state
    lines = [memory_pair(f"train step, one-device program ({widths(cfg)}, "
                         f"bf16 params, f32 AdamW state, remat full, batch "
                         f"{PART_BATCH} x {PART_SEQ})",
                         meta_temp(fn, structs), train)]
    dcfg = cut("minicpm-2b", DON_LAYERS)
    serve, ds = build_decode_step(dcfg, ShapeCfg(
        "decode_32k", DON_CACHE, DON_BATCH, "decode"), flat,
        StepConfig(serving_head_pad=False))
    params = init_params(dcfg, torch.Generator(device=cuda).manual_seed(
        seed), device=cuda)
    cache = init_cache(dcfg, DON_BATCH, DON_CACHE, device=cuda)
    tok = toks[:DON_BATCH, :1].contiguous()
    pos = DON_CACHE // 2
    serve(params, cache, tok, pos)
    decode = card_temp(lambda: serve(params, cache, tok, pos + 1), cuda)
    del params, cache
    lines.append(memory_pair(
        f"donated decode (minicpm-2b, {depth(dcfg)}, bf16, batch "
        f"{DON_BATCH}, cache {DON_CACHE} deep)",
        meta_temp(serve, [ds[0], ds[1], ds[2], pos + 1]), decode))
    return lines


def dryrun_card_check(card, cuda, seed) -> None:
    """The partitioned phase's train step (minicpm-2b at its widths, 2
    layers, bf16 params, f32 AdamW state, batch 8 x 128, a (data 2, model
    2) mesh in four device groups, ``partitioned_groups``) once on the card
    under ``ProgramTrace``, every shard executing, and the same step traced
    on the one-shard meta mesh (``MeshSpec``, as the dry run builds it):
    the collective records (kind, shard bytes, group) equal as multisets,
    and the dot FLOPs a device equal to the card trace's over 4, exactly.
    Prints the peer-copy bytes those records imply for the port's joins on
    card 0 with a group a card on four cards (``joined_peer_bytes``) beside
    the peer bytes one such step moves, measured (``card_trace``) where
    four cards hold the groups (``dryrun card`` line; a printed pair, no
    bar).  Then the memory count against the card's allocator
    (``dryrun card memory`` lines): on one card, ``one_device_memory``;
    where four cards hold the groups, the one-shard trace's temp bytes
    against each card's peak above what the partitioned step (warm: it ran
    above) found, cards 1-3 held to the bar, card 0 (the joins of
    ``core/mesh.py`` too) printed beside them."""
    from collections import Counter
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.launch.hlo_analysis import ProgramTrace, analyze
    from repro_torch.launch.mesh import MeshSpec, make_host_mesh
    from repro_torch.launch.sharding import (param_specs, place_batch,
                                             place_params)
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, init_params, moe_ep
    from repro_torch.optim import AdamWConfig, adamw_init
    t0 = time.perf_counter()
    cfg = cut("minicpm-2b", 2)
    devs = partitioned_groups(cuda)
    mesh = make_host_mesh(model=2, data=2, devices=devs)
    step_cfg = StepConfig(optimizer=AdamWConfig(state_dtype=torch.float32))
    shape = ShapeCfg("train", PART_SEQ, PART_BATCH, "train")
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        PART_BATCH, PART_SEQ + 1)).astype(np.int32)).to(cuda)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    try:
        fn, structs = build_train_step(cfg, shape, mesh, step_cfg)
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(
            seed), device=cuda)
        pm = place_params(params, mesh, param_specs(structs[0], mesh))
        st = place_params(adamw_init(params, step_cfg.optimizer), mesh,
                          param_specs(structs[1], mesh))
        pb = place_batch(batch, mesh)
        del params
        sync()
        t1 = time.perf_counter()
        with ProgramTrace() as on_card:
            fn(pm, st, pb)
        sync()
        card_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        spec = MeshSpec({"data": 2, "model": 2})
        mfn, mstructs = build_train_step(cfg, shape, spec, step_cfg)
        placed = place_inputs("train", mfn.plan, spec, PART_BATCH,
                              list(mstructs))
        with ProgramTrace() as one:
            held = one.hold(placed)
            mfn(*placed)
        meta_s = time.perf_counter() - t1
        n_cards = len(set(devs))
        peer = (card_trace(lambda: fn(pm, st, pb))[2] if n_cards >= 4
                else None)
        if n_cards >= 4:
            _, base, peak = peak_over(lambda: fn(pm, st, pb), devs)
            per_card = [p - b for p, b in zip(peak, base)]
        del pm, st, pb
        memory = one_device_memory(card, cuda, seed)
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    label = f"G={mesh.n_groups} devices={[str(d) for d in devs]}"
    if Counter(one.collectives) != Counter(on_card.collectives):
        raise AssertionError(
            f"dryrun card {label}: collective records differ: card "
            f"{sorted(Counter(on_card.collectives).items())} one-shard "
            f"{sorted(Counter(one.collectives).items())}")
    got, want = analyze(one), analyze(on_card)
    if got["dot_flops"] != want["dot_flops"] / mesh.size:
        raise AssertionError(f"dryrun card {label}: one-shard dot FLOPs "
                             f"{got['dot_flops']} against the card's "
                             f"{want['dot_flops']} / {mesh.size}")
    kinds = dict(sorted(Counter(k for k, _, _ in one.collectives).items()))
    implied = joined_peer_bytes(one.collectives, 4)
    measured = (f"{peer} (one profiled step, a group a card on {n_cards} "
                f"cards)" if peer is not None else
                f"not measured ({n_cards} card(s) hold the groups; needs "
                f"four)")
    print(f"dryrun card {label} {widths(cfg)}, bf16 params, f32 AdamW "
          f"state, remat full) on a (data 2, model 2) mesh batch "
          f"{PART_BATCH} x seq {PART_SEQ}, the train step: "
          f"{len(one.collectives)} collective records {kinds} equal as "
          f"multisets, the card's trace (every shard executing, "
          f"{card_s:.2f} s) and the one-shard meta trace ({meta_s:.2f} s) | "
          f"dot_flops_per_device={got['dot_flops']} = card total "
          f"{want['dot_flops']} / {mesh.size} | collective_bytes="
          f"{json.dumps(got['coll_bytes'], sort_keys=True)} "
          f"wire_bytes_per_device={got['wire_bytes_per_device']} | peer "
          f"bytes a step implied by the records for a group a card on four "
          f"cards {implied}; measured {measured} | {card}")
    temp = one.peak_bytes - held
    if n_cards >= 4:
        memory += [memory_pair(
            f"partitioned train step, a group a card, {devs[g]}", temp,
            per_card[g]) for g in range(1, 4)]
        memory.append((f"{devs[0]} (group 0 and the joins): predicted for "
                       f"its shard {temp} measured {per_card[0]} (no bar)",
                       True))
    else:
        memory.append((f"partitioned train step, a group a card: not "
                       f"measured ({n_cards} card(s); needs four), the "
                       f"one-shard trace's temp {temp}", True))
    for text, _ in memory:
        print(f"dryrun card memory {text} | {card}")
    beyond = [text for text, ok in memory if not ok]
    if beyond:
        raise AssertionError(f"dryrun card memory beyond the bar: {beyond}")
    print(f"dryrun card check: {time.perf_counter() - t0:.1f} s")


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


# the phases that take (card, cuda, seed) and launch none of the kernels:
# ``--phase NAME`` runs one alone
ALONE = {"mamba": mamba_phase, "ep": ep_phase,
         "partitioned": partitioned_phase,
         "partitioned_hybrid": partitioned_hybrid_phase,
         "sp": sp_phase, "decode_donated": donate_decode_phase,
         "serve_padded": serve_padded_phase, "dryrun": dryrun_phase}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase", choices=sorted(ALONE),
                    help="run this one phase alone (no kernel build, no "
                         "result lines) and exit")
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
    if args.phase:
        ALONE[args.phase](card, cuda, args.seed)
        return 0

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
    cards = "; ".join(card_lines())
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
    cards_phase({**stream, **lock["data"]}, cards, cuda, launches, args.seed)
    baseline_phase(stream, card, cuda, launches)
    pipeline_phase(card, cuda, launches, args.seed)
    train_phase(card, cuda, launches, args.seed)
    serve_phase(card, cuda, launches, args.seed)
    mamba_phase(card, cuda, args.seed)
    ep_phase(card, cuda, args.seed)
    partitioned_phase(card, cuda, args.seed)
    partitioned_hybrid_phase(card, cuda, args.seed)
    sp_phase(card, cuda, args.seed)
    donate_decode_phase(card, cuda, args.seed)
    serve_padded_phase(card, cuda, args.seed)
    dryrun_phase(card, cuda, args.seed)
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
