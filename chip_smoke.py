#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

Run from the repository root:  python3 chip_smoke.py [--seed N]

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed as set-up).
3. Kernel phase: at the main paths' shapes, holds each kernel against its
   plain-PyTorch twin on the card (radix_partition, the megakernel,
   hash_probe and segscan_max bitwise; segscan_affine to rtol = atol =
   1e-5; a second segscan call equal to the first) and times both
   with CUDA events; runs each kernel at 64, 512 and 1024 threads per
   block, which must change no bit; and prints the rung that
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
8. Every driven run of phases 4 to 7 follows one uncounted warm-up run of
   the same engine and stream, sets the launch counters to 0 just before it
   and reads them just after; every kernel must have launched, and each
   run must take the rung its plan names (``DualModeEngine.last_rung``).
   Each run prints an ``e2e`` line (wall s, events/s, launches, exchange
   stats); those of phases 4, 5 and 7 also a ``profile`` line: the device's
   busy share of one more, profiled run.  The warm-up runs record the
   launch shapes of radix_partition and the segscans, each timed alone in
   a ``shape`` line with its bound and share of the bound; each of their
   radix_partition calls (every path the kernel picks by shape) is held
   bitwise against its twin and at 64, 512 and 1024 threads per block
   (``hold`` lines).
9. Prints one JSON line of kernel numbers, the card line again, and last
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
    rops, _, _, cap = sh.route(events_to_torch(gs["events"], dev))
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
    (keys [bn, n] over k buckets, or coefficient rows [n, W]): each input
    read once, each output written once."""
    if kernel == "radix_partition":     # keys in; ranks and counts out
        bn, n = x.shape
        return 4.0 * (2 * bn * n + bn * k), float(bn * n)
    n, w = x.shape                      # flags and coefficients in; scans out
    if kernel == "segscan_affine":
        return n + 16.0 * n * w, 3.0 * n * w
    return n + 8.0 * n * w, 1.0 * n * w


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


def mega_work(values, sops, ch, pad_uid, n_luts):
    """(bytes, operations) of one megakernel call on this data.

    Bytes: each input of the function read once and each output written
    once: per row its chain-start flag, valid, fun, uid and flat position
    (14 B) and its success flag (1 B); per row and lane its operand, pre
    and post (12 B); the state in and out (8 B a slot and lane); the LUTs.
    The slot histograms are left out: the function finds each chain's end
    from the flags, and only this design reads them.  Operations: the
    scan's 3 per row, lane and step for the ceil(log2 L) steps this data
    needs (L each interval's longest chain other than the pad chain, or
    the pad chain where a row of it is valid), 8 per row and lane to
    compose and apply, 2 per touched slot and lane for the carry."""
    w = values.shape[-1]
    rows = sops.uid.numel()
    pad_valid = (sops.valid & (sops.uid == pad_uid)).any(dim=-1)
    longest = torch.maximum(
        ch.counts[..., :pad_uid].amax(dim=-1),
        torch.where(pad_valid, ch.counts[..., pad_uid], 0)).double()
    steps = torch.ceil(torch.log2(torch.clamp(longest, min=1)))
    n = sops.uid.shape[-1]
    touched = int((ch.counts[..., :pad_uid] > 0).sum())
    nbytes = (15.0 * rows + 12.0 * rows * w + 8.0 * values.numel()
              + 5.0 * n_luts)
    n_ops = (3.0 * float(steps.sum()) * n * w + 8.0 * rows * w
             + 2.0 * touched * w)
    return nbytes, n_ops


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
    nbytes, n_ops = mega_work(values, sops, ch, pad_uid, a_lut.numel())
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
    bnd = bound(*mega_work(values, sops, ch, pad_uid, a_lut.numel()))
    print(f"kernel megakernel[{label}] problems x rows = "
          f"{list(sops.uid.shape[1:])} W={values.shape[-1]}: max_abs_err=0 "
          f"ms={ms} plain_ms={plain} host_ms={host} bound_ms={bnd[0]}")
    return dict(ms=ms, plain_ms=plain, bound=bnd)


def hash_probe_row(sh) -> dict:
    """hash_probe at GS's probe shape: every op's uid of the 200 x 500 event
    stream (1,000,000 queries) against the 2,500 x 8 table; bitwise."""
    from repro_torch.kernels.hash_probe.ops import hash_probe
    from repro_torch.kernels.hash_probe.ref import (ASSOC, MAX_PROBES,
                                                    bucket_of, hash_probe_ref)

    table, q = sh["table"], sh["queries"]
    s1 = hash_probe(q, table)
    s0 = hash_probe_ref(q, table)
    torch.cuda.synchronize()
    assert_equal(s1, s0, "hash_probe slots")
    if bool((s0 < 0).any()):
        raise AssertionError("hash_probe: a uid of the store was not found")
    ms, host = cuda_ms(lambda: hash_probe(q, table), 50)
    plain, _ = cuda_ms(lambda: hash_probe_ref(q, table), 5)
    n, n_buckets = q.shape[0], table.shape[0]
    # Operations this data needs: per query the hash (multiply, shift,
    # modulo), per probe made a bucket index (add, modulo), and the compares
    # up to the matching way; counted against the f32 rate.
    hit = s0.long()
    probes = (hit // ASSOC - bucket_of(q, n_buckets).long()) % n_buckets + 1
    compares = (probes - 1) * ASSOC + hit % ASSOC + 1
    n_ops = float((3 + 2 * probes + compares).sum())
    assert int(probes.max()) <= MAX_PROBES
    nbytes = 8.0 * n + 4.0 * table.numel()
    bnd = bound(nbytes, n_ops)
    print(f"kernel hash_probe queries={n} table={list(table.shape)}: "
          f"max_abs_err=0 ms={ms} plain_ms={plain} host_ms={host} "
          f"bytes={nbytes} ops={n_ops} bound_ms={bnd[0]} share_of_bound="
          f"{bnd[0] / ms} probes_mean={float(probes.double().mean())}")
    return dict(replaces="src/repro/kernels/hash_probe/kernel.py:62",
                source="src/repro_torch/csrc/hash_probe.cu", ms=ms,
                plain_ms=plain, err=0.0, bound=bnd)


def block_size_check(p, plan, mega) -> None:
    """Each kernel at block sizes other than its default, as
    ``EngineConfig.kernel_block_params`` sets them: no bit may change.
    radix_partition here at GS's shape (the block sort); every driven
    run's radix calls, at every path, go through ``hold_radix`` too."""
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
    for threads in (64, 512, 1024):
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
          "megakernel (GS's stream and sharded GS's) and hash_probe at 64, 512 "
          "and 1024 threads per block equal their default runs bit for bit")


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
           probe=False, n_keys=None, **cfg_kw):
    """An engine on ``dev``; ``n_keys`` sizes a GS store other than the
    app's 10,000 records; ``cfg_kw`` sets more of its EngineConfig."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig
    app = ALL_APPS[app_name]
    cfg = EngineConfig(restructure_method=method, use_hash_probe_route=probe,
                       **cfg_kw)
    store = (app.make_store(device=dev) if n_keys is None else
             app.make_store(n_keys, device=dev))
    return DualModeEngine(app, store, cfg, device=dev, mesh=mesh,
                          layout=layout)


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
    kernel at 64, 512 and 1024 threads per block equal to it.  The shape
    picks the kernel's path (a warp per row, one counter pass, or the block
    sort), so the driven runs hold each path they take."""
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
        for threads in (64, 512, 1024):
            r1, c1 = fn(keys, k, **{**kw, "threads": threads})
            assert_equal(r1, rank, f"{what}: rank at {threads} threads")
            assert_equal(c1, counts, f"{what}: counts at {threads} threads")
        shapes.append(f"{list(keys.shape)} K={k}")
    if shapes:
        print(f"hold radix_partition[{label}]: {'; '.join(shapes)} bitwise "
              "with the twin, and at 64, 512 and 1024 threads per block")


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


def lockstep_phase(card, cuda, launches, seed) -> None:
    """SL and OB through the lockstep path on the card, forced "partition"
    and "auto", and SL's abort repass on an overdrawn stream: each bitwise
    with the port's CPU run of the same stream (state, outputs, per-op
    pre/post/success)."""
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
    lockstep_phase(card, cuda, launches, args.seed)
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
