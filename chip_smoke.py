#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py [--seed N]

1. Prints the card (nvidia-smi name and power limit, torch's device name).
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed as set-up).
3. Kernel phase: at the main path's shapes, holds each kernel against its
   plain-PyTorch twin on the card (radix_partition and the megakernel
   bitwise, the segscans to rtol = atol = 1e-5) and times both with CUDA
   events; runs each kernel at two other block sizes, which must change no
   bit; and prints the rung that ``restructure_method="auto"`` resolves to
   at these shapes.
4. End-to-end phase: ``DualModeEngine.run_stream(fused=True)`` on the card
   for GS (10,000 keys, theta 0.6, megakernel rung) and TP (100 segments,
   theta 0.2, partition rung), 200 intervals of 500 events each, with the
   launch counters set to 0 just before each run and read just after; every
   kernel must have launched.  The final state is held against the port's
   CPU run of the same seeded stream (GS bitwise, TP rtol 1e-5) and the
   post-processed outputs to rtol = atol = 1e-5; a small stream is held
   against the sequential ``lock`` oracle on the CPU.
5. Prints one JSON line of kernel numbers, the card line again, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Without a CUDA card it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
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
    from repro_torch.core.engines import simple_affine_luts, tstream_scan_plan
    from repro_torch.core.restructure import (megakernel_engaged, restructure,
                                              restructure_path)

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
        auto = ("megakernel" if megakernel_engaged(
            n, k, method="auto", has_max=any(store.table_is_max),
            funs_simple=simple_affine_luts(app.funs, dev) is not None)
            else restructure_path(n, store.pad_uid, rowmajor_ts=True))
        print(f"auto rung {name}: {n} rows per interval over {k} buckets "
              f"resolve to {auto!r}; the main path forces {method!r} "
              "(\"auto\" reads the cpu rows of LADDER_BOUNDS/MEGA_BOUNDS)")
        if name == "tp":
            out[name]["plan"] = tstream_scan_plan(store, ops, app.funs,
                                                  prestructured=pres,
                                                  use_kernels=False)
    return out


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
        bn, n = keys.shape
        print(f"kernel radix_partition[{name}] keys={list(keys.shape)} K={k}: "
              f"max_abs_err=0 ms={ms} plain_ms={plain} host_ms={host}")
        rad["ms"] += ms
        rad["plain_ms"] += plain
        rad["bytes"] += 4.0 * (2 * bn * n + bn * k)
        rad["ops"] += float(bn * n)
    rows["radix_partition"] = dict(
        replaces="src/repro/kernels/radix_partition/kernel.py:78",
        source="src/repro_torch/csrc/radix_partition.cu", ms=rad["ms"],
        plain_ms=rad["plain_ms"], err=rad["err"],
        bound=bound(rad["bytes"], rad["ops"]))

    # segscan affine / max: TP's flattened stream [400,000, 32]; 1e-5
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
    for what, x, y in (("A", A1, A0), ("B", B1, B0), ("M", M1, M0)):
        assert_close(x.cpu().numpy(), y.cpu().numpy(), f"segscan {what}")
    for name, fn, ref, err, nb, nops in (
            ("segscan_affine", lambda: segscan_affine(a, b, flags),
             lambda: segscan_affine_ref(flags, a, b),
             max(max_err(A1, A0), max_err(B1, B0)),
             n + 16.0 * n * w, 3.0 * n * w),
            ("segscan_max", lambda: segscan_max(m, flags),
             lambda: segscan_max_ref(flags, m), max_err(M1, M0),
             n + 8.0 * n * w, 1.0 * n * w)):
        ms, host = cuda_ms(fn, 20)
        plain, _ = cuda_ms(ref, 3)
        print(f"kernel {name} rows={n} W={w}: max_abs_err={err} ms={ms} "
              f"plain_ms={plain} host_ms={host}")
        rows[name] = dict(
            replaces=("src/repro/kernels/segscan/kernel.py:130"
                      if name == "segscan_affine" else
                      "src/repro/kernels/segscan/kernel.py:151"),
            source="src/repro_torch/csrc/segscan.cu", ms=ms, plain_ms=plain,
            err=err, bound=bound(nb, nops))

    # megakernel: one GS interval (5,000 rows, W = 1, 10,001 slots); bitwise
    store = p["gs"]["store"]
    sops_all, ch_all = p["gs"]["pres"]
    sops, ch = tree_index(sops_all, 0), tree_index(ch_all, 0)
    a_lut, b_lut = simple_affine_luts(p["gs"]["app"].funs, store.device)
    v1 = store.values.clone()
    res1, v1, _ = fused_chain_eval(v1, sops, ch, store.pad_uid,
                                   a_lut=a_lut, b_lut=b_lut)
    res0, v0, _ = fused_chain_eval_ref(store.values.clone(), sops, ch,
                                       store.pad_uid, a_lut=a_lut,
                                       b_lut=b_lut)
    torch.cuda.synchronize()
    assert_equal(v1, v0, "megakernel values")
    for k in res0:
        assert_equal(res1[k], res0[k], f"megakernel {k}")
    scratch = store.values.clone()
    ms, host = cuda_ms(lambda: fused_chain_eval(
        scratch, sops, ch, store.pad_uid, a_lut=a_lut, b_lut=b_lut), 50)
    plain, _ = cuda_ms(lambda: fused_chain_eval_ref(
        store.values, sops, ch, store.pad_uid, a_lut=a_lut, b_lut=b_lut), 10)
    n, w = sops.operand.shape
    s = store.values.shape[0]
    steps = math.ceil(math.log2(n)) if n > 1 else 0
    # Least bytes of this interval: per row its flag, valid, fun and uid
    # (10 B) and its operand, pre and post (12 B a lane); per chain one
    # gather of its slot, and per chain other than the pad's one commit;
    # the pad slot's zeroing and the LUTs.
    chains = int(ch.n_chains)
    commits = int((ch.counts[:store.pad_uid] > 0).sum())
    mk_bytes = (10.0 * n + 12.0 * n * w + 4.0 * (chains + commits + 1) * w
                + 5.0 * a_lut.numel())
    print(f"kernel megakernel rows={n} W={w} slots={s} chains={chains}: "
          f"max_abs_err=0 ms={ms} plain_ms={plain} host_ms={host} "
          f"bytes={mk_bytes}")
    rows["megakernel"] = dict(
        replaces="src/repro/kernels/megakernel/kernel.py:119",
        source="src/repro_torch/csrc/megakernel.cu", ms=ms, plain_ms=plain,
        err=0.0, bound=bound(mk_bytes, 3.0 * steps * n * w + 8.0 * n * w))

    block_size_check(p, plan, (sops, ch, a_lut, b_lut))
    return rows


def block_size_check(p, plan, mega) -> None:
    """Each kernel at block sizes other than its default, as
    ``EngineConfig.kernel_block_params`` sets them: no bit may change."""
    from repro_torch.kernels.megakernel.ops import fused_chain_eval
    from repro_torch.kernels.radix_partition.ops import radix_partition_rank
    from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max

    keys, k = p["gs"]["keys"], p["gs"]["store"].pad_uid + 1
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
                                      b_lut=b_lut)[:2])
    for threads in (64, 512):
        got = dict(radix=radix_partition_rank(keys, k, threads=threads),
                   affine=segscan_affine(a, b, flags, threads=threads),
                   max=(segscan_max(m, flags, threads=threads),),
                   mega=fused_chain_eval(store.values.clone(), sops, ch,
                                         store.pad_uid, a_lut=a_lut,
                                         b_lut=b_lut, threads=threads)[:2])
        for name, outs in got.items():
            for i, (x, y) in enumerate(zip(outs, base[name])):
                pairs = ([(x[j], y[j]) for j in y] if isinstance(y, dict)
                         else [(x, y)])
                for u, v in pairs:
                    assert_equal(u, v, f"{name} output {i} at {threads} "
                                 "threads per block")
    print("block sizes: radix_partition, segscan_affine, segscan_max and the "
          "megakernel at 64 and 512 threads per block equal their default "
          "runs bit for bit")


def run(app_name, method, stream, dev):
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig
    app = ALL_APPS[app_name]
    store = app.make_store(device=dev)
    eng = DualModeEngine(app, store, EngineConfig(restructure_method=method),
                         device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, values = eng.run_stream(store.values, stream, INTERVAL, fused=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return outs, values.cpu(), time.perf_counter() - t0


def end_to_end(stream, card, cuda) -> dict:
    from repro_torch import LAUNCHES, reset_launches
    cpu = torch.device("cpu")
    launches = {k: 0 for k in LAUNCHES}
    for app_name, method in (("gs", "megakernel"), ("tp", "partition")):
        reset_launches()
        outs, values, wall = run(app_name, method, stream[app_name], cuda)
        got = dict(LAUNCHES)
        print(f"e2e {app_name} rung={method} intervals={N_INTERVALS}x"
              f"{INTERVAL}: wall_s={wall} events_per_s="
              f"{N_INTERVALS * INTERVAL / wall} launches={got} card={card}")
        for k, v in got.items():
            launches[k] += v
        outs_c, values_c, wall_c = run(app_name, method, stream[app_name], cpu)
        print(f"e2e {app_name} cpu reference: wall_s={wall_c}")
        if not torch.isfinite(values).all():
            raise AssertionError(f"{app_name}: non-finite final state")
        if app_name == "gs":
            assert_equal(values, values_c, "gs final state vs CPU run")
        else:
            assert_close(values, values_c, "tp final state vs CPU run")
        if len(outs) != N_INTERVALS or len(outs_c) != N_INTERVALS:
            raise AssertionError(f"{app_name}: {len(outs)} intervals out")
        for i, (o, oc) in enumerate(zip(outs, outs_c)):
            for k in oc:
                if o[k].shape != (INTERVAL,):
                    raise AssertionError(f"{app_name} {k}: shape {o[k].shape}")
                assert_close(o[k], oc[k], f"{app_name} interval {i} {k}")
        print(f"e2e {app_name}: state and outputs agree with the CPU run "
              f"(state max abs err {max_err(values, values_c)})")
    needed = {"radix_partition", "segscan_affine", "segscan_max",
              "megakernel"}
    missing = sorted(k for k in needed if launches[k] <= 0)
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    return launches


def profile_phase(stream, cuda) -> None:
    """One more run of each app under torch.profiler: the device's busy
    share of the wall time and the kernels that take it (the profiler's own
    cost lengthens the wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for app_name, method in (("gs", "megakernel"), ("tp", "partition")):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, wall = run(app_name, method, stream[app_name], cuda)
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev) / 1e6
        if busy <= 0:
            print(f"profile {app_name}: wall_s={wall} device time not "
                  "measured (the profiler saw no CUDA activity)")
            continue
        top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
        print(f"profile {app_name}: wall_s={wall} device_busy_s={busy} "
              f"busy_share={busy / wall} top: " + "; ".join(
                  f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
                  f"x{e.count}" for e in top))


def oracle_check(cuda) -> None:
    """A small stream on the card against the sequential lock schedule."""
    from repro_torch.apps import ALL_APPS
    from repro_torch.core.scheduler import DualModeEngine, EngineConfig
    for app_name, method in (("gs", "megakernel"), ("tp", "partition")):
        app = ALL_APPS[app_name]
        stream = app.gen_events(np.random.default_rng(7), 256)
        got = DualModeEngine(app, app.make_store(device=cuda),
                             EngineConfig(restructure_method=method),
                             device=cuda)
        ref = DualModeEngine(app, app.make_store(device="cpu"),
                             EngineConfig(scheme="lock"), device="cpu")
        o1, v1 = got.run_stream(got.init_store.values, stream, 64)
        o0, v0 = ref.run_stream(ref.init_store.values, stream, 64)
        assert_close(v1.cpu(), v0, f"{app_name} vs lock oracle: state")
        for a, b in zip(o1, o0):
            for k in b:
                assert_close(a[k], b[k], f"{app_name} vs lock oracle: {k}")
        print(f"oracle {app_name}: 4 x 64 events on the card match the "
              "sequential lock schedule")


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
    launches = end_to_end(stream, card, cuda)
    profile_phase(stream, cuda)

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
