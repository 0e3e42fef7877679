"""Dual-mode scheduling (paper §IV-B, D1) on one device.

Reference: ``repro/core/scheduler.py``.  One engine *step* processes one
punctuation interval:

  compute mode      batched PRE_PROCESS + op registration into blotters
  state-access mode restructure + evaluate the postponed transaction batch
  compute mode      batched POST_PROCESS over stored events + access results

Two drivers share the per-interval logic:

* ``run_stream(fused=False)`` — the host loop: one step per interval.
* ``run_stream(fused=True)``  — the stream is reshaped to ``[n_intervals,
  interval, ...]``; compute mode, the restructure plan and (on the
  associative path) the coefficient scans run once for all intervals, and
  only the values-dependent evaluation loops over intervals, carrying the
  state.  The reference's ``lax.scan`` is that Python loop; on the
  megakernel rung it is one megakernel call for the whole stream.  Other
  apps and schemes (the lockstep path, the baselines) take the generic
  branch: one restructure for the stream, then one evaluation per interval.

The engine runs on the CUDA card unless built with ``device="cpu"``.  Built
with a ``mesh`` (``core/mesh.ShardMesh``) it runs the sharded fused driver
instead (``core/sharded_stream``).

The chunked service API (``runtime/service.py``) drives the same fused
program one chunk of K intervals at a time: ``run_stream_chunk`` takes the
carry and ``[K, interval, ...]`` device columns and returns the next carry,
so K-chunked execution is the monolithic run's schedule, bit for bit;
``ensure_variant`` binds a scheme/rung plan variant for the controller.  On
a sharded engine the carry is the ownership-block layout
(``carry_in``/``carry_out``), and ``apply_resharding`` migrates it live onto
a new placement between chunks.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import convert
from ..kernels import autotune
from ..kernels.megakernel.ops import fused_chain_eval
from ..kernels.megakernel.ref import fused_chain_stream_ref
from ..kernels.runtime import resolve_device, smem_optin
from .blotter import AppSpec, build_opbatch
from .engines import (CHAIN_SCHEMES, EngineStats, evaluate,
                      simple_affine_luts, tstream_scan_coefs,
                      tstream_scan_execute, tstream_scan_plan)
from .restructure import megakernel_engaged, restructure, restructure_path
from .types import OpResults, StateStore, tree_index


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    scheme: str = "tstream"
    n_partitions: int = 16      # pat's partitions
    max_dep_levels: int = 3     # lockstep levels before the sequential sweep
    # re-run an interval with its aborted transactions masked (§IV-C2)
    abort_repass: bool = False
    # launch the hand-written kernels (on a CUDA tensor; a CPU tensor takes
    # each kernel's plain twin); False runs the plain PyTorch path throughout
    use_kernels: bool = True
    # restructure backbone: "auto" resolves the partition -> packed-sort ->
    # lexsort ladder; "megakernel" forces the fused chain-evaluation rung
    restructure_method: str = "auto"
    # threads per block for a kernel, as (kernel, value) pairs, e.g.
    # (("segscan", 128), ("radix_partition", 512)); () keeps the defaults
    kernel_block_params: tuple = ()
    # sharded streaming: resolve uid -> owner through the hash-probe kernel
    # instead of the direct-addressed gather (DESIGN.md §2.5)
    use_hash_probe_route: bool = False

    def block_param(self, kernel: str):
        return dict(self.kernel_block_params).get(kernel)


class DualModeEngine:
    """The TStream engine bound to one application, on one device.

    With ``mesh`` the engine is shard-parallel: the ownership permutation
    and routing tables are built once here, and ``run_stream`` runs the
    whole stream through the sharded fused driver on the mesh's shards.
    The mesh's device must be the engine's.
    """

    def __init__(self, app: AppSpec, store: StateStore,
                 cfg: EngineConfig = EngineConfig(), *, device=None,
                 mesh=None, layout: str = "shared_nothing",
                 exchange_slack: float = 2.0):
        self.app = app
        self.cfg = cfg
        self.device = resolve_device(device)
        self.init_store = store.to(self.device)
        self._sharded = None
        self.last_exchange_stats = None
        # the rung the last fused run took: "megakernel" or the
        # restructure backbone ("partition", "packed" or "lexsort"); None
        # for a scheme that restructures nothing
        self.last_rung = None
        # the per-interval EngineStats of the last single-device fused run
        self.last_stats = None
        # the fused program, and its scheme/rung plan variants (adaptive
        # control plane, DESIGN.md §2.9), selectable per chunk
        self._fused = functools.partial(_fused_impl, app=app, cfg=cfg,
                                        store=self.init_store)
        self._variants: Dict[Tuple[str, str], functools.partial] = {}
        if mesh is not None:
            if mesh.device != self.device:
                raise ValueError(f"mesh on {mesh.device}, engine on "
                                 f"{self.device}: they must be the same")
            from .sharded_stream import ShardedStream
            self._sharded = ShardedStream(app, self.init_store, cfg, mesh,
                                          layout,
                                          exchange_slack=exchange_slack)

    def step(self, values: torch.Tensor, events: Dict, ts_base: int
             ) -> Tuple[Dict, torch.Tensor, EngineStats]:
        """Process one punctuation interval. Returns (outputs, values', stats).
        Records the interval's restructure backbone in ``last_rung`` (None
        for a scheme that restructures nothing)."""
        values = torch.as_tensor(values, dtype=torch.float32).to(self.device)
        store = dataclasses.replace(self.init_store, values=values)
        n_rows = len(next(iter(events.values()))) * self.app.max_ops
        self.last_rung = (restructure_path(
            n_rows, store.pad_uid, rowmajor_ts=True,
            method=self.cfg.restructure_method,
            device_kind=autotune.kind_of(self.device))
            if self.cfg.scheme in CHAIN_SCHEMES else None)
        res, ebs, values, stats = _step_impl(
            store, convert.events_to_torch(events, self.device), ts_base,
            app=self.app, cfg=self.cfg)
        outs = self._outs(_stack([res]), _stack([ebs]), 1)
        return outs[0], values, stats

    def run_stream(self, values, event_stream: Dict[str, np.ndarray],
                   punct_interval: int, fused: bool = True):
        """Drive an event stream punctuation by punctuation.

        ``values`` is the initial state ``[S+1, W]``; it is copied once and
        the copy carries the state (the caller's tensor is left as it was).
        ``event_stream`` holds numpy columns; a trailing partial interval is
        dropped.  Returns ``(outputs, values')``: a list with one dict of
        numpy arrays per interval, and the final state on the engine's
        device.  Both drivers give the same outputs and final state.

        An engine built with a ``mesh`` runs the sharded fused driver
        (fused only); its exchange stats land in ``last_exchange_stats``
        and overflow drops are logged.  A fused run records its rung in
        ``last_rung`` and, on one device, its per-interval stats in
        ``last_stats``.
        """
        values = torch.as_tensor(values, dtype=torch.float32).to(
            self.device, copy=True)
        self.last_rung = None
        if self._sharded is not None:
            if not fused:
                raise ValueError("the sharded run_stream has no unfused "
                                 "host loop: pass fused=True")
            outs, values = self._sharded.run_stream(values, event_stream,
                                                    punct_interval)
            self.last_exchange_stats = self._sharded.last_stats
            self.last_rung = self._sharded.last_rung
            return outs, values
        n = len(next(iter(event_stream.values())))
        n_intervals = n // punct_interval
        if n_intervals == 0:
            return [], values
        if not fused:
            res_l, ebs_l = [], []
            for i in range(n_intervals):
                sl = slice(i * punct_interval, (i + 1) * punct_interval)
                batch = convert.events_to_torch(
                    {k: np.asarray(v)[sl] for k, v in event_stream.items()},
                    self.device)
                store = dataclasses.replace(self.init_store, values=values)
                res, ebs, values, _ = _step_impl(store, batch,
                                                 i * punct_interval,
                                                 app=self.app, cfg=self.cfg)
                res_l.append(res)
                ebs_l.append(ebs)
            return self._outs(_stack(res_l), _stack(ebs_l), n_intervals), values

        batched = {}
        for k, v in event_stream.items():
            v = np.asarray(v)[: n_intervals * punct_interval]
            batched[k] = v.reshape((n_intervals, punct_interval) + v.shape[1:])
        res_all, ebs_all, values, self.last_stats, self.last_rung = \
            _fused_impl(values, convert.events_to_torch(batched, self.device),
                        0, app=self.app, cfg=self.cfg, store=self.init_store)
        return self._outs(res_all, ebs_all, n_intervals), values

    # -- chunked service API (runtime/service.py; DESIGN.md §2.6/§2.9) -----
    def ensure_variant(self, scheme: Optional[str] = None,
                       restructure_method: Optional[str] = None):
        """Bind a plan variant with scheme/rung overridden.

        Returns the key to pass to :meth:`run_stream_chunk`, or None when
        the requested plan is the construction plan.  Idempotent.
        Single-device only: the sharded driver's lattice is {exchange
        slack, chunk size}.
        """
        sch = scheme or self.cfg.scheme
        rung = restructure_method or self.cfg.restructure_method
        if (sch, rung) == (self.cfg.scheme, self.cfg.restructure_method):
            return None
        if self._sharded is not None:
            raise ValueError("the sharded driver has no scheme/rung plan "
                             "variants")
        key = (sch, rung)
        if key not in self._variants:
            cfg = dataclasses.replace(self.cfg, scheme=sch,
                                      restructure_method=rung)
            self._variants[key] = functools.partial(
                _fused_impl, app=self.app, cfg=cfg, store=self.init_store)
        return key

    def run_stream_chunk(self, values, batched, ts0: int, variant=None):
        """One chunk of a continuous run.

        ``batched`` holds ``[K, interval, ...]`` columns on the engine's
        device and ``values`` the carry; the caller threads the returned
        carry into the next chunk, so K-chunked execution runs the same
        per-interval schedule as one monolithic ``run_stream`` over the
        concatenated events.  The carry is copied once on entry: the
        megakernel commits in place, and the caller's ``values`` must stay
        the pre-chunk state (the service's emergency snapshot reads it).
        ``ts0`` is the global timestamp base of the chunk's first interval;
        it and every base of the chunk must fit int32.  ``variant``
        selects a plan variant (``ensure_variant``).

        Returns ``(res_all, ebs_all, values', stats)``; ``stats`` is
        ``dict(engine=EngineStats)`` with the K intervals' counters stacked
        (``[K]`` tensors) on one device, and ``dict(exchange=...)`` on a
        sharded engine (``ShardedStream.run_chunk``: dropped/shipped/
        max_fill per interval, capacity, shard_load, slot_load).  There the
        carry is the ownership-block layout and is not written.  The
        associative rungs read the host nowhere, so the call returns before
        the device finishes; the lockstep path reads each sweep's round
        sizes.  Materialize the outputs with :meth:`post_outputs`.
        """
        some = next(iter(batched.values()))
        k, interval = int(some.shape[0]), int(some.shape[1])
        if not 0 <= int(ts0) or int(ts0) + k * interval > 2 ** 31 - 1:
            raise ValueError(f"ts0={ts0}: the chunk's timestamps must fit "
                             f"int32 (use runtime.service.ts_base_for)")
        if self._sharded is not None:
            if variant is not None:
                raise ValueError("the sharded driver has no scheme/rung plan "
                                 "variants")
            res_all, ebs_all, values, xst = self._sharded.run_chunk(
                values, batched, int(ts0))
            self.last_rung = self._sharded.last_rung
            return res_all, ebs_all, values, dict(exchange=xst)
        fn = self._fused if variant is None else self._variants[variant]
        res_all, ebs_all, values, est, rung = fn(
            values.to(self.device, copy=True), batched, int(ts0))
        self.last_rung = rung
        return res_all, ebs_all, values, dict(engine=_stack_stats(est))

    def post_outputs(self, res_all, ebs_all, n_intervals: int):
        """Materialize a chunk's per-interval outputs (one device-to-host
        copy)."""
        return self._outs(res_all, ebs_all, n_intervals)

    def chunk_lowered_text(self, values, batched, variant=None) -> str:
        """The reference returns the chunk program's compiled XLA HLO for
        its cost attribution; eager PyTorch has no such program text."""
        raise NotImplementedError(
            "chunk_lowered_text reads compiled XLA HLO, which eager PyTorch "
            "does not have; the port's cost attribution is chunk_cost, a "
            "trace of the chunk's own execution")

    def chunk_cost(self, values, batched, ts0: int, variant=None):
        """``run_stream_chunk`` run once under a program trace
        (``launch/hlo_analysis.ProgramTrace``, on this thread): returns
        ``((res_all, ebs_all, values, stats), trace)``.  The run is the
        real one, its results and launch counts as without the trace; read
        the cost with ``hlo_analysis.analyze(trace, n_devices)``."""
        from ..launch.hlo_analysis import ProgramTrace
        with ProgramTrace() as trace:
            out = self.run_stream_chunk(values, batched, ts0, variant=variant)
        return out, trace

    # -- carry and ownership (reference: scheduler.py, elastic carry API) --
    def carry_in(self, values):
        """Canonical [S+1, W] values -> the driver's resident carry."""
        if self._sharded is not None:
            return self._sharded.carry_in(values)
        return values

    def carry_out(self, carry):
        """Resident carry -> canonical [S+1, W] values."""
        if self._sharded is not None:
            return self._sharded.carry_out(carry)
        return carry

    @property
    def owners(self):
        """Current ownership overrides (() = pure striping)."""
        return self._sharded.owners if self._sharded is not None else ()

    @property
    def reshardable(self) -> bool:
        """Whether ``apply_resharding`` can migrate the carry: a sharded
        engine under shared_nothing on more than one shard, without the
        probe route (``ShardedStream.reshardable``)."""
        return self._sharded is not None and self._sharded.reshardable

    def rebind_ownership(self, overrides) -> None:
        """Rebind the sharded plan to ``overrides`` without moving data;
        identity on the single-device driver."""
        if self._sharded is not None and overrides != self._sharded.owners:
            self._sharded.set_ownership(overrides)

    def apply_resharding(self, carry, overrides):
        """Live migration of the resident carry onto ``overrides`` (the
        sharded driver; ``ShardedStream.reshard``).  Returns ``(carry,
        moved_rows)``; identity on one device."""
        if self._sharded is None:
            return carry, 0
        return self._sharded.reshard(carry, overrides)

    def _outs(self, res_all, ebs_all, n_intervals: int) -> List[Dict]:
        """Shared output program + one bulk device-to-host copy, split per
        interval."""
        outs = {k: v.cpu().numpy()
                for k, v in _post_stream(res_all, ebs_all, app=self.app).items()}
        return [{k: v[i] for k, v in outs.items()} for i in range(n_intervals)]


def _stack(dicts: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([d[k] for d in dicts]) for k in dicts[0]}


def _stack_stats(stats) -> EngineStats:
    """Per-interval EngineStats (a list, or one already stacked over the
    intervals, as the megakernel's) as one EngineStats of ``[K]``
    counters."""
    if isinstance(stats, EngineStats):
        return stats
    col = lambda f: torch.stack([torch.as_tensor(getattr(s, f)).reshape(())
                                 for s in stats])
    first = stats[0]
    return dataclasses.replace(
        first, rounds=col("rounds"), n_chains=col("n_chains"),
        max_chain=col("max_chain"), swept=sum(s.swept for s in stats),
        residue=sum(s.residue for s in stats))


def _eval_interval(store: StateStore, ops, *, app: AppSpec,
                   cfg: EngineConfig, prestructured=None):
    """State-access mode for one interval: restructure once (unless the
    fused driver hands in this interval's ``prestructured`` view), evaluate,
    and under ``abort_repass`` evaluate again with the aborted transactions
    masked, reusing the same sort."""
    pres = prestructured
    if pres is None and cfg.scheme in CHAIN_SCHEMES:
        # the segmented-scan path reads only 4 sorted columns
        light = (cfg.scheme in ("tstream", "tstream_scan")
                 and app.associative_only)
        pres = restructure(ops, store.pad_uid, rowmajor_ts=True, light=light,
                           method=cfg.restructure_method,
                           use_kernels=cfg.use_kernels,
                           threads=cfg.block_param("radix_partition"))
    kw = dict(associative_only=app.associative_only, has_gates=app.has_gates,
              n_partitions=cfg.n_partitions,
              max_dep_levels=cfg.max_dep_levels, use_kernels=cfg.use_kernels)
    res, values, stats = evaluate(store, ops, app.funs, cfg.scheme,
                                  prestructured=pres, **kw)
    if cfg.abort_repass and app.may_abort:
        # Abort without rollback: a transaction with a failed op is masked
        # out and the interval re-evaluated from its initial state.  Chain
        # geometry depends only on uids, so the repass tightens ``valid``
        # in both layouts instead of sorting again.
        succ = res["success"].reshape(-1, app.max_ops)
        valid = ops.valid.reshape(-1, app.max_ops)
        txn_ok = torch.all(succ | ~valid, dim=1)
        keep = txn_ok.repeat_interleave(app.max_ops)
        ops = dataclasses.replace(ops, valid=ops.valid & keep)
        if pres is not None:
            sops, ch = pres
            pres = (dataclasses.replace(sops, valid=sops.valid & ch.take(keep)),
                    ch)
        res, values, stats = evaluate(store, ops, app.funs, cfg.scheme,
                                      prestructured=pres, **kw)
    return res, values, stats


def _post_stream(res_all, ebs_all, *, app: AppSpec):
    """Post-process a whole stream's stacked per-op results.

    THE output program: every driver evaluates to per-op results stacked as
    ``[n_intervals, N, ...]`` and post-processes them here in one batched
    call.
    """
    n_i, n = res_all["success"].shape
    batch = n // app.max_ops
    shaped = OpResults(
        pre=res_all["pre"].reshape(n_i, batch, app.max_ops, -1)[..., :app.width],
        post=res_all["post"].reshape(n_i, batch, app.max_ops,
                                     -1)[..., :app.width],
        success=res_all["success"].reshape(n_i, batch, app.max_ops),
    )
    return app.post_process(ebs_all, shaped)


def _step_impl(store: StateStore, events, ts_base, *, app: AppSpec,
               cfg: EngineConfig):
    # -- compute mode: pre-process + postpone state access (D1) ------------
    ops, ebs = build_opbatch(app, store, events, ts_base)
    # -- state access mode: dynamic restructuring execution (D2) -----------
    res, values, stats = _eval_interval(store, ops, app=app, cfg=cfg)
    return res, ebs, values, stats


def _fused_impl(values, events_b, ts0: int, *, app: AppSpec,
                cfg: EngineConfig, store: StateStore):
    """Whole-stream driver over ``[n_intervals, interval, ...]`` events.

    ``values`` is the engine's private state copy, carried across intervals.
    Everything values-independent (op registration, the restructure plan,
    and on the associative path the coefficient scans and commit maps) runs
    once for all intervals before the loop.  Returns ``(res_all, ebs_all,
    values, stats, rung)``: ``rung`` is the associative path's rung
    (``fused_rung``), on the generic path the restructure backbone of a
    chain scheme, else None.
    """
    some = next(iter(events_b.values()))
    n_intervals, interval = some.shape[0], some.shape[1]
    store = dataclasses.replace(store, values=values)

    # compute mode for ALL intervals at once (interval-parallel)
    ts_bases = ts0 + torch.arange(n_intervals, dtype=torch.int32,
                                  device=values.device) * interval
    ops_all, ebs_all = build_opbatch(app, store, events_b, ts_bases)

    if (cfg.scheme in ("tstream", "tstream_scan") and app.associative_only
            and not (cfg.abort_repass and app.may_abort)):
        res_all, values, stats, rung = _fused_assoc(store, ops_all, app=app,
                                                    cfg=cfg)
        return res_all, ebs_all, values, stats, rung

    # generic path: one restructure for the whole stream (on the partition
    # rung one radix launch), then one evaluation per interval from its
    # slice of the sorted view
    pres_all, rung = None, None
    if cfg.scheme in CHAIN_SCHEMES:
        n_rows = ops_all.uid.shape[-1]
        rung = restructure_path(n_rows, store.pad_uid, rowmajor_ts=True,
                                method=cfg.restructure_method,
                                device_kind=autotune.kind_of(store.device))
        pres_all = restructure(ops_all, store.pad_uid, rowmajor_ts=True,
                               method=cfg.restructure_method,
                               use_kernels=cfg.use_kernels,
                               threads=cfg.block_param("radix_partition"))
    res_l, stats = [], []
    for i in range(n_intervals):
        st = dataclasses.replace(store, values=values)
        res, values, s = _eval_interval(st, tree_index(ops_all, i), app=app,
                                        cfg=cfg,
                                        prestructured=tree_index(pres_all, i))
        res_l.append(res)
        stats.append(s)
    return _stack(res_l), ebs_all, values, stats, rung


def fused_rung(store: StateStore, n_rows: int, *, app: AppSpec,
               cfg: EngineConfig) -> str:
    """The rung the fused associative driver takes for intervals of
    ``n_rows`` ops: "megakernel", or the staged path's restructure backbone
    ("partition", "packed" or "lexsort").

    The megakernel is engaged only where its block holds the interval on
    the device that launches it (``restructure.megakernel_fits``); without
    kernels, or on the CPU, its twin has no such limit.
    """
    dev = store.values.device
    if megakernel_engaged(
            n_rows, store.values.shape[0], method=cfg.restructure_method,
            has_max=any(store.table_is_max),
            funs_simple=simple_affine_luts(app.funs, dev) is not None,
            lanes=store.values.shape[-1],
            smem_limit=smem_optin(dev) if cfg.use_kernels else None,
            device_kind=autotune.kind_of(dev)):
        return "megakernel"
    return restructure_path(n_rows, store.pad_uid, rowmajor_ts=True,
                            method=cfg.restructure_method,
                            device_kind=autotune.kind_of(dev))


def _fused_assoc(store: StateStore, ops_all, *, app: AppSpec,
                 cfg: EngineConfig):
    """Associative fast path: the per-interval body is O(N) gathers and
    elementwise work.

    The one-pass restructure plan (one radix launch for all intervals), the
    coefficient scans (one launch per scan over the flattened stream) and
    the commit maps run before the loop; results return to flat layout in
    the body and stack per interval.  Returns ``(res_all, values, stats,
    rung)``, ``rung`` the one it took (``fused_rung``).
    """
    rung = fused_rung(store, ops_all.uid.shape[-1], app=app, cfg=cfg)
    if rung == "megakernel":
        return (*_fused_assoc_mega(store, ops_all, cfg=cfg, app=app), rung)

    pres_all = restructure(ops_all, store.pad_uid, rowmajor_ts=True,
                           light=True, method=cfg.restructure_method,
                           use_kernels=cfg.use_kernels,
                           threads=cfg.block_param("radix_partition"))
    plan_all = tstream_scan_plan(store, ops_all, app.funs,
                                 prestructured=pres_all,
                                 use_kernels=cfg.use_kernels)
    plan_all = tstream_scan_coefs(plan_all, use_kernels=cfg.use_kernels,
                                  threads=cfg.block_param("segscan"))

    values = store.values
    res_l, stats = [], []
    for i in range(ops_all.uid.shape[0]):
        res, values, s = tstream_scan_execute(values, tree_index(plan_all, i),
                                              store.pad_uid)
        res_l.append(res)
        stats.append(s)
    return _stack(res_l), values, stats, rung


def _fused_assoc_mega(store: StateStore, ops_all, *, app: AppSpec,
                      cfg: EngineConfig):
    """Megakernel rung of the associative fast path.

    The hoisted plan shrinks to the partition permutation and histograms
    (``geometry=False``); ONE call of ``kernels/megakernel`` then evaluates
    every interval's chains, carrying the state from one interval to the
    next and committing it in place, bit-identical to the staged rungs.  Its
    results come back in flat layout.
    """
    a_lut, b_lut = simple_affine_luts(app.funs, store.device)
    sops_all, ch_all = restructure(
        ops_all, store.pad_uid, rowmajor_ts=True, light=True,
        method="partition", use_kernels=cfg.use_kernels, geometry=False,
        threads=cfg.block_param("radix_partition"))
    if cfg.use_kernels:
        evaluate_chains = functools.partial(
            fused_chain_eval, threads=cfg.block_param("megakernel"))
    else:
        evaluate_chains = fused_chain_stream_ref
    return evaluate_chains(store.values, sops_all, ch_all, store.pad_uid,
                           a_lut=a_lut, b_lut=b_lut)
