"""Continuous streaming service runtime (DESIGN.md §2.6, failure model §2.7).

The reference's ``repro/runtime/service.py`` on the port's engine: the same
pipeline, threads, admission, watermark, snapshots, resume, straggler
policy, controller and drop accounting.  What differs:

* the carry is a tensor on the engine's device, copied in once; each host
  read of a device result is one ``.cpu()``, and a chunk's events go to the
  device as one copy of each stacked column;
* the port's fused driver reads the host inside a chunk (the rung, each
  lockstep sweep's round sizes), so ``run_stream_chunk`` returns after the
  chunk ran: holding a finished chunk until the next one is dispatched
  would overlap nothing, so the executor commits it at once instead of
  the reference's one-behind double buffer;
* on the card the kernels are built before the first chunk (nvcc takes
  longer than ``watchdog_grace_s`` is meant to cover);
* ``ChunkProfiler`` windows are ``torch.profiler``'s, opened and closed on
  the executor thread; the cost attribution (``hlo_attribution``) traces
  the first chunk of each shape as it runs on the executor thread
  (``CostAttributor``), where the reference lowers and compiles it once
  more.

``StreamService`` turns the batch-replay drivers into a steady-state
pipeline over an unbounded arrival source:

    arrivals -> admission (bounded queue) -> IntervalAssembler (watermark)
             -> ready intervals -> chunked fused run (K intervals per
             call, the state carry threaded chunk to chunk)
             -> commit (post-process + D2H) -> outputs + latency record

* **Commit as soon as run**: chunks are dispatched and committed in
  order on a dedicated executor thread while the main thread pulls,
  assembles and stages (H2D) the next chunk.  The executor commits each
  chunk right after its dispatch, before it takes the next one from the
  work queue.
* **Chunked == monolithic**: chunk boundaries are punctuation boundaries
  and the carry is the state buffer, so K-chunked execution is
  bit-identical to one ``run_stream`` over the same events, on both the
  single-device and sharded drivers (tests/test_torch_service.py,
  tests/test_torch_service_sharded.py).
* **Backpressure / admission control**: the ready queue is bounded
  (``queue_intervals``); when the source outruns the engine the service
  either stops pulling (``admission="block"``) or drops whole arrival
  batches with accounting (``admission="drop"``).
* **Punctuation-aligned recovery**: every ``snapshot_every`` intervals
  the service drains the pipeline and writes the state buffer through
  ``ckpt/`` (the checkpoint step number IS the punctuation index).
  Recovery restores the newest snapshot that *verifies* — a torn or
  corrupted latest falls back to the previous valid one — and replays
  the deterministic source, discarding the first ``intervals_done``
  re-assembled intervals: the resumed run is bitwise identical to an
  uninterrupted one.

Hardened failure path (DESIGN.md §2.7):

* **Source retry/backoff**: transient pull failures
  (``faults.TransientSourceError`` / ``TimeoutError``) retry up to
  ``source_retries`` times with exponential backoff; pulls slower than
  the ``StragglerPolicy`` deadline count as deadline misses, and the
  combined backfill ratio trips the policy's alarm (logged once,
  recorded in ``stats["source"]``).
* **Executor watchdog**: with ``watchdog_factor`` set, a monitor thread
  declares the executor hung when no progress lands within
  ``watchdog_factor ×`` the median recent chunk latency (never below
  ``watchdog_min_s``; ``watchdog_grace_s`` covers every possibly
  compiling chunk — the first, and the first at any new
  (plan variant, slack, chunk-size) shape).  On fire it aborts the
  executor, drains every
  committable in-flight chunk, writes an *emergency* punctuation-aligned
  snapshot when the carry is safe, and surfaces a structured
  ``ExecutorHungError`` with the merged stats intact.
* **Fault injection**: ``run(..., faults=FaultPlane(...))`` consults the
  deterministic fault plane (``runtime/faults.py``) at each named site.

Adaptive control plane (DESIGN.md §2.9, ``runtime/controller.py``):

* With ``ServiceConfig.controller`` set, a deterministic feedback
  controller runs on the main thread at every chunk boundary: it reads
  the per-chunk record window (see below), moves the live plan inside a
  small legal lattice (scheme degradation, exchange slack, chunk size K,
  restructure rung), and the chunk is submitted *carrying* its plan — the
  executor binds the plan variant / slack at the dispatch that first
  observes a new plan.  Every switch appends to a monotone decision
  trace; punctuation-aligned snapshots publish the trace (+ the record
  window tail) in their manifest and ``resume`` folds it back, so
  crash → restore → replay of an adaptive run is bitwise identical to the
  uninterrupted adaptive run.
* ``escalate_overflow`` is sugar for an implicit slack-only controller: a
  sharded chunk that dropped ops triggers a logged ``exchange_slack``
  widening at a later boundary, up to ``escalate_overflow`` times — a
  traced decision, so it composes with snapshots.
* **Per-chunk time series**: the service keeps a ring buffer of the last
  ``chunk_record_ring`` chunk records (latency, failed ops, chain stats,
  exchange drop/fill, queue fill) — the controller's observation window,
  exposed as ``stats["chunks"]``.  A record's ``lat_s`` runs from the
  chunk's dispatch to its commit, the chunk's own run.  Only the
  controller's wall-clock timing tier reads it, which is off under
  snapshots and never on the replay path.

Elastic resharding (DESIGN.md §2.10):

* On the sharded driver every chunk record also carries the per-shard
  access histogram (``x_shard``) and the chunk's hottest slots
  (``hot``).  With ``ControllerConfig.reshard_imbalance`` set, sustained
  imbalance emits a ``reshard`` decision — a skew-aware ownership
  permutation computed by greedy bin-packing over the observed load —
  and the dispatch that first observes the new plan applies it as a
  *live migration*: drain the pipe at the punctuation boundary, ship
  only the rows whose owner changed through the owner-routed
  ``all_to_all``, rebind the plan, resume.  Migrations are traced
  decisions and snapshots store canonical uid-order values, so
  crash → restore → replay across a migration stays bitwise identical;
  the run's placement ledger lands in ``stats["placement"]``.

``StreamService.stats`` is the one merged accounting record: watermark
drops, admission drops, exchange overflow, the assembler ledger,
source retry/backfill counters, fired faults, the chunk-record ring, the
controller trace and any structured error land in a single dict; each
category is logged at most once per run.

Unified telemetry plane (DESIGN.md §2.11, ``runtime/telemetry.py``):

* Every run owns a ``Telemetry`` registry (``run.telemetry``); ``stats``
  is now a *view* rendered from the registry's versioned snapshot, and
  the once-per-run log lines are rate-limited structured events (same
  messages, same logger, no hand-rolled flags).
* With ``ServiceConfig.telemetry.trace_path`` set, every pipeline stage
  (source pull → assembly → admission → dispatch → execute → commit →
  ``controller.decide`` → snapshot publish → ``reshard.apply``) emits a
  Chrome-trace/Perfetto span; ``profile_dir`` adds per-chunk
  ``torch.profiler`` windows.  Six spans tile each chunk's life, each
  carrying ``chunk`` (its global index) and meeting the next on one stamp:
  ``chunk.fill`` (first admission -> submit), ``chunk.submit``,
  ``chunk.wait`` (the work queue), ``chunk.dispatch`` (with the engine's
  ``dispatch.*`` parts and, on one device, the lockstep walk's ``swept``
  rounds and ``residue`` ops), ``chunk.hold`` (until the commit starts:
  the fault hook's time, about 0) and ``chunk.commit``.
* Replay-safety contract: telemetry never feeds ``decide()`` — a
  tracing-enabled run is bitwise identical to a tracing-off run,
  including crash → restore → replay (tests/test_torch_telemetry.py).  The
  only timing→control bridge is the *advisory* channel: when snapshots
  force ``allow_timing`` off, a shadow controller still evaluates the
  timing tier and its would-be decisions are logged + recorded under
  ``stats["controller"]["advisory"]`` — never applied.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..ckpt import (checkpoint_steps, load_checkpoint, prune_checkpoints,
                    read_manifest_meta, save_checkpoint, verify_checkpoint)
from ..core.intervals import IntervalAssembler, WatermarkPolicy
from ..kernels._build import build_all
from .controller import (AdvisoryTiming, ControllerConfig, Plan,
                         PlanController, replay_plan)
from .faults import FaultPlane, TransientSourceError
from .telemetry import (ChunkProfiler, CostAttributor, Telemetry,
                        TelemetryConfig, empty_stats, make_tracer, stats_view)

log = logging.getLogger(__name__)

@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """"A shard is slow" has exactly one owner: this policy classifies a
    slow *source pull* (``deadline_s``; misses + retries trip the
    ``max_backfill_ratio`` alarm in ``stats["source"]``), and a slow
    *device shard* — sustained load imbalance — is the controller's
    ``reshard`` knob reading the same per-chunk records
    (``runtime/controller.py``, DESIGN.md §2.10).  The old standalone
    ``runtime/straggler.py`` dispatcher duplicated the deadline half of
    this split and is gone."""

    deadline_s: float = 1.0          # per-pull fetch budget
    max_backfill_ratio: float = 0.2  # alarm threshold
    backup_seed_offset: int = 1_000_003


class ExecutorHungError(RuntimeError):
    """Watchdog verdict: the executor made no progress within its budget.

    ``info`` is the structured record (idle/timeout seconds, committed
    intervals, in-flight chunks, emergency snapshot step if one was
    written) — also merged into ``stats["error"]``.
    """

    def __init__(self, msg: str, info: Optional[Dict] = None):
        super().__init__(msg)
        self.info = dict(info or {})


class _Aborted(Exception):
    """Internal: the run was already declared failed; stop silently."""


def _host(x) -> np.ndarray:
    """One device-to-host read of a tensor (a number passes through)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def ts_base_for(global_interval: int, interval: int) -> int:
    """int32-safe timestamp base for an unbounded run.

    Engine timestamps are only meaningful *within* one punctuation
    interval's restructure sort (nothing persists them across intervals),
    so the base wraps at an interval-aligned boundary below 2**30 —
    within any chunk the bases stay monotone and the per-op ``ts_base +
    arange(interval)`` stays well inside int32 forever.  Below the wrap
    (~2**30 events) this equals ``global_interval * interval`` exactly,
    which is what the chunked-vs-monolithic bit-identity tests compare.
    """
    wrap = max(1, 2 ** 30 // interval)
    return (global_interval % wrap) * interval


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    punct_interval: int
    chunk_intervals: int = 4        # K — scan window per device dispatch
    queue_intervals: int = 16       # ready-queue bound (admission control)
    admission: str = "block"        # "block" (backpressure) | "drop"
    watermark: WatermarkPolicy = WatermarkPolicy()
    snapshot_every: int = 0         # intervals between snapshots; 0 = off
    ckpt_dir: Optional[str] = None
    keep_last: int = 0              # snapshot retention; 0 = keep all
    # -- hardened failure path (DESIGN.md §2.7) ------------------------
    straggler: StragglerPolicy = StragglerPolicy()
    source_retries: int = 2         # bounded retry on transient pull errors
    retry_backoff_s: float = 0.05   # exponential backoff base
    watchdog_factor: float = 0.0    # × median recent chunk latency; 0 = off
    watchdog_min_s: float = 5.0     # timeout floor once latencies exist
    watchdog_grace_s: float = 120.0  # before the first commit
    escalate_overflow: int = 0      # max automatic slack escalations; 0 = off
    escalate_factor: float = 2.0
    # -- adaptive control plane (DESIGN.md §2.9) -----------------------
    controller: Optional[ControllerConfig] = None
    chunk_record_ring: int = 32     # per-chunk time series depth
    # -- observability plane (DESIGN.md §2.11); None = metrics only ----
    telemetry: Optional[TelemetryConfig] = None

    def __post_init__(self):
        assert self.punct_interval > 0
        assert self.chunk_intervals > 0
        assert self.admission in ("block", "drop"), self.admission
        assert self.queue_intervals >= self.chunk_intervals, \
            "queue_intervals must cover at least one chunk"
        assert self.keep_last >= 0
        assert self.source_retries >= 0 and self.retry_backoff_s >= 0
        assert self.watchdog_factor >= 0
        if self.watchdog_factor:
            assert self.watchdog_min_s > 0 and self.watchdog_grace_s > 0
        assert self.escalate_overflow >= 0
        if self.escalate_overflow:
            assert self.escalate_factor > 1.0
            # NOTE: escalation + snapshots used to be statically excluded
            # (a mid-run capacity change was not replayable).  Escalations
            # are now controller decisions recorded in the snapshot's
            # decision trace and folded back by ``resume``, so the modes
            # compose (DESIGN.md §2.9).
        assert self.chunk_record_ring >= 1
        if self.controller is not None:
            c = self.controller
            assert c.window >= 1 and 1 <= c.sustain <= c.window, \
                "controller needs 1 <= sustain <= window"
            assert c.cooldown >= 1, "controller cooldown must be >= 1"
        if self.snapshot_every:
            assert self.snapshot_every % self.chunk_intervals == 0, \
                ("snapshots are taken at chunk boundaries: snapshot_every "
                 "must be a multiple of chunk_intervals")
            assert self.ckpt_dir, "snapshot_every needs a ckpt_dir"
            # admission drops depend on ready-queue occupancy, and replay
            # (skip_intervals) bypasses the queue for the skipped prefix —
            # a dropping queue is therefore not replayable and would break
            # the crash -> restore -> replay bit-identity guarantee
            assert self.admission == "block", \
                "snapshot/recovery requires admission='block'"


@dataclasses.dataclass
class ServiceRun:
    """Mutable record of one service run (kept on ``service.last_run`` so
    a crashed run's committed prefix stays inspectable)."""

    outputs: List = dataclasses.field(default_factory=list)   # per interval
    commits: List[Dict] = dataclasses.field(default_factory=list)
    latencies: List[np.ndarray] = dataclasses.field(default_factory=list)
    snapshots: List[int] = dataclasses.field(default_factory=list)
    # adaptive control plane: live alias of the controller's decision
    # trace (monotone in g; includes any restored prefix) and the final
    # chunk-record ring (per-chunk time series, newest last; a record's
    # ``lat_s`` is dispatch -> commit, the chunk's own run, and feeds only
    # the controller's timing tier)
    decisions: List[Dict] = dataclasses.field(default_factory=list)
    chunk_records: List[Dict] = dataclasses.field(default_factory=list)
    # elastic resharding: one dict per applied live migration (boundary
    # interval, rows moved, override count) and the per-shard observed
    # event totals behind stats["placement"]
    migrations: List[Dict] = dataclasses.field(default_factory=list)
    shard_events: Optional[np.ndarray] = None
    admission_dropped: int = 0
    replayed_intervals: int = 0
    exchange_dropped: int = 0
    exchange_shipped: int = 0
    exchange_capacity: int = 0
    t_first_enqueue: Optional[float] = None
    t_last_commit: Optional[float] = None
    final_values: Optional[np.ndarray] = None
    stats: Optional[Dict] = None
    # the run's telemetry registry (DESIGN.md §2.11): counters, gauges,
    # histograms and record logs behind the versioned schema; ``stats``
    # is rendered from its snapshot by _finish
    telemetry: Optional[Telemetry] = None

    def latency_s(self) -> np.ndarray:
        """Per-event end-to-end latency (enqueue -> interval commit)."""
        if not self.latencies:
            return np.zeros((0,), np.float64)
        return np.concatenate(self.latencies)

    def latency_percentiles(self, qs=(50, 99)) -> Dict[str, float]:
        lat = self.latency_s()
        if lat.size == 0:
            return {f"p{q}": float("nan") for q in qs}
        return {f"p{q}": float(np.percentile(lat, q)) for q in qs}

    def sustained_events_per_s(self) -> float:
        n = sum(len(l) for l in self.latencies)
        if not n or self.t_first_enqueue is None \
                or self.t_last_commit is None:
            return 0.0
        span = self.t_last_commit - self.t_first_enqueue
        return n / span if span > 0 else 0.0


class StreamService:
    """Long-running punctuation pipeline over a ``DualModeEngine``."""

    def __init__(self, engine, cfg: ServiceConfig):
        if engine._sharded is not None:
            engine._sharded._check_interval(cfg.punct_interval)
        self.engine = engine
        self.cfg = cfg
        self.last_run: Optional[ServiceRun] = None

    # ------------------------------------------------------------------
    def run(self, source, values=None, *, skip_intervals: int = 0,
            max_intervals: Optional[int] = None,
            crash_after_interval: Optional[int] = None,
            faults: Optional[FaultPlane] = None,
            controller_state: Optional[Dict] = None) -> ServiceRun:
        """Drive the service until the source drains (or ``max_intervals``).

        ``skip_intervals`` is the recovery path: the first N re-assembled
        intervals are discarded without execution (the snapshot already
        contains their effects) and execution resumes at global interval
        index N with the restored state — assembly is deterministic, so
        the continuation is bitwise identical to the uninterrupted run.
        ``crash_after_interval`` injects a failure once the interval with
        that global index has committed (tests/CI restart drill);
        ``faults`` is the general, scheduled fault plane
        (``runtime/faults.py``).  ``controller_state`` is the adaptive
        recovery path (normally supplied by :meth:`resume` from the
        snapshot manifest): the decision trace is folded back into the
        plan and the stored record window seeds the controller's
        observations, so post-restore decisions recompute exactly as the
        uninterrupted run made them.
        """
        cfg, eng = self.cfg, self.engine
        if skip_intervals and cfg.admission != "block":
            raise ValueError(
                "replay (skip_intervals) requires admission='block': a "
                "dropping queue makes the arrival->interval mapping depend "
                "on commit progress, which replay does not reproduce")
        interval, K = cfg.punct_interval, cfg.chunk_intervals
        asm = IntervalAssembler(interval, cfg.watermark)
        ready = collections.deque()
        in_flight = collections.deque()    # dispatched, not yet committed
        rec = ServiceRun()
        self.last_run = rec
        # -- observability plane (DESIGN.md §2.11) ---------------------
        # The registry is always on (no clocks of its own); the tracer and
        # profiler are opt-in and provably off the replay path: with both
        # enabled the run stays bitwise identical to a bare one.
        tcfg = cfg.telemetry
        tele = Telemetry(record_cap=tcfg.record_cap if tcfg else 4096)
        rec.telemetry = tele
        tracer = make_tracer(tcfg, tele)
        profiler = ChunkProfiler(tcfg.profile_dir if tcfg else "")
        cost_attr = None
        if tcfg is not None and tcfg.hlo_attribution:
            cost_attr = CostAttributor(
                n_devices=(eng._sharded.n_dev
                           if eng._sharded is not None else 1),
                device=eng.device)
        costs: Dict = {}     # shape key -> analyze dict (or None)
        if eng.device.type == "cuda" and eng.cfg.use_kernels:
            build_all()     # before the first chunk, off the watchdog's clock
        init = eng.init_store.values if values is None else values
        src = iter(source)
        state = dict(exhausted=False, to_skip=int(skip_intervals), err=None)
        g_next = int(skip_intervals)    # global index of next interval
        executed = 0                    # intervals submitted this run
        srcst = dict(pulls=0, retries=0, deadline_misses=0, backoff_s=0.0)
        vals_ok = dict(safe=True)       # carry readable (not mid-chunk)

        # -- adaptive control plane (DESIGN.md §2.9) -----------------------
        ctl = self._make_controller(controller_state)
        # advisory timing channel (DESIGN.md §2.11): the user asked for
        # the timing tier but snapshots forced it off — shadow-evaluate
        # it anyway; hints are logged/recorded, never applied
        advisory = None
        if (ctl is not None and cfg.controller is not None
                and cfg.snapshot_every and cfg.controller.allow_timing):
            advisory = AdvisoryTiming(ctl)
        # the engine carry: canonical uid-order values enter the engine's
        # native carry layout (ownership blocks on the sharded driver, the
        # plain buffer on one device).  _make_controller already rebound
        # any restored ownership, so the blocks are built on the layout
        # the replayed trace folds to.
        vals = eng.carry_in(torch.as_tensor(init, dtype=torch.float32).to(
            eng.device, copy=True))
        if ctl is not None:
            rec.decisions = ctl.trace       # live alias (monotone trace)
        # per-chunk record ring: the controller's observation window and
        # the stats["chunks"] time series.  Records are appended by the
        # commit path (executor thread / post-hang drain) and read by the
        # main thread's decision step under ``rec_cv``.
        ring = cfg.chunk_record_ring
        if ctl is not None:
            ring = max(ring, ctl.cfg.window + 4)
        hist: collections.deque = collections.deque(maxlen=ring)
        rec_cv = threading.Condition()
        chunks_done0 = int((controller_state or {}).get("chunks_done", 0))
        # n: committed-chunk count (== next record's global index);
        # last_i: newest committed record; j: chunks submitted this run
        chn = dict(n=chunks_done0, last_i=chunks_done0 - 1, j=0)
        for r in (controller_state or {}).get("records", ()):
            hist.append(dict(r))
        # the plan the engine is actually bound to (slack applied at
        # restore by _make_controller; scheme/rung rebind lazily at the
        # first dispatch that observes a different plan)
        # slack AND ownership are already live at restore (applied by
        # _make_controller), so the first dispatch must not re-apply them
        applied = dict(plan=None if ctl is None else dataclasses.replace(
            ctl.init_plan, slack=ctl.plan.slack, owners=ctl.plan.owners))
        # watchdog progress record: ``busy`` is True only while the
        # executor is actively processing (dispatch/commit/drain), ``t``
        # is bumped at every step forward, ``lat`` holds recent
        # commit-to-commit chunk latencies
        progress = dict(busy=False, t=time.monotonic(), last_commit=None,
                        lat=collections.deque(maxlen=8))
        # staged chunks queued for the executor thread; maxsize=1 plus the
        # one chunk the executor runs bounds the pipeline
        work_q: queue.Queue = queue.Queue(maxsize=1)

        def drain_asm():
            for ev_iv, info in asm.pop_ready():
                if state["to_skip"] > 0:
                    state["to_skip"] -= 1
                    rec.replayed_intervals += 1
                else:
                    ready.append((ev_iv, info))

        def guarded_pull():
            """One source pull under the straggler policy: transient
            failures retry with exponential backoff (bounded by
            ``source_retries``), slow pulls count as deadline misses."""
            attempt = 0
            with tracer.span("source.pull") as sp:
                while True:
                    t0 = time.monotonic()
                    try:
                        if faults is not None:
                            faults.on_source_pull()
                        item = next(src)
                    except StopIteration:
                        raise
                    except (TransientSourceError, TimeoutError):
                        srcst["retries"] += 1
                        if attempt >= cfg.source_retries:
                            raise
                        delay = cfg.retry_backoff_s * (2.0 ** attempt)
                        srcst["backoff_s"] += delay
                        attempt += 1
                        time.sleep(delay)
                        continue
                    srcst["pulls"] += 1
                    if time.monotonic() - t0 > cfg.straggler.deadline_s:
                        srcst["deadline_misses"] += 1
                    if attempt:
                        sp.set(retries=attempt)
                    return item

        def pull_one() -> bool:
            """Admit one arrival batch; False = backpressure (queue full)."""
            if state["exhausted"] or state["err"] is not None:
                return False
            if len(ready) >= cfg.queue_intervals and cfg.admission == "block":
                return False
            with tracer.span("admission", qfill=len(ready)) as adm:
                try:
                    ev, t = guarded_pull()
                except StopIteration:
                    state["exhausted"] = True
                    asm.close()
                    adm.set(outcome="exhausted")
                else:
                    if len(ready) >= cfg.queue_intervals:  # admission=="drop"
                        n_drop = int(np.asarray(t).shape[0])
                        rec.admission_dropped += n_drop
                        adm.set(outcome="dropped", events=n_drop)
                    else:
                        now = time.perf_counter()
                        if rec.t_first_enqueue is None:
                            rec.t_first_enqueue = now
                        asm.push(ev, t, enqueue_s=now)
                        adm.set(outcome="admitted")
            with tracer.span("assembly") as asp:
                before = len(ready)
                drain_asm()
                asp.set(intervals=len(ready) - before)
            return True

        def commit_oldest(check_crash: bool = True):
            (g0, kk, res, ebs, infos, xst, item_plan, qfill,
             t_disp, cost, ci, t_dispatched) = in_flight.popleft()
            commit_span = tracer.span("chunk.commit", g0=g0, k=kk, chunk=ci)
            commit_span.__enter__()
            if tracer.enabled:
                tracer.complete_ns("chunk.hold", t_dispatched,
                                   commit_span.t0, "chunk.hold", g0=g0,
                                   k=kk, chunk=ci)
            outs = eng.post_outputs(res, ebs, kk)
            t_commit = time.perf_counter()
            rec.t_last_commit = t_commit
            now = time.monotonic()
            # the device-execute span: the dispatch->commit wall window,
            # reconstructed from stamps the accounting already takes (no
            # extra clock reads on the replay path); cost attribution
            # and roofline fractions ride on its args
            if tracer.enabled:
                xargs = dict(g0=g0, k=kk, chunk=ci)
                if cost is not None and cost_attr is not None:
                    xargs.update(cost_attr.annotate(cost, now - t_disp))
                tracer.complete_ns("chunk.execute", int(t_disp * 1e9),
                                   int(now * 1e9), **xargs)
            if progress["last_commit"] is not None:
                progress["lat"].append(now - progress["last_commit"])
            progress["last_commit"] = now
            progress["t"] = now
            # -- per-chunk record (the controller's observation unit) ----
            entry = dict(
                i=chn["n"], g0=g0, k=kk, events=kk * interval,
                lat_s=float(now - t_disp), qfill=int(qfill),
                scheme=(item_plan.scheme if item_plan is not None
                        else eng.cfg.scheme),
                fail=0, ops=0, max_chain=0, n_chains=0, rounds=0,
                x_drop=0, x_ship=0, x_fill=0, x_cap=0)
            suc = _host(res["success"])
            entry["ops"] = int(suc.size)
            entry["fail"] = int(suc.size - np.sum(suc))
            st_d = xst or {}
            est = st_d.get("engine")
            if est is not None:
                entry["max_chain"] = int(np.max(_host(est.max_chain)))
                entry["n_chains"] = int(np.min(_host(est.n_chains)))
                entry["rounds"] = int(np.max(_host(est.rounds)))
            xs = st_d.get("exchange")
            if xs is not None:
                st = {k: _host(v) for k, v in xs.items()}
                dropped_now = int(np.sum(st["dropped"]))
                rec.exchange_dropped += dropped_now
                rec.exchange_shipped += int(np.sum(st["shipped"]))
                rec.exchange_capacity = int(st["capacity"])
                entry["x_drop"] = dropped_now
                entry["x_ship"] = int(np.sum(st["shipped"]))
                entry["x_fill"] = (int(np.max(st["max_fill"]))
                                   if np.size(st["max_fill"]) else 0)
                entry["x_cap"] = int(st["capacity"])
                sl = st.get("shard_load")
                if sl is not None:
                    # per-shard access histogram (state rows touched on
                    # each ownership shard this chunk) — the controller's
                    # skew signal, and the top hot slots its placement
                    # input.  The stable argsort makes the hot list (and
                    # therefore every reshard decision derived from it)
                    # replay-exact.
                    shard = np.asarray(sl, np.int64)
                    entry["x_shard"] = [int(v) for v in shard]
                    slot = np.asarray(st["slot_load"], np.int64)
                    top = np.argsort(-slot, kind="stable")[:32]
                    entry["hot"] = [[int(u), int(slot[u])]
                                    for u in top if slot[u] > 0]
                    if rec.shard_events is None:
                        rec.shard_events = np.zeros(shard.size, np.int64)
                    rec.shard_events = rec.shard_events + shard
            with rec_cv:
                hist.append(entry)
                chn["last_i"] = entry["i"]
                chn["n"] += 1
                rec_cv.notify_all()
            for i in range(kk):
                info = infos[i]
                rec.outputs.append(outs[i])
                rec.latencies.append(t_commit - info.enqueue_s)
                rec.commits.append(dict(
                    interval=g0 + i, commit_s=t_commit,
                    watermark=int(info.watermark), n_late=int(info.n_late)))
            commit_span.__exit__(None, None, None)
            if check_crash and crash_after_interval is not None \
                    and g0 + kk - 1 >= crash_after_interval:
                raise RuntimeError(
                    f"injected failure after interval {g0 + kk - 1}")

        def take_snapshot(step: int, emergency: bool = False):
            snap_span = tracer.span("snapshot.publish", step=step,
                                    emergency=emergency)
            snap_span.__enter__()
            # the carry leaves in canonical uid order (carry_out inverts
            # the ownership-block layout), so a snapshot restores onto ANY
            # placement — in particular onto the migrated layout the
            # replayed decision trace folds to
            host_vals = _host(eng.carry_out(vals))
            extra = dict(intervals_done=step, punct_interval=interval,
                         emergency=emergency)
            if eng._sharded is not None:
                # the ownership the engine is bound to at this boundary ==
                # replay_plan(init_plan, trace g < step).owners; recorded
                # so operators (and tests) can see the layout a snapshot
                # was cut on without replaying the trace
                extra["ownership"] = dict(
                    n_owners=int(eng._sharded.n_dev),
                    overrides=[[int(u), int(o)] for (u, o) in eng.owners])
            if ctl is not None:
                # decisions AT the boundary (g == step) race with this
                # write on the main thread, so the manifest records the
                # strict prefix g < step; the first post-restore decision
                # recomputes from the stored record tail — same window,
                # same decision (DESIGN.md §2.9 replay contract)
                trace = [dict(d) for d in list(ctl.trace)
                         if d["g"] < step]
                extra["controller"] = dict(
                    init_plan=ctl.init_plan.as_dict(),
                    plan=replay_plan(ctl.init_plan, trace).as_dict(),
                    trace=trace,
                    records=[dict(r) for r in
                             list(hist)[-(ctl.cfg.window + 1):]],
                    chunks_done=chn["n"])
            path = save_checkpoint(
                cfg.ckpt_dir, step, dict(values=host_vals),
                extra_meta=extra,
                tracer=(tracer if tracer.enabled else None))
            if faults is not None and not emergency:
                faults.on_snapshot_publish(path)
            if cfg.keep_last:
                prune_checkpoints(cfg.ckpt_dir, cfg.keep_last)
            rec.snapshots.append(step)
            snap_span.__exit__(None, None, None)

        seen_shapes = set()     # (variant-key, chunk size) already compiled

        def dispatch(batched, kk: int, infos, plan, qfill, ci: int,
                     t_submitted):
            nonlocal vals, g_next
            if state["err"] is not None:
                raise _Aborted()
            variant = None
            if plan is not None:
                prev = applied["plan"]
                if eng._sharded is not None and plan.slack != prev.slack:
                    # graceful degradation, a replayed decision: widen the
                    # exchange at the boundary the trace recorded (shipped
                    # results are unaffected, only the padding widens)
                    eng._sharded.set_exchange_slack(plan.slack)
                    tele.event(
                        "controller.slack_widen",
                        "controller: exchange slack %.2f -> %.2f at "
                        "punctuation boundary %d",
                        prev.slack, plan.slack, g_next,
                        logger=log, limit=-1)
                if eng._sharded is not None and plan.owners != prev.owners:
                    # live migration (DESIGN.md §2.10): every earlier chunk
                    # has committed, so the carry is exactly this
                    # punctuation boundary's state; ship only the rows
                    # whose owner changed through the owner-routed
                    # all_to_all, rebind the plan to the new ownership and
                    # resume — the stream never stops
                    vals_ok["safe"] = False
                    t0m = time.monotonic()
                    with tracer.span("reshard.apply", g=g_next,
                                     overrides=len(plan.owners)) as rsp:
                        vals, moved = eng.apply_resharding(vals, plan.owners)
                        rsp.set(moved=int(moved))
                    vals_ok["safe"] = True
                    progress["t"] = time.monotonic()
                    rec.migrations.append(dict(
                        g=g_next, moved=int(moved),
                        overrides=len(plan.owners),
                        apply_s=float(time.monotonic() - t0m)))
                    tele.event(
                        "controller.migration",
                        "controller: live migration at punctuation "
                        "boundary %d (%d rows moved, %d overrides)",
                        g_next, int(moved), len(plan.owners),
                        logger=log, limit=-1)
                    if faults is not None:
                        faults.on_reshard_apply()
                if eng._sharded is None:
                    variant = eng.ensure_variant(
                        scheme=plan.scheme, restructure_method=plan.rung)
                    if (plan.scheme, plan.rung) != (prev.scheme, prev.rung):
                        tele.event(
                            "controller.variant_switch",
                            "controller: plan variant %s/%s -> %s/%s at "
                            "punctuation boundary %d",
                            prev.scheme, prev.rung, plan.scheme, plan.rung,
                            g_next, logger=log, limit=-1)
                applied["plan"] = plan
            shape = (variant, None if plan is None else plan.slack,
                     None if plan is None else plan.owners, kk)
            if shape not in seen_shapes:
                # first dispatch of this (variant, slack, K) compiles a
                # new program: drop the warm-chunk latency window so the
                # watchdog judges it against ``watchdog_grace_s``, not
                # the warm median — same reason grace covers chunk 0
                seen_shapes.add(shape)
                progress["lat"].clear()
            vals_ok["safe"] = False     # the carry is being replaced
            t_disp = time.monotonic()
            ts0 = ts_base_for(g_next, interval)
            with tracer.span("chunk.dispatch", g0=g_next, k=kk, chunk=ci,
                             cpu=True) as dsp:
                with profiler.chunk(g_next), tracer.bound():
                    if cost_attr is not None and shape not in costs:
                        # opt-in per-chunk-shape attribution: this chunk
                        # runs once, under the trace, on this thread
                        (res, ebs, new_vals, xst), costs[shape] = \
                            cost_attr.run_chunk(eng, vals, batched, ts0,
                                                variant=variant)
                    else:
                        res, ebs, new_vals, xst = eng.run_stream_chunk(
                            vals, batched, ts0, variant=variant)
                if tracer.enabled and (xst or {}).get("engine") is not None:
                    # the lockstep walk's rounds and residue ops: host ints
                    est = xst["engine"]
                    dsp.set(swept=int(est.swept), residue=int(est.residue))
            t_dispatched = None
            if tracer.enabled:
                tracer.complete_ns("chunk.wait", t_submitted, dsp.t0,
                                   "chunk.wait", g0=g_next, k=kk, chunk=ci)
                t_dispatched = dsp.t1
            vals = new_vals
            vals_ok["safe"] = True
            progress["t"] = time.monotonic()
            in_flight.append((g_next, kk, res, ebs, infos, xst, plan,
                              qfill, t_disp, costs.get(shape), ci,
                              t_dispatched))
            g_next += kk
            if faults is not None:
                faults.on_executor_chunk()
            # commit at once: the chunk has already run (the driver reads
            # the host inside it), so holding it would overlap nothing
            commit_oldest()
            if cfg.snapshot_every and g_next % cfg.snapshot_every == 0:
                # punctuation-aligned snapshot: every chunk has committed,
                # so the carry is this boundary's state; publish via ckpt/
                if state["err"] is not None:    # abandoned run: never write
                    raise _Aborted()
                take_snapshot(g_next)

        def executor():
            """Chunk executor thread: dispatch/commit strictly in order so
            the state carry chains exactly as the monolithic run's would.
            Running it off the main thread overlaps the main thread's
            pulls, assembly and staging of chunk i+1 with chunk i (torch
            releases the GIL in its kernels and device waits).  The loop
            re-checks ``state['err']`` between items so a watchdog verdict
            stops it promptly.  The profiler window opens and closes here:
            ``torch.profiler`` records the thread that starts it."""
            profiler.start()
            try:
                while state["err"] is None:
                    try:
                        item = work_q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    if item is None:
                        break
                    progress["busy"] = True
                    progress["t"] = time.monotonic()
                    try:
                        dispatch(*item)
                    finally:
                        progress["busy"] = False
            except _Aborted:
                pass
            except BaseException as e:
                if state["err"] is None:
                    state["err"] = e
                try:                    # unblock the producer
                    while True:
                        work_q.get_nowait()
                except queue.Empty:
                    pass
            finally:
                profiler.stop()

        def watchdog():
            """Fires when the busy executor lands no progress within
            ``watchdog_factor`` × the median recent chunk latency
            (``watchdog_grace_s`` before the first commit)."""
            while not wd_stop.wait(0.02):
                if not progress["busy"] or state["err"] is not None:
                    continue
                if progress["lat"]:
                    timeout = max(cfg.watchdog_min_s, cfg.watchdog_factor
                                  * float(np.median(progress["lat"])))
                else:
                    timeout = cfg.watchdog_grace_s
                idle = time.monotonic() - progress["t"]
                if idle > timeout:
                    state["err"] = ExecutorHungError(
                        f"executor made no progress for {idle:.2f}s "
                        f"(timeout {timeout:.2f}s)",
                        info=dict(idle_s=idle, timeout_s=timeout,
                                  committed_intervals=len(rec.outputs),
                                  in_flight_chunks=len(in_flight)))
                    if faults is not None:
                        faults.abort()  # wake any injected stall/hang
                    return

        worker = threading.Thread(target=executor, daemon=True,
                                  name="stream-service-executor")
        worker.start()
        wd_stop = threading.Event()
        wd_thread = None
        if cfg.watchdog_factor:
            wd_thread = threading.Thread(target=watchdog, daemon=True,
                                         name="stream-service-watchdog")
            wd_thread.start()

        def submit(kk: int, plan):
            nonlocal executed
            g0 = int(skip_intervals) + executed
            qfill = len(ready)      # deterministic backlog signal
            chunk = [ready.popleft() for _ in range(kk)]
            # count at pop time: a chunk stranded by a crash (in work_q,
            # in_flight, or aborted here) is executed-but-uncommitted and
            # must land in the stats as unprocessed, not vanish
            executed += kk
            ci = chunks_done0 + chn["j"]    # global chunk index
            chn["j"] += 1
            with tracer.span("chunk.submit", g0=g0, k=kk, qfill=qfill,
                             chunk=ci) as ssp:
                batched = convert.events_to_torch(
                    {k: np.stack([c[0][k] for c in chunk])
                     for k in chunk[0][0]}, eng.device)
            t_submitted = None
            if tracer.enabled:
                # the chunk fills from its first interval's first admission
                t_first = tracer.perf_ns(float(chunk[0][1].enqueue_s.min()))
                tracer.complete_ns("chunk.fill", t_first, ssp.t0,
                                   "chunk.fill", g0=g0, k=kk, chunk=ci)
                t_submitted = ssp.t1
            item = (batched, kk, [c[1] for c in chunk], plan, qfill, ci,
                    t_submitted)
            while state["err"] is None:
                try:
                    work_q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    continue

        def wait_records(need_i: int) -> bool:
            """Block until the record of global chunk ``need_i`` exists.

            The decision for the j-th submitted chunk reads records of
            chunks committed strictly before submission j-1 — the newest
            record whose presence does not depend on the commit/decide
            race, so the window is identical on replay.  No deadlock: the
            needed commit happens inside the executor's dispatch of the
            previous chunk, which never waits on the main thread.
            """
            if chn["last_i"] >= need_i:
                return True
            with rec_cv:
                while chn["last_i"] < need_i and state["err"] is None:
                    rec_cv.wait(0.05)
            return state["err"] is None and chn["last_i"] >= need_i

        try:
            while state["err"] is None:
                # admission: a "drop" source never waits — one arrival
                # batch is admitted (or dropped at the full queue) per
                # dispatch cycle, modelling an arrival rate the service
                # cannot defer; a "block" source is backpressured: pulled
                # only while the next chunk is still short.
                if cfg.admission == "drop" and not state["exhausted"]:
                    pull_one()
                if ctl is not None:
                    K = ctl.plan.chunk
                while not state["exhausted"] and len(ready) < K:
                    if not pull_one():
                        break
                room = (K if max_intervals is None
                        else max(0, int(max_intervals) - executed))
                if min(K, len(ready), room) == 0:
                    break
                if ctl is not None:
                    # decide BEFORE building the submission, at the
                    # boundary of the chunk about to submit
                    gj = chunks_done0 + chn["j"]
                    if not wait_records(gj - 2):
                        break       # run already declared failed
                    window = [r for r in list(hist) if r["i"] <= gj - 2]
                    with tracer.span("controller.decide", g=int(
                            skip_intervals) + executed) as dsp:
                        decisions = ctl.step(int(skip_intervals) + executed,
                                             window)
                        dsp.set(n=len(decisions))
                    if advisory is not None:
                        # shadow timing tier: hints are logged + recorded,
                        # never applied — the replay path is untouched
                        for h in advisory.step(int(skip_intervals) + executed,
                                               window, decisions):
                            tele.record_doc("advisory", dict(h))
                            tele.event(
                                "controller.advisory",
                                "advisory (timing tier, NOT applied): "
                                "%s %s -> %s at g=%d",
                                h["knob"], h["old"], h["new"], h["g"],
                                logger=log, level=logging.INFO, limit=8)
                    if decisions and faults is not None:
                        faults.on_controller_decide()
                    if ctl.plan.chunk != K:
                        K = ctl.plan.chunk
                        while not state["exhausted"] and len(ready) < K:
                            if not pull_one():
                                break
                        room = (K if max_intervals is None
                                else max(0, int(max_intervals) - executed))
                kk = min(K, len(ready), room)
                if kk == 0:
                    break
                submit(kk, ctl.plan if ctl is not None else None)
        except BaseException as e:
            # a fatal source error (retries exhausted) lands here: fold it
            # into the structured crash path so stats stay intact
            if state["err"] is None:
                state["err"] = e
        finally:
            if wd_thread is not None:
                wd_stop.set()
                wd_thread.join()
            # always shut the executor down — even when the source raised —
            # so no run leaks a thread blocked on the work queue
            if state["err"] is None:
                work_q.put(None)
                worker.join()
            else:
                try:
                    work_q.put_nowait(None)
                except queue.Full:
                    pass
                # a cooperatively-aborted executor exits promptly; a truly
                # hung one (blocked inside a device call) is abandoned as a
                # daemon after the timeout and recorded in the stats
                worker.join(timeout=2.0 if isinstance(
                    state["err"], ExecutorHungError) else None)

        err = state["err"]
        hung_thread = worker.is_alive()
        if isinstance(err, ExecutorHungError) and not hung_thread:
            # the watchdog's contract: drain every committable in-flight
            # chunk (their device arrays are valid results), then publish
            # an emergency punctuation-aligned snapshot so recovery starts
            # from this boundary instead of the last periodic one
            try:
                while in_flight:
                    commit_oldest(check_crash=False)
                if cfg.snapshot_every and vals_ok["safe"] \
                        and g_next not in rec.snapshots:
                    take_snapshot(g_next, emergency=True)
                    err.info["emergency_snapshot"] = g_next
            except Exception:
                log.exception("post-hang drain/snapshot failed")
        stranded = max(0, executed - len(rec.outputs))
        if err is not None:
            self._finish(rec, asm, ready, crashed=True, stranded=stranded,
                         source=srcst, error=err, plane=faults,
                         chunks=list(hist), controller=ctl,
                         hung_thread=hung_thread, advisory=advisory)
            tracer.close()
            raise err

        rec.final_values = _host(eng.carry_out(vals))
        self._finish(rec, asm, ready, crashed=False, stranded=stranded,
                     source=srcst, plane=faults, chunks=list(hist),
                     controller=ctl, advisory=advisory)
        tracer.close()
        return rec

    def _make_controller(self, controller_state: Optional[Dict]
                         ) -> Optional[PlanController]:
        """Build the run's controller: the configured one, or the implicit
        slack-only controller that subsumes ``escalate_overflow``, or
        None.  Restoring from ``controller_state`` folds the snapshot's
        decision trace back into the plan and re-applies its slack and
        ownership; single-device scheme/rung variants bind here so a
        mid-storm switch costs a rebind."""
        cfg, eng = self.cfg, self.engine
        ctl_cfg = cfg.controller
        if (ctl_cfg is None and cfg.escalate_overflow
                and eng._sharded is not None):
            # the escalate_overflow contract as a one-knob controller:
            # widen on observed drops only, one boundary of cool-down,
            # bounded by the configured escalation budget
            ctl_cfg = ControllerConfig(
                window=1, sustain=1, cooldown=cfg.chunk_intervals,
                slack_widen=True, slack_factor=cfg.escalate_factor,
                max_escalations=cfg.escalate_overflow, fill_widen=0.0,
                degrade_scheme="", chunk_ladder=(), rung_ladder=())
        elif ctl_cfg is not None and cfg.escalate_overflow:
            ctl_cfg = dataclasses.replace(
                ctl_cfg, max_escalations=cfg.escalate_overflow,
                slack_factor=cfg.escalate_factor)
        if ctl_cfg is None:
            assert not controller_state, \
                ("snapshot records an adaptive run: configure "
                 "ServiceConfig.controller (or escalate_overflow) to "
                 "resume it")
            return None
        if cfg.snapshot_every and ctl_cfg.allow_timing:
            # wall latencies are not replayable signals: a snapshotted
            # run must decide from the deterministic tier only
            ctl_cfg = dataclasses.replace(ctl_cfg, allow_timing=False)
        sharded = eng._sharded is not None
        init_plan = Plan(
            scheme=eng.cfg.scheme, rung=eng.cfg.restructure_method,
            slack=(eng._sharded.exchange_slack if sharded else 0.0),
            chunk=cfg.chunk_intervals, owners=eng.owners)
        if controller_state and controller_state.get("init_plan"):
            stored = Plan.from_dict(controller_state["init_plan"])
            # scheme/rung/chunk come from the engine/service config and
            # must match (config mismatch is a caller error); slack and
            # ownership may differ when the same engine object already
            # escalated or migrated — the stored value is the original
            # run's ground truth
            assert (stored.scheme, stored.rung, stored.chunk) == \
                (init_plan.scheme, init_plan.rung, init_plan.chunk), \
                ("snapshot's adaptive run started from plan "
                 f"{stored.as_dict()}, this service is configured for "
                 f"{init_plan.as_dict()}")
            init_plan = stored
        ctl = PlanController(
            ctl_cfg, init_plan, sharded=sharded,
            snap_align=cfg.snapshot_every, queue_cap=cfg.queue_intervals,
            # the reshard knob only opens on an engine that can migrate
            # (shared_nothing, >1 shard, index routing)
            n_owners=(eng._sharded.n_dev if eng.reshardable else 0),
            n_slots=(eng.init_store.n_slots if eng.reshardable else 0))
        if controller_state:
            # pre-elastic manifests recorded plans without an "owners"
            # key; round-tripping through Plan normalizes the dict so the
            # restore check compares like with like
            plan_check = controller_state.get("plan")
            if plan_check is not None:
                plan_check = Plan.from_dict(plan_check).as_dict()
            ctl.restore(controller_state.get("trace", ()),
                        plan_check=plan_check)
        if sharded:
            # re-enter the restored layout: the snapshot's canonical
            # uid-order values are loaded by run() AFTER this rebind, so
            # they enter under the ownership the replayed trace folds to
            eng.rebind_ownership(ctl.plan.owners)
            if ctl.plan.slack != eng._sharded.exchange_slack:
                eng._sharded.set_exchange_slack(ctl.plan.slack)
        else:
            for sch in {ctl_cfg.degrade_scheme} - {""}:
                eng.ensure_variant(scheme=sch)
            for rung in ctl_cfg.rung_ladder:
                eng.ensure_variant(restructure_method=rung)
        return ctl

    def resume(self, source, **run_kwargs) -> ServiceRun:
        """Restore the newest *valid* punctuation-aligned snapshot, replay.

        Fallback order (DESIGN.md §2.7): candidate steps descend; a
        snapshot that fails :func:`verify_checkpoint` (torn
        manifest, truncated or corrupted leaf) or fails to load is logged
        and skipped, so corruption of the latest snapshot never escapes
        ``resume`` — it falls back to the previous valid one.  Raises
        ``FileNotFoundError`` only when no valid snapshot exists at all.
        """
        cfg = self.cfg
        assert cfg.ckpt_dir, "resume needs a ckpt_dir"
        rejected = []
        for step in checkpoint_steps(cfg.ckpt_dir):
            ok, why = verify_checkpoint(cfg.ckpt_dir, step)
            if not ok:
                log.warning("snapshot step %d failed verification (%s); "
                            "falling back to an older one", step, why)
                rejected.append(step)
                continue
            try:
                restored = load_checkpoint(
                    cfg.ckpt_dir, step,
                    dict(values=self.engine.init_store.values))
                meta = read_manifest_meta(cfg.ckpt_dir, step)
                assert meta is not None   # verified above
            except Exception as e:
                log.warning("snapshot step %d failed to load (%s: %s); "
                            "falling back to an older one",
                            step, type(e).__name__, e)
                rejected.append(step)
                continue
            # a config mismatch is a caller error, not corruption — raise
            assert meta["punct_interval"] == cfg.punct_interval, \
                "snapshot was taken at a different punctuation interval"
            return self.run(source, values=restored["values"],
                            skip_intervals=int(meta["intervals_done"]),
                            controller_state=meta.get("controller"),
                            **run_kwargs)
        raise FileNotFoundError(
            f"no valid snapshot under {cfg.ckpt_dir}"
            + (f" (rejected steps: {rejected})" if rejected else ""))

    # ------------------------------------------------------------------
    @property
    def stats(self) -> Dict:
        """The last run's stats, or a schema-valid zero record before any
        run — ``service.stats["drops"]`` never raises on a fresh service
        (the old ``None`` footgun)."""
        if self.last_run is not None and self.last_run.stats is not None:
            return self.last_run.stats
        return empty_stats()

    def _finish(self, rec: ServiceRun, asm: IntervalAssembler, ready,
                crashed: bool, stranded: int = 0,
                source: Optional[Dict] = None, error=None, plane=None,
                chunks: Optional[List[Dict]] = None, controller=None,
                hung_thread: bool = False, advisory=None):
        """Publish the run's accounting into the telemetry registry, then
        render ``rec.stats`` as the legacy compatibility view over its
        snapshot (DESIGN.md §2.11) — the registry is the source of truth,
        the merged dict a projection of it."""
        tele = rec.telemetry
        interval = self.cfg.punct_interval
        unprocessed = (len(ready) + stranded) * interval + asm.pending
        tele.count("service.arrived", asm.arrived + rec.admission_dropped)
        tele.count("service.processed", len(rec.outputs) * interval)
        tele.count("service.replayed", rec.replayed_intervals * interval)
        tele.count("service.late_rerouted", asm.late_rerouted)
        tele.count("service.drops", asm.watermark_dropped, kind="watermark")
        tele.count("service.drops", rec.admission_dropped, kind="admission")
        tele.count("service.drops", rec.exchange_dropped, kind="exchange")
        tele.count("service.unprocessed", unprocessed)
        tele.gauge("service.watermark", int(asm.watermark))
        tele.gauge("service.crashed", int(crashed))
        asm.publish(tele)

        srcstats = dict(source or {})
        backfill = ((srcstats.get("retries", 0)
                     + srcstats.get("deadline_misses", 0))
                    / max(srcstats.get("pulls", 0), 1))
        tele.count("source.pulls", srcstats.get("pulls", 0))
        tele.count("source.retries", srcstats.get("retries", 0))
        tele.count("source.deadline_misses",
                   srcstats.get("deadline_misses", 0))
        tele.count("source.backoff_s", srcstats.get("backoff_s", 0.0))
        tele.gauge("source.backfill_ratio", backfill)
        tele.gauge("source.alarm_threshold",
                   self.cfg.straggler.max_backfill_ratio)
        tele.gauge("source.alarm",
                   int(backfill > self.cfg.straggler.max_backfill_ratio))

        tele.ensure_records("snapshots")
        for s in rec.snapshots:
            tele.record("snapshots", step=int(s))
        # per-chunk time series (ring-bounded, newest last): the
        # controller's observation window, published for benchmarks and
        # post-mortems alike
        rec.chunk_records = [dict(r) for r in (chunks or [])]
        tele.ensure_records("chunks")
        for r in rec.chunk_records:
            tele.record_doc("chunks", dict(r))
        tele.observe_many("latency.event_s", rec.latency_s())
        tele.observe_many("latency.chunk_s",
                          [r["lat_s"] for r in rec.chunk_records])

        if controller is not None:
            tele.record_doc("controller", dict(
                init_plan=controller.init_plan.as_dict(),
                plan=controller.plan.as_dict(),
                escalations=controller.esc_done))
            tele.ensure_records("decisions")
            for d in controller.trace:
                tele.record_doc("decisions", dict(d))
            if advisory is not None:
                tele.ensure_records("advisory")
        if error is not None:
            tele.record_doc("error", dict(
                type=type(error).__name__, msg=str(error),
                hung_thread=hung_thread, **getattr(error, "info", {})))
        if plane is not None:
            plane.publish(tele)
        if self.engine._sharded is not None:
            tele.count("exchange.dropped", rec.exchange_dropped)
            tele.count("exchange.shipped", rec.exchange_shipped)
            tele.gauge("exchange.capacity", rec.exchange_capacity)
            tele.gauge("exchange.escalations",
                       controller.esc_done if controller is not None else 0)
            tele.gauge("exchange.slack",
                       self.engine._sharded.exchange_slack)
            # skew-aware placement ledger: observed load per ownership
            # shard over the whole run, its imbalance ratio (max/mean),
            # and every live migration the controller applied
            sh = rec.shard_events
            tot = int(sh.sum()) if sh is not None else 0
            tele.record_doc("placement", dict(
                shard_events=([int(v) for v in sh]
                              if sh is not None else []),
                imbalance=(float(int(sh.max()) * sh.size / tot)
                           if tot else 1.0),
                owners=[[int(u), int(o)]
                        for (u, o) in self.engine.owners]))
            tele.ensure_records("migrations")
            for m in rec.migrations:
                tele.record_doc("migrations", dict(m))
        rec.stats = stats_view(tele.snapshot())
        if not crashed:
            self._log_events(tele, rec.stats)

    @staticmethod
    def _log_events(tele: Telemetry, stats: Dict):
        """One structured event per nonzero drop category per run — never
        per interval.  ``tele.event`` rate-limits (limit=1 per registry,
        i.e. per run) and counts every occurrence in the snapshot."""
        drops = stats["drops"]
        if drops["watermark"]:
            tele.event("drops.watermark",
                       "watermark policy dropped %d late events this run",
                       drops["watermark"], logger=log)
        if drops["admission"]:
            tele.event("drops.admission",
                       "admission control dropped %d events at the full "
                       "queue this run", drops["admission"], logger=log)
        if drops["exchange"]:
            tele.event("drops.exchange",
                       "sharded exchange overflow dropped %d ops this run "
                       "(capacity=%d/bucket) — raise exchange_slack",
                       drops["exchange"], stats["exchange"]["capacity"],
                       logger=log)
        if stats["late_rerouted"]:
            tele.event("late.rerouted",
                       "%d late events rerouted into later intervals this "
                       "run", stats["late_rerouted"], logger=log,
                       level=logging.INFO)
        src = stats.get("source") or {}
        if src.get("alarm"):
            tele.event(
                "source.straggler_alarm",
                "source backfill ratio %.2f exceeded the straggler alarm "
                "threshold %.2f this run (%d retries, %d deadline misses "
                "over %d pulls)", src["backfill_ratio"],
                src["alarm_threshold"], src.get("retries", 0),
                src.get("deadline_misses", 0), src.get("pulls", 0),
                logger=log)
