"""Adaptive dual-mode control plane (DESIGN.md §2.9).

A copy of the reference's ``repro/runtime/controller.py``, which is pure
Python; only the lazy import of ``rebalance_ownership`` points at the port.
``decide`` is ported as the reference's code stands: on a sharded plan the
``chunk`` knob moves too (DESIGN.md §2.9), although a reference test asserts
that a sharded plan moves ``slack`` alone.

A deterministic feedback controller embedded in ``StreamService``'s loop:
at each punctuation boundary it reads the per-chunk record window the
service maintains (``stats["chunks"]``) and moves the live plan inside a
small legal lattice of pre-jitted variants —

  ``scheme``  degrade the optimistic scheme to a pessimistic one under a
              sustained conflict storm (tstream → lock), probe back after
              the cool-down
  ``slack``   widen the sharded exchange capacity before (fill crowding)
              or after (observed drops) overflow loses events — this
              subsumes the earlier one-way ``escalate_overflow`` hack
  ``chunk``   grow/shrink the service chunk size K when fixed per-chunk
              cost dominates (backlog) or per-interval latency degrades
  ``rung``    step the restructure rung when chain dominance leaves the
              autotuned ladder's band

Everything here is a *pure function of the observed record window*: the
controller never reads a clock, an rng, or device values.  Signals split
into a deterministic tier (abort/fail counts, chain stats, exchange
drop/fill counters, queue fill — all replayed bit-identically from the
same events) and a timing tier (chunk wall latency), and the timing tier
is force-disabled whenever snapshots are on, so every decision a
snapshotted run makes is reproducible from the replayed stream alone.
That is what makes crash → restore → replay of an *adaptive* run bitwise
identical to the uninterrupted run: the snapshot manifest carries the
decision trace plus the record window tail, ``resume`` folds the trace
back into the plan, and the first post-restore decision recomputes from
the same records the uninterrupted run saw (tests/test_faults.py,
tests/test_controller_property.py).

Hysteresis: each knob carries the global-interval index of its last
switch and may not move again within ``cooldown`` intervals; storm
triggers additionally require ``sustain`` consecutive storming records.
Decisions append to a monotone trace (non-decreasing ``g``), one dict
per switch: ``{"g", "knob", "old", "new", "reason"}``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

KNOBS = ("slack", "scheme", "chunk", "rung", "reshard")


def norm_owners(owners) -> Tuple[Tuple[int, int], ...]:
    """Canonical ownership-override form: sorted tuple of (uid, owner)."""
    return tuple(sorted((int(u), int(o)) for u, o in owners))


@dataclasses.dataclass(frozen=True)
class Plan:
    """One point of the plan lattice.  ``scheme``/``rung`` name the
    engine variant (construction values = the base ``_fused`` program),
    ``slack`` the sharded exchange slack (0.0 on single-device),
    ``chunk`` the service chunk size K in intervals, and ``owners`` the
    ownership-placement overrides the ``reshard`` knob migrates onto
    (() = pure round-robin striping)."""

    scheme: str
    rung: str
    slack: float
    chunk: int
    owners: Tuple[Tuple[int, int], ...] = ()

    def as_dict(self) -> Dict:
        return dict(scheme=self.scheme, rung=self.rung, slack=self.slack,
                    chunk=self.chunk,
                    owners=[[int(u), int(o)] for u, o in self.owners])

    @staticmethod
    def from_dict(d: Dict) -> "Plan":
        return Plan(scheme=str(d["scheme"]), rung=str(d["rung"]),
                    slack=float(d["slack"]), chunk=int(d["chunk"]),
                    owners=norm_owners(d.get("owners", ())))


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Decision rules + lattice bounds.  A knob whose lattice is empty
    (``degrade_scheme=""``, ``chunk_ladder=()``, ``rung_ladder=()``,
    ``slack_widen=False``) never moves."""

    window: int = 4        # records a decision may read
    sustain: int = 2       # consecutive storming records to call a storm
    cooldown: int = 8      # global intervals a switched knob stays frozen

    # scheme degradation (single-device lattice)
    degrade_scheme: str = ""          # "" disables the knob
    degrade_chain_frac: float = 0.75  # max_chain / events-per-interval
    degrade_fail_frac: float = 0.25   # failed-op fraction of all op slots

    # exchange slack (sharded lattice)
    slack_widen: bool = True
    slack_factor: float = 2.0
    slack_max: float = 64.0
    fill_widen: float = 0.0   # >0: widen when max_fill/capacity crosses
                              # this BEFORE anything drops (predictive)
    max_escalations: int = 0  # 0 = unbounded

    # chunk size K
    chunk_ladder: Tuple[int, ...] = ()  # legal K values; () disables
    backlog_grow: float = 2.0   # grow when qfill >= backlog_grow*K sustained
    grow_lat_s: float = 0.0     # timing tier: grow while chunks run under
    shrink_lat_s: float = 0.0   # timing tier: shrink when lat/interval over

    # restructure rung
    rung_ladder: Tuple[str, ...] = ()  # () disables; [0]=calm, [-1]=storm
    rung_chain_frac: float = 0.0       # chain dominance that steps up

    # elastic resharding (sharded shared_nothing lattice): migrate hot
    # slots when max/mean shard load sustains above the threshold
    reshard_imbalance: float = 0.0  # <=1.0 disables the knob
    reshard_max_moves: int = 16     # hot uids migrated per decision

    # timing tier master switch.  The service forces this False whenever
    # snapshots are on: wall latencies are not replayable signals.
    allow_timing: bool = False


def _shard_imbalance(r: Dict) -> float:
    """max/mean of one record's per-shard load (1.0 = perfectly flat)."""
    xs = r.get("x_shard") or ()
    total = sum(xs)
    if not xs or total <= 0:
        return 1.0
    return max(xs) * len(xs) / total


def _chain_frac(r: Dict) -> float:
    """Chain dominance of one chunk record: longest version chain over
    events per interval (every event touches >= 1 distinct key, so a
    value near 1.0 means one hot key serializes the interval)."""
    ev_per_iv = r["events"] // max(r["k"], 1)
    return r["max_chain"] / max(ev_per_iv, 1)


def _fail_frac(r: Dict) -> float:
    return r["fail"] / max(r["ops"], 1)


def _stormy(r: Dict, cfg: ControllerConfig, base_scheme: str) -> bool:
    """Conflict-storm predicate for one record.  Only records executed
    under the *base* scheme count: the degraded oracle (eval_lock)
    reports the whole interval as one serial chain, so its stats measure
    the plan, not the workload."""
    if r.get("scheme") != base_scheme:
        return False
    return (_chain_frac(r) >= cfg.degrade_chain_frac
            or _fail_frac(r) >= cfg.degrade_fail_frac)


def _ladder_step(ladder: Sequence, cur, up: bool):
    """Next rung above/below ``cur`` on ``ladder`` (None at the ends or
    when ``cur`` left the ladder)."""
    if cur not in ladder:
        return None
    i = ladder.index(cur) + (1 if up else -1)
    return ladder[i] if 0 <= i < len(ladder) else None


def decide(cfg: ControllerConfig, plan: Plan, window: Sequence[Dict],
           g: int, last_switch: Dict[str, int], *, init_plan: Plan,
           sharded: bool, esc_done: int, snap_align: int,
           queue_cap: int, n_owners: int = 0,
           n_slots: int = 0) -> List[Dict]:
    """The decision function: pure in every argument.

    ``window`` is the chunk-record window (oldest first) visible at
    boundary ``g`` — the service guarantees the same window contents on
    replay (records of chunks committed strictly before the previous
    submission).  Returns at most one decision per knob, in fixed knob
    order; the caller folds them into the plan via ``PlanController``.
    """
    decisions: List[Dict] = []
    w = list(window)[-cfg.window:]
    sust = w[-cfg.sustain:] if len(w) >= cfg.sustain else None

    def ready(knob: str) -> bool:
        last = last_switch.get(knob)
        return last is None or g - last >= cfg.cooldown

    def emit(knob, old, new, reason):
        decisions.append(dict(g=int(g), knob=knob, old=old, new=new,
                              reason=reason))

    # -- slack: sharded exchange capacity (one-way widening) --------------
    if (sharded and cfg.slack_widen and ready("slack")
            and plan.slack < cfg.slack_max
            and (cfg.max_escalations <= 0 or esc_done < cfg.max_escalations)):
        drops = any(r["x_drop"] > 0 for r in w)
        crowded = (cfg.fill_widen > 0.0
                   and any(r["x_cap"] > 0
                           and r["x_fill"] >= cfg.fill_widen * r["x_cap"]
                           for r in w))
        if drops or crowded:
            new = min(plan.slack * cfg.slack_factor, cfg.slack_max)
            if new > plan.slack:
                emit("slack", plan.slack, new,
                     "overflow-drops" if drops else "fill-crowding")

    # -- scheme: degrade under a sustained conflict storm, probe back -----
    if not sharded and cfg.degrade_scheme and ready("scheme"):
        if plan.scheme == init_plan.scheme:
            if sust and all(_stormy(r, cfg, init_plan.scheme)
                            for r in sust):
                emit("scheme", plan.scheme, cfg.degrade_scheme,
                     "conflict-storm")
        elif plan.scheme == cfg.degrade_scheme:
            # the degraded oracle cannot observe chain structure, so
            # recovery is a probe: re-enter the base plan once the
            # cool-down expires; a persisting storm re-degrades only
            # after `sustain` fresh base-scheme records
            emit("scheme", plan.scheme, init_plan.scheme, "probe")

    # -- chunk size K ------------------------------------------------------
    if (cfg.chunk_ladder and ready("chunk")
            and (snap_align == 0 or g % snap_align == 0)):
        # legality: K must tile the snapshot period and fit the queue
        ladder = sorted(k for k in set(cfg.chunk_ladder)
                        if 0 < k <= queue_cap
                        and (snap_align == 0 or snap_align % k == 0))
        full = sust and all(r["k"] == plan.chunk for r in sust)
        grow = shrink = False
        if full and all(r["qfill"] >= cfg.backlog_grow * plan.chunk
                        for r in sust):
            grow, reason = True, "backlog"
        elif (cfg.allow_timing and cfg.grow_lat_s > 0.0 and full
              and all(r["lat_s"] < cfg.grow_lat_s for r in sust)):
            grow, reason = True, "amortize-dispatch"
        elif (cfg.allow_timing and cfg.shrink_lat_s > 0.0 and sust
              and all(r["lat_s"] / max(r["k"], 1) > cfg.shrink_lat_s
                      for r in sust)):
            shrink, reason = True, "latency"
        if grow or shrink:
            new = _ladder_step(ladder, plan.chunk, up=grow)
            if new is None and plan.chunk not in ladder:
                # construction K off the ladder: enter at the nearest
                # rung in the direction of travel
                cands = ([k for k in ladder if k > plan.chunk] if grow
                         else [k for k in ladder if k < plan.chunk][::-1])
                new = cands[0] if cands else None
            if new is not None:
                emit("chunk", plan.chunk, new, reason)

    # -- restructure rung --------------------------------------------------
    if (not sharded and cfg.rung_ladder and cfg.rung_chain_frac > 0.0
            and ready("rung") and plan.scheme == init_plan.scheme):
        base_w = [r for r in w if r.get("scheme") == init_plan.scheme]
        bs = base_w[-cfg.sustain:] if len(base_w) >= cfg.sustain else None
        if bs is not None:
            hot = all(_chain_frac(r) >= cfg.rung_chain_frac for r in bs)
            want = cfg.rung_ladder[-1] if hot else cfg.rung_ladder[0]
            if want != plan.rung and plan.rung in cfg.rung_ladder:
                emit("rung", plan.rung, want,
                     "chain-dominance" if hot else "calm")

    # -- reshard: skew-aware placement from the window's load histogram ----
    # Pure over the record window (per-shard totals + the top-M hot-slot
    # counts the service records per chunk), so replay after a restore
    # recomputes the SAME placement from the same records.
    if (sharded and cfg.reshard_imbalance > 1.0 and ready("reshard")
            and n_owners > 1 and n_slots > 0):
        xw = [r for r in w if r.get("x_shard")]
        sx = xw[-cfg.sustain:] if len(xw) >= cfg.sustain else None
        if sx and all(_shard_imbalance(r) >= cfg.reshard_imbalance
                      for r in sx):
            from ..core.ownership import rebalance_ownership
            shard = [0] * n_owners
            hot_acc: Dict[int, int] = {}
            for r in xw:
                for i, v in enumerate(r["x_shard"]):
                    shard[i] += int(v)
                for u, c in r.get("hot", ()):
                    hot_acc[int(u)] = hot_acc.get(int(u), 0) + int(c)
            new = rebalance_ownership(
                n_slots, n_owners, plan.owners, shard,
                list(hot_acc.items()), max_moves=cfg.reshard_max_moves)
            if new != norm_owners(plan.owners):
                emit("reshard",
                     [[int(u), int(o)] for u, o in plan.owners],
                     [[int(u), int(o)] for u, o in new],
                     f"imbalance-{_shard_imbalance(sx[-1]):.2f}x")

    return decisions


def apply_decision(plan: Plan, d: Dict) -> Plan:
    """Fold one decision into a plan (knob names == Plan field names,
    except ``reshard`` which sets the ``owners`` placement)."""
    assert d["knob"] in KNOBS, d
    if d["knob"] == "reshard":
        return dataclasses.replace(plan, owners=norm_owners(d["new"]))
    return dataclasses.replace(plan, **{d["knob"]: d["new"]})


def replay_plan(init_plan: Plan, trace: Sequence[Dict]) -> Plan:
    """Fold a decision trace: the plan at the trace's end.  Used by the
    snapshot publisher (plan at the punctuation boundary), by ``resume``
    and by the property suite's replay checks."""
    plan = init_plan
    for d in trace:
        plan = apply_decision(plan, d)
    return plan


class PlanController:
    """The mutable shell around :func:`decide`: holds the live plan, the
    monotone decision trace and per-knob cool-down state.  All mutation
    happens on the service's main thread."""

    def __init__(self, cfg: ControllerConfig, init_plan: Plan, *,
                 sharded: bool, snap_align: int, queue_cap: int,
                 n_owners: int = 0, n_slots: int = 0):
        self.cfg = cfg
        self.init_plan = init_plan
        self.plan = init_plan
        self.sharded = bool(sharded)
        self.snap_align = int(snap_align)
        self.queue_cap = int(queue_cap)
        self.n_owners = int(n_owners)   # 0 disables the reshard knob
        self.n_slots = int(n_slots)
        self.trace: List[Dict] = []
        self.last_switch: Dict[str, int] = {}
        self.esc_done = 0

    def _fold(self, d: Dict) -> None:
        assert not self.trace or d["g"] >= self.trace[-1]["g"], \
            "decision trace must be monotone in g"
        self.plan = apply_decision(self.plan, d)
        self.last_switch[d["knob"]] = int(d["g"])
        if d["knob"] == "slack":
            self.esc_done += 1
        self.trace.append(d)

    def restore(self, trace: Sequence[Dict], plan_check: Optional[Dict] = None
                ) -> None:
        """Rebuild controller state from a snapshot's decision trace."""
        assert not self.trace, "restore() only into a fresh controller"
        for d in trace:
            self._fold(dict(d))
        if plan_check is not None:
            assert self.plan.as_dict() == dict(plan_check), \
                (f"replayed trace folds to {self.plan.as_dict()}, snapshot "
                 f"recorded plan {plan_check}")

    def step(self, g: int, window: Sequence[Dict]) -> List[Dict]:
        """Decide at boundary ``g`` from ``window``; fold + return the
        decisions (empty list = plan unchanged)."""
        decisions = decide(
            self.cfg, self.plan, window, g, self.last_switch,
            init_plan=self.init_plan, sharded=self.sharded,
            esc_done=self.esc_done, snap_align=self.snap_align,
            queue_cap=self.queue_cap, n_owners=self.n_owners,
            n_slots=self.n_slots)
        for d in decisions:
            self._fold(d)
        return decisions


class AdvisoryTiming:
    """The sanctioned timing→control bridge (DESIGN.md §2.11).

    Snapshots force ``allow_timing`` off because wall latencies are not
    replayable signals.  This shadow evaluates :func:`decide` with the
    timing tier re-enabled — same plan, same window, same cool-down
    state as the applied controller — and surfaces only the decisions
    the deterministic tier did NOT make, tagged ``advisory=True``.
    Hints are pure observability: the service logs and records them but
    never folds them into the plan, never stores them in snapshots, and
    never lets them touch the decision trace, so replay identity is
    untouched.  A per-knob hint ledger applies the same ``cooldown`` so
    a persistent timing signal hints once per cool-down window, not at
    every boundary.
    """

    def __init__(self, ctl: PlanController):
        self.ctl = ctl
        self.cfg = dataclasses.replace(ctl.cfg, allow_timing=True)
        self.last_hint: Dict[str, int] = {}
        self.hints: List[Dict] = []

    def step(self, g: int, window: Sequence[Dict],
             applied: Sequence[Dict]) -> List[Dict]:
        """Shadow-decide at boundary ``g`` AFTER the applied controller
        stepped; returns the fresh hints (possibly empty)."""
        last = dict(self.ctl.last_switch)
        for knob, hg in self.last_hint.items():
            last[knob] = max(hg, last.get(knob, hg))
        shadow = decide(
            self.cfg, self.ctl.plan, window, g, last,
            init_plan=self.ctl.init_plan, sharded=self.ctl.sharded,
            esc_done=self.ctl.esc_done, snap_align=self.ctl.snap_align,
            queue_cap=self.ctl.queue_cap, n_owners=self.ctl.n_owners,
            n_slots=self.ctl.n_slots)
        applied_knobs = {d["knob"] for d in applied}
        out: List[Dict] = []
        for d in shadow:
            if d["knob"] in applied_knobs:
                continue        # the deterministic tier already moved it
            hint = dict(d, advisory=True)
            self.last_hint[d["knob"]] = int(g)
            self.hints.append(hint)
            out.append(hint)
        return out
