"""Deterministic, seeded fault-injection plane (DESIGN.md §2.7).

A copy of the reference's ``repro/runtime/faults.py`` (no JAX there): the
same sites, kinds and seeded schedules, so a seed fires the same faults in
both packages.

A *fault site* is a named host-side point in the service loop where a
scheduled fault can act.  The plane never touches device code: every
fault models something the host runtime must survive — a flaky or
stalled source, an executor thread dying between dispatch and commit, a
hung executor, a snapshot torn mid-write.  Sites:

=====================  ====================================================
``source.pull``        before each ``next(source)``: raise a
                       ``TransientSourceError`` (retryable) or stall
``executor.crash``     on the executor thread between a chunk's dispatch
                       and its commit: raise ``InjectedCrashError``
``executor.hang``      same point: stall for ``duration_s`` — an
                       *abortable* wait, so the service watchdog can cut
                       it short (``HangAborted``)
``snapshot.publish``   after a snapshot's atomic publish: corrupt it on
                       disk (torn manifest, flipped or truncated leaf,
                       crashed-writer debris directory)
``controller.decide``  on the main thread right after the adaptive
                       controller appends a decision to its trace and
                       BEFORE the decided chunk is submitted — the
                       decision exists but no snapshot has recorded it
                       yet (DESIGN.md §2.9 replay contract)
=====================  ====================================================

A ``FaultSchedule`` is a **pure function of its seed**
(:func:`random_schedule`): the same seed always yields the same faults
at the same site visits, so every chaos run is replayable.  The plane
records every fault it fires in ``FaultPlane.fired`` and the service
merges that log into ``stats["faults"]``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np

SOURCE_PULL = "source.pull"
EXECUTOR_CRASH = "executor.crash"
EXECUTOR_HANG = "executor.hang"
SNAPSHOT_PUBLISH = "snapshot.publish"
CONTROLLER_DECIDE = "controller.decide"
RESHARD_APPLY = "reshard.apply"

#: every site -> the fault kinds that may act there.  New sites append
#: LAST: random_schedule's draw order follows this dict, so inserting a
#: site earlier would silently re-deal every pre-existing seed.
SITE_KINDS: Dict[str, tuple] = {
    SOURCE_PULL: ("raise", "stall"),
    EXECUTOR_CRASH: ("crash",),
    EXECUTOR_HANG: ("hang",),
    SNAPSHOT_PUBLISH: ("torn_manifest", "corrupt_leaf", "truncate_leaf",
                       "debris"),
    CONTROLLER_DECIDE: ("crash",),
    RESHARD_APPLY: ("crash",),
}
SITES = tuple(SITE_KINDS)


class InjectedFault(RuntimeError):
    """Base class of every error the fault plane raises."""


class TransientSourceError(InjectedFault):
    """A retryable source failure (the service's retry/backoff target)."""


class InjectedCrashError(InjectedFault):
    """Executor death between dispatch and commit (worker crash)."""


class HangAborted(InjectedFault):
    """An injected hang that the watchdog cut short."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: fire ``kind`` on the ``at``-th visit (0-based)
    of ``site``."""

    site: str
    at: int
    kind: str
    duration_s: float = 0.0     # stall/hang only

    def __post_init__(self):
        assert self.site in SITE_KINDS, self.site
        assert self.kind in SITE_KINDS[self.site], (self.site, self.kind)
        assert self.at >= 0, self.at
        assert self.duration_s >= 0.0, self.duration_s


def random_schedule(seed: int, *, n_pulls: int, n_chunks: int,
                    n_snapshots: int, n_decisions: int = 0,
                    n_reshards: int = 0, max_faults: int = 3,
                    hang_s: float = 8.0,
                    stall_s: float = 0.1) -> List[Fault]:
    """Deterministic schedule: a pure function of ``seed`` (and the site
    ranges).  At most one hang per schedule (a hang costs one watchdog
    timeout of wall clock); ``hang_s`` should exceed the watchdog timeout
    so an injected hang is always *detected*, never slept through.
    ``n_decisions`` opens the ``controller.decide`` site (adaptive runs
    only) and ``n_reshards`` the ``reshard.apply`` site (elastic runs);
    the defaults of 0 keep them closed, so pre-existing seeds yield
    byte-identical schedules."""
    rng = np.random.default_rng(np.random.SeedSequence([0xFA017, int(seed)]))
    n_faults = int(rng.integers(1, max_faults + 1))
    ranges = dict(zip(SITES, (n_pulls, n_chunks, n_chunks, n_snapshots,
                              n_decisions, n_reshards)))
    sites, weights = [], []
    for site, w in ((SOURCE_PULL, 0.35), (EXECUTOR_CRASH, 0.25),
                    (EXECUTOR_HANG, 0.15), (SNAPSHOT_PUBLISH, 0.25),
                    (CONTROLLER_DECIDE, 0.2), (RESHARD_APPLY, 0.2)):
        if ranges[site] > 0:
            sites.append(site)
            weights.append(w)
    if not sites:
        return []
    weights = np.asarray(weights) / np.sum(weights)
    out: List[Fault] = []
    used = set()
    hung = False
    for _ in range(n_faults):
        site = sites[int(rng.choice(len(sites), p=weights))]
        if site == EXECUTOR_HANG and hung:
            site = EXECUTOR_CRASH      # at most one hang per schedule
        at = int(rng.integers(0, ranges[site]))
        if (site, at) in used:
            continue
        used.add((site, at))
        kind = SITE_KINDS[site][int(rng.integers(0, len(SITE_KINDS[site])))]
        dur = 0.0
        if kind == "stall":
            dur = float(stall_s)
        elif kind == "hang":
            dur, hung = float(hang_s), True
        out.append(Fault(site=site, at=at, kind=kind, duration_s=dur))
    return sorted(out, key=lambda f: (f.site, f.at))


class FaultPlane:
    """Consults the schedule at each site visit and acts.

    Per-site visit counters make the plane deterministic: the *n*-th
    visit of a site always observes the same scheduled fault, whatever
    the wall-clock interleaving.  ``abort()`` (called by the service
    watchdog) wakes every injected stall/hang immediately.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self._sched: Dict[tuple, Fault] = {}
        for f in faults:
            assert (f.site, f.at) not in self._sched, \
                f"duplicate fault at {(f.site, f.at)}"
            self._sched[(f.site, f.at)] = f
        self.visits: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: List[Dict] = []
        self._abort = threading.Event()

    def abort(self) -> None:
        """Cut every in-progress injected stall/hang short (watchdog)."""
        self._abort.set()

    def publish(self, tele) -> None:
        """Mirror the injection ledger into a telemetry registry
        (DESIGN.md §2.11): one structured record per fired fault plus a
        per-site visit counter.  ``tele`` is duck-typed (anything with
        ``ensure_records``/``record_doc``/``count``) so this layer never
        imports the runtime telemetry module."""
        tele.ensure_records("faults")
        for f in self.fired:
            tele.record_doc("faults", dict(f))
        tele.count("faults.fired", len(self.fired))
        for site, n in self.visits.items():
            if n:
                tele.count("faults.visits", n, site=site)

    def _visit(self, site: str) -> Optional[Fault]:
        i = self.visits[site]
        self.visits[site] = i + 1
        f = self._sched.get((site, i))
        if f is not None:
            self.fired.append(dict(site=site, visit=i, kind=f.kind,
                                   duration_s=f.duration_s))
        return f

    # -- sites (called by runtime/service.py) --------------------------
    def on_source_pull(self) -> None:
        f = self._visit(SOURCE_PULL)
        if f is None:
            return
        if f.kind == "raise":
            raise TransientSourceError(
                f"injected source fault at pull {f.at}")
        self._abort.wait(f.duration_s)          # stall (abortable)

    def on_executor_chunk(self) -> None:
        """Between a chunk's dispatch and its commit."""
        f = self._visit(EXECUTOR_CRASH)
        if f is not None:
            raise InjectedCrashError(
                f"injected executor crash at chunk {f.at}")
        f = self._visit(EXECUTOR_HANG)
        if f is not None and self._abort.wait(f.duration_s):
            raise HangAborted(
                f"injected executor hang at chunk {f.at} aborted")

    def on_snapshot_publish(self, step_dir: str) -> None:
        f = self._visit(SNAPSHOT_PUBLISH)
        if f is not None:
            corrupt_snapshot(step_dir, f.kind)

    def on_controller_decide(self) -> None:
        """After the controller appended >= 1 decision to its trace, on
        the main thread, BEFORE the decided chunk is submitted.  The
        visit counter indexes decision *boundaries*, so ``at=k`` crashes
        on the k-th boundary that actually switched a knob — between the
        decision and any snapshot that would record it."""
        f = self._visit(CONTROLLER_DECIDE)
        if f is not None:
            raise InjectedCrashError(
                f"injected controller crash at decision boundary {f.at}")

    def on_reshard_apply(self) -> None:
        """Right after a live migration moved the state onto its new
        placement and BEFORE the next chunk is dispatched — the worst
        crash point for elastic resharding: the device layout changed but
        no snapshot records the migrated run yet.  Recovery must land on
        a *consistent* layout (the pre-migration snapshot's canonical
        values re-enter under whatever ownership the replayed trace
        folds to)."""
        f = self._visit(RESHARD_APPLY)
        if f is not None:
            raise InjectedCrashError(
                f"injected crash after reshard apply {f.at}")


# ---------------------------------------------------------------------------
# on-disk snapshot corruption (torn-write simulation; also used directly
# by tests and examples/streaming_service.py --corrupt-latest)
# ---------------------------------------------------------------------------
def corrupt_snapshot(step_dir: str, kind: str) -> str:
    """Damage a *published* snapshot the way a torn write / crashed
    writer would.  Returns a short description of what was done."""
    assert kind in SITE_KINDS[SNAPSHOT_PUBLISH], kind
    if kind == "torn_manifest":
        path = os.path.join(step_dir, "manifest.json")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return f"truncated manifest.json to {max(1, size // 2)}B"
    if kind == "debris":
        # a crashed writer's half-made step directory with a HIGHER step:
        # it must never shadow the valid snapshot it sits next to
        parent = os.path.dirname(step_dir.rstrip(os.sep))
        m = re.match(r"step_(\d+)$", os.path.basename(step_dir.rstrip(os.sep)))
        step = int(m.group(1)) if m else 0
        debris = os.path.join(parent, f"step_{step + 1:08d}")
        os.makedirs(debris, exist_ok=True)
        with open(os.path.join(debris, "values.npy"), "wb") as f:
            f.write(b"\x93NUMPY partial")
        return f"planted manifest-less debris dir {os.path.basename(debris)}"
    leaves = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))
    assert leaves, f"no leaves under {step_dir}"
    path = os.path.join(step_dir, leaves[0])
    size = os.path.getsize(path)
    if kind == "truncate_leaf":
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
        return f"truncated {leaves[0]} to {max(1, size // 2)}B"
    with open(path, "r+b") as f:            # corrupt_leaf: flip last byte
        f.seek(size - 1)
        b = f.read(1)
        f.seek(size - 1)
        f.write(bytes([b[0] ^ 0xFF]))
    return f"flipped a byte in {leaves[0]}"


def schedule_to_json(faults: Sequence[Fault]) -> str:
    return json.dumps([dataclasses.asdict(f) for f in faults])


def schedule_from_json(s: str) -> List[Fault]:
    return [Fault(**d) for d in json.loads(s)]
