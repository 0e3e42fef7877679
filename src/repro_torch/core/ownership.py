"""Ownership, local stores and the owner-routed op exchange.

Reference: ``repro/core/ownership.py`` (DESIGN.md §2.5).  Every chain-shard
layout (the paper's NUMA-aware configurations, §IV-E) starts from an
**ownership permutation** of the state store: ``owner(uid) = uid % n_owners``
stripes hot keys across shards, and permuting slots owner-major turns "route
to owner" into an integer division and lets a shard hold its part as a dense
``[per+1, W]`` block (``+1``: the local padding chain).  It is built once per
engine.

On top of it, the sharded driver buckets the ops each shard built by
destination owner (``bucket_by_owner``), pads every bucket to one capacity
and ships all of them with one ``all_to_all`` (``core/mesh.py``).  Bucket
overflow drops ops; drops are counted and surfaced, never silent.

What differs from the reference:

* ``bucket_by_owner`` takes any leading batch dimensions (the reference
  vmaps it inside ``shard_map``).  It always ranks with the one-pass
  counting partition, ``kernels/radix_partition``: the kernel on a CUDA
  tensor, over ``[n_intervals * n_shards, N_loc]`` keys in one launch, its
  twin on a CPU one.  The reference's ``_exchange_counting_wins`` picks the
  packed sort in a band of shapes where it measured faster on its host
  backend; both of its backbones give the same outputs bit for bit, so the
  port keeps the counting pass alone.
* The hash-probe table is one int32 key table (``kernels/hash_probe``), not
  two float32 tables of 16-bit halves.
* ``rebalance_ownership`` and ``migration_plan`` are the reference's, pure
  numpy on the host: the service's controller calls the first, live
  resharding (``ShardedStream.reshard``) the second.
* ``chunk_shard_output`` / ``unchunk_output`` work around ``shard_map``'s
  output specs; a stacked mesh has no such outputs, so they have no
  counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..kernels.hash_probe.ops import hash_probe
from ..kernels.hash_probe.ref import ASSOC, hash_probe_ref, insert_keys
from ..kernels.radix_partition.ops import radix_partition_rank
from ..kernels.radix_partition.ref import radix_partition_rank_ref
from .restructure import partition_permutation, take_along
from .types import StateStore

LAYOUTS = ("shared_nothing", "shared_per_socket", "shared_everything")

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Ownership:
    """Ownership permutation of a state store over ``n_owners`` shards.

    ``fwd``  : i32[S+1], original uid -> permuted uid (pad -> s_pad)
    ``per``  : slots per owner; owner o holds permuted uids
               [o*per, (o+1)*per)
    ``s_pad``: n_owners * per (>= S; trailing slots are dead padding)
    ``slot_is_max``: bool[s_pad+1] per *permuted* slot, or None when the
    store has no max-type tables.
    ``overrides``: sorted ``((uid, owner), ...)`` deviations from the
    round-robin striping ``uid % n_owners``.
    """

    n_owners: int
    per: int
    s_pad: int
    fwd: torch.Tensor
    slot_is_max: Optional[torch.Tensor]
    overrides: tuple = ()


def owner_of_uids(n_slots: int, n_owners: int, overrides=()) -> np.ndarray:
    """i32[S] owner per uid: round-robin striping + explicit overrides."""
    owner = (np.arange(n_slots, dtype=np.int64) % n_owners).astype(np.int32)
    for u, o in overrides:
        owner[int(u)] = int(o)
    return owner


def build_ownership(store: StateStore, n_owners: int,
                    overrides=()) -> Ownership:
    """Ownership permutation: striping + ``overrides``, on the store's device.

    Slots are laid out owner-major, uid-ascending within each owner; with no
    overrides this is the closed form ``(uid % n) * per + uid // n``.
    Overrides must keep every owner's bin within ``per`` slots.
    """
    s = store.n_slots
    n_owners = max(int(n_owners), 1)
    per = -(-s // n_owners)
    s_pad = per * n_owners
    overrides = tuple(sorted((int(u), int(o)) for u, o in overrides))
    owner = owner_of_uids(s, n_owners, overrides)
    counts = np.bincount(owner, minlength=n_owners)
    if counts.max(initial=0) > per:
        raise ValueError(f"override bin overflow: {counts.max()} > {per}")
    order = np.lexsort((np.arange(s), owner))  # owner-major, uid-asc
    new_np = np.empty(s, np.int32)
    ranks = np.arange(s, dtype=np.int64) - np.repeat(
        np.cumsum(np.concatenate([[0], counts[:-1]])), counts)
    new_np[order] = (owner[order].astype(np.int64) * per + ranks).astype(
        np.int32)
    dev = store.device
    fwd_np = np.full((s + 1,), s_pad, np.int32)
    fwd_np[:s] = new_np
    fwd = torch.from_numpy(fwd_np).to(dev)
    sim = None
    if any(store.table_is_max):
        flags = store.uid_is_max()  # [S+1]
        sim = torch.zeros((s_pad + 1,), dtype=torch.bool, device=dev)
        sim[fwd[:-1].long()] = flags[:-1]
    return Ownership(n_owners=n_owners, per=per, s_pad=s_pad, fwd=fwd,
                     slot_is_max=sim, overrides=overrides)


def rebalance_ownership(n_slots: int, n_owners: int, overrides,
                        shard_load: np.ndarray, hot,
                        max_moves: int = 16):
    """Greedy skew-aware placement from the observed access histogram.

    ``shard_load``: i64[n_owners] ops served per shard over the decision
    window; ``hot``: ``[(uid, count), ...]`` the window's hottest slots.
    Each step moves the heaviest not-yet-moved hot uid from the most
    loaded shard to the least loaded one, *swapping* it with that
    shard's coldest hot-listed (or synthetic zero-load) resident so
    every bin keeps exactly its striped size — ``per``/``s_pad`` and
    all block shapes are migration-invariant.  Pure host arithmetic,
    deterministic (ties broken by lowest uid), replay-safe: the result
    depends only on the arguments, which the decision trace records.

    Returns the new overrides tuple (sorted), or the input overrides
    unchanged when no beneficial move exists.
    """
    n_owners = max(int(n_owners), 1)
    if n_owners <= 1 or not len(hot):
        return tuple(sorted((int(u), int(o)) for u, o in overrides))
    load = np.asarray(shard_load, np.int64).copy()
    assert load.shape == (n_owners,)
    owner = owner_of_uids(n_slots, n_owners, overrides)
    hot = sorted(((int(u), int(c)) for u, c in hot),
                 key=lambda t: (-t[1], t[0]))
    hot_count = {u: c for u, c in hot}
    moved: set = set()
    for u, c in hot:
        if len(moved) >= 2 * max_moves:
            break
        if u in moved or c <= 0:
            continue
        src = int(owner[u])
        dst = int(np.argmin(load))
        if dst == src:
            continue
        # only move when it strictly shrinks the src/dst imbalance
        if load[src] - c < load[dst]:
            continue
        # swap victim: dst's coldest resident (prefer load-0, lowest uid)
        residents = np.flatnonzero(owner == dst)
        victim, v_load = -1, None
        for v in residents:
            if int(v) in moved:
                continue
            vl = hot_count.get(int(v), 0)
            if v_load is None or vl < v_load:
                victim, v_load = int(v), vl
                if vl == 0:
                    break
        if victim < 0:
            continue
        owner[u], owner[victim] = dst, src
        load[src] += v_load - c
        load[dst] += c - v_load
        moved.add(u)
        moved.add(victim)
    stripe = np.arange(n_slots, dtype=np.int64) % n_owners
    diff = np.flatnonzero(owner != stripe)
    return tuple((int(u), int(owner[u])) for u in diff)


def migration_plan(old: Ownership, new: Ownership):
    """Host-side plan for the moved-rows migration exchange.

    For each shard d and local block row r (permuted uid p = d*per+r):
      ``dst``  i32[n_dev, per]: new owner of the uid stored there under
               ``old`` (== d when the row stays put; dead padding rows
               route to their own shard so no traffic is generated)
      ``nidx`` i32[n_dev, per]: the row's index in the NEW owner's block
               (dead rows -> per, the local padding slot, overwritten by
               the pad-row reset)
      ``cap``  int: max rows moved between any (src, dst) pair, the
               all_to_all bucket capacity.  Exact by construction: a
               migration never drops rows.
    Shapes are migration-invariant because swaps preserve bin sizes.
    """
    if old.per != new.per or old.n_owners != new.n_owners:
        raise ValueError(f"migration between unequal ownerships: "
                         f"{old.n_owners} x {old.per} -> "
                         f"{new.n_owners} x {new.per}")
    n_dev, per = old.n_owners, old.per
    fwd_o = old.fwd[:-1].cpu().numpy()   # [S]
    fwd_n = new.fwd[:-1].cpu().numpy()
    dst = np.tile(np.arange(n_dev, dtype=np.int32)[:, None], (1, per))
    nidx = np.full((n_dev, per), per, np.int32)
    dst.flat[fwd_o] = (fwd_n // per).astype(np.int32)
    nidx.flat[fwd_o] = (fwd_n % per).astype(np.int32)
    src = np.repeat(np.arange(n_dev), per).reshape(n_dev, per)
    movers = dst != src
    cap = 0
    if movers.any():
        pair = src[movers].astype(np.int64) * n_dev + dst[movers]
        cap = int(np.bincount(pair).max())
    return dst, nidx, max(1, cap)


def permute_values(own: Ownership, values: torch.Tensor) -> torch.Tensor:
    """[S+1, W] original -> [s_pad+1, W] ownership layout (pad rows zero)."""
    out = torch.zeros((own.s_pad + 1, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out[own.fwd[:-1].long()] = values[:-1]
    return out


def unpermute_values(own: Ownership, values_pad: torch.Tensor
                     ) -> torch.Tensor:
    """[s_pad+1, W] ownership layout -> [S+1, W] original (pad row zero)."""
    s = own.fwd.shape[0] - 1
    out = torch.zeros((s + 1, values_pad.shape[1]), dtype=values_pad.dtype,
                      device=values_pad.device)
    out[:-1] = values_pad[own.fwd[:-1].long()]
    return out


def make_local_store(values: torch.Tensor,
                     slot_is_max: Optional[torch.Tensor] = None
                     ) -> StateStore:
    """The one constructor of per-shard local stores.

    ``values`` is a shard's ``[n_local+1, W]`` block (last row = local
    padding chain), or the ``[n_shards, n_local+1, W]`` stack of every
    shard's block; ``slot_is_max`` its per-slot max flags (``[n_local+1]``
    or ``[n_shards, n_local+1]``), since the ownership layout interleaves
    tables.  Every layout gets the same table metadata: one merged table
    based at 0 with the full local capacity.
    """
    n_local = values.shape[-2] - 1
    return StateStore(
        values=values, table_base=(0,), table_capacity=(n_local,),
        table_is_max=(slot_is_max is not None,), slot_is_max=slot_is_max)


# ---------------------------------------------------------------------------
# Owner-routed exchange: capacity-padded counting-partition bucketing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RoutePlan:
    """Bucketing of local rows by destination shard (fields ``[*lead, ...]``).

    ``take``    : i32[n_route, cap] local row feeding each bucket cell
    ``ok``      : bool[n_route, cap] cell holds a real (shipped) op
    ``rank``    : i32[N] each row's cell within its bucket (>= cap when the
                  row overflowed and was dropped)
    ``dst``     : i32[N] destination bucket (n_route for unrouted padding)
    ``dropped`` : i32, valid ops lost to bucket overflow
    ``fill``    : i32, occupancy of the fullest real bucket, before the
                  clamp (so ``fill > cap`` iff something dropped)
    """

    take: torch.Tensor
    ok: torch.Tensor
    rank: torch.Tensor
    dst: torch.Tensor
    dropped: torch.Tensor
    fill: torch.Tensor


def bucket_by_owner(dst: torch.Tensor, n_route: int, cap: int, *,
                    use_kernels: bool = True,
                    threads: Optional[int] = None) -> RoutePlan:
    """Bucket rows by ``dst`` (i32[*lead, N] in [0, n_route]; ``n_route``
    marks rows that are never shipped, e.g. padding ops).

    One counting-partition pass yields the per-destination histogram, the
    bucket offsets and each row's stable cell rank together; the capacity
    and overflow accounting read the same counts.  ``use_kernels`` lets the
    radix wrapper run its kernel on a CUDA tensor (its twin on a CPU one);
    ``threads`` overrides the kernel's block size.
    """
    n = dst.shape[-1]
    lead = tuple(dst.shape[:-1])
    keys = dst.reshape(-1, n)
    if use_kernels:
        rank, counts = radix_partition_rank(keys, n_route + 1,
                                            threads=threads)
    else:
        rank, counts = radix_partition_rank_ref(keys, n_route + 1)
    rank = rank.reshape(dst.shape)
    counts = counts.reshape(lead + (n_route + 1,))
    starts, _, order = partition_permutation(dst, rank, counts)
    cells = torch.arange(cap, dtype=I32, device=dst.device)
    j = starts[..., :n_route, None] + cells                 # [*lead, R, cap]
    real = counts[..., :n_route]
    ok = cells < torch.clamp(real, max=cap)[..., None]
    picked = take_along(order, torch.clamp(j, max=n - 1).reshape(
        lead + (n_route * cap,))).reshape(j.shape)
    take = torch.where(ok, picked, torch.zeros_like(picked))
    dropped = torch.sum(torch.clamp(real - cap, min=0), dim=-1, dtype=I32)
    fill = torch.amax(real, dim=-1)
    return RoutePlan(take=take, ok=ok, rank=rank, dst=dst, dropped=dropped,
                     fill=fill)


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - mask.dim()))


def route_gather(plan: RoutePlan, field: torch.Tensor, pad_value
                 ) -> torch.Tensor:
    """Gather a per-row field ``[*lead, N, ...]`` into its bucket layout
    ``[*lead, n_route, cap, ...]``; empty cells hold ``pad_value``."""
    nl = plan.take.dim() - 2
    n_route, cap = plan.take.shape[-2:]
    flat = plan.take.reshape(tuple(plan.take.shape[:nl]) + (n_route * cap,))
    out = take_along(field, flat)
    out = out.reshape(tuple(plan.take.shape) + tuple(field.shape[nl + 1:]))
    pad = torch.full((), pad_value, dtype=field.dtype, device=field.device)
    return torch.where(_bcast(plan.ok, out), out, pad)


def unroute_gather(plan: RoutePlan, bucketed: torch.Tensor, n_route: int,
                   cap: int, pad_value=0) -> torch.Tensor:
    """Inverse of ``route_gather`` for returned per-op results.

    ``bucketed``: ``[*lead, n_route*cap, ...]`` results laid out by (bucket,
    cell), as the reverse ``all_to_all`` deposits them.  Rows that were
    dropped (overflow) or never shipped get ``pad_value``.
    """
    ok = (plan.dst < n_route) & (plan.rank < cap)
    pos = (torch.clamp(plan.dst, max=n_route - 1) * cap
           + torch.clamp(plan.rank, max=cap - 1))
    out = take_along(bucketed, pos)
    pad = torch.full((), pad_value, dtype=bucketed.dtype,
                     device=bucketed.device)
    return torch.where(_bcast(ok, out), out, pad)


def exchange_capacity(n_local_ops: int, n_route: int, slack: float) -> int:
    """Bucket capacity: ``slack``× the balanced share, clamped to the worst
    case (all local ops to one owner).  slack >= n_route therefore
    guarantees zero drops at replicate-everything cost; the default (2.0)
    bounds exchange bytes at 2·N while absorbing moderate skew."""
    per_route = -(-n_local_ops // max(n_route, 1))
    cap = int(np.ceil(per_route * max(slack, 1.0)))
    return max(1, min(cap, n_local_ops))


# ---------------------------------------------------------------------------
# Flag-gated hash-probe owner lookup (kernels/hash_probe in the hot path)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ProbeRoute:
    """uid -> destination shard through the bucketed hash probe.

    The direct-addressed stores make owner lookup a gather; sparse-key
    deployments resolve the uid through a hash probe instead.  Under
    ``EngineConfig.use_hash_probe_route`` the sharded driver probes uid ->
    table slot, then reads the owner recorded at insertion time.
    """

    table: torch.Tensor       # i32[n_buckets, ASSOC], -1 = empty
    slot_owner: torch.Tensor  # i32[n_buckets*ASSOC + 1]; last = miss owner

    def owners_of(self, uid: torch.Tensor, *,
                  use_kernels: bool = True) -> torch.Tensor:
        probe = hash_probe if use_kernels else hash_probe_ref
        slot = probe(uid, self.table)
        # absent keys (slot -1) -> the sentinel slot holding the miss owner
        miss = torch.full_like(slot, self.slot_owner.shape[0] - 1)
        return self.slot_owner[torch.where(slot < 0, miss, slot).long()]


def build_probe_route(n_uids: int, owner_of_uid: np.ndarray,
                      miss_owner: int, *, device) -> ProbeRoute:
    """Insert uids 0..n_uids-1 (one pass that records each uid's slot) and
    write each uid's owner at its slot."""
    keys = np.arange(n_uids, dtype=np.int32)
    n_buckets = max(64, 2 * (-(-n_uids // ASSOC)))
    table, slot = insert_keys(keys, n_buckets)
    slot_owner = np.full((n_buckets * ASSOC + 1,), miss_owner, np.int32)
    slot_owner[slot] = np.asarray(owner_of_uid, np.int32)[keys]
    return ProbeRoute(table=torch.from_numpy(table).to(device),
                      slot_owner=torch.from_numpy(slot_owner).to(device))
