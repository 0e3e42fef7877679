"""Sharded fused streaming: the device-parallel ``run_stream`` on one card.

Reference: ``repro/core/sharded_stream.py`` (DESIGN.md §2.5), its
associative branch.  The whole stream runs as the single-device fused
driver's hoist-then-loop schedule, with state partitioned by ownership:

* **compute mode is event-parallel**: each shard registers ops for its
  contiguous slice of every punctuation interval;
* **ops are owner-routed, not replicated**: each shard buckets the ops it
  built by ``owner(uid)`` (``ownership.bucket_by_owner``: one radix launch
  for every interval of every shard) and ships them with one
  ``all_to_all`` covering every interval at once;
* **each shard restructures and evaluates only its local chains**, with the
  restructure and coefficient scans hoisted out of the interval loop; the
  segment-relative scans make a chain's result independent of where it
  lands, so on the CPU twins the sharded schedule is bit-identical to the
  single-device fused driver;
* **results go home by the reverse exchange** and post-processing runs
  over the whole stream as in the single-device driver.

Layouts (paper §IV-E / Fig. 14):

  shared_nothing    a state block per shard; no collective inside the
                    interval loop (the exchange is hoisted)
  shared_per_socket a state block per socket, replicated on its cores; ops
                    routed to the owning socket, all-gathered over its
                    cores; each core takes the chains of the slots with
                    ``slot % n_core == core``; one merge per interval
  shared_everything state replicated; chains routed round-robin over all
                    shards; one global merge per interval

State merges are an ownership-masked ``pmax`` select (every slot has one
writer), not a sum of deltas, so every layout stays exact.

The port keeps the shards in the mesh's device groups (``core/mesh.py``):
group g holds ``mesh.per_group`` shards, as a tensor axis, on
``mesh.devices[g]``.  The reference's per-device program runs once per
group, on that group's device: its body works on ``[n_intervals,
n_group_shards, ...]`` tensors and folds both axes into the batch axes the
kernels take, and the collectives move data between groups.  The loop over
groups enqueues each group's work without waiting for the card, so on the
associative schedule groups on separate cards run at once (on the lockstep
schedule they do not: see below); the loop over intervals carries each group's ``[n_group_shards, lpad+1, W]``
state blocks (on the megakernel rung of ``shared_nothing``, which merges
nothing, one megakernel call per group carries them through the whole
stream).  With one group (``ShardMesh(..., device=...)``) every shard is
on one device and each kernel launches once where it launches once per
group.  On the card the staged rung's segscans run over the flat
concatenation of a group's rows, one launch per scan and group, and the
CUDA affine scan's association depends on where a chain lies among its
fixed tiles (``csrc/segscan.cu``; the same from call to call), so there a
sharded run with max tables (TP) agrees with the single-device run, and
with another grouping, to a tolerance, not bit for bit; the megakernel
rung (GS) stays bitwise.  On the CPU twins every grouping is bitwise with
every other.

Non-associative or gated apps (SL, OB), and the ``tstream_lockstep`` and
``mvlk`` schemes, run the lockstep schedule sharded, under
``shared_nothing`` on a 1-D mesh only (as in the reference).  Each shard
walks its local chains with the single-device walk (``engines.
_lockstep_sweep``, every shard of a group's round at once on the group's
stacked blocks, one host read a sweep and group, only the rounds that hold
a valid op).  That host read makes the groups' sweeps run one after
another: group g+1's sweep is enqueued only once group g's has been read
back.  Cross-chain gates
resolve level by level against a success frontier keyed by global op id and
merged with a max over the shard axis after each level (a gated op's mate
chain always sits at a strictly lower level); the level fixpoint merges with
a min over that axis; and the dependency-cycle residue runs once, as the
sequential sweep over every shard's gathered residue ops in global (ts,
slot) order, on the first group's device.  So the sharded lockstep run is
bitwise the single-device one, on the CPU and on the card, under every
grouping.

The chunked service drives the same program one chunk at a time
(``run_chunk``: blocks in, blocks out, so chunks chain with no per-chunk
permute), and moves its resident carry onto a new placement between chunks
(``reshard``: live migration under ``shared_nothing``; only the rows whose
owner changed travel, through one ``all_to_all`` at the exact capacity of
``ownership.migration_plan``, so a migration never drops a row).  The block
carry is a tuple of one tensor per device group, each on its group's
device; canonical values, event columns, per-op results and stats live on
the first group's device (``mesh.device``).
"""
from __future__ import annotations

import dataclasses
import functools
import logging
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..kernels import autotune
from ..kernels.megakernel.ops import fused_chain_eval
from ..kernels.megakernel.ref import fused_chain_stream_ref
from ..kernels.runtime import smem_optin
from .blotter import AppSpec, build_opbatch
from .engines import (INF_LEVEL, _empty_results, _lockstep_sweep,
                      _segment_max, _sequential_sweep, simple_affine_luts,
                      tstream_scan_coefs, tstream_scan_execute,
                      tstream_scan_plan)
from .mesh import ShardMesh
from .ownership import (LAYOUTS, bucket_by_owner, build_ownership,
                        build_probe_route, exchange_capacity,
                        make_local_store, migration_plan, permute_values,
                        route_gather, unpermute_values, unroute_gather)
from .restructure import (megakernel_engaged, restructure_path,
                          restructure_stream, take_along)
from .scheduler import _post_stream, _stack
from .types import OpBatch, StateStore, tree_index

log = logging.getLogger(__name__)

I32 = torch.int32


class ShardedStream:
    """Sharded fused streaming driver bound to one (app, mesh, layout).

    The ownership permutation and routing tables are built once here (and
    copied to every group's device); a call reshapes the host stream and
    runs the whole-stream program, once per device group.
    """

    def __init__(self, app: AppSpec, store: StateStore, cfg,
                 mesh: ShardMesh, layout: str = "shared_nothing",
                 exchange_slack: float = 2.0):
        if layout not in LAYOUTS:
            raise ValueError(f"layout={layout!r}; choose from {LAYOUTS}")
        if cfg.scheme not in ("tstream", "tstream_scan", "tstream_lockstep",
                              "mvlk"):
            raise ValueError(
                f"sharded run_stream implements the TStream/mvlk engines "
                f"only (got scheme={cfg.scheme!r})")
        self.assoc = (app.associative_only
                      and cfg.scheme in ("tstream", "tstream_scan")
                      and not (cfg.abort_repass and app.may_abort))
        if not self.assoc and (layout != "shared_nothing"
                               or len(mesh.shape) != 1):
            # lockstep sharding (mvlk included: eval_mvlk IS the lockstep
            # schedule) exchanges gate successes on global op ids; state
            # must be shard-resident and the mesh flat
            raise ValueError(
                f"sharded {cfg.scheme!r} on app {app.name!r} takes the "
                f"lockstep schedule, which shards under shared_nothing on a "
                f"1-D mesh only (got {layout!r} on mesh {mesh.shape})")
        self.app, self.cfg, self.mesh, self.layout = app, cfg, mesh, layout
        self.store = store.to(mesh.device)
        self.devices, self.n_loc = mesh.devices, mesh.per_group
        self._stores = tuple(store.to(d) for d in self.devices)
        self.exchange_slack = float(exchange_slack)
        self.axes = mesh.axis_names
        self.n_dev = mesh.size
        if layout == "shared_per_socket":
            if len(self.axes) != 2:
                raise ValueError("shared_per_socket needs a (socket, core) "
                                 "mesh")
            self.n_sockets, self.n_core = mesh.shape
            n_owners, self.n_route = self.n_sockets, self.n_sockets
            self.route_axes = (self.axes[0],)
        else:
            n_owners = self.n_dev if layout == "shared_nothing" else 1
            self.n_route = self.n_dev
            self.route_axes = self.axes
        self._n_owners = n_owners
        # each group's state blocks: the owners whose blocks it holds, and
        # for each of its shards the index of that shard's block among them
        self._blocks_of, self._block_idx = [], []
        for g, d in enumerate(self.devices):
            owner = [self._block_owner(s) for s in mesh.shards(g)]
            self._blocks_of.append(range(owner[0], owner[-1] + 1))
            self._block_idx.append(torch.tensor(
                [o - owner[0] for o in owner], device=d))
        self._bind_ownership(())
        self.last_stats: Optional[Dict] = None
        self.last_rung: Optional[str] = None

    def _block_owner(self, shard: int) -> int:
        """The state block a shard works on (0 under shared_everything)."""
        if self.layout == "shared_nothing":
            return shard
        if self.layout == "shared_per_socket":
            return shard // self.n_core
        return 0

    def _shard_ids(self, g: int) -> torch.Tensor:
        """Group g's flat shard indices, on its device."""
        return torch.arange(g * self.n_loc, (g + 1) * self.n_loc, dtype=I32,
                            device=self.devices[g])

    def _bind_ownership(self, overrides) -> None:
        """(Re)build the ownership permutation and routing tables against
        ``overrides``: the one place the plan binds to a placement."""
        self.own = build_ownership(self.store, self._n_owners, overrides)
        self._fwd = tuple(self.own.fwd.to(d) for d in self.devices)
        self._sim = tuple(None if self.own.slot_is_max is None
                          else self.own.slot_is_max.to(d)
                          for d in self.devices)
        self._probes = None
        if self.cfg.use_hash_probe_route:
            fwd = self.own.fwd[:-1].cpu().numpy()
            if self.layout == "shared_everything":
                owner = fwd % self.n_dev
            else:
                owner = fwd // self.own.per
            self._probes = tuple(
                build_probe_route(self.store.n_slots, owner,
                                  miss_owner=self.n_route, device=d)
                for d in self.devices)

    @property
    def probe(self):
        """The first group's hash-probe route (None on the direct route)."""
        return None if self._probes is None else self._probes[0]

    @property
    def owners(self):
        """Current ownership overrides (sorted ``((uid, owner), ...)``)."""
        return self.own.overrides

    @property
    def reshardable(self) -> bool:
        """Live migration needs one state block per shard (the moved-rows
        exchange is a shard-level all_to_all), more than one owner to move
        to, and the direct-addressed route (the probe table records owners
        at construction)."""
        return (self.layout == "shared_nothing" and self.n_dev > 1
                and self.probe is None)

    def set_ownership(self, overrides) -> None:
        """Rebind the plan to a new placement without touching data (the
        canonical values re-enter through ``carry_in`` under it)."""
        overrides = tuple(sorted((int(u), int(o)) for u, o in overrides))
        if overrides != self.own.overrides:
            self._bind_ownership(overrides)

    def reshard(self, blocks, overrides):
        """Live migration: move the block carry onto a new placement.

        Rows that stay keep their shard and move to their new index there;
        only the moved rows travel, bucketed by new owner
        (``bucket_by_owner``) at the exact capacity from the host-side
        :func:`migration_plan` and shipped with one ``all_to_all``, so a
        migration never drops a row.  Then the plan rebinds to the new
        ownership.  Returns ``(blocks, moved_rows)``.  Must run at a
        punctuation boundary with the pipeline drained (the service's
        snapshot barrier).
        """
        if not self.reshardable:
            raise ValueError(f"live migration needs shared_nothing on more "
                             f"than one shard without the probe route (got "
                             f"{self.layout!r} on {self.n_dev} shards, "
                             f"probe={self.probe is not None})")
        overrides = tuple(sorted((int(u), int(o)) for u, o in overrides))
        if overrides == self.own.overrides:
            return blocks, 0
        new_own = build_ownership(self.store, self._n_owners, overrides)
        dst, nidx, cap = migration_plan(self.own, new_own)
        blocks, moved = self._migrate(blocks, dst, nidx, cap)
        self._bind_ownership(overrides)
        return blocks, moved

    def _migrate(self, blocks, dst, nidx, cap: int):
        """Reference: ``_migrate_impl`` / ``_migrate_body``, every shard of
        a group at once.  ``dst``/``nidx`` (``[n_dev, per]``, from
        ``migration_plan``) give each block row its new owner and its row in
        that owner's block."""
        n_dev, per, nl = self.n_dev, self.own.per, self.n_loc
        w = blocks[0].shape[-1]
        outs, plans, srows, sidx = [], [], [], []
        for g, dev in enumerate(self.devices):
            b = blocks[g].reshape(nl, per + 1, w)
            rows = b[:, :per]
            at_g = slice(g * nl, (g + 1) * nl)
            dstv = torch.from_numpy(dst[at_g]).to(dev)
            nidxv = torch.from_numpy(nidx[at_g]).to(dev)
            stay = dstv == self._shard_ids(g)[:, None]
            out = torch.zeros_like(b)
            # rows that stay scatter straight to their new index; the others
            # (and dead padding rows, nidx == per) land on the pad row as 0
            at = torch.where(stay, nidxv, torch.full_like(nidxv, per)).long()
            out.scatter_(1, at[..., None].expand(nl, per, w).contiguous(),
                         torch.where(stay[..., None], rows,
                                     torch.zeros_like(rows)))
            # moved rows bucket by new owner and ship with ONE all_to_all;
            # cells beyond a pair's move count hold 0.0 at index per
            plan = bucket_by_owner(
                torch.where(stay, torch.full_like(dstv, n_dev), dstv), n_dev,
                cap, use_kernels=self.cfg.use_kernels,
                threads=self.cfg.block_param("radix_partition"))
            srows.append(route_gather(plan, rows, 0.0))  # [nl, n_dev, cap, w]
            sidx.append(route_gather(plan, nidxv, per))  # [nl, n_dev, cap]
            outs.append(out)
            plans.append(plan)
        rrows = self.mesh.all_to_all(tuple(srows), self.axes, 0, 0, dim=0)
        ridx = self.mesh.all_to_all(tuple(sidx), self.axes, 0, 0, dim=0)
        for out, rr, ri in zip(outs, rrows, ridx):
            out.scatter_(1, ri.reshape(nl, -1, 1).expand(
                nl, n_dev * cap, w).long(), rr.reshape(nl, -1, w))
            out[:, per] = 0.0
        return (tuple(o.reshape(nl * (per + 1), w) for o in outs),
                sum(int(p.ok.sum()) for p in plans))

    def set_exchange_slack(self, slack: float) -> None:
        """Widen (or narrow) the per-bucket capacity from the next call on;
        results of shipped ops are unaffected, only the padding changes."""
        self.exchange_slack = float(slack)

    # -- block carry <-> canonical values ---------------------------------
    def carry_in(self, values: torch.Tensor):
        """[S+1, W] canonical values -> the resident block carry, a tuple
        with one tensor per device group on its device: the
        ``[n_blocks*(per+1), W]`` blocks of the owners its shards work on
        (one block per owner, pad row last) for the partitioned layouts,
        the full ``[s_pad+1, W]`` permuted buffer for shared_everything."""
        own = self.own
        vperm = permute_values(own, values.to(self.mesh.device))
        if self.layout == "shared_everything":
            return tuple(vperm.to(d) for d in self.devices)
        nb, per, w = self._n_owners, own.per, vperm.shape[1]
        blocks = torch.cat([vperm[:-1].reshape(nb, per, w),
                            vperm.new_zeros((nb, 1, w))], dim=1)
        return tuple(blocks[o.start:o.stop].reshape(-1, w).to(d)
                     for o, d in zip(self._blocks_of, self.devices))

    def carry_out(self, blocks) -> torch.Tensor:
        """Block carry -> [S+1, W] canonical values on the first group's
        device (exact gathers only)."""
        own, home = self.own, self.mesh.device
        per, s_pad, w = own.per, own.s_pad, blocks[0].shape[-1]
        if self.layout == "shared_everything":
            vperm = blocks[0][:s_pad]
        else:
            # each owner's block from the first group that holds it
            parts, done = [], 0
            for o, b in zip(self._blocks_of, blocks):
                b = b.reshape(len(o), per + 1, w)[done - o.start:, :per]
                if b.shape[0]:
                    parts.append(b.to(home))
                done = o.stop
            vperm = torch.cat(parts).reshape(s_pad, w)
        return unpermute_values(own, torch.cat([vperm,
                                                vperm.new_zeros((1, w))]))

    # -- host driver ------------------------------------------------------
    def run_stream(self, values: torch.Tensor, event_stream,
                   punct_interval: int):
        """Run the stream; returns ``(outputs, values')`` like the
        single-device driver and sets ``last_stats`` (exchange stats) and
        ``last_rung`` (the rung of the state-access mode)."""
        self.last_rung = None
        n = len(next(iter(event_stream.values())))
        interval = self._check_interval(punct_interval)
        n_intervals = n // interval
        if n_intervals == 0:
            # publish empty (not stale) exchange stats for this call
            self.last_stats = dict(
                dropped=np.zeros((0,), np.int32),
                shipped=np.zeros((0,), np.int32),
                max_fill=np.zeros((0,), np.int32),
                capacity=np.int32(0),
                exchanged_rows_per_device=np.int32(0))
            return [], values
        batched = {}
        for k, v in event_stream.items():
            v = np.asarray(v)[: n_intervals * interval]
            batched[k] = v.reshape((n_intervals, interval) + v.shape[1:])
        res_all, ebs_all, blocks, stats = self._blocks_impl(
            self.carry_in(values),
            convert.events_to_torch(batched, self.mesh.device), 0)
        values = self.carry_out(blocks)
        stats = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.int32(v)) for k, v in stats.items()}
        self.last_stats = stats
        total_dropped = int(np.sum(stats["dropped"]))
        if total_dropped:
            log.warning(
                "sharded exchange overflow: %d ops dropped across %d "
                "intervals (capacity=%d/bucket, slack=%.2f); results "
                "exclude dropped ops — raise exchange_slack",
                total_dropped, n_intervals, stats["capacity"],
                self.exchange_slack)
        outs = {k: v.cpu().numpy()
                for k, v in _post_stream(res_all, ebs_all,
                                         app=self.app).items()}
        return [{k: v[i] for k, v in outs.items()}
                for i in range(n_intervals)], values

    def run_chunk(self, blocks, batched, ts0: int):
        """Chunked service entry (see ``DualModeEngine.run_stream_chunk``).

        ``blocks`` is the resident block carry (``carry_in`` of the
        canonical values; it is not written) and ``batched`` holds ``[K,
        interval, ...]`` event columns on the mesh's device.  Returns the
        chunk's per-op results and event payloads, the next carry and the
        chunk's exchange stats (``dropped``/``shipped``/``max_fill`` per
        interval, ``capacity``, ``shard_load``, ``slot_load``; the lockstep
        schedule adds ``swept`` and ``residue``), as ``run_stream`` gives
        them.  Overflow is not logged here: the service logs each drop
        category once per run."""
        self.last_rung = None
        self._check_interval(next(iter(batched.values())).shape[1])
        return self._blocks_impl(blocks, batched, int(ts0))

    def _check_interval(self, interval) -> int:
        """Each shard registers an equal slice of every interval."""
        interval = int(interval)
        if interval % self.n_dev:
            raise ValueError(f"punct_interval={interval} must divide evenly "
                             f"across {self.n_dev} shards")
        return interval

    # -- the whole-stream program (block-carry form) ------------------------
    def _blocks_impl(self, blocks, events_b, ts0: int):
        """Blocks in, blocks out: expand each group's carry to one state
        block per shard, route, evaluate and return the results, fold the
        blocks back and reduce the stats (on the first group's device)."""
        own, layout, n_dev, nl = self.own, self.layout, self.n_dev, self.n_loc
        per, s_pad = own.per, own.s_pad
        w = self.app.width
        home = self.mesh.device
        has_max = any(self.store.table_is_max)
        vals0, sim_d = [], []
        for g, dev in enumerate(self.devices):
            sim = (self._sim[g] if has_max else
                   torch.zeros((s_pad + 1,), dtype=torch.bool, device=dev))
            if layout == "shared_everything":
                vals0.append(blocks[g][None].expand(nl, s_pad + 1, w).clone())
                sim_d.append(sim[None].expand(nl, s_pad + 1))
                continue
            o = self._blocks_of[g]
            v = blocks[g].reshape(len(o), per + 1, w).clone()
            sb = torch.cat([sim[:-1].reshape(self._n_owners, per)[
                o.start:o.stop], sim.new_zeros((len(o), 1))], dim=1)
            if layout == "shared_per_socket":   # replicated on its cores
                v, sb = v[self._block_idx[g]], sb[self._block_idx[g]]
            vals0.append(v)
            sim_d.append(sb)

        rops, plans, ebs_all, cap, gflat = self.route(events_b, ts0)
        walk = {}
        if self.assoc:
            vals_fin, res_routed = self._evaluate(
                vals0, sim_d if has_max else None, rops)
        else:
            vals_fin, res_routed, walk = self._evaluate_lockstep(
                vals0, rops, gflat,
                next(iter(events_b.values())).shape[1] * self.app.max_ops)
        res_loc = self._reverse(res_routed, plans, cap)

        # carry out: the canonical block layout (pad rows zero), the block
        # of each owner a group holds from the group's first shard on it
        carry = []
        for g, v in enumerate(vals_fin):
            if layout == "shared_nothing":
                carry.append(v.reshape(nl * (per + 1), w))
                continue
            if layout == "shared_per_socket":
                first = [max(o * self.n_core - g * nl, 0)
                         for o in self._blocks_of[g]]
                vperm = v[first, :per]
            else:
                vperm = v[:1, :s_pad]
            carry.append(torch.cat([vperm, vperm.new_zeros(
                (vperm.shape[0], 1, w))], dim=1).reshape(-1, w))

        # per-local-slot access counts over the whole stream; each valid
        # routed op counts on exactly one shard (per_socket: the core filter)
        lpad = vals0[0].shape[1] - 1
        loads = []
        for r in rops:
            ld = torch.zeros((nl, lpad + 1), dtype=I32, device=r.uid.device)
            ld.scatter_add_(
                1, torch.clamp(r.uid, max=lpad).transpose(0, 1).reshape(
                    nl, -1).long(),
                r.valid.to(I32).transpose(0, 1).reshape(nl, -1))
            loads.append(ld)
        loads = self.mesh.join(tuple(loads))
        # per-shard / per-slot access histogram (skew observability)
        if layout == "shared_nothing":
            l2 = loads[:, :per]
            shard_load = torch.sum(l2, dim=1, dtype=I32)
            slot_perm = l2.reshape(s_pad)
        elif layout == "shared_per_socket":
            l3 = torch.sum(loads.reshape(self.n_sockets, self.n_core,
                                         per + 1), dim=1, dtype=I32)[:, :per]
            shard_load = torch.sum(l3, dim=1, dtype=I32)
            slot_perm = l3.reshape(s_pad)
        else:   # shared_everything: owner(slot) = slot % n_dev
            slot_perm = torch.sum(loads, dim=0, dtype=I32)[:s_pad]
            shard_load = torch.zeros((n_dev,), dtype=I32, device=home)
            shard_load.index_add_(0, torch.arange(s_pad, device=home) % n_dev,
                                  slot_perm)
        slot_load = slot_perm[own.fwd[:-1].long()]          # original uids

        stats = dict(
            dropped=torch.sum(self.mesh.join(tuple(
                p.dropped for p in plans), dim=1), dim=1, dtype=I32),
            shipped=torch.sum(self.mesh.join(tuple(
                torch.sum(p.ok, dim=(2, 3), dtype=I32) for p in plans),
                dim=1), dim=1, dtype=I32),
            max_fill=torch.amax(self.mesh.join(tuple(
                p.fill for p in plans), dim=1), dim=1),
            capacity=cap, exchanged_rows_per_device=n_dev * cap,
            shard_load=shard_load, slot_load=slot_load, **walk)
        return res_loc, ebs_all, tuple(carry), stats

    def route(self, events_b, ts0: int = 0):
        """Compute mode and the exchange, hoisted over the whole stream.

        ``events_b``: event columns ``[n_intervals, interval, ...]`` on the
        mesh's device.  Each shard registers the ops of its slice of every
        interval, buckets them by owner and ships them with one
        ``all_to_all``.  Returns ``(rops, plans, ebs, cap, gflat)``: for
        each device group, the op batch each of its shards received
        (fields ``[n_intervals, n_group_shards, R]``, rows
        source-shard-major, then cell, so row order is ts order) and its
        route plans (``[n_intervals, n_group_shards, ...]``); the event
        payloads in the single-device layout on the mesh's device; the
        bucket capacity; and for the lockstep schedule each group's
        received rows' global op ids (``N_glob`` on a padding row; None on
        the associative path).  There the gates ship too, as global op
        ids.
        """
        app, cfg, own, layout = self.app, self.cfg, self.own, self.layout
        mesh, n_dev, n_route, nl = (self.mesh, self.n_dev, self.n_route,
                                    self.n_loc)
        per = own.per
        lpad = own.s_pad if layout == "shared_everything" else per
        some = next(iter(events_b.values()))
        n_intervals, interval = some.shape[0], some.shape[1]
        e_loc = interval // n_dev
        cap = exchange_capacity(e_loc * app.max_ops, n_route,
                                self.exchange_slack)
        sends, plans, ebs_l = [], [], []
        for g, dev in enumerate(self.devices):
            shard = self._shard_ids(g)
            # ---- compute mode: event-parallel op registration -----------
            ev = {k: v.reshape((n_intervals, n_dev, e_loc)
                               + tuple(v.shape[2:]))[:, g * nl:(g + 1) * nl]
                  .to(dev) for k, v in events_b.items()}
            ts_bases = (ts0 + torch.arange(n_intervals, dtype=I32,
                                           device=dev)[:, None] * interval
                        + shard[None, :] * e_loc)
            ops_all, ebs = build_opbatch(app, self._stores[g], ev, ts_bases)
            ebs_l.append({k: v.reshape((n_intervals, nl * e_loc)
                                       + tuple(v.shape[3:]))
                          for k, v in ebs.items()})
            n_loc = ops_all.uid.shape[-1]

            # ---- owner routing (values-independent, hoisted) --------------
            uid_perm = self._fwd[g][ops_all.uid.long()]  # [n_i, nl, N_loc]
            if self._probes is not None:
                dst_v = self._probes[g].owners_of(
                    ops_all.uid.reshape(-1),
                    use_kernels=cfg.use_kernels).reshape(ops_all.uid.shape)
            elif layout == "shared_everything":
                dst_v = uid_perm % n_dev
            else:
                dst_v = uid_perm // per
            dst = torch.where(ops_all.valid, dst_v,
                              torch.full_like(dst_v, n_route)).to(I32)
            plan = bucket_by_owner(dst, n_route, cap,
                                   use_kernels=cfg.use_kernels,
                                   threads=cfg.block_param("radix_partition"))
            if layout == "shared_everything":
                uid_local = uid_perm
            else:
                uid_local = uid_perm - torch.clamp(dst_v,
                                                   max=n_route - 1) * per
            uid_send = torch.where(ops_all.valid, uid_local,
                                   torch.full_like(uid_local, lpad))
            send = dict(
                uid=route_gather(plan, uid_send, lpad),
                fun=route_gather(plan, ops_all.fun, 0),
                operand=route_gather(plan, ops_all.operand, 0.0),
                valid=route_gather(plan, ops_all.valid, False),
                ts=route_gather(plan, ops_all.ts, 0),
                slot=route_gather(plan, ops_all.slot, 0),
            )
            if not self.assoc:
                # gates and op ids as global op ids: shard d's ops are the
                # interval's flat ops [d * N_loc, (d + 1) * N_loc)
                base = (shard * n_loc)[None, :, None]
                gflat = (base + torch.arange(n_loc, dtype=I32, device=dev)
                         ).expand(ops_all.uid.shape)
                send["gate"] = route_gather(
                    plan, torch.where(ops_all.gate >= 0, ops_all.gate + base,
                                      torch.full_like(ops_all.gate, -1)), -1)
                send["gflat"] = route_gather(plan, gflat, n_dev * n_loc)
            sends.append(send)
            plans.append(plan)
        ebs_all = {k: mesh.join(tuple(e[k] for e in ebs_l), dim=1)
                   for k in ebs_l[0]}

        # ---- THE exchange: one all_to_all for the whole stream ------------
        recv = {k: mesh.all_to_all(tuple(s[k] for s in sends),
                                   self.route_axes, 1, 1, dim=1)
                for k in sends[0]}
        if layout == "shared_per_socket":
            # every core sees the socket's full routed set, in flat
            # source-shard order (socket-major), so rows stay ts-sorted
            recv = {k: tuple(t.movedim(2, 3) for t in mesh.all_gather(
                v, self.axes[1], 1, dim=1)) for k, v in recv.items()}
        rest = 5 if layout == "shared_per_socket" else 4
        rops, gflat = [], []
        for g in range(len(self.devices)):
            r = {k: v[g].reshape((n_intervals, nl, n_dev * cap)
                                 + tuple(v[g].shape[rest:]))
                 for k, v in recv.items()}
            rvalid, ruid = r["valid"], r["uid"]
            if layout == "shared_per_socket":
                core = (self._shard_ids(g) % self.n_core)[None, :, None]
                rvalid = rvalid & ((ruid % self.n_core) == core)
            zeros = torch.zeros_like(ruid)
            rops.append(OpBatch(
                uid=ruid, ts=r["ts"], txn=zeros, slot=r["slot"], kind=zeros,
                fun=r["fun"], gate=r.get("gate", torch.full_like(ruid, -1)),
                operand=r["operand"], valid=rvalid))
            gflat.append(r.get("gflat"))
        return rops, plans, ebs_all, cap, gflat

    def _evaluate(self, vals0, sim_d, rops):
        """State-access mode: the intervals carry every shard's block.

        ``vals0``: each group's ``[n_group_shards, lpad+1, W]`` state
        blocks, one per shard; ``sim_d``: their per-slot max flags or None.
        Returns each group's final blocks and per-op results
        ``[n_intervals, n_group_shards, R, ...]`` in each shard's
        received-row order.
        """
        app, cfg, layout = self.app, self.cfg, self.layout
        mesh, axes, n_dev = self.mesh, self.axes, self.n_dev
        devs = self.devices
        lpad = vals0[0].shape[1] - 1
        n_intervals, _, rows = rops[0].uid.shape
        threads_radix = cfg.block_param("radix_partition")

        merge_axes, own_mask = None, [None] * len(devs)
        if layout == "shared_per_socket":
            merge_axes = (axes[1],)
        elif layout == "shared_everything":
            merge_axes = axes
        if merge_axes is not None:
            for g, dev in enumerate(devs):
                shard = self._shard_ids(g).long()
                slots = torch.arange(lpad, device=dev)
                if layout == "shared_per_socket":
                    m = (slots[None, :] % self.n_core
                         == (shard % self.n_core)[:, None])
                else:
                    m = slots[None, :] % n_dev == shard[:, None]
                # the pad row has no owner
                own_mask[g] = torch.cat([m, m.new_zeros((m.shape[0], 1))],
                                        dim=1)[..., None]

        def merge(vals):
            if merge_axes is None:
                return vals
            # ownership-masked SELECT (one writer per slot): exact, unlike
            # delta summation
            vals = list(mesh.pmax(tuple(
                torch.where(m, v, torch.full((), float("-inf"),
                                             dtype=v.dtype, device=v.device))
                for m, v in zip(own_mask, vals)), merge_axes, dim=0))
            for v in vals:
                v[:, lpad] = 0.0
            return vals

        luts = [simple_affine_luts(app.funs, d) for d in devs]
        vals, res_l = list(vals0), [[] for _ in devs]
        if all(megakernel_engaged(
                rows, lpad + 1, method=cfg.restructure_method,
                has_max=sim_d is not None, funs_simple=lut is not None,
                lanes=vals0[0].shape[-1],
                smem_limit=smem_optin(d) if cfg.use_kernels else None,
                device_kind=autotune.kind_of(d))
                for lut, d in zip(luts, devs)):
            self.last_rung = "megakernel"
            # megakernel rung: a geometry-free partition plan, then ONE call
            # per group for the whole stream evaluates every shard's chains;
            # a layout that merges after every interval calls it once per
            # interval and group
            pres = [restructure_stream(
                r, lpad, rowmajor_ts=True, light=True, method="partition",
                use_kernels=cfg.use_kernels, geometry=False,
                threads=threads_radix) for r in rops]
            if cfg.use_kernels:
                evaluate_chains = functools.partial(
                    fused_chain_eval, threads=cfg.block_param("megakernel"))
            else:
                evaluate_chains = fused_chain_stream_ref
            if merge_axes is None:
                out = [evaluate_chains(v, sops, ch, lpad, a_lut=lut[0],
                                       b_lut=lut[1])
                       for v, (sops, ch), lut in zip(vals, pres, luts)]
                return [o[1] for o in out], [o[0] for o in out]
            for i in range(n_intervals):
                at = slice(i, i + 1)
                out = [evaluate_chains(
                    v, tree_index(sops, at), tree_index(ch, at), lpad,
                    a_lut=lut[0], b_lut=lut[1])
                    for v, (sops, ch), lut in zip(vals, pres, luts)]
                vals = merge([o[1] for o in out])
                for r, o in zip(res_l, out):
                    r.append({k: v[0] for k, v in o[0].items()})
        else:
            self.last_rung = restructure_path(
                rows, lpad, rowmajor_ts=True, method=cfg.restructure_method,
                device_kind=autotune.kind_of(devs[0]))
            plan_all = []
            for g, r in enumerate(rops):
                pres = restructure_stream(
                    r, lpad, rowmajor_ts=True, light=True,
                    method=cfg.restructure_method,
                    use_kernels=cfg.use_kernels, threads=threads_radix)
                plan = tstream_scan_plan(
                    make_local_store(vals0[g], None if sim_d is None
                                     else sim_d[g]),
                    r, app.funs, prestructured=pres,
                    use_kernels=cfg.use_kernels)
                plan_all.append(tstream_scan_coefs(
                    plan, use_kernels=cfg.use_kernels,
                    threads=cfg.block_param("segscan")))
            for i in range(n_intervals):
                plan = [tree_index(p, i) for p in plan_all]
                out = [tstream_scan_execute(v, p, lpad, raw=True)
                       for v, p in zip(vals, plan)]
                vals = merge([o[1] for o in out])
                for r, o, p in zip(res_l, out, plan):
                    r.append({k: p.ch.untake(v) for k, v in o[0].items()})
        return vals, [_stack(r) for r in res_l]

    # -- the lockstep schedule (shared_nothing, 1-D mesh) -----------------
    def _evaluate_lockstep(self, vals0, rops, gflat, n_glob: int):
        """State-access mode of the lockstep schedule: one restructure for
        the stream and group (on the partition rung one radix launch each),
        then one lockstep walk per interval, every shard's at once.

        ``vals0``: each group's ``[n_group_shards, per+1, W]`` state
        blocks; ``gflat``: each received row's global op id (``n_glob`` on
        a padding row).  Returns each group's final blocks and per-op
        results ``[n_intervals, n_group_shards, R, ...]`` in each shard's
        received-row order, and the walk's totals (``swept``: rounds run,
        by the group that ran the most in each sweep; ``residue``: ops left
        to the sequential sweep).
        """
        cfg = self.cfg
        lpad = vals0[0].shape[1] - 1
        n_intervals, _, rows = rops[0].uid.shape
        self.last_rung = restructure_path(
            rows, lpad, rowmajor_ts=True, method=cfg.restructure_method,
            device_kind=autotune.kind_of(vals0[0].device))
        pres = [restructure_stream(
            r, lpad, rowmajor_ts=True, method=cfg.restructure_method,
            use_kernels=cfg.use_kernels,
            threads=cfg.block_param("radix_partition")) for r in rops]
        vals, res_l = list(vals0), [[] for _ in rops]
        walk = dict(swept=0, residue=0)
        for i in range(n_intervals):
            walker = _LockstepWalk(self, [tree_index(s, i) for s, _ in pres],
                                   [tree_index(c, i) for _, c in pres],
                                   [f[i] for f in gflat], n_glob)
            vals, res = walker.interval(vals)
            walk["swept"] += walker.swept
            walk["residue"] += walker.residue
            for r, x in zip(res_l, res):
                r.append(x)
        return vals, [_stack(r) for r in res_l], walk

    def _reverse(self, res_routed, plans, cap: int):
        """The reverse exchange: results home to their source shard, then
        back to flat per-op layout ``[n_intervals, N_glob, ...]`` on the
        mesh's device."""
        mesh, n_route, nl = self.mesh, self.n_route, self.n_loc
        n_intervals = plans[0].dst.shape[0]
        res_loc = {}
        for k in res_routed[0]:
            vs = tuple(r[k] for r in res_routed)
            if self.layout == "shared_per_socket":
                # socket-complete results (each op evaluated on exactly one
                # core), then each core returns the rows of its own source
                # core
                if vs[0].dtype == torch.bool:
                    vs = tuple(v > 0 for v in mesh.psum(tuple(
                        v.to(I32) for v in vs), self.axes[1], dim=1))
                else:
                    vs = mesh.psum(vs, self.axes[1], dim=1)
                back = []
                for g, v in enumerate(vs):
                    core = self._shard_ids(g).long() % self.n_core
                    v = v.reshape((n_intervals, nl, self.n_sockets,
                                   self.n_core, cap) + tuple(v.shape[3:]))
                    back.append(v[:, torch.arange(nl, device=v.device), :,
                                  core].movedim(0, 1))
            else:
                back = [v.reshape((n_intervals, nl, self.n_dev, cap)
                                  + tuple(v.shape[3:])) for v in vs]
            outs = []
            for v, plan in zip(mesh.all_to_all(tuple(back), self.route_axes,
                                               1, 1, dim=1), plans):
                v = v.reshape((n_intervals, nl, n_route * cap)
                              + tuple(v.shape[4:]))
                v = unroute_gather(plan, v, n_route, cap)
                outs.append(v.reshape((n_intervals, nl * v.shape[2])
                                      + tuple(v.shape[3:])))
            res_loc[k] = mesh.join(tuple(outs), dim=1)
        return res_loc


class _LockstepWalk:
    """One interval of the sharded lockstep schedule, every shard at once.

    Reference: ``_lockstep_interval``, ``_lockstep_eval``,
    ``_sweep_sharded``, ``_chain_levels_sharded`` and ``_residue_sharded``
    (``repro/core/sharded_stream.py``).  Each device group's stacked blocks
    ``[n_group_shards, per+1, W]`` are walked as one state of
    ``n_group_shards * (per+1)`` rows (local shard d's local uid u is row
    ``d * (per+1) + u``), so the single-device walk runs round r of every
    shard of the group at once: the shards' states are disjoint, and a
    valid received op never addresses a pad row.  Per-op results sit per
    shard in received-row order (row ``d * R + ch.order``); the success
    frontier and the level array are keyed by global op id, one replica per
    shard (``[n_group_shards, N_glob+1]``), merged over the shard axis.
    Every argument and result is a list with one entry per group.

    A gated op reads its mate's success from the frontier alone, where the
    reference also reads the shard's own results: the mate's chain sits at
    a strictly lower level (or the op is residue), so the frontier already
    holds it.  ``swept`` and ``residue`` count the last pass's rounds (in
    each sweep, those of the group that ran the most) and residue ops.
    """

    def __init__(self, eng: ShardedStream, sops, ch, gflat_r, n_glob: int):
        self.eng, self.sops, self.ch = eng, sops, ch
        self.gflat_r = gflat_r                          # [nl, R] a group
        self.gflat_s = [take_along(f, c.order)          # sorted layout
                        for f, c in zip(gflat_r, ch)]
        self.n_glob = n_glob
        self.n_loc, self.rows = sops[0].uid.shape
        self.local = [torch.arange(self.n_loc, dtype=I32,
                                   device=s.uid.device)[:, None]
                      for s in sops]
        self.dst = [(d * self.rows + c.order).reshape(-1)
                    for d, c in zip(self.local, ch)]
        self.swept = self.residue = 0

    def interval(self, vals):
        """``_lockstep_interval``: the walk, then under ``abort_repass``
        the walk again from the pre-interval values with every transaction
        that failed an op masked (its verdict needs the global valid mask
        and success frontier)."""
        app, cfg = self.eng.app, self.eng.cfg
        vals1, res1, succ1 = self.evaluate(vals, self.sops)
        if not (cfg.abort_repass and app.may_abort):
            return vals1, res1
        n_glob, m = self.n_glob, app.max_ops
        gvalid = self.frontier([c.untake(s.valid)
                                for c, s in zip(self.ch, self.sops)])
        sops2 = []
        for s, ok, gv, gs in zip(self.sops, succ1, gvalid, self.gflat_s):
            txn_ok = torch.all((ok[:n_glob] | ~gv[0, :n_glob])
                               .reshape(-1, m), dim=1)     # [interval]
            txn = torch.clamp(gs // m, max=txn_ok.shape[0] - 1)
            keep = txn_ok[txn.long()] & (gs < n_glob)
            sops2.append(dataclasses.replace(s, valid=s.valid & keep))
        vals2, res2, _ = self.evaluate(vals, sops2)
        return vals2, res2

    def frontier(self, flags_r):
        """A bool per received row -> the global-op-id frontier
        ``[n_group_shards, N_glob+1]`` a group: scattered on each shard,
        merged with a max over the shard axis (the reference's bool
        ``pmax``).  A padding row lands on column ``N_glob`` and is
        False."""
        arrs = []
        for f, gr in zip(flags_r, self.gflat_r):
            arr = torch.zeros((self.n_loc, self.n_glob + 1), dtype=I32,
                              device=f.device)
            arrs.append(arr.scatter_(1, gr.long(), f.to(I32)))
        return [a > 0 for a in self.eng.mesh.pmax(tuple(arrs), self.eng.axes,
                                                   dim=0)]

    def levels(self, sops):
        """``_chain_levels_sharded``: the per-chain level fixpoint against a
        per-op level array keyed by global op id, merged with a min over the
        shard axis (levels only decrease).  Returns each shard's chain
        levels and which chains stay unresolved."""
        mesh, axes = self.eng.mesh, self.eng.axes
        nl, rows = self.n_loc, self.rows
        st = []
        for s, c, d in zip(sops, self.ch, self.local):
            seg = (d * rows + c.seg_id).reshape(-1).long()
            gated = (s.gate >= 0) & s.valid
            has_gate = (_segment_max(gated.to(I32).reshape(-1), seg,
                                     nl * rows) > 0).reshape(nl, rows)
            zero = torch.zeros((nl, rows), dtype=I32, device=seg.device)
            st.append(dict(seg=seg, gated=gated, has_gate=has_gate,
                           zero=zero, inf=torch.full_like(zero, INF_LEVEL),
                           mate=s.gate.clamp(min=0).long()))
        lvl = [torch.where(x["has_gate"], x["inf"], x["zero"]) for x in st]
        for _ in range(self.eng.cfg.max_dep_levels):
            opl = []
            for x, lv, c, gs in zip(st, lvl, self.ch, self.gflat_s):
                per_op = torch.where(gs < self.n_glob,
                                     take_along(lv, c.seg_id), x["inf"])
                o = torch.full((nl, self.n_glob + 1), INF_LEVEL, dtype=I32,
                               device=lv.device)
                opl.append(o.scatter_(1, gs.long(), per_op))
            opl = mesh.pmin(tuple(opl), axes, dim=0)
            for j, (x, o) in enumerate(zip(st, opl)):
                pred = torch.gather(o, 1, x["mate"])
                need = _segment_max(
                    torch.where(x["gated"], torch.clamp(pred + 1,
                                                        max=INF_LEVEL),
                                x["zero"]).reshape(-1), x["seg"], nl * rows)
                lvl[j] = torch.where(x["has_gate"], torch.clamp(
                    need.reshape(nl, rows), max=INF_LEVEL), x["zero"])
        return lvl, [lv >= INF_LEVEL for lv in lvl]

    def evaluate(self, vals, sops):
        """``_lockstep_eval``: the walk of one pass from ``vals``.  Returns
        the new blocks, the per-op results ``[n_group_shards, R, ...]`` and
        the merged success frontier ``[N_glob+1]``, one of each a group."""
        app, cfg = self.eng.app, self.eng.cfg
        nl, rows, n_glob = self.n_loc, self.rows, self.n_glob
        w = vals[0].shape[-1]
        lpad = vals[0].shape[1] - 1
        values, res, success_r, flat = [], [], [], []
        for v, s, d in zip(vals, sops, self.local):
            values.append(v.clone())
            r = _empty_results(nl * rows, w, v.device)
            res.append(r)
            success_r.append(r["success"][:nl * rows].view(nl, rows))
            # one flat state and op batch over the group's shards; a gate
            # addresses its shard's replica of the frontier
            f = OpBatch(**{x.name: getattr(s, x.name).reshape(
                (nl * rows,) + tuple(getattr(s, x.name).shape[2:]))
                for x in dataclasses.fields(OpBatch)})
            flat.append(dataclasses.replace(
                f, uid=(s.uid + d * (lpad + 1)).reshape(-1),
                gate=torch.where(s.gate >= 0, s.gate + d * (n_glob + 1),
                                 torch.full_like(s.gate, -1)).reshape(-1)))

        def sweep(g, at, frontier=None):
            ch = self.ch[g]
            group = torch.where(at, ch.pos, torch.full_like(ch.pos, -1))
            return _lockstep_sweep(values[g].view(-1, w), flat[g],
                                   self.dst[g], app.funs, group.reshape(-1),
                                   res[g], lpad, frontier=frontier)

        self.residue = 0
        if not app.has_gates:
            self.swept = max(sweep(g, s.valid) for g, s in enumerate(sops))
            succ = [f[0] for f in self.frontier(success_r)]
            return values, self._per_shard(res), succ

        lvl, unresolved = self.levels(sops)
        lvl_s = [take_along(lv, c.seg_id) for lv, c in zip(lvl, self.ch)]
        succ = self.frontier(success_r)
        self.swept = 0
        for level in range(cfg.max_dep_levels + 1):
            swept = max(sweep(g, s.valid & (lvl_s[g] == level),
                              frontier=succ[g].reshape(-1))
                        for g, s in enumerate(sops))
            if swept:
                self.swept += swept
                succ = self.frontier(success_r)
        succ = self._residue(values, sops, [
            take_along(u, c.seg_id) & s.valid
            for u, c, s in zip(unresolved, self.ch, sops)], res,
            succ[0][0].clone())
        return values, self._per_shard(res), succ

    def _residue(self, values, sops, run, res, succ):
        """``_residue_sharded``: the ops of unresolved chains (dependency
        cycles) run once, one at a time in global (ts, slot) order, over
        every shard's gathered residue ops and the gathered state on the
        first group's device (the reference's all_gathers), then each shard
        takes its block and its ops' results back.  Returns the frontier,
        one copy a group."""
        mesh = self.eng.mesh
        nl, rows, n_glob = self.n_loc, self.rows, self.n_glob
        per, w = values[0].shape[1] - 1, values[0].shape[-1]
        s_pad = self.eng.n_dev * per
        home = mesh.device
        vals_full = torch.cat([mesh.join(tuple(
            v[:, :per] for v in values)).reshape(s_pad, w),
            values[0].new_zeros((1, w)).to(home)])
        flat = lambda x: x.reshape((nl * rows,) + tuple(x.shape[2:]))
        gs = []
        for g, (s, r) in enumerate(zip(sops, run)):
            shard = self.eng._shard_ids(g)[:, None]
            cols = {f.name: flat(getattr(s, f.name))
                    for f in dataclasses.fields(OpBatch)}
            cols["uid"] = flat(torch.where(r, s.uid + shard * per,
                                           torch.full_like(s.uid, s_pad)))
            gs.append(cols)
        g_all = OpBatch(**{k: mesh.join(tuple(x[k] for x in gs))
                           for k in gs[0]})
        gres = dict(pre=vals_full.new_zeros((n_glob + 1, w)),
                    post=vals_full.new_zeros((n_glob + 1, w)), success=succ)
        self.residue = _sequential_sweep(
            vals_full, g_all, self.eng.app.funs, gres,
            mask_flat=mesh.join(tuple(flat(r) for r in run)), pad_uid=s_pad,
            sink=mesh.join(tuple(flat(x) for x in self.gflat_s)))
        if self.residue:
            for v, part in zip(values, mesh.split(
                    vals_full[:s_pad].reshape(self.eng.n_dev, per, w))):
                v[:, :per] = part
            for c, r, rs, gr in zip(self.ch, run, res, self.gflat_r):
                un = flat(c.untake(r))
                back = flat(gr).long().to(home)
                for k in ("pre", "post", "success"):
                    mine = rs[k][:nl * rows]
                    sel = un[:, None] if mine.dim() == 2 else un
                    mine.copy_(torch.where(sel, gres[k][back].to(
                        mine.device), mine))
        return [gres["success"].to(d) for d in self.eng.devices]

    def _per_shard(self, res):
        n = self.n_loc * self.rows
        return [{k: v[:n].reshape((self.n_loc, self.rows)
                                  + tuple(v.shape[1:]))
                 for k, v in r.items()} for r in res]
