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

The port keeps every shard on the engine's device, with the shards as a
tensor axis (``core/mesh.py``): the body works on ``[n_intervals,
n_shards, ...]`` tensors and folds both axes into the batch axes the kernels
take, so no Python loop over shards runs; the loop over intervals carries
``[n_shards, lpad+1, W]`` state blocks (on the megakernel rung of
``shared_nothing``, which merges nothing, one megakernel call carries them
through the whole stream).  On the card the staged rung's
segscans run over the flat concatenation of every shard's rows, one launch
per scan, and the CUDA affine scan's association depends on where a chain
lies among its fixed tiles (``csrc/segscan.cu``; the same from call to
call), so there a sharded run with max tables (TP) agrees with the
single-device run to a tolerance, not bit for bit; the megakernel rung
(GS) stays bitwise.

Non-associative or gated apps (SL, OB), and the ``tstream_lockstep`` and
``mvlk`` schemes, run the lockstep schedule sharded, under
``shared_nothing`` on a 1-D mesh only (as in the reference).  Each shard
walks its local chains with the single-device walk (``engines.
_lockstep_sweep``, every shard's round at once on the stacked blocks, one
host read a sweep, only the rounds that hold a valid op); cross-chain gates
resolve level by level against a success frontier keyed by global op id and
merged with a max over the shard axis after each level (a gated op's mate
chain always sits at a strictly lower level); the level fixpoint merges with
a min over that axis; and the dependency-cycle residue runs once, as the
sequential sweep over every shard's gathered residue ops in global (ts,
slot) order.  So the sharded lockstep run is bitwise the single-device one,
on the CPU and on the card.

The chunked service drives the same program one chunk at a time
(``run_chunk``: blocks in, blocks out, so chunks chain with no per-chunk
permute), and moves its resident carry onto a new placement between chunks
(``reshard``: live migration under ``shared_nothing``; only the rows whose
owner changed travel, through one ``all_to_all`` at the exact capacity of
``ownership.migration_plan``, so a migration never drops a row).
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

    The ownership permutation and routing tables are built once here; a
    call reshapes the host stream and runs the whole-stream program.
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
        self._bind_ownership(())
        self.last_stats: Optional[Dict] = None
        self.last_rung: Optional[str] = None

    def _bind_ownership(self, overrides) -> None:
        """(Re)build the ownership permutation and routing tables against
        ``overrides``: the one place the plan binds to a placement."""
        self.own = build_ownership(self.store, self._n_owners, overrides)
        self.probe = None
        if self.cfg.use_hash_probe_route:
            fwd = self.own.fwd[:-1].cpu().numpy()
            if self.layout == "shared_everything":
                owner = fwd % self.n_dev
            else:
                owner = fwd // self.own.per
            self.probe = build_probe_route(self.store.n_slots, owner,
                                           miss_owner=self.n_route,
                                           device=self.mesh.device)

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

    def reshard(self, blocks: torch.Tensor, overrides):
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
        """Reference: ``_migrate_impl`` / ``_migrate_body``, every shard at
        once.  ``dst``/``nidx`` (``[n_dev, per]``, from ``migration_plan``)
        give each block row its new owner and its row in that owner's
        block."""
        n_dev, per, w = self.n_dev, self.own.per, blocks.shape[-1]
        dev = blocks.device
        b = blocks.reshape(n_dev, per + 1, w)
        rows = b[:, :per]
        dstv = torch.from_numpy(dst).to(dev)
        nidxv = torch.from_numpy(nidx).to(dev)
        stay = dstv == torch.arange(n_dev, dtype=I32, device=dev)[:, None]
        out = torch.zeros_like(b)
        # rows that stay scatter straight to their new index; the others
        # (and dead padding rows, nidx == per) land on the pad row as 0
        at = torch.where(stay, nidxv, torch.full_like(nidxv, per)).long()
        out.scatter_(1, at[..., None].expand(n_dev, per, w).contiguous(),
                     torch.where(stay[..., None], rows,
                                 torch.zeros_like(rows)))
        # moved rows bucket by new owner and ship with ONE all_to_all;
        # cells beyond a pair's move count hold 0.0 at index per
        plan = bucket_by_owner(
            torch.where(stay, torch.full_like(dstv, n_dev), dstv), n_dev,
            cap, use_kernels=self.cfg.use_kernels,
            threads=self.cfg.block_param("radix_partition"))
        srows = route_gather(plan, rows, 0.0)          # [n_dev, n_dev, cap, w]
        sidx = route_gather(plan, nidxv, per)          # [n_dev, n_dev, cap]
        rrows = self.mesh.all_to_all(srows, self.axes, 0, 0, dim=0)
        ridx = self.mesh.all_to_all(sidx, self.axes, 0, 0, dim=0)
        out.scatter_(1, ridx.reshape(n_dev, -1, 1).expand(
            n_dev, n_dev * cap, w).long(), rrows.reshape(n_dev, -1, w))
        out[:, per] = 0.0
        return out.reshape(n_dev * (per + 1), w), int(plan.ok.sum())

    def set_exchange_slack(self, slack: float) -> None:
        """Widen (or narrow) the per-bucket capacity from the next call on;
        results of shipped ops are unaffected, only the padding changes."""
        self.exchange_slack = float(slack)

    # -- block carry <-> canonical values ---------------------------------
    @property
    def _n_blocks(self) -> int:
        return self.n_dev if self.layout == "shared_nothing" else \
            self.n_sockets

    def carry_in(self, values: torch.Tensor) -> torch.Tensor:
        """[S+1, W] canonical values -> the resident block carry:
        ``[n_blocks*(per+1), W]`` (one block per owner, pad row last) for
        the partitioned layouts, the full ``[s_pad+1, W]`` permuted buffer
        for shared_everything."""
        own = self.own
        vperm = permute_values(own, values.to(self.mesh.device))
        if self.layout == "shared_everything":
            return vperm
        nb, per, w = self._n_blocks, own.per, vperm.shape[1]
        return torch.cat([vperm[:-1].reshape(nb, per, w),
                          vperm.new_zeros((nb, 1, w))],
                         dim=1).reshape(nb * (per + 1), w)

    def carry_out(self, blocks: torch.Tensor) -> torch.Tensor:
        """Block carry -> [S+1, W] canonical values (exact gathers only)."""
        own = self.own
        per, s_pad, w = own.per, own.s_pad, blocks.shape[-1]
        if self.layout == "shared_everything":
            vperm = blocks[:s_pad]
        else:
            vperm = blocks.reshape(self._n_blocks, per + 1, w)[:, :per]
            vperm = vperm.reshape(s_pad, w)
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

    def run_chunk(self, blocks: torch.Tensor, batched, ts0: int):
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
        """Blocks in, blocks out: expand the carry to one state block per
        shard, route, evaluate and return the results, fold the blocks back
        and reduce the stats."""
        own, layout, n_dev = self.own, self.layout, self.n_dev
        per, s_pad = own.per, own.s_pad
        w = self.app.width
        dev = self.mesh.device
        has_max = any(self.store.table_is_max)
        sim = (own.slot_is_max if has_max else
               torch.zeros((s_pad + 1,), dtype=torch.bool, device=dev))
        if layout == "shared_everything":
            vals0 = blocks[None].expand(n_dev, s_pad + 1, w).clone()
            sim_d = sim[None].expand(n_dev, s_pad + 1)
        else:
            nb = self._n_blocks
            vals0 = blocks.reshape(nb, per + 1, w).clone()
            sim_d = torch.cat([sim[:-1].reshape(nb, per),
                               sim.new_zeros((nb, 1))], dim=1)
            if layout == "shared_per_socket":   # replicated on its cores
                vals0 = vals0.repeat_interleave(self.n_core, dim=0)
                sim_d = sim_d.repeat_interleave(self.n_core, dim=0)

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

        # carry out: the canonical block layout (pad rows zero)
        if layout == "shared_nothing":
            carry = vals_fin.reshape(n_dev * (per + 1), w)
        else:
            if layout == "shared_per_socket":   # every core holds its block
                vperm = vals_fin[::self.n_core, :per]
            else:
                vperm = vals_fin[:1, :s_pad]
            carry = torch.cat([vperm, vperm.new_zeros(
                (vperm.shape[0], 1, w))], dim=1).reshape(-1, w)

        # per-local-slot access counts over the whole stream; each valid
        # routed op counts on exactly one shard (per_socket: the core filter)
        lpad = vals0.shape[1] - 1
        loads = torch.zeros((n_dev, lpad + 1), dtype=I32, device=dev)
        loads.scatter_add_(
            1, torch.clamp(rops.uid, max=lpad).transpose(0, 1).reshape(
                n_dev, -1).long(),
            rops.valid.to(I32).transpose(0, 1).reshape(n_dev, -1))
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
            shard_load = torch.zeros((n_dev,), dtype=I32, device=dev)
            shard_load.index_add_(0, torch.arange(s_pad, device=dev) % n_dev,
                                  slot_perm)
        slot_load = slot_perm[own.fwd[:-1].long()]          # original uids

        stats = dict(
            dropped=torch.sum(plans.dropped, dim=1, dtype=I32),
            shipped=torch.sum(plans.ok, dim=(1, 2, 3), dtype=I32),
            max_fill=torch.amax(plans.fill, dim=1),
            capacity=cap, exchanged_rows_per_device=n_dev * cap,
            shard_load=shard_load, slot_load=slot_load, **walk)
        return res_loc, ebs_all, carry, stats

    def route(self, events_b, ts0: int = 0):
        """Compute mode and the exchange, hoisted over the whole stream.

        ``events_b``: event columns ``[n_intervals, interval, ...]`` on the
        mesh's device.  Each shard registers the ops of its slice of every
        interval, buckets them by owner and ships them with one
        ``all_to_all``.  Returns ``(rops, plans, ebs, cap, gflat)``: the op
        batch each shard received (fields ``[n_intervals, n_shards, R]``,
        rows source-shard-major, then cell, so row order is ts order), the
        route plans (``[n_intervals, n_shards, ...]``), the event payloads
        in the single-device layout, the bucket capacity, and for the
        lockstep schedule each received row's global op id (``N_glob`` on a
        padding row; None on the associative path).  There the gates ship
        too, as global op ids.
        """
        app, cfg, own, layout = self.app, self.cfg, self.own, self.layout
        mesh, n_dev, n_route = self.mesh, self.n_dev, self.n_route
        dev = mesh.device
        per = own.per
        lpad = own.s_pad if layout == "shared_everything" else per
        some = next(iter(events_b.values()))
        n_intervals, interval = some.shape[0], some.shape[1]
        e_loc = interval // n_dev
        cap = exchange_capacity(e_loc * app.max_ops, n_route,
                                self.exchange_slack)
        shard = torch.arange(n_dev, dtype=I32, device=dev)

        # ---- compute mode: event-parallel op registration (all intervals) -
        ev = {k: v.reshape((n_intervals, n_dev, e_loc) + tuple(v.shape[2:]))
              for k, v in events_b.items()}
        ts_bases = (ts0 + torch.arange(n_intervals, dtype=I32,
                                       device=dev)[:, None] * interval
                    + shard[None, :] * e_loc)
        ops_all, ebs_all = build_opbatch(app, self.store, ev, ts_bases)
        ebs_all = {k: v.reshape((n_intervals, interval) + tuple(v.shape[3:]))
                   for k, v in ebs_all.items()}
        n_loc = ops_all.uid.shape[-1]

        # ---- owner routing (values-independent, hoisted) ------------------
        uid_perm = own.fwd[ops_all.uid.long()]           # [n_i, n_dev, N_loc]
        if self.probe is not None:
            dst_v = self.probe.owners_of(
                ops_all.uid.reshape(-1),
                use_kernels=cfg.use_kernels).reshape(ops_all.uid.shape)
        elif layout == "shared_everything":
            dst_v = uid_perm % n_dev
        else:
            dst_v = uid_perm // per
        dst = torch.where(ops_all.valid, dst_v,
                          torch.full_like(dst_v, n_route)).to(I32)
        plans = bucket_by_owner(dst, n_route, cap,
                                use_kernels=cfg.use_kernels,
                                threads=cfg.block_param("radix_partition"))
        if layout == "shared_everything":
            uid_local = uid_perm
        else:
            uid_local = uid_perm - torch.clamp(dst_v, max=n_route - 1) * per
        uid_send = torch.where(ops_all.valid, uid_local,
                               torch.full_like(uid_local, lpad))
        send = dict(
            uid=route_gather(plans, uid_send, lpad),
            fun=route_gather(plans, ops_all.fun, 0),
            operand=route_gather(plans, ops_all.operand, 0.0),
            valid=route_gather(plans, ops_all.valid, False),
            ts=route_gather(plans, ops_all.ts, 0),
            slot=route_gather(plans, ops_all.slot, 0),
        )
        if not self.assoc:
            # gates and op ids as global op ids: shard d's ops are the
            # interval's flat ops [d * N_loc, (d + 1) * N_loc)
            base = (shard * n_loc)[None, :, None]
            gflat = (base + torch.arange(n_loc, dtype=I32, device=dev)
                     ).expand(ops_all.uid.shape)
            send["gate"] = route_gather(
                plans, torch.where(ops_all.gate >= 0, ops_all.gate + base,
                                   torch.full_like(ops_all.gate, -1)), -1)
            send["gflat"] = route_gather(plans, gflat, n_dev * n_loc)

        # ---- THE exchange: one all_to_all for the whole stream ------------
        recv = {k: mesh.all_to_all(v, self.route_axes, 1, 1, dim=1)
                for k, v in send.items()}
        if layout == "shared_per_socket":
            # every core sees the socket's full routed set, in flat
            # source-shard order (socket-major), so rows stay ts-sorted
            recv = {k: mesh.all_gather(v, self.axes[1], 1, dim=1).movedim(2, 3)
                    for k, v in recv.items()}
        rest = 5 if layout == "shared_per_socket" else 4
        recv = {k: v.reshape((n_intervals, n_dev, n_dev * cap)
                             + tuple(v.shape[rest:]))
                for k, v in recv.items()}
        rvalid, ruid = recv["valid"], recv["uid"]
        if layout == "shared_per_socket":
            core = (shard % self.n_core)[None, :, None]
            rvalid = rvalid & ((ruid % self.n_core) == core)
        zeros = torch.zeros_like(ruid)
        rops = OpBatch(uid=ruid, ts=recv["ts"], txn=zeros, slot=recv["slot"],
                       kind=zeros, fun=recv["fun"],
                       gate=recv.get("gate", torch.full_like(ruid, -1)),
                       operand=recv["operand"], valid=rvalid)
        return rops, plans, ebs_all, cap, recv.get("gflat")

    def _evaluate(self, vals0, sim_d, rops):
        """State-access mode: the intervals carry every shard's block.

        ``vals0``: ``[n_dev, lpad+1, W]`` state blocks, one per shard;
        ``sim_d``: their per-slot max flags or None.  Returns the final
        blocks and per-op results ``[n_intervals, n_dev, R, ...]`` in each
        shard's received-row order.
        """
        app, cfg, layout = self.app, self.cfg, self.layout
        mesh, axes, n_dev = self.mesh, self.axes, self.n_dev
        dev = mesh.device
        lpad = vals0.shape[1] - 1
        n_intervals, _, rows = rops.uid.shape
        shard = torch.arange(n_dev, device=dev)
        threads_radix = cfg.block_param("radix_partition")

        merge_axes, own_mask = None, None
        slots = torch.arange(lpad, device=dev)
        if layout == "shared_per_socket":
            merge_axes = (axes[1],)
            own_mask = (slots[None, :] % self.n_core
                        == (shard % self.n_core)[:, None])
        elif layout == "shared_everything":
            merge_axes = axes
            own_mask = slots[None, :] % n_dev == shard[:, None]
        if own_mask is not None:   # the pad row has no owner
            own_mask = torch.cat([own_mask, own_mask.new_zeros((n_dev, 1))],
                                 dim=1)[..., None]

        def merge(vals):
            if own_mask is None:
                return vals
            # ownership-masked SELECT (one writer per slot): exact, unlike
            # delta summation
            neg = torch.full((), float("-inf"), dtype=vals.dtype, device=dev)
            vals = mesh.pmax(torch.where(own_mask, vals, neg), merge_axes,
                             dim=0)
            vals[:, lpad] = 0.0
            return vals

        luts = simple_affine_luts(app.funs, dev)
        vals, res_l = vals0, []
        if megakernel_engaged(
                rows, lpad + 1, method=cfg.restructure_method,
                has_max=sim_d is not None, funs_simple=luts is not None,
                lanes=vals0.shape[-1],
                smem_limit=smem_optin(dev) if cfg.use_kernels else None,
                device_kind=autotune.kind_of(dev)):
            self.last_rung = "megakernel"
            # megakernel rung: a geometry-free partition plan, then ONE call
            # for the whole stream evaluates every shard's chains; a layout
            # that merges after every interval calls it once per interval
            a_lut, b_lut = luts
            sops_all, ch_all = restructure_stream(
                rops, lpad, rowmajor_ts=True, light=True, method="partition",
                use_kernels=cfg.use_kernels, geometry=False,
                threads=threads_radix)
            if cfg.use_kernels:
                evaluate_chains = functools.partial(
                    fused_chain_eval, threads=cfg.block_param("megakernel"))
            else:
                evaluate_chains = fused_chain_stream_ref
            if own_mask is None:
                res, vals, _ = evaluate_chains(vals, sops_all, ch_all, lpad,
                                               a_lut=a_lut, b_lut=b_lut)
                return vals, res
            for i in range(n_intervals):
                at = slice(i, i + 1)
                res, vals, _ = evaluate_chains(
                    vals, tree_index(sops_all, at), tree_index(ch_all, at),
                    lpad, a_lut=a_lut, b_lut=b_lut)
                vals = merge(vals)
                res_l.append({k: v[0] for k, v in res.items()})
        else:
            self.last_rung = restructure_path(
                rows, lpad, rowmajor_ts=True, method=cfg.restructure_method,
                device_kind=autotune.kind_of(dev))
            pres_all = restructure_stream(
                rops, lpad, rowmajor_ts=True, light=True,
                method=cfg.restructure_method, use_kernels=cfg.use_kernels,
                threads=threads_radix)
            plan_all = tstream_scan_plan(
                make_local_store(vals0, sim_d), rops, app.funs,
                prestructured=pres_all, use_kernels=cfg.use_kernels)
            plan_all = tstream_scan_coefs(plan_all,
                                          use_kernels=cfg.use_kernels,
                                          threads=cfg.block_param("segscan"))
            for i in range(n_intervals):
                plan = tree_index(plan_all, i)
                res, vals, _ = tstream_scan_execute(vals, plan, lpad,
                                                    raw=True)
                vals = merge(vals)
                res_l.append({k: plan.ch.untake(v) for k, v in res.items()})
        return vals, _stack(res_l)

    # -- the lockstep schedule (shared_nothing, 1-D mesh) -----------------
    def _evaluate_lockstep(self, vals0, rops, gflat, n_glob: int):
        """State-access mode of the lockstep schedule: one restructure for
        the stream (on the partition rung one radix launch), then one
        lockstep walk per interval, every shard's at once.

        ``vals0``: ``[n_dev, per+1, W]`` state blocks; ``gflat``: each
        received row's global op id (``n_glob`` on a padding row).  Returns
        the final blocks, per-op results ``[n_intervals, n_dev, R, ...]`` in
        each shard's received-row order, and the walk's totals (``swept``:
        rounds run, ``residue``: ops left to the sequential sweep).
        """
        cfg = self.cfg
        lpad = vals0.shape[1] - 1
        n_intervals, _, rows = rops.uid.shape
        self.last_rung = restructure_path(
            rows, lpad, rowmajor_ts=True, method=cfg.restructure_method,
            device_kind=autotune.kind_of(vals0.device))
        sops_all, ch_all = restructure_stream(
            rops, lpad, rowmajor_ts=True, method=cfg.restructure_method,
            use_kernels=cfg.use_kernels,
            threads=cfg.block_param("radix_partition"))
        vals, res_l, walk = vals0, [], dict(swept=0, residue=0)
        for i in range(n_intervals):
            walker = _LockstepWalk(self, tree_index(sops_all, i),
                                   tree_index(ch_all, i), gflat[i], n_glob)
            vals, res = walker.interval(vals)
            walk["swept"] += walker.swept
            walk["residue"] += walker.residue
            res_l.append(res)
        return vals, _stack(res_l), walk

    def _reverse(self, res_routed, plans, cap: int):
        """The reverse exchange: results home to their source shard, then
        back to flat per-op layout ``[n_intervals, N_glob, ...]``."""
        mesh, n_dev, n_route = self.mesh, self.n_dev, self.n_route
        n_intervals = plans.dst.shape[0]
        shard = torch.arange(n_dev, device=mesh.device)
        if self.layout == "shared_per_socket":
            # socket-complete results (each op evaluated on exactly one
            # core), then each core returns the rows of its own source core
            core = shard % self.n_core
            back = {}
            for k, v in res_routed.items():
                if v.dtype == torch.bool:
                    v = mesh.psum(v.to(I32), self.axes[1], dim=1) > 0
                else:
                    v = mesh.psum(v, self.axes[1], dim=1)
                v = v.reshape((n_intervals, n_dev, self.n_sockets,
                               self.n_core, cap) + tuple(v.shape[3:]))
                back[k] = v[:, shard, :, core].movedim(0, 1)
        else:
            back = {k: v.reshape((n_intervals, n_dev, n_dev, cap)
                                 + tuple(v.shape[3:]))
                    for k, v in res_routed.items()}
        res_loc = {}
        for k, v in back.items():
            v = mesh.all_to_all(v, self.route_axes, 1, 1, dim=1)
            v = v.reshape((n_intervals, n_dev, n_route * cap)
                          + tuple(v.shape[4:]))
            v = unroute_gather(plans, v, n_route, cap)
            res_loc[k] = v.reshape((n_intervals, n_dev * v.shape[2])
                                   + tuple(v.shape[3:]))
        return res_loc


class _LockstepWalk:
    """One interval of the sharded lockstep schedule, every shard at once.

    Reference: ``_lockstep_interval``, ``_lockstep_eval``,
    ``_sweep_sharded``, ``_chain_levels_sharded`` and ``_residue_sharded``
    (``repro/core/sharded_stream.py``).  The stacked blocks ``[n_dev,
    per+1, W]`` are walked as one state of ``n_dev * (per+1)`` rows (shard
    d's local uid u is row ``d * (per+1) + u``), so the single-device walk
    runs round r of every shard at once: the shards' states are disjoint,
    and a valid received op never addresses a pad row.  Per-op results sit
    per shard in received-row order (row ``d * R + ch.order``); the success
    frontier and the level array are keyed by global op id, one replica
    per shard (``[n_dev, N_glob+1]``), merged over the shard axis.

    A gated op reads its mate's success from the frontier alone, where the
    reference also reads the shard's own results: the mate's chain sits at
    a strictly lower level (or the op is residue), so the frontier already
    holds it.  ``swept`` and ``residue`` count the last pass's rounds and
    residue ops.
    """

    def __init__(self, eng: ShardedStream, sops: OpBatch, ch, gflat_r,
                 n_glob: int):
        self.eng, self.sops, self.ch = eng, sops, ch
        self.gflat_r = gflat_r                          # [n_dev, R]
        self.gflat_s = take_along(gflat_r, ch.order)    # sorted layout
        self.n_glob = n_glob
        self.n_dev, self.rows = sops.uid.shape
        self.shard = torch.arange(self.n_dev, dtype=I32,
                                  device=sops.uid.device)[:, None]
        self.dst = (self.shard * self.rows + ch.order).reshape(-1)
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
        gvalid = self.frontier(self.ch.untake(self.sops.valid))[0]
        txn_ok = torch.all((succ1[:n_glob] | ~gvalid[:n_glob])
                           .reshape(-1, m), dim=1)         # [interval]
        txn = torch.clamp(self.gflat_s // m, max=txn_ok.shape[0] - 1)
        keep = txn_ok[txn.long()] & (self.gflat_s < n_glob)
        sops2 = dataclasses.replace(self.sops, valid=self.sops.valid & keep)
        vals2, res2, _ = self.evaluate(vals, sops2)
        return vals2, res2

    def frontier(self, flags_r):
        """A bool per received row -> the global-op-id frontier ``[n_dev,
        N_glob+1]``: scattered on each shard, merged with a max over the
        shard axis (the reference's bool ``pmax``).  A padding row lands
        on column ``N_glob`` and is False."""
        arr = torch.zeros((self.n_dev, self.n_glob + 1), dtype=I32,
                          device=flags_r.device)
        arr.scatter_(1, self.gflat_r.long(), flags_r.to(I32))
        return self.eng.mesh.pmax(arr, self.eng.axes, dim=0) > 0

    def levels(self, sops):
        """``_chain_levels_sharded``: the per-chain level fixpoint against a
        per-op level array keyed by global op id, merged with a min over the
        shard axis (levels only decrease).  Returns each shard's chain
        levels and which chains stay unresolved."""
        mesh, axes = self.eng.mesh, self.eng.axes
        ch, n_dev, rows = self.ch, self.n_dev, self.rows
        seg = (self.shard * rows + ch.seg_id).reshape(-1).long()
        gated = (sops.gate >= 0) & sops.valid
        has_gate = (_segment_max(gated.to(I32).reshape(-1), seg,
                                 n_dev * rows) > 0).reshape(n_dev, rows)
        zero = torch.zeros((n_dev, rows), dtype=I32, device=seg.device)
        inf = torch.full_like(zero, INF_LEVEL)
        lvl = torch.where(has_gate, inf, zero)
        mate = sops.gate.clamp(min=0).long()
        shipped = self.gflat_s < self.n_glob
        for _ in range(self.eng.cfg.max_dep_levels):
            per_op = torch.where(shipped, take_along(lvl, ch.seg_id), inf)
            opl = torch.full((n_dev, self.n_glob + 1), INF_LEVEL, dtype=I32,
                             device=seg.device)
            opl = mesh.pmin(opl.scatter_(1, self.gflat_s.long(), per_op),
                            axes, dim=0)
            pred = torch.gather(opl, 1, mate)
            need = _segment_max(
                torch.where(gated, torch.clamp(pred + 1, max=INF_LEVEL),
                            zero).reshape(-1), seg, n_dev * rows)
            lvl = torch.where(has_gate, torch.clamp(
                need.reshape(n_dev, rows), max=INF_LEVEL), zero)
        return lvl, lvl >= INF_LEVEL

    def evaluate(self, vals, sops):
        """``_lockstep_eval``: the walk of one pass from ``vals``.  Returns
        the new blocks, the per-op results ``[n_dev, R, ...]`` and the
        merged success frontier ``[N_glob+1]``."""
        app, cfg = self.eng.app, self.eng.cfg
        ch, n_dev, rows, n_glob = self.ch, self.n_dev, self.rows, self.n_glob
        dev, w = vals.device, vals.shape[-1]
        lpad = vals.shape[1] - 1
        values = vals.clone()
        res = _empty_results(n_dev * rows, w, dev)
        success_r = res["success"][:n_dev * rows].view(n_dev, rows)
        # one flat state and op batch over every shard; a gate addresses
        # its shard's replica of the frontier
        flat = OpBatch(**{f.name: getattr(sops, f.name).reshape(
            (n_dev * rows,) + tuple(getattr(sops, f.name).shape[2:]))
            for f in dataclasses.fields(OpBatch)})
        flat = dataclasses.replace(
            flat, uid=(sops.uid + self.shard * (lpad + 1)).reshape(-1),
            gate=torch.where(sops.gate >= 0,
                             sops.gate + self.shard * (n_glob + 1),
                             torch.full_like(sops.gate, -1)).reshape(-1))
        never = torch.full_like(ch.pos, -1)

        def sweep(group, frontier=None):
            return _lockstep_sweep(values.view(-1, w), flat, self.dst,
                                   app.funs, group.reshape(-1), res, lpad,
                                   frontier=frontier)

        self.residue = 0
        if not app.has_gates:
            self.swept = sweep(torch.where(sops.valid, ch.pos, never))
            succ = self.frontier(success_r)[0]
            return values, self._per_shard(res), succ

        lvl, unresolved = self.levels(sops)
        lvl_s = take_along(lvl, ch.seg_id)
        succ = self.frontier(success_r)
        self.swept = 0
        for level in range(cfg.max_dep_levels + 1):
            at = sops.valid & (lvl_s == level)
            swept = sweep(torch.where(at, ch.pos, never),
                          frontier=succ.reshape(-1))
            if swept:
                self.swept += swept
                succ = self.frontier(success_r)
        succ = self._residue(values, sops, take_along(unresolved, ch.seg_id)
                             & sops.valid, res, succ[0].clone())
        return values, self._per_shard(res), succ

    def _residue(self, values, sops, run, res, succ):
        """``_residue_sharded``: the ops of unresolved chains (dependency
        cycles) run once, one at a time in global (ts, slot) order, over
        every shard's gathered residue ops and the gathered state (the
        reference's all_gathers are reshapes here), then each shard takes
        its block and its ops' results back.  Returns the frontier."""
        n_dev, rows, n_glob = self.n_dev, self.rows, self.n_glob
        per, w = values.shape[1] - 1, values.shape[-1]
        s_pad = n_dev * per
        vals_full = torch.cat([values[:, :per].reshape(s_pad, w),
                               values.new_zeros((1, w))])
        flat = lambda x: x.reshape((n_dev * rows,) + tuple(x.shape[2:]))
        g = dataclasses.replace(
            sops, **{f.name: flat(getattr(sops, f.name))
                     for f in dataclasses.fields(OpBatch)})
        g = dataclasses.replace(g, uid=flat(torch.where(
            run, sops.uid + self.shard * per, torch.full_like(sops.uid,
                                                              s_pad))))
        gres = dict(pre=values.new_zeros((n_glob + 1, w)),
                    post=values.new_zeros((n_glob + 1, w)), success=succ)
        self.residue = _sequential_sweep(vals_full, g, self.eng.app.funs,
                                         gres, mask_flat=flat(run),
                                         pad_uid=s_pad,
                                         sink=flat(self.gflat_s))
        if not self.residue:
            return succ
        values[:, :per] = vals_full[:s_pad].reshape(n_dev, per, w)
        un = flat(self.ch.untake(run))
        back = flat(self.gflat_r).long()
        for k in ("pre", "post", "success"):
            mine = res[k][:n_dev * rows]
            sel = un[:, None] if mine.dim() == 2 else un
            mine.copy_(torch.where(sel, gres[k][back], mine))
        return gres["success"]

    def _per_shard(self, res):
        n = self.n_dev * self.rows
        return {k: v[:n].reshape((self.n_dev, self.rows) + tuple(v.shape[1:]))
                for k, v in res.items()}
