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

Not ported here: the lockstep branch for non-associative apps and schemes
(ROADMAP A9), the chunk entry ``run_chunk`` and live resharding
(``reshard``, ``_migrate_impl``), which move the chunked service's resident
carry (ROADMAP A8, A9).
"""
from __future__ import annotations

import functools
import logging
from typing import Dict, Optional

import numpy as np
import torch

from .. import convert
from ..kernels.megakernel.ops import fused_chain_eval
from ..kernels.megakernel.ref import fused_chain_stream_ref
from ..kernels.runtime import smem_optin
from .blotter import AppSpec, build_opbatch
from .engines import (simple_affine_luts, tstream_scan_coefs,
                      tstream_scan_execute, tstream_scan_plan)
from .mesh import ShardMesh
from .ownership import (LAYOUTS, bucket_by_owner, build_ownership,
                        build_probe_route, exchange_capacity,
                        make_local_store, permute_values, route_gather,
                        unpermute_values, unroute_gather)
from .restructure import (megakernel_engaged, restructure_path,
                          restructure_stream)
from .scheduler import _post_stream, _stack
from .types import OpBatch, StateStore, tree_index

log = logging.getLogger(__name__)

I32 = torch.int32

LOCKSTEP_NOT_PORTED = (
    "the sharded lockstep schedule (non-associative or gated apps, the "
    "tstream_lockstep and mvlk schemes) is not ported yet: it comes with "
    "ROADMAP A9")


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
                      and cfg.scheme in ("tstream", "tstream_scan"))
        if not self.assoc:
            raise NotImplementedError(
                f"sharded {cfg.scheme!r} on app {app.name!r}: "
                + LOCKSTEP_NOT_PORTED)
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

    def set_ownership(self, overrides) -> None:
        """Rebind the plan to a new placement without touching data (the
        canonical values re-enter through ``carry_in`` under it)."""
        overrides = tuple(sorted((int(u), int(o)) for u, o in overrides))
        if overrides != self.own.overrides:
            self._bind_ownership(overrides)

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
        interval = int(punct_interval)
        if interval % self.n_dev:
            raise ValueError(f"punct_interval={interval} must divide evenly "
                             f"across {self.n_dev} shards")
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

        rops, plans, ebs_all, cap = self.route(events_b, ts0)
        vals_fin, res_routed = self._evaluate(
            vals0, sim_d if has_max else None, rops)
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
            shard_load=shard_load, slot_load=slot_load)
        return res_loc, ebs_all, carry, stats

    def route(self, events_b, ts0: int = 0):
        """Compute mode and the exchange, hoisted over the whole stream.

        ``events_b``: event columns ``[n_intervals, interval, ...]`` on the
        mesh's device.  Each shard registers the ops of its slice of every
        interval, buckets them by owner and ships them with one
        ``all_to_all``.  Returns ``(rops, plans, ebs, cap)``: the op batch
        each shard received (fields ``[n_intervals, n_shards, R]``, rows
        source-shard-major, then cell, so row order is ts order), the route
        plans (``[n_intervals, n_shards, ...]``), the event payloads in the
        single-device layout and the bucket capacity.
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
                       gate=torch.full_like(ruid, -1),
                       operand=recv["operand"], valid=rvalid)
        return rops, plans, ebs_all, cap

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
                smem_limit=smem_optin(dev) if cfg.use_kernels else None):
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
            self.last_rung = restructure_path(rows, lpad, rowmajor_ts=True,
                                              method=cfg.restructure_method)
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
