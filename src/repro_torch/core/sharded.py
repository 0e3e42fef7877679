"""Per-batch chain-shard layouts over a mesh: the replicate-everything
baseline.

Reference: ``repro/core/sharded.py`` (DESIGN.md §2.5), the paper's
NUMA-aware processing configurations (§IV-E):

  shared-nothing     state slots owned by one shard (contiguous after the
                     ownership permutation); chains evaluate where their
                     state lives; no collective
  shared-per-socket  state owned per ``socket`` mesh axis, work split over
                     the socket's ``core`` axis -> one intra-socket merge
  shared-everything  state replicated; work split over every shard -> one
                     global merge

Every shard receives the full OpBatch and masks out the ops that are not its
own, paying O(n_shards · N) replicated rows, a restructure and an ownership
permutation per call.  The owner-routed fused driver
(``core/sharded_stream``) removes all three for streams; this is the
per-batch baseline it is measured against.

As in the port's fused driver the shards sit in the device groups of a
``ShardMesh`` (``core/mesh.py``): each group's replicated batch is
``[n_group_shards, N]`` on its device, and one restructure and one
``eval_tstream_scan`` a group evaluate every local batch of the group at
once.  The merge is ``ShardMesh.psum`` of what each shard owns.
The reference sums state deltas and adds them to the old values, which can
round (``old + (new - old)`` need not be ``new``); the port sums each
shard's own slots, zero elsewhere, and since one shard writes each slot the
sum is exact.  So every layout equals the single-device ``eval_tstream_scan``
bit for bit on the CPU twins, whose segmented scans are segment-relative,
under every grouping of the shards.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .engines import eval_tstream_scan
from .mesh import ShardMesh
from .ownership import (LAYOUTS, build_ownership, make_local_store,
                        permute_values, unpermute_values)
from .types import FunSpec, OpBatch, StateStore

__all__ = ["LAYOUTS", "evaluate_sharded"]


def evaluate_sharded(store: StateStore, ops: OpBatch,
                     funs: Tuple[FunSpec, ...], mesh: ShardMesh, layout: str,
                     *, restructure_method: str = "auto") -> torch.Tensor:
    """TStream's segmented-scan path under a chain-shard layout.

    ``ops`` (fields ``[N]``) must come from ``build_opbatch``: row order is
    (ts, slot).  ``shared_per_socket`` needs a ``(socket, core)`` mesh.
    Returns the new values ``[S, W]`` in the original slot order, pad row
    dropped (the reference's contract); the layout governs where each chain
    is evaluated and which collective reconciles the state.
    ``restructure_method`` is ``eval_tstream_scan``'s.
    """
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}; choose from {LAYOUTS}")
    n_dev, nl = mesh.size, mesh.per_group
    home = mesh.device
    n_sockets = 1
    if layout == "shared_per_socket":
        if len(mesh.shape) != 2:
            raise ValueError("shared_per_socket needs a (socket, core) mesh, "
                             f"got {mesh.axis_names}")
        n_sockets = mesh.shape[0]
    n_owners = {"shared_nothing": n_dev, "shared_per_socket": n_sockets,
                "shared_everything": 1}[layout]

    store = store.to(home)
    own = build_ownership(store, n_owners)
    per, s_pad = own.per, own.s_pad
    has_max = own.slot_is_max is not None
    values = permute_values(own, store.values)              # [s_pad+1, W]
    w = values.shape[1]
    sim = (own.slot_is_max if has_max else
           torch.zeros((s_pad + 1,), dtype=torch.bool, device=home))
    valid0 = ops.valid.to(home)
    # the permuted uid of every op, replicated on every shard
    uid0 = torch.where(valid0, own.fwd[ops.uid.to(home).long()],
                       torch.full_like(ops.uid, s_pad, device=home))
    if layout != "shared_everything":
        # the owners' blocks, [per+1] with the local pad row last
        nb = n_owners
        blocks = torch.cat([values[:-1].reshape(nb, per, w),
                            values.new_zeros((nb, 1, w))], dim=1)
        sim_b = torch.cat([sim[:-1].reshape(nb, per),
                           sim.new_zeros((nb, 1))], dim=1)
        n_core = n_dev // nb
    new_vals, keep = [], []
    for g, dev in enumerate(mesh.devices):
        uid, valid = uid0.to(dev), valid0.to(dev)
        shard = torch.arange(g * nl, (g + 1) * nl, dtype=uid.dtype,
                             device=dev)[:, None]
        rep = lambda x: x.to(dev)[None].expand((nl,) + tuple(x.shape))
        if layout == "shared_everything":
            mine = ((uid[None] % n_dev) == shard) & valid[None]
            local_uid = uid[None].expand(nl, -1)
            pad, vals, sim_d = s_pad, rep(values), rep(sim)
            owned = (torch.arange(s_pad + 1, device=dev)[None] % n_dev
                     == shard) & (torch.arange(s_pad + 1, device=dev) < s_pad)
        else:
            block_of = shard // n_core                  # the shard's owner
            local_uid = uid[None] - block_of * per
            mine = (local_uid >= 0) & (local_uid < per) & valid[None]
            owned = None
            if layout == "shared_per_socket":
                # chains split over the socket's cores by permuted uid
                mine = mine & ((uid[None] % n_core) == shard % n_core)
                slot = (torch.arange(per, device=dev)[None]
                        + block_of * per)               # permuted uids
                owned = torch.cat([slot % n_core == shard % n_core,
                                   torch.zeros((nl, 1), dtype=torch.bool,
                                               device=dev)], dim=1)
            pad = per
            vals = blocks.to(dev)[block_of[:, 0].long()]
            sim_d = sim_b.to(dev)[block_of[:, 0].long()]

        lops = dataclasses.replace(
            ops, **{f.name: rep(getattr(ops, f.name))
                    for f in dataclasses.fields(OpBatch)})
        lops = dataclasses.replace(
            lops, uid=torch.where(mine, local_uid,
                                  torch.full_like(local_uid, pad)),
            valid=mine)
        _, nv, _ = eval_tstream_scan(
            make_local_store(vals, sim_d if has_max else None), lops, funs,
            rowmajor_ts=True, restructure_method=restructure_method)
        new_vals.append(nv)
        if owned is not None:
            keep.append(torch.where(owned[..., None], nv,
                                    torch.zeros_like(nv)))

    if not keep:                                        # shared_nothing
        out = mesh.join(tuple(v[:, :per] for v in new_vals)).reshape(s_pad,
                                                                     w)
    else:
        # the merge: a psum of each shard's own slots (one writer a slot)
        axes = (mesh.axis_names[1:] if layout == "shared_per_socket"
                else mesh.axis_names)
        merged = mesh.psum(tuple(keep), axes, dim=0)
        if layout == "shared_per_socket":
            out = mesh.join(merged)[::n_dev // n_sockets,
                                    :per].reshape(s_pad, w)
        else:
            out = merged[0][0, :s_pad]
    return unpermute_values(own, torch.cat([out, out.new_zeros((1, w))]))[:-1]
