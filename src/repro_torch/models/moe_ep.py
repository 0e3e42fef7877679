"""Expert-parallel MoE: route, all-to-all dispatch, local experts, all-to-all
back, combine (reference: ``repro/models/moe_ep.py``, GShard-style).

The reference runs the routed-expert block under ``shard_map``: each device
routes its own tokens (top-k over sigmoid router scores), packs each
token-choice into the send buffer of the shard that owns the expert at a
static capacity (overflowing choices are dropped), exchanges the buffers
with an all-to-all over the expert-parallel axes, runs its E/n experts with
``ragged_dot``, sends the results back and combines them weighted by the
gates.  The shared experts stay on the dense path.

The port keeps every shard of the mesh on one device, as a tensor axis
(``core/mesh.ShardMesh``).  ``moe_forward_ep`` cuts ``x`` into the blocks
``shard_map`` hands each device (``TokenLayout``, the reference's
``x_spec``), runs every shard's step at once on the stacked tensor, and
exchanges through ``ShardMesh.all_to_all`` over the EP axes.  The capacity
drop keeps the reference's rows: a choice's rank among the choices bound
for its shard comes from a stable sort of the destinations and a running
max of the run starts, and the combine sums each token's choices in flat
(token, choice) order, as ``out.at[flat_tok].add`` does.

Wire per layer is about 2 * T_local * k * D * (bytes per element), in both
directions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core.mesh import ShardMesh, axis_sizes
from .config import ArchConfig
from .layers import (act_fn, ffn_forward, group_sizes, grouped_matmul,
                     sigmoid, top_k)

CAPACITY_FACTOR = 1.25

# set by the launch layer when a mesh is active (None: the dropless path)
_EP_MESH = None
_DP_AXES: Tuple[str, ...] = ("data",)
_TP_AXIS = "model"


def set_ep_mesh(mesh, dp_axes, tp_axis="model"):
    global _EP_MESH, _DP_AXES, _TP_AXIS
    _EP_MESH = mesh
    _DP_AXES = tuple(dp_axes)
    _TP_AXIS = tp_axis


def get_ep_mesh():
    return _EP_MESH


def ep_axes(mesh, n_experts: int) -> Tuple[str, ...]:
    """Mesh axes carrying expert parallelism: the largest suffix of
    (pod, data, model) whose size divides n_experts."""
    sizes = axis_sizes(mesh)
    axes = list(mesh.axis_names)
    while axes:
        if n_experts % math.prod(sizes[a] for a in axes) == 0:
            return tuple(axes)
        axes.pop(0)  # drop pod, then data: model stays innermost
    return ()


def _coords(mesh) -> np.ndarray:
    """[mesh size, n axes]: each shard's index on each axis, shards in
    row-major order over the mesh axes."""
    sizes = axis_sizes(mesh)
    dims = [sizes[a] for a in mesh.axis_names]
    return np.indices(dims).reshape(len(dims), -1).T


def _group_index(mesh, axes) -> np.ndarray:
    """Each shard's row-major index within its group over ``axes``."""
    sizes, coords = axis_sizes(mesh), _coords(mesh)
    idx = np.zeros(len(coords), np.int64)
    for a in axes:
        idx = idx * sizes[a] + coords[:, mesh.axis_names.index(a)]
    return idx


@dataclasses.dataclass(frozen=True)
class TokenLayout:
    """The blocks of ``x`` [B, S, D] that ``shard_map`` hands each shard
    under the reference's ``x_spec``: the batch over the data axes where
    they divide it, the sequence over the model axis where it divides it;
    a shard's block index on each (``bi``, ``si``), the block counts."""
    bi: np.ndarray
    si: np.ndarray
    nb: int
    ns: int

    @classmethod
    def of(cls, mesh, b: int, s: int, dp, tp) -> "TokenLayout":
        sizes = axis_sizes(mesh)
        dp_size = math.prod(sizes[a] for a in dp)
        msize = sizes[tp]
        nb = dp_size if b % dp_size == 0 else 1
        ns = msize if s % msize == 0 and s >= msize else 1
        n = math.prod(sizes.values())
        bi = _group_index(mesh, dp) if nb > 1 else np.zeros(n, np.int64)
        si = _group_index(mesh, (tp,)) if ns > 1 else np.zeros(n, np.int64)
        return cls(bi, si, nb, ns)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, D] -> every shard's block, stacked: [N, B/nb, S/ns, D]."""
        b, s, d = x.shape
        blocks = x.reshape(self.nb, b // self.nb, self.ns, s // self.ns, d)
        blocks = blocks.permute(0, 2, 1, 3, 4)
        return blocks[torch.as_tensor(self.bi, device=x.device),
                      torch.as_tensor(self.si, device=x.device)]

    def join(self, y: torch.Tensor) -> torch.Tensor:
        """Stacked blocks [N, bl, sl, D] -> [B, S, D], each block from the
        first shard that holds it (its replicas computed the same)."""
        key = self.bi * self.ns + self.si
        first = np.unique(key, return_index=True)[1]      # sorted by key
        blocks = y[torch.as_tensor(first, device=y.device)]
        _, bl, sl, d = y.shape
        blocks = blocks.reshape(self.nb, self.ns, bl, sl, d)
        return blocks.permute(0, 2, 1, 3, 4).reshape(self.nb * bl,
                                                     self.ns * sl, d)


@dataclasses.dataclass(frozen=True)
class Routing:
    """Every shard's routing of its ``t`` tokens, in flat (token, choice)
    order: ``choice`` and ``gate`` [N, t*k], ``keep`` (the choice fits its
    destination's capacity) and ``slot`` (its row in the send buffer, or
    ``n_shards * cap`` when dropped); ``cap`` rows per destination."""
    choice: torch.Tensor
    gate: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def route(cfg: ArchConfig, x_loc: torch.Tensor, router: torch.Tensor,
          n_shards: int, e_loc: int) -> Routing:
    """The reference's ``local_fn`` routing on every shard at once.
    x_loc: [N, t, D]; ``e_loc`` experts a shard."""
    n, t, _ = x_loc.shape
    k = cfg.experts_per_token
    cap = max(int(t * k * CAPACITY_FACTOR) // n_shards, 8)
    logits = torch.einsum("ntd,de->nte", x_loc.float(), router.float())
    gates, choice = top_k(sigmoid(logits), k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    tk = t * k
    flat_choice = choice.reshape(n, tk)
    dest = flat_choice // e_loc                       # owning shard
    # slot within the destination buffer: rank among same-dest entries
    order = torch.argsort(dest, dim=-1, stable=True)
    sd = torch.gather(dest, 1, order)
    starts = torch.cat([torch.ones_like(sd[:, :1], dtype=torch.bool),
                        sd[:, 1:] != sd[:, :-1]], dim=1)
    ar = torch.arange(tk, device=x_loc.device).expand(n, tk)
    rank_sorted = ar - torch.cummax(torch.where(starts, ar, 0), dim=1).values
    rank = torch.zeros_like(ar).scatter(1, order, rank_sorted)
    keep = rank < cap                                  # capacity drop
    slot = torch.where(keep, dest * cap + rank, n_shards * cap)
    return Routing(flat_choice, gates.reshape(n, tk), keep, slot, cap)


def _local_expert_block(cfg: ArchConfig, recv_x, recv_eid, recv_valid,
                        wg, wu, wd, first):
    """Every shard's experts on the rows it received, at once.  recv_x:
    [N, R, D]; recv_eid: each row's expert within its shard's block, which
    starts at global expert ``first[n]`` of the full weights [E, ...].  The
    rows sort by expert; invalid rows go in a pad group past the last
    expert and come out zero."""
    n, r, d = recv_x.shape
    e = wu.shape[0]
    eid = torch.where(recv_valid, recv_eid.long() + first[:, None], e)
    eid = eid.reshape(n * r)
    order = torch.argsort(eid, stable=True)
    xs = recv_x.reshape(n * r, d)[order]
    sizes = group_sizes(eid, e)
    f = act_fn(cfg.act)
    if cfg.gated_ffn:
        h = f(grouped_matmul(xs, wg, sizes)) * grouped_matmul(xs, wu, sizes)
    else:
        h = f(grouped_matmul(xs, wu, sizes))
    ys = grouped_matmul(h, wd, sizes)
    inv = torch.argsort(order)
    return ys[inv].reshape(n, r, -1)


def _shard_mesh(mesh, x: torch.Tensor) -> ShardMesh:
    """The collectives' mesh: the EP mesh itself where it is a
    ``ShardMesh`` (on ``x``'s device), else one of its shape on ``x``'s
    device (``meta`` under the dry run)."""
    if isinstance(mesh, ShardMesh):
        if mesh.n_groups != 1:
            raise ValueError(f"expert parallelism takes a one-group mesh "
                             f"(got {mesh.n_groups} device groups)")
        if mesh.device != x.device:
            raise ValueError(f"EP mesh on {mesh.device}, tokens on "
                             f"{x.device}")
        return mesh
    sizes = axis_sizes(mesh)
    shape = [sizes[a] for a in mesh.axis_names]
    if x.is_meta:
        return ShardMesh.meta(shape, mesh.axis_names)
    return ShardMesh(shape, mesh.axis_names, device=x.device)


def moe_forward_ep(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``layers.moe_forward`` when an EP mesh is set: the routed experts
    run expert-parallel over the EP axes, the shared experts on the dense
    path.  x: [B, S, D]."""
    mesh, dp, tp = _EP_MESH, _DP_AXES, _TP_AXIS
    sm = _shard_mesh(mesh, x)
    ep = ep_axes(mesh, cfg.n_experts) or (tp,)
    sizes = axis_sizes(mesh)
    n_shards = math.prod(sizes[a] for a in ep)
    e_loc = cfg.n_experts // n_shards
    b, s, d = x.shape
    layout = TokenLayout.of(mesh, b, s, dp, tp)
    x_st = layout.split(x)
    n, bl, sl, _ = x_st.shape
    t = bl * sl
    x_loc = x_st.reshape(n, t, d)
    r = route(cfg, x_loc, p["router"], n_shards, e_loc)
    k = cfg.experts_per_token
    rows = n_shards * r.cap

    # pack: each kept choice's token row into its destination's buffer
    # (a broadcast then a scatter to distinct rows: no backward adds into
    # one row from many; dropped choices all land in one extra row)
    xt_rep = x_loc[:, :, None, :].expand(n, t, k, d).reshape(n, t * k, d)
    slot = r.slot
    send_x = x_loc.new_zeros((n, rows + 1, d)).scatter(
        1, slot[..., None].expand(n, t * k, d), xt_rep)[:, :rows]
    send_eid = torch.zeros((n, rows + 1), dtype=torch.int32,
                           device=x.device).scatter(
        1, slot, (r.choice % e_loc).to(torch.int32))[:, :rows]
    send_valid = torch.zeros((n, rows + 1), dtype=torch.bool,
                             device=x.device).scatter(1, slot, r.keep)[:, :rows]

    def exchange(v):
        """all_to_all over the EP axes of every shard's [n_shards, cap,
        ...] buffer."""
        shaped = v.reshape((n, n_shards, r.cap) + tuple(v.shape[2:]))
        (out,) = sm.all_to_all((shaped,), ep, 0, 0, dim=0)
        return out.reshape(v.shape)

    recv_x, recv_eid, recv_valid = (exchange(send_x), exchange(send_eid),
                                    exchange(send_valid))
    first = torch.as_tensor(_group_index(mesh, ep) * e_loc, device=x.device)
    ys = _local_expert_block(cfg, recv_x, recv_eid, recv_valid, p.get("wg"),
                             p["wu"], p["wd"], first)
    ys = torch.where(recv_valid[..., None], ys, 0.0)
    back = exchange(ys)

    contrib = torch.gather(
        torch.cat([back, back.new_zeros((n, 1, d))], dim=1), 1,
        torch.clamp(slot, max=rows)[..., None].expand(n, t * k, d))
    contrib = contrib.float() * (r.gate * r.keep)[..., None]
    contrib = contrib.reshape(n, t, k, d)
    out = torch.zeros((n, t, d), dtype=torch.float32, device=x.device)
    for j in range(k):          # flat (token, choice) order
        out = out + contrib[:, :, j]
    routed = layout.join(out.reshape(n, bl, sl, d).to(x.dtype))

    if cfg.n_shared_experts:
        sh = dict(wu=p["shared_wu"], wd=p["shared_wd"])
        if cfg.gated_ffn:
            sh["wg"] = p["shared_wg"]
        routed = routed + ffn_forward(cfg, sh, x)
    return routed
