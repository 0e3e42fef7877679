"""Expert-parallel MoE: route, all-to-all dispatch, local experts, all-to-all
back, combine (reference: ``repro/models/moe_ep.py``, GShard-style).

The reference runs the routed-expert block under ``shard_map``: each device
routes its own tokens (top-k over sigmoid router scores), packs each
token-choice into the send buffer of the shard that owns the expert at a
static capacity (overflowing choices are dropped), exchanges the buffers
with an all-to-all over the expert-parallel axes, runs its E/n experts with
``ragged_dot``, sends the results back and combines them weighted by the
gates.  The shared experts stay on the dense path.

The port keeps the mesh's shards in device groups (``core/mesh.ShardMesh``:
G contiguous groups of the flat shard axis, group g on ``mesh.devices[g]``;
a tensor axis within a group).  ``moe_forward_ep`` cuts ``x`` into the
blocks ``shard_map`` hands each device (``TokenLayout``, the reference's
``x_spec``) and splits them into the groups.  The router's logits are one
product over every shard's tokens on ``mesh.device`` (the router is
replicated, and one product keeps its gradient one sum, bit for bit with
one group).  ``ep_groups`` then has each group route, pack its send
buffers and run its experts on its own card, in a Python loop that only
enqueues work; the buffers go through ``ShardMesh.all_to_all`` over the EP
axes (whose gradient is again an all-to-all across the groups), and the
combined output is joined back on ``mesh.device``.  The partitioned step
(``models/partitioned.py``) calls ``ep_groups`` with each shard's own
tokens and router logits.  Group g reads only the experts its shards own,
``expert_spans(mesh, E)[g]``: the routed-expert weights are either whole on
``mesh.device`` (a group then takes its slice) or, as
``launch/sharding.place_params`` holds them, each shard's block of the
reference's ``P(ep, None, None)`` stacked per group on its card.
The capacity drop keeps the reference's rows: a choice's rank among the
choices bound for its shard comes from a stable sort of the destinations
and a running max of the run starts, and the combine sums each token's
choices in flat (token, choice) order, as ``out.at[flat_tok].add`` does.
Every step is per shard or exact, so any grouping gives the bits of one
group.

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
from .layers import act_fn, ffn_forward, grouped_matmul, sigmoid, top_k

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
    return _route_logits(cfg, _logits(x_loc, router), n_shards, e_loc)


def _logits(x_loc: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ntd,de->nte", x_loc.float(), router.float())


def _route_logits(cfg: ArchConfig, logits: torch.Tensor, n_shards: int,
                  e_loc: int) -> Routing:
    """``route`` from the router's logits [N, t, E]."""
    n, t, _ = logits.shape
    k = cfg.experts_per_token
    cap = max(int(t * k * CAPACITY_FACTOR) // n_shards, 8)
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
    ar = torch.arange(tk, device=logits.device).expand(n, tk)
    rank_sorted = ar - torch.cummax(torch.where(starts, ar, 0), dim=1).values
    rank = torch.zeros_like(ar).scatter(1, order, rank_sorted)
    keep = rank < cap                                  # capacity drop
    slot = torch.where(keep, dest * cap + rank, n_shards * cap)
    return Routing(flat_choice, gates.reshape(n, tk), keep, slot, cap)


def _expert_order(recv_eid, recv_valid, first, e: int):
    """Each received row's expert within the group's ``e`` experts (its
    shard's block starts at ``first[n]``), invalid rows in a pad group past
    the last; the stable order that sorts the rows by it, and the rows of
    each expert as a device tensor (None for ``meta`` tensors)."""
    eid = torch.where(recv_valid, recv_eid.long() + first[:, None], e)
    eid = eid.reshape(-1)
    order = torch.argsort(eid, stable=True)
    counts = None if eid.is_meta else torch.bincount(eid, minlength=e)[:e]
    return order, counts


def _local_expert_block(cfg: ArchConfig, recv_x, order, sizes, wg, wu, wd):
    """One group's experts on the rows its shards received, at once.
    recv_x: [N, R, D]; ``order`` sorts its rows by expert, ``sizes`` the
    rows of each of the group's experts (host ints; None on ``meta``), the
    weights the group's own [E_g, ...].  Rows past the experts (the pad
    group) come out zero."""
    n, r, d = recv_x.shape
    xs = recv_x.reshape(n * r, d)[order]
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
    ``ShardMesh`` (its first group on ``x``'s device), else one of its
    shape on ``x``'s device (``meta`` under the dry run)."""
    if isinstance(mesh, ShardMesh):
        if mesh.device != x.device:
            raise ValueError(f"EP mesh on {mesh.device}, tokens on "
                             f"{x.device}")
        return mesh
    sizes = axis_sizes(mesh)
    shape = [sizes[a] for a in mesh.axis_names]
    if x.is_meta:
        return ShardMesh.meta(shape, mesh.axis_names)
    return ShardMesh(shape, mesh.axis_names, device=x.device)


def _ep(mesh, n_experts: int) -> Tuple[Tuple[str, ...], int, int]:
    """The EP axes moe_forward_ep takes, the EP shard count and the
    experts a shard."""
    ep = ep_axes(mesh, n_experts) or (_TP_AXIS,)
    n_shards = math.prod(axis_sizes(mesh)[a] for a in ep)
    return ep, n_shards, n_experts // n_shards


def expert_spans(mesh: ShardMesh, n_experts: int):
    """The experts ``[lo, hi)`` each device group of ``mesh`` reads: from
    the first to the last expert its shards own."""
    ep, _, e_loc = _ep(mesh, n_experts)
    idx = _group_index(mesh, ep)
    spans = []
    for g in range(mesh.n_groups):
        own = idx[list(mesh.shards(g))]
        spans.append((int(own.min()) * e_loc, (int(own.max()) + 1) * e_loc))
    return spans


def _group_weight(w, g: int, span, dev: torch.device, own, e_loc: int
                  ) -> torch.Tensor:
    """Group ``g``'s experts of a routed-expert leaf: from a placed leaf
    (``launch/sharding.place_params``: a tuple of G ``[per_group, e_loc,
    ...]`` blocks of the EP rule) the blocks of its shards, the first shard
    of each expert block its span holds (``own``: each of the group's
    shards' EP index; no copy where they are the span in order), else its
    span of the whole leaf on ``dev``."""
    if isinstance(w, (tuple, list)):
        blk = w[g]
        own = list(own)
        rows = [own.index(j) for j in range(span[0] // e_loc,
                                             span[1] // e_loc)]
        if blk.device != dev or blk.shape[1] != e_loc:
            raise ValueError(f"placed expert blocks of shape "
                             f"{tuple(blk.shape)} on {blk.device} are not "
                             f"group {g}'s blocks of {e_loc} experts on "
                             f"{dev}")
        if rows != list(range(blk.shape[0])):
            blk = blk[rows]
        return blk.flatten(0, 1)
    if span != (0, w.shape[0]):
        w = w[span[0]:span[1]]
    return w.to(dev)


def route_groups(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """The EP mesh's routing of ``x`` [B, S, D], one ``Routing`` a device
    group (each on its group's device), as ``moe_forward_ep`` routes it."""
    sm = _shard_mesh(_EP_MESH, x)
    _, n_shards, e_loc = _ep(_EP_MESH, cfg.n_experts)
    layout = TokenLayout.of(_EP_MESH, *x.shape[:2], _DP_AXES, _TP_AXIS)
    x_st = layout.split(x)
    x_loc = x_st.reshape(x_st.shape[0], -1, x.shape[-1])
    return _routes(cfg, sm, x_loc, p["router"], n_shards, e_loc)


def _routes(cfg, sm: ShardMesh, x_loc, router, n_shards, e_loc):
    logits = sm.split(_logits(x_loc, router))
    return [_route_logits(cfg, lg, n_shards, e_loc) for lg in logits]


def moe_forward_ep(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``layers.moe_forward`` when an EP mesh is set: the routed experts
    run expert-parallel over the EP axes, each device group of the mesh on
    its own card, the shared experts on the dense path.  x: [B, S, D] on
    the mesh's first device."""
    mesh, dp, tp = _EP_MESH, _DP_AXES, _TP_AXIS
    sm = _shard_mesh(mesh, x)
    _, n_shards, e_loc = _ep(mesh, cfg.n_experts)
    b, s, d = x.shape
    layout = TokenLayout.of(mesh, b, s, dp, tp)
    x_st = layout.split(x)
    n, bl, sl, _ = x_st.shape
    x_loc = x_st.reshape(n, bl * sl, d)
    logits = sm.split(_logits(x_loc, p["router"]))
    outs = ep_groups(cfg, sm, sm.split(x_loc), logits, p)
    routed = layout.join(sm.join(tuple(
        o.reshape(o.shape[0], bl, sl, d).to(x.dtype) for o in outs)))

    if cfg.n_shared_experts:
        sh = dict(wu=p["shared_wu"], wd=p["shared_wd"])
        if cfg.gated_ffn:
            sh["wg"] = p["shared_wg"]
        routed = routed + ffn_forward(cfg, sh, x)
    return routed


def ep_groups(cfg: ArchConfig, sm: ShardMesh, xs, logits, p: dict):
    """The routed-expert block on every shard's tokens, group by group:
    ``xs`` [per_group, t, D] and the router's ``logits`` [per_group, t, E]
    of each group, on its device.  Each shard routes its tokens, packs its
    send buffers, exchanges them over the EP axes, runs its experts (the
    routed-expert leaves of ``p``, whole or placed) and combines what comes
    back.  Returns each group's float32 output [per_group, t, D]."""
    ep, n_shards, e_loc = _ep(_EP_MESH, cfg.n_experts)
    routes = [_route_logits(cfg, lg, n_shards, e_loc) for lg in logits]
    t, d = xs[0].shape[1], xs[0].shape[2]
    k = cfg.experts_per_token
    cap = routes[0].cap
    rows = n_shards * cap
    pg = sm.per_group
    spans = expert_spans(sm, cfg.n_experts)
    index = _group_index(_EP_MESH, ep)

    # pack: each kept choice's token row into its destination's buffer
    # (a broadcast then a scatter to distinct rows: no backward adds into
    # one row from many; dropped choices all land in one extra row)
    send_x, send_eid, send_valid = [], [], []
    for xg, r in zip(xs, routes):
        dev = xg.device
        xt_rep = xg[:, :, None, :].expand(pg, t, k, d).reshape(pg, t * k, d)
        send_x.append(xg.new_zeros((pg, rows + 1, d)).scatter(
            1, r.slot[..., None].expand(pg, t * k, d), xt_rep)[:, :rows])
        send_eid.append(torch.zeros((pg, rows + 1), dtype=torch.int32,
                                    device=dev).scatter(
            1, r.slot, (r.choice % e_loc).to(torch.int32))[:, :rows])
        send_valid.append(torch.zeros((pg, rows + 1), dtype=torch.bool,
                                      device=dev).scatter(
            1, r.slot, r.keep)[:, :rows])

    def exchange(vs):
        """all_to_all over the EP axes of every shard's [n_shards, cap,
        ...] buffer, group by group."""
        shaped = sm.all_to_all(tuple(
            v.reshape((pg, n_shards, cap) + tuple(v.shape[2:])) for v in vs),
            ep, 0, 0, dim=0)
        return [o.reshape(v.shape) for o, v in zip(shaped, vs)]

    recv_x, recv_eid, recv_valid = (exchange(send_x), exchange(send_eid),
                                    exchange(send_valid))
    # every group's expert order and counts are enqueued before any group's
    # counts are read back
    orders = []
    for g, dev in enumerate(sm.devices):
        lo, hi = spans[g]
        first = torch.as_tensor(index[list(sm.shards(g))] * e_loc - lo,
                                device=dev)
        orders.append(_expert_order(recv_eid[g], recv_valid[g], first,
                                    hi - lo))
    ys = []
    for g, dev in enumerate(sm.devices):
        order, counts = orders[g]
        own = index[list(sm.shards(g))]
        w = [None if p.get(name) is None else
             _group_weight(p[name], g, spans[g], dev, own, e_loc)
             for name in ("wg", "wu", "wd")]
        y = _local_expert_block(cfg, recv_x[g], order,
                                None if counts is None else counts.tolist(),
                                *w)
        ys.append(torch.where(recv_valid[g][..., None], y, 0.0))
    back = exchange(ys)

    outs = []
    for bg, r in zip(back, routes):
        contrib = torch.gather(
            torch.cat([bg, bg.new_zeros((pg, 1, d))], dim=1), 1,
            torch.clamp(r.slot, max=rows)[..., None].expand(pg, t * k, d))
        contrib = contrib.float() * (r.gate * r.keep)[..., None]
        contrib = contrib.reshape(pg, t, k, d)
        out = torch.zeros((pg, t, d), dtype=torch.float32, device=bg.device)
        for j in range(k):          # flat (token, choice) order
            out = out + contrib[:, :, j]
        outs.append(out)
    return outs
