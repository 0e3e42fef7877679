"""A device mesh of shards on one card, and the collectives over it.

Reference: ``jax.make_mesh((8,), ("dev",))`` / ``jax.make_mesh((2, 4),
("socket", "core"))`` and the ``jax.lax`` collectives that the sharded
driver's ``shard_map`` body calls (``repro/core/sharded_stream.py``).

The port keeps every shard on one device, with the shards as a **tensor
axis**: a stacked tensor holds one shard's value per index of a flat shard
axis of ``mesh.size`` entries, in row-major order over the mesh axes (shard
``(s, c)`` of a ``(socket, core)`` mesh is index ``s * n_core + c``).  The
collectives take that tensor and the position ``dim`` of its shard axis;
every other axis number is the one a shard's own array would have, as in
JAX, so the driver's body reads like the reference's.  A collective returns
the stacked result of every shard at once.

Every exchange of the sharded driver goes through these four functions, so a
transport across cards (``torch.distributed``) replaces only this module.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

from ..kernels.runtime import resolve_device

Axes = Union[str, Sequence[str]]


class ShardMesh:
    """Named mesh axes over stacked shards on ``device`` (None: the card)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} must match and be non-empty")
        if min(self.shape) < 1 or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"bad mesh {self.shape} {self.axis_names}")
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    # -- layout helpers ----------------------------------------------------
    def _axes(self, axes: Axes) -> Tuple[int, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = tuple(self.axis_names.index(a) for a in names)
        if list(idx) != sorted(set(idx)):
            raise ValueError(f"axes {names} must be distinct and in mesh "
                             f"order {self.axis_names}")
        return idx

    def _unflatten(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if x.shape[dim] != self.size:
            raise ValueError(f"shard axis {dim} of shape {tuple(x.shape)} "
                             f"is not the mesh size {self.size}")
        return x.unflatten(dim, self.shape)

    def _local(self, ax: int, dim: int) -> int:
        """Position, in the unflattened tensor, of a shard's own axis."""
        return ax if ax < dim else ax + len(self.shape)

    # -- collectives ---------------------------------------------------------
    def all_to_all(self, x: torch.Tensor, axes: Axes, split_axis: int,
                   concat_axis: int, *, dim: int) -> torch.Tensor:
        """``jax.lax.all_to_all`` over ``axes``: shard d's chunk g of its
        ``split_axis`` goes to shard g of d's group, which stores it as
        chunk d.  The group's shards are numbered row-major over ``axes``;
        shards that differ on another mesh axis do not exchange.  Only
        ``split_axis == concat_axis`` is taken (all the driver needs): the
        exchange is then a transpose of the group's mesh axes with the
        split axis."""
        if split_axis != concat_axis:
            raise ValueError("all_to_all takes split_axis == concat_axis")
        group = self._axes(axes)
        sizes = [self.shape[i] for i in group]
        xu = self._unflatten(x, dim)
        b = self._local(split_axis, dim)
        if xu.shape[b] != math.prod(sizes):
            raise ValueError(f"split axis of size {xu.shape[b]} is not the "
                             f"group size {math.prod(sizes)}")
        xu = xu.unflatten(b, sizes)
        shift = len(sizes) - 1 if b < dim else 0
        for j, m in enumerate(group):
            xu = xu.transpose(dim + shift + m, b + j)
        xu = xu.flatten(b, b + len(sizes) - 1)
        return xu.flatten(dim, dim + len(self.shape) - 1).contiguous()

    def all_gather(self, x: torch.Tensor, axis: str, gather_axis: int, *,
                   dim: int) -> torch.Tensor:
        """``jax.lax.all_gather(x, axis, axis=gather_axis)`` (not tiled):
        each shard gets a new axis at ``gather_axis`` holding the values of
        every shard along ``axis`` that agrees with it on the other axes."""
        (m,) = self._axes(axis)
        k = len(self.shape)
        xu = self._unflatten(x, dim)
        g = xu.movedim(dim + m, -1)                      # gathered axis last
        g = g.unsqueeze(dim + m).expand(
            g.shape[:dim + m] + (self.shape[m],) + g.shape[dim + m:])
        pos = gather_axis if gather_axis < dim else gather_axis + k
        g = g.movedim(-1, pos)
        start = dim + 1 if gather_axis < dim else dim
        return g.flatten(start, start + k - 1).contiguous()

    def psum(self, x: torch.Tensor, axes: Axes, *, dim: int) -> torch.Tensor:
        """``jax.lax.psum`` over ``axes``: every shard gets its group's sum."""
        return self._reduce(x, axes, dim, torch.sum)

    def pmax(self, x: torch.Tensor, axes: Axes, *, dim: int) -> torch.Tensor:
        """``jax.lax.pmax`` over ``axes``: every shard gets its group's max.
        With every value but one owner's masked to -inf it is the sharded
        driver's ownership-masked select (exact, unlike a sum of deltas)."""
        return self._reduce(x, axes, dim, torch.amax)

    def _reduce(self, x, axes, dim, op):
        xu = self._unflatten(x, dim)
        pos = [dim + m for m in self._axes(axes)]
        r = op(xu, dim=pos, keepdim=True).expand(xu.shape)
        return r.flatten(dim, dim + len(self.shape) - 1).contiguous()
