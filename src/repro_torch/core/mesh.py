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

Every exchange of the sharded driver goes through these five functions, so a
transport across cards (``torch.distributed``) replaces only this module.
Under a program trace (``launch/hlo_analysis.ProgramTrace``) each call
counts once, as the collective it stands for (all-to-all, all-gather or
all-reduce) over its group, with one shard's result bytes; the tensor ops
that carry it out on one device are not recorded.  ``all_to_all`` is its
own inverse, so its gradient is an ``all_to_all`` of the output's
gradient: a traced backward pass counts its exchanges too.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch

from ..kernels.runtime import active_trace, resolve_device

Axes = Union[str, Sequence[str]]


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``ShardMesh`` (a shape tuple) and for a
    mesh whose ``shape`` is already that dict (``launch.mesh.MeshSpec``, a
    JAX mesh)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.axis_names, mesh.shape))


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

    @classmethod
    def meta(cls, shape: Sequence[int], axis_names: Sequence[str]
             ) -> "ShardMesh":
        """A mesh over shape-only ``meta`` tensors, for the dry run
        (``launch/dryrun.py``).  No entry point takes the meta device: this
        is the only way to a mesh on it."""
        mesh = cls(shape, axis_names, device="cpu")
        mesh.device = torch.device("meta")
        return mesh

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

    def group_size(self, axes: Axes) -> int:
        """Shards in one group of ``axes``."""
        return math.prod(self.shape[i] for i in self._axes(axes))

    def _traced(self, kind: str, axes: Axes, fn):
        """Run ``fn()`` (one collective) and, under an active trace, record
        it in place of the tensor ops that carry it out."""
        trace = active_trace()
        if trace is None:
            return fn()
        with trace.opaque():
            out = fn()
        trace.collective(kind, out, self.size, self.group_size(axes))
        return out

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
        if torch.is_grad_enabled() and x.requires_grad:
            return _AllToAll.apply(self, x, axes, split_axis, dim)
        return self._traced("all-to-all", axes, lambda: self._all_to_all(
            x, axes, split_axis, dim))

    def _all_to_all(self, x, axes, split_axis, dim):
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
        return self._traced("all-gather", axis, lambda: self._all_gather(
            x, axis, gather_axis, dim))

    def _all_gather(self, x, axis, gather_axis, dim):
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

    def pmin(self, x: torch.Tensor, axes: Axes, *, dim: int) -> torch.Tensor:
        """``jax.lax.pmin`` over ``axes``: every shard gets its group's min
        (the sharded lockstep walk's level fixpoint)."""
        return self._reduce(x, axes, dim, torch.amin)

    def _reduce(self, x, axes, dim, op):
        return self._traced("all-reduce", axes, lambda: self._reduce_now(
            x, axes, dim, op))

    def _reduce_now(self, x, axes, dim, op):
        xu = self._unflatten(x, dim)
        pos = [dim + m for m in self._axes(axes)]
        r = op(xu, dim=pos, keepdim=True).expand(xu.shape)
        return r.flatten(dim, dim + len(self.shape) - 1).contiguous()


class _AllToAll(torch.autograd.Function):
    """``ShardMesh.all_to_all`` with its gradient: the exchange swaps chunk
    g of shard d with chunk d of shard g, so it is its own inverse."""

    @staticmethod
    def forward(ctx, mesh, x, axes, split_axis, dim):
        ctx.args = (mesh, axes, split_axis, dim)
        return mesh.all_to_all(x, axes, split_axis, split_axis, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes, split_axis, dim = ctx.args
        return (None, mesh.all_to_all(grad, axes, split_axis, split_axis,
                                      dim=dim), None, None, None)
