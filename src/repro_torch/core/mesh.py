"""A device mesh of shards, in groups on one or more cards, and the
collectives over it.

Reference: ``jax.make_mesh((8,), ("dev",))`` / ``jax.make_mesh((2, 4),
("socket", "core"))`` and the ``jax.lax`` collectives that the sharded
driver's ``shard_map`` body calls (``repro/core/sharded_stream.py``).

The shards of a mesh are numbered along a flat shard axis of ``mesh.size``
entries, in row-major order over the mesh axes (shard ``(s, c)`` of a
``(socket, core)`` mesh is index ``s * n_core + c``).  That axis is cut into
G contiguous **device groups** of ``mesh.size // G`` shards, and group g
lives on ``mesh.devices[g]``; a device may repeat.  Within a group the
shards are a **tensor axis**: a value per shard is a tuple of G stacked
tensors, group g's holding one entry per shard of the group.  With one
group (``device=``, G = 1) it is a one-tuple of the whole stack.

The collectives take such a tuple and the position ``dim`` of its shard
axis; every other axis number is the one a shard's own array would have,
as in JAX, so the driver's body reads like the reference's.  A collective
returns the result of every shard at once, as a tuple of the same groups.
With one group it runs as tensor ops on the stack.  Across groups every
collective joins the groups' operands onto the first device in shard order
by peer copies (``Tensor.to``, which PyTorch orders after the work queued
on both devices' current streams), runs there as the one-group stack does
(so a sum associates as it does with G = 1, bit for bit) and sends each
group its part.  No process group is involved: the reference's
``shard_map`` spans the devices of one process, and so does this mesh.
``card_groups`` places a mesh's shards on the visible cards.

Under a program trace (``launch/hlo_analysis.ProgramTrace``) each call
counts once, as the collective it stands for (all-to-all, all-gather,
reduce-scatter or all-reduce) over its group, with one shard's result
bytes; the tensor ops and copies that carry it out are not recorded.  The
collectives a program differentiates through carry their gradients:
``all_to_all`` is its own inverse, a (tiled) ``all_gather``'s gradient is
a ``reduce_scatter`` and the reverse, and ``psum``'s is a ``psum`` of the
results' gradients; a traced backward pass counts them too.  ``place``
and ``assemble`` cut a whole value into every shard's block under a
partition spec (the reference's ``PartitionSpec``, a tuple of axis names)
and put it back together.

**The one-shard form** (``ShardMesh.one_shard``, the dry run's): a mesh of
the production shape over ``meta`` tensors whose values hold shard 0 alone,
a one-tuple of ``[1, *block]`` stacks.  Blocks and group sizes come from the
mesh's shape as on any mesh, and each collective returns shard 0's result
shape (a tiled gather over g shards multiplies the gathered axis by g, a
reduce-scatter divides it by g; the reductions and ``all_to_all`` keep it),
recorded under a trace as on a mesh of every shard: one shard's program of
a mesh whose other shards run the same program on blocks of the same shapes.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch

from ..kernels.runtime import active_trace, resolve_device

Axes = Union[str, Sequence[str]]
Groups = Tuple[torch.Tensor, ...]


def spec_entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one entry of a partition spec (None, an axis name or
    a tuple of names)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``ShardMesh`` (a shape tuple) and for a
    mesh whose ``shape`` is already that dict (``launch.mesh.MeshSpec``, a
    JAX mesh)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.axis_names, mesh.shape))


def card_groups(n_shards: int, device) -> list:
    """The device of each group of ``n_shards`` shards spread over the
    visible cards: one group a card, as many groups as the largest G that
    is at most the card count and divides ``n_shards``, from ``device``'s
    card on (wrapping round); off CUDA, one group on ``device``."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    cards = torch.cuda.device_count()
    first = torch.cuda.current_device() if dev.index is None else dev.index
    g = max(k for k in range(1, min(cards, n_shards) + 1)
            if n_shards % k == 0)
    return [torch.device("cuda", (first + i) % cards) for i in range(g)]


class ShardMesh:
    """Named mesh axes over shards in device groups: ``devices`` (G
    devices, G dividing the mesh size) or ``device`` alone (one group; None:
    the card)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None, devices=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names) or not self.shape:
            raise ValueError(f"mesh shape {self.shape} and axis names "
                             f"{self.axis_names} must match and be non-empty")
        if min(self.shape) < 1 or len(set(self.axis_names)) != len(
                self.axis_names):
            raise ValueError(f"bad mesh {self.shape} {self.axis_names}")
        self.one_shard = False
        if devices is None:
            self.devices = (resolve_device(device),)
        else:
            if device is not None:
                raise ValueError("give device= or devices=, not both")
            self.devices = tuple(resolve_device(d) for d in devices)
            if not self.devices or self.size % len(self.devices):
                raise ValueError(f"{len(self.devices)} device groups do not "
                                 f"divide the mesh size {self.size}")

    @classmethod
    def meta(cls, shape: Sequence[int], axis_names: Sequence[str]
             ) -> "ShardMesh":
        """A mesh over shape-only ``meta`` tensors, for the dry run
        (``launch/dryrun.py``).  No entry point takes the meta device: this
        is the only way to a mesh on it."""
        mesh = cls(shape, axis_names, device="cpu")
        mesh.devices = (torch.device("meta"),)
        return mesh

    @classmethod
    def one_shard(cls, shape: Sequence[int], axis_names: Sequence[str]
                  ) -> "ShardMesh":
        """The one-shard form of a ``meta`` mesh of ``shape``: its values
        hold shard 0 alone (``held`` is 1), whose program the dry run traces
        as one device's of the whole mesh (module docstring)."""
        mesh = cls.meta(shape, axis_names)
        mesh.one_shard = True
        return mesh

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def device(self) -> torch.device:
        """The first group's device: where the driver keeps what is not
        per shard (canonical values, outputs)."""
        return self.devices[0]

    @property
    def n_groups(self) -> int:
        return len(self.devices)

    @property
    def held(self) -> int:
        """Shards whose values the mesh holds: every shard, or shard 0
        alone in the one-shard form."""
        return 1 if self.one_shard else self.size

    @property
    def per_group(self) -> int:
        """Shards in one device group."""
        return self.held // len(self.devices)

    def shards(self, g: int) -> range:
        """The flat shard indices of device group ``g``."""
        return range(g * self.per_group, (g + 1) * self.per_group)

    def split(self, x: torch.Tensor, dim: int = 0) -> Groups:
        """A stacked tensor of every shard (shard axis ``dim``, on any
        device) -> the per-group tuple on the groups' devices (with one
        group, the stack itself on ``device``)."""
        if len(self.devices) == 1:
            return (x.to(self.device).contiguous(),)
        return tuple(c.to(d).contiguous() for c, d in zip(
            x.split(self.per_group, dim=dim), self.devices))

    def join(self, xs: Groups, dim: int = 0) -> torch.Tensor:
        """The per-group tuple -> one stacked tensor on ``device`` (with
        one group, the group's own tensor: no copy)."""
        if len(xs) == 1:
            return xs[0].to(self.device)
        return torch.cat([x.to(self.device) for x in xs], dim=dim)

    def _stacked(self, xs: Groups, dim: int, fn, out_dim=None) -> Groups:
        """A collective's one-group form ``fn`` run on the joined stack and
        split back to the groups along its result's shard axis ``out_dim``
        (default ``dim``); with one group, on the stack itself."""
        if len(xs) == 1:
            return (fn(xs[0]),)
        return self.split(fn(self.join(xs, dim)),
                          dim if out_dim is None else out_dim)

    def _groups(self, xs, dim: int) -> Groups:
        if not isinstance(xs, (tuple, list)) or len(xs) != self.n_groups:
            raise ValueError(f"a collective takes a tuple of {self.n_groups} "
                             f"group tensors, got {type(xs).__name__}")
        for x in xs:
            if x.shape[dim] != self.per_group:
                raise ValueError(f"shard axis {dim} of shape "
                                 f"{tuple(x.shape)} is not the group size "
                                 f"{self.per_group}")
        return tuple(xs)

    # -- values cut by a partition spec ---------------------------------------
    def coords(self, s: int) -> Tuple[int, ...]:
        """Shard ``s``'s index on each mesh axis (row-major numbering)."""
        out = []
        for n in reversed(self.shape):
            out.append(s % n)
            s //= n
        return tuple(reversed(out))

    def _block(self, entry, s: int) -> Tuple[int, int]:
        """``(index, count)`` of shard ``s``'s block along a dim whose spec
        entry is ``entry`` (None, an axis name or a tuple of them)."""
        axes = spec_entry_axes(entry)
        c = self.coords(s)
        idx = 0
        for a in axes:
            m = self.axis_names.index(a)
            idx = idx * self.shape[m] + c[m]
        return idx, math.prod(self.shape[self.axis_names.index(a)]
                              for a in axes)

    def block_of(self, x: torch.Tensor, spec, s: int) -> torch.Tensor:
        """Shard ``s``'s block of the whole value ``x`` under ``spec`` (a
        view)."""
        for d, entry in enumerate(spec):
            i, n = self._block(entry, s)
            if n > 1:
                step = x.shape[d] // n
                x = x.narrow(d, i * step, step)
        return x

    def place(self, x: torch.Tensor, spec) -> Groups:
        """The whole value ``x`` cut by ``spec`` into every shard's block,
        stacked per group on the group's device: a tuple of G tensors
        ``[per_group, *block]`` (a shard of a replicated dim holds it
        whole)."""
        return tuple(torch.stack([self.block_of(x, spec, s)
                                  for s in self.shards(g)]).to(dev)
                     for g, dev in enumerate(self.devices))

    def first_replica(self, spec, s: int) -> bool:
        """Whether shard ``s`` is the first (lowest) of the shards that hold
        its block under ``spec``: its index is 0 on every axis ``spec``
        leaves out."""
        used = {a for e in spec for a in spec_entry_axes(e)}
        c = self.coords(s)
        return all(c[m] == 0 for m, a in enumerate(self.axis_names)
                   if a not in used)

    def assemble(self, xs: Groups, spec) -> torch.Tensor:
        """``place``'s inverse: the whole value on ``device``, each block
        from the first shard that holds it."""
        if self.one_shard:
            raise ValueError("the one-shard form holds one block: nothing "
                             "to assemble")
        stack = self.join(xs)
        blk = stack.shape[1:]
        shape = [n * self._block(e, 0)[1] for n, e in zip(
            blk, tuple(spec) + (None,) * (len(blk) - len(spec)))]
        out = stack.new_empty(shape)
        for s in range(self.size):
            if self.first_replica(spec, s):
                self.block_of(out, spec, s).copy_(stack[s])
        return out

    def psum_replicas(self, xs: Groups, spec) -> Groups:
        """A placed value summed over the mesh axes ``spec`` leaves out
        (its replicas), every replica then holding the sum: per-copy
        gradients of a replicated leaf into the leaf's one gradient."""
        used = {a for e in spec for a in spec_entry_axes(e)}
        rep = tuple(a for a in self.axis_names if a not in used)
        return self.psum(xs, rep, dim=0) if rep else xs

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
        trace.collective(kind, out, self.held, self.group_size(axes))
        return out

    def _shard0(self, kind: str, axes: Axes, xs: Groups, shape) -> Groups:
        """A collective in the one-shard form: shard 0's result, of
        ``shape`` (its stack's, the shard axis included)."""
        return self._traced(kind, axes, lambda: (xs[0].new_empty(shape),))

    @staticmethod
    def _at(axis: int, dim: int) -> int:
        """Position, in a stack whose shard axis is ``dim``, of a shard's
        own ``axis``."""
        return axis if axis < dim else axis + 1

    # -- collectives ---------------------------------------------------------
    def all_to_all(self, xs: Groups, axes: Axes, split_axis: int,
                   concat_axis: int, *, dim: int) -> Groups:
        """``jax.lax.all_to_all`` over ``axes``: shard d's chunk g of its
        ``split_axis`` goes to shard g of d's group, which stores it as
        chunk d.  The group's shards are numbered row-major over ``axes``;
        shards that differ on another mesh axis do not exchange.  Only
        ``split_axis == concat_axis`` is taken (all the driver needs): the
        exchange is then a transpose of the group's mesh axes with the
        split axis."""
        if split_axis != concat_axis:
            raise ValueError("all_to_all takes split_axis == concat_axis")
        xs = self._groups(xs, dim)
        if _needs_grad(xs):
            return _AllToAll.apply(self, axes, split_axis, dim, *xs)
        if self.one_shard:
            n = xs[0].shape[self._at(split_axis, dim)]
            if n != self.group_size(axes):
                raise ValueError(f"split axis of size {n} is not the group "
                                 f"size {self.group_size(axes)}")
            return self._shard0("all-to-all", axes, xs, xs[0].shape)
        return self._traced("all-to-all", axes, lambda: self._stacked(
            xs, dim, lambda x: self._all_to_all_stack(x, axes, split_axis,
                                                      dim)))

    def _all_to_all_stack(self, x, axes, split_axis, dim):
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

    def all_gather(self, xs: Groups, axis: Axes, gather_axis: int, *,
                   dim: int, tiled: bool = False) -> Groups:
        """``jax.lax.all_gather(x, axis, axis=gather_axis, tiled=tiled)``.
        Not tiled (one axis name): each shard gets a new axis at
        ``gather_axis`` holding the values of every shard along ``axis``
        that agrees with it on the other axes.  Tiled (``axis`` a name or a
        tuple in mesh order): those values are concatenated along the
        existing ``gather_axis``, row-major over the axes.  Its gradient is
        ``reduce_scatter``."""
        xs = self._groups(xs, dim)
        if _needs_grad(xs):
            return _AllGather.apply(self, axis, gather_axis, dim, tiled, *xs)
        if self.one_shard:
            shape, p = list(xs[0].shape), self._at(gather_axis, dim)
            g = self.group_size(axis)
            if tiled:
                shape[p] *= g
            else:
                shape.insert(p, g)
            return self._shard0("all-gather", axis, xs, shape)
        if tiled:
            fn = lambda x: self._gather_tiled_stack(x, axis, gather_axis,
                                                    dim)
            out_dim = dim
        else:
            fn = lambda x: self._all_gather_stack(x, axis, gather_axis, dim)
            out_dim = dim + 1 if gather_axis < dim else dim
        return self._traced("all-gather", axis, lambda: self._stacked(
            xs, dim, fn, out_dim=out_dim))

    def _all_gather_stack(self, x, axis, gather_axis, dim):
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

    def _gather_tiled_stack(self, x, axes, gather_axis, dim):
        idx = self._axes(axes)
        k = len(self.shape)
        xu = self._unflatten(x, dim)
        p = gather_axis if gather_axis < dim else gather_axis + k
        mesh_pos = [dim + m for m in idx]
        rest = [i for i in range(xu.dim()) if i not in mesh_pos]
        at = rest.index(p)
        g = xu.permute(rest[:at] + mesh_pos + rest[at:])
        g = g.flatten(at, at + len(idx))                 # the gathered axis
        for mp in mesh_pos:                              # ascending
            g = g.unsqueeze(mp)
        shape = list(g.shape)
        for m in idx:
            shape[dim + m] = self.shape[m]
        return g.expand(shape).flatten(dim, dim + k - 1).contiguous()

    def reduce_scatter(self, xs: Groups, axes: Axes, scatter_axis: int, *,
                       dim: int, tiled: bool = True) -> Groups:
        """``jax.lax.psum_scatter(x, axes, scatter_dimension=scatter_axis,
        tiled=tiled)``: every shard gets its own block, along
        ``scatter_axis``, of the sum over its group of ``axes`` (blocks in
        row-major order over the axes; not tiled, one axis name, the block
        axis is dropped).  The gradient of a tiled ``all_gather``, and its
        own gradient is that gather."""
        xs = self._groups(xs, dim)
        if _needs_grad(xs):
            return _ReduceScatter.apply(self, axes, scatter_axis, dim, tiled,
                                        *xs)
        if self.one_shard:
            shape, p = list(xs[0].shape), self._at(scatter_axis, dim)
            g = self.group_size(axes)
            if shape[p] % g or (not tiled and shape[p] != g):
                raise ValueError(f"scatter axis of size {shape[p]} does not "
                                 f"divide into {g} blocks")
            if tiled:
                shape[p] //= g
            else:
                del shape[p]
            return self._shard0("reduce-scatter", axes, xs, shape)
        out_dim = dim - 1 if not tiled and scatter_axis < dim else dim

        def fn(x):
            r = self._scatter_tiled_stack(x, axes, scatter_axis, dim)
            if tiled:
                return r
            return r.squeeze(scatter_axis if scatter_axis < dim
                             else scatter_axis + 1)

        return self._traced("reduce-scatter", axes, lambda: self._stacked(
            xs, dim, fn, out_dim=out_dim))

    def _scatter_tiled_stack(self, x, axes, scatter_axis, dim):
        idx = self._axes(axes)
        k = len(self.shape)
        xu = self._unflatten(x, dim)
        p = scatter_axis if scatter_axis < dim else scatter_axis + k
        mesh_pos = [dim + m for m in idx]
        sizes = [self.shape[m] for m in idx]
        if xu.shape[p] % math.prod(sizes):
            raise ValueError(f"scatter axis of size {xu.shape[p]} does not "
                             f"divide into {math.prod(sizes)} blocks")
        rest = [i for i in range(xu.dim()) if i not in mesh_pos]
        r = torch.sum(xu, dim=mesh_pos)                  # dims: ``rest``
        at = rest.index(p)
        r = r.unflatten(at, sizes + [xu.shape[p] // math.prod(sizes)])
        # each axis of the block grid takes the place of its mesh axis
        label = rest[:at] + mesh_pos + [p] + rest[at + 1:]
        r = r.permute(sorted(range(len(label)), key=label.__getitem__))
        return r.flatten(dim, dim + k - 1).contiguous()

    def psum(self, xs: Groups, axes: Axes, *, dim: int) -> Groups:
        """``jax.lax.psum`` over ``axes``: every shard gets its group's sum.
        Its gradient is the psum of the results' gradients."""
        xs = self._groups(xs, dim)
        if _needs_grad(xs):
            return _PSum.apply(self, axes, dim, *xs)
        return self._reduce(xs, axes, dim, torch.sum)

    def pmax(self, xs: Groups, axes: Axes, *, dim: int) -> Groups:
        """``jax.lax.pmax`` over ``axes``: every shard gets its group's max.
        With every value but one owner's masked to -inf it is the sharded
        driver's ownership-masked select (exact, unlike a sum of deltas)."""
        return self._reduce(xs, axes, dim, torch.amax)

    def pmin(self, xs: Groups, axes: Axes, *, dim: int) -> Groups:
        """``jax.lax.pmin`` over ``axes``: every shard gets its group's min
        (the sharded lockstep walk's level fixpoint)."""
        return self._reduce(xs, axes, dim, torch.amin)

    def _reduce(self, xs, axes, dim, op):
        xs = self._groups(xs, dim)
        if self.one_shard:
            return self._shard0("all-reduce", axes, xs, xs[0].shape)
        return self._traced("all-reduce", axes, lambda: self._stacked(
            xs, dim, lambda x: self._reduce_stack(x, axes, dim, op)))

    def _reduce_stack(self, x, axes, dim, op):
        xu = self._unflatten(x, dim)
        pos = [dim + m for m in self._axes(axes)]
        r = op(xu, dim=pos, keepdim=True).expand(xu.shape)
        return r.flatten(dim, dim + len(self.shape) - 1).contiguous()


class _AllToAll(torch.autograd.Function):
    """``ShardMesh.all_to_all`` with its gradient: the exchange swaps chunk
    g of shard d with chunk d of shard g, so it is its own inverse."""

    @staticmethod
    def forward(ctx, mesh, axes, split_axis, dim, *xs):
        ctx.args = (mesh, axes, split_axis, dim)
        return mesh.all_to_all(xs, axes, split_axis, split_axis, dim=dim)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes, split_axis, dim = ctx.args
        return (None, None, None, None) + tuple(mesh.all_to_all(
            grads, axes, split_axis, split_axis, dim=dim))


def _needs_grad(xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class _AllGather(torch.autograd.Function):
    """``ShardMesh.all_gather`` with its gradient, a ``reduce_scatter`` of
    the results' gradients over the same axes."""

    @staticmethod
    def forward(ctx, mesh, axes, gather_axis, dim, tiled, *xs):
        ctx.args = (mesh, axes, gather_axis, dim, tiled)
        return mesh.all_gather(xs, axes, gather_axis, dim=dim, tiled=tiled)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes, gather_axis, dim, tiled = ctx.args
        out_dim = dim + 1 if not tiled and gather_axis < dim else dim
        return (None,) * 5 + tuple(mesh.reduce_scatter(
            grads, axes, gather_axis, dim=out_dim, tiled=tiled))


class _ReduceScatter(torch.autograd.Function):
    """``ShardMesh.reduce_scatter`` with its gradient, the gather."""

    @staticmethod
    def forward(ctx, mesh, axes, scatter_axis, dim, tiled, *xs):
        ctx.args = (mesh, axes, scatter_axis, dim, tiled)
        return mesh.reduce_scatter(xs, axes, scatter_axis, dim=dim,
                                   tiled=tiled)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes, scatter_axis, dim, tiled = ctx.args
        out_dim = dim - 1 if not tiled and scatter_axis < dim else dim
        return (None,) * 5 + tuple(mesh.all_gather(
            grads, axes, scatter_axis, dim=out_dim, tiled=tiled))


class _PSum(torch.autograd.Function):
    """``ShardMesh.psum`` with its gradient: every input reaches every
    result of its group, so its gradient is the psum of theirs."""

    @staticmethod
    def forward(ctx, mesh, axes, dim, *xs):
        ctx.args = (mesh, axes, dim)
        return mesh.psum(xs, axes, dim=dim)

    @staticmethod
    def backward(ctx, *grads):
        mesh, axes, dim = ctx.args
        return (None,) * 3 + tuple(mesh.psum(grads, axes, dim=dim))
