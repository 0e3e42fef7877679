"""The mesh's device groups (``core/mesh.ShardMesh(..., devices=...)``) on
the CPU.

A mesh cut into G device groups holds a value per shard as a tuple of G
stacked tensors.  Each of the five collectives, on meshes ``(8,)``,
``(2, 4)`` and ``(2, 2)`` with G in {1, 2, 4} groups (every group on
``"cpu"``: a device may repeat), must give bit for bit what the one-group
mesh gives on the stacked tensor: ``all_to_all`` and ``all_gather`` move
rows, ``pmax`` and ``pmin`` are exact, and ``psum`` reduces on the first
group's device in shard order, so it associates as the stack does.  The
one-group results are held to the collectives' definitions in
``tests/test_torch_sharded.py``.  A grouped collective also counts once
under a program trace, with the bytes of the one-group call, and
``all_to_all`` keeps its gradient.
"""
import itertools

import pytest
import torch

from repro_torch.core.mesh import ShardMesh, card_groups
from repro_torch.launch.hlo_analysis import ProgramTrace, analyze

MESHES = {"8": ((8,), ("dev",)), "2x4": ((2, 4), ("socket", "core")),
          "2x2": ((2, 2), ("socket", "core"))}
GROUPS = (1, 2, 4)


def _axes_sets(names):
    """Every non-empty subset of the mesh axes, in mesh order."""
    return [c for r in range(1, len(names) + 1)
            for c in itertools.combinations(names, r)]


def _meshes(key, g):
    shape, names = MESHES[key]
    return (ShardMesh(shape, names, device="cpu"),
            ShardMesh(shape, names, devices=["cpu"] * g))


def _data(shape, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-1000, 1000, shape, generator=gen, dtype=dtype)
    # magnitudes over many decades, so a sum's association shows
    return (torch.randn(shape, generator=gen)
            * 10.0 ** torch.randint(-6, 7, shape, generator=gen))


def _same(got, want, dim, what):
    """``got``, a tuple of group tensors, joined along the shard axis
    ``dim``, is ``want`` bit for bit."""
    assert isinstance(got, tuple), what
    assert all(t.is_contiguous() for t in got), what
    assert got[0].dtype == want.dtype, what
    assert torch.equal(torch.cat(got, dim=dim), want), what


CASES = [(k, g) for k in MESHES for g in GROUPS]
IDS = [f"{k}-G{g}" for k, g in CASES]


@pytest.mark.parametrize("key,g", CASES, ids=IDS)
@pytest.mark.parametrize("dim", [0, 1])
def test_all_to_all_grouped_is_the_stacked_one(key, g, dim):
    one, grouped = _meshes(key, g)
    for j, axes in enumerate(_axes_sets(one.axis_names)):
        c = one.group_size(axes)
        # split on the shard's first axis, before or after the shard axis
        shape = (one.size, c, 3) if dim == 0 else (c, one.size, 2, 3)
        split = 0
        x = _data(shape, seed=100 * g + 10 * dim + j)
        (want,) = one.all_to_all((x,), axes, split, split, dim=dim)
        got = grouped.all_to_all(grouped.split(x, dim), axes, split, split,
                                 dim=dim)
        _same(got, want, dim, f"all_to_all {axes}")
        assert [t.shape[dim] for t in got] == [grouped.per_group] * g


@pytest.mark.parametrize("key,g", CASES, ids=IDS)
@pytest.mark.parametrize("gather_axis", [0, 1, 2])
def test_all_gather_grouped_is_the_stacked_one(key, g, gather_axis):
    one, grouped = _meshes(key, g)
    x = _data((3, one.size, 4, 5), seed=7 * g + gather_axis)
    for axis in one.axis_names:
        (want,) = one.all_gather((x,), axis, gather_axis, dim=1)
        got = grouped.all_gather(grouped.split(x, 1), axis, gather_axis,
                                 dim=1)
        # the shard axis moves past a gathered axis inserted before it
        _same(got, want, 2 if gather_axis < 1 else 1,
              f"all_gather {axis} at {gather_axis}")


@pytest.mark.parametrize("key,g", CASES, ids=IDS)
@pytest.mark.parametrize("op", ["psum", "pmax", "pmin"])
def test_reductions_grouped_are_the_stacked_ones(key, g, op):
    one, grouped = _meshes(key, g)
    for dtype in (torch.float32, torch.int32):
        x = _data((3, one.size, 6), seed=11 * g, dtype=dtype)
        for axes in _axes_sets(one.axis_names):
            (want,) = getattr(one, op)((x,), axes, dim=1)
            got = getattr(grouped, op)(grouped.split(x, 1), axes, dim=1)
            _same(got, want, 1, f"{op} {axes} {dtype}")


def test_groups_and_their_layout():
    mesh = ShardMesh((2, 4), ("socket", "core"), devices=["cpu"] * 4)
    assert (mesh.n_groups, mesh.per_group, mesh.size) == (4, 2, 8)
    assert mesh.device == torch.device("cpu")
    assert [list(mesh.shards(g)) for g in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    x = torch.arange(8 * 3).reshape(8, 3)
    parts = mesh.split(x)
    assert [p.shape for p in parts] == [torch.Size([2, 3])] * 4
    assert torch.equal(mesh.join(parts), x)
    one = ShardMesh((2, 4), ("socket", "core"), device="cpu")
    assert (one.n_groups, one.per_group) == (1, 8)
    assert one.devices == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="divide"):
        ShardMesh((2, 4), ("socket", "core"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="not both"):
        ShardMesh((8,), ("dev",), device="cpu", devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="tuple of 4"):
        mesh.psum((x,), "core", dim=0)
    with pytest.raises(ValueError, match="group size"):
        mesh.psum(tuple(torch.zeros(3, 3) for _ in range(4)), "core", dim=0)
    # off CUDA a mesh's shards stay in one group on the device asked for
    assert card_groups(8, "cpu") == [torch.device("cpu")]


@pytest.mark.parametrize("g", [2, 4])
def test_grouped_collectives_trace_as_one(g):
    """Under a program trace a grouped collective counts once, with the
    bytes of the one-group call; the copies between groups are not
    recorded."""
    traces = []
    for mesh in _meshes("2x4", g):
        x = torch.randn(8, 8, 3)
        with ProgramTrace() as tr:
            mesh.all_to_all(mesh.split(x), ("socket", "core"), 0, 0, dim=0)
            mesh.all_gather(mesh.split(x), "core", 0, dim=0)
            mesh.psum(mesh.split(x), "socket", dim=0)
            mesh.pmax(mesh.split(x), ("socket", "core"), dim=0)
        traces.append(tr)
    one, grouped = (analyze(t, 8) for t in traces)
    assert grouped["coll_bytes"] == one["coll_bytes"]
    assert grouped["wire_bytes_per_device"] == one["wire_bytes_per_device"]
    assert [r.name for r in traces[1].ops if "all" in r.name] == [
        "all-to-all", "all-gather", "all-reduce", "all-reduce"]


@pytest.mark.parametrize("g", [2, 4])
def test_grouped_all_to_all_gradient(g):
    one, grouped = _meshes("2x4", g)
    w = torch.randn(8, 8, 3)
    grads = []
    for mesh in (one, grouped):
        x = torch.randn(8, 8, 3, generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        ys = mesh.all_to_all(mesh.split(x), ("socket", "core"), 0, 0, dim=0)
        (gx,) = torch.autograd.grad((mesh.join(ys) * w).sum(), [x])
        grads.append(gx)
    assert torch.equal(grads[0], grads[1])
    # the exchange is its own inverse: the gradient is the exchanged w
    (want,) = one.all_to_all((w,), ("socket", "core"), 0, 0, dim=0)
    assert torch.equal(grads[1], want)
