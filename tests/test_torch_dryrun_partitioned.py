"""The dry run's partitioned trace (``repro_torch/launch/dryrun.py``): one
shard's program of ``models/partitioned.Partitioned`` on the one-shard form
of a mesh (``core/mesh.ShardMesh.one_shard``), held against what it stands
for.

* **The one-shard form's collectives** against a ``ShardMesh.meta`` mesh of
  every shard: each returns shard 0's result shape and records the same
  (kind, shard bytes, group), the autograd forms too; a trace records a
  collective on a thread that inherits its dispatch mode but not the
  thread-local (the autograd engine's thread of a card).
* **The one-shard trace against a full trace**: for the ten archs' smoke
  configs x train / prefill / decode (an encoder has no decode), batch 8 x
  sequence 16, on a (data 2, model 2) and a (pod 2, data 2, model 2) mesh,
  the step traced on the one-shard form (built on a ``MeshSpec``, as the
  dry run builds it) against the same step on a ``ShardMesh.meta`` mesh of
  every shard: the collective records equal as multisets and the dot FLOPs
  equal the full trace's over the shard count, exactly.  Bytes written
  agree within ``BYTES_TOL`` of the full trace's mean a shard, by field:
  the train step's global norm counts each block on its first replica, and
  shard 0 is the first of every block, so it writes the most (dense archs
  0.02-0.19% above the mean); a full trace of an MoE arch also copies each
  layer's stacked expert blocks where a group holds more than one shard,
  which one shard's program does not (up to 19% below the mean).
* **FSDP gathers against the specs**: the all-gather bytes over the data
  axes of a train step equal, exactly, a count from ``param_specs`` alone:
  each leaf the specs shard over the data axes, its bytes over its
  ``model`` split, times the step gathers it (a layer's leaves in the
  forward and again in the backward's recompute under remat "full"; the
  hybrid stack's shared attention in each group; the embedding and head
  again for MTP).
* **Shard 0's placed inputs** (params, AdamW state and batch; params,
  batch; params, cache, tokens and the position) for every cell the
  reference runs, on the single- and the multi-pod production mesh: their
  bytes equal ``dryrun.argument_bytes`` and the reference's count from its
  own specs (``tests/torch_dryrun.reference_argument_bytes``).
"""
import collections
import threading

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh, axis_sizes, spec_entry_axes
from repro_torch.kernels.runtime import set_active_trace
from repro_torch.launch.dryrun import argument_bytes, place_inputs
from repro_torch.launch.hlo_analysis import ProgramTrace, analyze
from repro_torch.launch.mesh import (MeshSpec, dp_axes,
                                     make_production_mesh)
from repro_torch.launch.steps import build_step
from repro_torch.models import (SHAPE_BY_NAME, ShapeCfg, cell_is_applicable,
                                moe_ep)
from repro_torch.models.model import layer_plan

from torch_dryrun import ARCHS, CELLS, reference_argument_bytes, traced

B, S = 8, 16
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# bytes written by the one-shard trace against the full trace's mean a
# shard (module docstring)
BYTES_TOL = {"dense": 5e-3, "moe": 0.2}


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


# -- the one-shard form's collectives -----------------------------------------
def _collectives(mesh, x):
    """Every collective on a stacked value ``x`` [held, 4, 6] (the shards'
    own arrays [4, 6]): (name, result)."""
    xs = (x,)
    return [
        ("gather tiled", mesh.all_gather(xs, ("data", "model"), 1, dim=0,
                                         tiled=True)),
        ("gather", mesh.all_gather(xs, "data", 0, dim=0)),
        ("scatter tiled", mesh.reduce_scatter(xs, "model", 0, dim=0)),
        ("scatter", mesh.reduce_scatter(
            mesh.all_gather(xs, "model", 1, dim=0), "model", 1, dim=0,
            tiled=False)),
        ("psum", mesh.psum(xs, ("data",), dim=0)),
        ("pmax", mesh.pmax(xs, "model", dim=0)),
        ("all_to_all", mesh.all_to_all(xs, ("data", "model"), 0, 0,
                                       dim=0))]


@pytest.mark.parametrize("grad", [False, True], ids=["plain", "autograd"])
def test_one_shard_collectives_give_shard_zeros_shapes(grad):
    full = ShardMesh.meta((2, 2), ("data", "model"))
    one = ShardMesh.one_shard((2, 2), ("data", "model"))
    assert (one.size, one.held, one.per_group, one.shape) == (4, 1, 1,
                                                              (2, 2))
    assert list(one.shards(0)) == [0]
    runs = {}
    for name, mesh in (("full", full), ("one", one)):
        x = torch.empty((mesh.held, 4, 6), device="meta",
                        requires_grad=grad)
        with ProgramTrace() as trace:
            outs = _collectives(mesh, x)
            if grad:
                loss = sum(o[0].sum() for _, o in outs)
                (g,) = torch.autograd.grad(loss, x)
                assert g.shape == x.shape
        runs[name] = (outs, trace.collectives)
    for (n, a), (_, b) in zip(runs["full"][0], runs["one"][0]):
        assert a[0].shape[1:] == b[0].shape[1:] and b[0].shape[0] == 1, n
    assert collections.Counter(runs["full"][1]) == collections.Counter(
        runs["one"][1])
    # pmax has no gradient form: the other six backward collectives
    assert len(runs["one"][1]) == (15 if grad else 8)


def test_one_shard_checks_the_shard_axis_and_assembles_nothing():
    one = ShardMesh.one_shard((2, 2), ("data", "model"))
    x = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="group size 1"):
        one.psum((x,), "data", dim=0)
    with pytest.raises(ValueError, match="divide"):
        one.reduce_scatter((torch.empty((1, 3), device="meta"),), "model",
                           0, dim=0)
    with pytest.raises(ValueError, match="not the group size"):
        one.all_to_all((torch.empty((1, 3), device="meta"),), "model", 0, 0,
                       dim=0)
    with pytest.raises(ValueError, match="nothing to assemble"):
        one.assemble((torch.empty((1, 3), device="meta"),), (None,))


def test_collective_recorded_on_a_thread_with_the_mode_alone():
    """The autograd engine runs a card's backward on its own thread, which
    inherits the trace's dispatch mode and not the thread-local: the
    collective is found through the mode."""
    mesh = ShardMesh.one_shard((2, 2), ("data", "model"))
    x = torch.empty((1, 4), device="meta")
    with ProgramTrace() as trace:
        set_active_trace(None)                   # as on such a thread
        try:
            mesh.psum((x,), "data", dim=0)
        finally:
            set_active_trace(trace)
    assert trace.collectives == [("all-reduce", 16.0, 2)]
    assert [r.name for r in trace.ops] == ["all-reduce"]


def test_opaque_is_per_thread():
    """A collective on one thread hides its own ops, not another thread's."""
    trace = ProgramTrace()
    seen = []
    with trace.opaque():
        t = threading.Thread(target=lambda: seen.append(
            getattr(trace._opaque, "depth", 0)))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and trace._opaque.depth == 1
    assert seen == [0] and trace._opaque.depth == 0


# -- the one-shard trace against a full trace ---------------------------------
CASES = [(a, k, m) for a in ARCHS for k in ("train", "prefill", "decode")
         for m in MESHES
         if not (k == "decode" and get_arch(a).encoder_only)]


@pytest.mark.parametrize("arch,kind,mesh", CASES)
def test_one_shard_trace_matches_every_shard(arch, kind, mesh):
    shp, names = MESHES[mesh]
    cfg = get_arch(arch).smoke()
    shape = ShapeCfg("t", S, B, kind)
    full, fplan = traced(cfg, shape, ShardMesh.meta(shp, names))
    one, oplan = traced(cfg, shape, MeshSpec(dict(zip(names, shp))))
    assert oplan.mesh.one_shard and oplan.mesh.shape == shp
    n = fplan.mesh.size
    assert collections.Counter(one.collectives) == collections.Counter(
        full.collectives)
    got, want = analyze(one), analyze(full)
    assert got["dot_flops"] > 0
    assert got["dot_flops"] == want["dot_flops"] / n
    assert got["wire_bytes_per_device"] == want["wire_bytes_per_device"]
    tol = BYTES_TOL["moe" if cfg.is_moe else "dense"]
    mean = want["bytes_written"] / n
    assert abs(got["bytes_written"] - mean) <= tol * mean
    if kind == "train" and not cfg.is_moe:       # the first replicas
        assert got["bytes_written"] >= mean


# -- FSDP gathers against the specs ----------------------------------------
def _leaves(tree, specs, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in _leaves(tree[k], specs[k], prefix + (k,))]
    return [(prefix, tree, specs)]


def fsdp_gather_bytes(cfg, params, specs, mesh) -> float:
    """The FSDP all-gather bytes of one train step (remat "full") from the
    specs alone (module docstring)."""
    dp, m = set(dp_axes(mesh)), axis_sizes(mesh)["model"]
    groups = dict(layer_plan(cfg)).get("hybrid_group", 0)
    total = 0.0
    for path, leaf, spec in _leaves(params, specs):
        axes = [spec_entry_axes(e) for e in spec]
        if not any(a and set(a) <= dp for a in axes):
            continue
        split = m if any("model" in a for a in axes) else 1
        times = 2 if path[0] == "stacks" else 1
        if path[0] == "shared_attn":
            times = 2 * groups
        if path[0] in ("embed", "lm_head") and cfg.mtp:
            times = 2
        total += leaf.numel() * leaf.element_size() / split * times
    return total


@pytest.mark.parametrize("shp", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_gathers_match_a_count_from_the_specs(arch, shp):
    """On a mesh whose data and model sizes differ, the gathers over the
    data axes of a train step are the FSDP gathers: nothing else gathers
    over them."""
    cfg = get_arch(arch).smoke()
    mesh = MeshSpec({"data": shp[0], "model": shp[1]})
    trace, plan = traced(cfg, ShapeCfg("t", S, B, "train"), mesh)
    got = sum(b for kind, b, g in trace.collectives
              if kind == "all-gather" and g == shp[0])
    params = build_step(cfg, ShapeCfg("t", S, B, "train"), mesh)[1][0]
    moe_ep.set_ep_mesh(None, ("data",))
    want = fsdp_gather_bytes(cfg, params, plan.specs, mesh)
    assert got > 0 and got == want
    # the gradients' reduce-scatters move the same blocks back
    back = sum(b for kind, b, g in trace.collectives
               if kind == "reduce-scatter" and g == shp[0])
    assert back > 0


# -- shard 0's placed inputs against the argument bytes ----------------------
INPUT_CELLS = [(a, s, mp) for a, s in CELLS for mp in (False, True)
               if cell_is_applicable(get_arch(a), SHAPE_BY_NAME[s])[0]]


def _bytes(x) -> float:
    """Bytes of shard 0's values in placed inputs (a 0-d leaf, the AdamW
    step or the position, as it is)."""
    if isinstance(x, (dict, list)):
        return sum(_bytes(v) for v in (x.values() if isinstance(x, dict)
                                       else x))
    if isinstance(x, tuple):
        return float(x[0][0].numel() * x[0].element_size())
    return float(x.numel() * x.element_size())


@pytest.mark.parametrize("arch,shape,multi_pod", INPUT_CELLS)
def test_shard_zero_inputs_are_the_argument_bytes(arch, shape, multi_pod):
    cfg, sh = get_arch(arch), SHAPE_BY_NAME[shape]
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        fn, structs = build_step(cfg, sh, mesh)
        args = list(structs)
        placed = place_inputs(sh.kind, fn.plan, mesh, sh.global_batch, args)
        want = argument_bytes(sh.kind, sh, mesh, args)
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    assert fn.plan.mesh.held == 1 and fn.plan.mesh.size == mesh.size
    got = _bytes(placed)
    assert got == want == reference_argument_bytes(arch, shape, multi_pod)
