"""The MoE archs' params at rest in device groups (``launch/sharding.
place_params`` / ``gather_params``) through the partitioned program, the
optimizer, the checkpoint and the train step (``launch/steps.
build_train_step``).

Every grouping runs on the CPU (``devices=["cpu"] * G``).  Held here, for
the smoke configs of both MoE archs (moonshot-v1-16b-a3b; deepseek-v3-671b,
whose MTP block holds experts outside the layer stacks, and whose MLA
attention runs over its heads on ``model``), float32 params:

* ``place_params`` holds every leaf (params and AdamW moments) as G group
  stacks of its shards' blocks; a routed-expert leaf's block is the
  experts its shard owns under the EP rule; ``gather_params`` gives back
  the tree bitwise; on a one-shard mesh it changes nothing, and without EP
  the experts take the TP/FSDP rule;
* a checkpoint of placed params and state saves each group's stack as a
  leaf of its own and loads back bitwise, each onto its target's device;
* the global norm over placed gradients counts every block once and is
  within 1e-6 relative of the norm over the whole ones (the per-block sums
  associate differently);
* step 0 of ``build_train_step`` on a (2, 4) mesh of G = 2 and 4 groups,
  every leaf placed: the loss and every gradient leaf bitwise with one
  group; three steps: params, optimizer state and losses within rtol =
  atol = 1e-6 (on the CPU they are bitwise), the expert blocks in their
  groups.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import (gather_params, param_specs,
                                         place_batch, place_params)
from repro_torch.launch.steps import StepConfig, build_train_step
from repro_torch.models import ShapeCfg, init_params, moe_ep
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import _global_norm

torch.set_num_threads(1)

MOE_ARCHS = ["moonshot-v1-16b-a3b", "deepseek-v3-671b"]
B, S = 8, 16
# the schedule's warmup takes the rate to 0 at step 0 and 1e-3 x lr at
# step 2: the params move by about 2e-3 in three steps
OPT = AdamWConfig(lr=1.0, state_dtype=torch.float32)


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _mesh(g, shape=(2, 4)):
    if g == 1:
        return ShardMesh(shape, ("data", "model"), device="cpu")
    return ShardMesh(shape, ("data", "model"), devices=["cpu"] * g)


def _params(arch, seed=0):
    cfg = get_arch(arch).smoke()
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            dtype=torch.float32, device="cpu")


def _expert_paths(tree):
    return [p for p, x in _flatten(tree) if p[-1] in ("wu", "wg", "wd")
            and x.dim() - (1 if "stacks" in p else 0) == 3]


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    toks = torch.from_numpy(toks.astype(np.int32))
    return dict(tokens=toks[:, :-1].contiguous(),
                labels=toks[:, 1:].contiguous())


def _specs(cfg, mesh):
    """The param and AdamW-state specs under the EP mesh the train step
    sets (``moe_ep.set_ep_mesh``)."""
    _, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                  StepConfig(optimizer=OPT))
    return param_specs(structs[0], mesh), param_specs(structs[1], mesh)


def _leaf_values(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaf_values(v)]
    return [tree]


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_place_and_gather_round_trip(arch, g):
    cfg, params = _params(arch)
    mesh = _mesh(g)
    ps, ss = _specs(cfg, mesh)
    state = adamw_init(params, OPT)
    experts = _expert_paths(params)
    assert experts and (arch != "deepseek-v3-671b" or any(
        "mtp" in p for p in experts))
    own = moe_ep._group_index(mesh, ("data", "model"))
    e_loc = cfg.n_experts // mesh.size
    for tree, specs in ((params, ps), (state, ss)):
        placed = place_params(tree, mesh, specs)
        flat = dict(_flatten(tree))
        for path, leaf in _flatten(placed):
            if path == ("step",):
                assert torch.equal(leaf, flat[path])
                continue
            gi = int(path[-1])
            assert leaf.device == mesh.devices[gi]
            assert leaf.shape[0] == mesh.per_group
            whole = flat[path[:-1]]
            if path[:-1] in experts or path[1:-1] in experts:
                for j, sh in enumerate(mesh.shards(gi)):
                    lo = int(own[sh]) * e_loc
                    assert torch.equal(leaf[j], whole.narrow(-3, lo, e_loc))
        assert len(_flatten(placed)) == g * len(flat) - (g - 1) * (
            "step" in tree)
        back = gather_params(placed, mesh, specs)
        assert [p for p, _ in _flatten(back)] == list(flat)
        for path, leaf in _flatten(back):
            assert torch.equal(leaf, flat[path]), path


def test_place_params_keeps_one_group_and_dense_trees():
    """A one-shard mesh keeps every tree; one group of the (2, 4) mesh
    places every leaf, a dense tree's too; without EP the experts take the
    TP/FSDP rule."""
    cfg, params = _params("moonshot-v1-16b-a3b")
    flat = _mesh(1, (1, 1))
    moe_ep.set_ep_mesh(flat, ("data",))
    assert place_params(params, flat) is params
    _, dense = _params("granite-34b")
    assert place_params(dense, flat) is dense
    placed = place_params(dense, _mesh(1))
    assert all(isinstance(x, tuple) and len(x) == 1 and x[0].shape[0] == 8
               for x in _leaf_values(placed))
    moe_ep.set_ep_mesh(None, ("data",))
    spec = param_specs(params, _mesh(2))["stacks"]["moe"]["ffn"]["wu"]
    assert spec == (None, "model", ("data",), None)


@pytest.mark.parametrize("g", [2, 4])
def test_checkpoint_of_placed_params_round_trips(g, tmp_path):
    cfg, params = _params("deepseek-v3-671b", seed=3)
    mesh = _mesh(g)
    ps, ss = _specs(cfg, mesh)
    tree = dict(p=place_params(params, mesh, ps),
                o=place_params(adamw_init(params, OPT), mesh, ss))
    save_checkpoint(str(tmp_path), 5, tree)
    blank = _unflatten(tree, iter(torch.zeros_like(x)
                                  for _, x in _flatten(tree)))
    back = load_checkpoint(str(tmp_path), 5, blank, verify=True)
    got, want = _flatten(back), _flatten(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert any(p[-1] == str(g - 1) and p[-2] == "wu" for p, _ in want)
    for (path, a), (_, b) in zip(got, want):
        assert torch.equal(a, b) and a.dtype == b.dtype, path
        assert a.device == b.device, path


@pytest.mark.parametrize("g", [2, 4])
def test_global_norm_over_placed_leaves(g):
    cfg, params = _params("moonshot-v1-16b-a3b", seed=5)
    mesh = _mesh(g)
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                   StepConfig(optimizer=OPT))
    whole = float(_global_norm([x for _, x in _flatten(params)]))
    placed = float(fn.plan.global_norm(place_params(
        params, mesh, param_specs(structs[0], mesh))))
    assert abs(placed - whole) <= 1e-6 * whole


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_train_step_matches_one_group(arch, g):
    cfg, params = _params(arch, seed=7)
    batch = _batch(cfg, 7)
    shape = ShapeCfg("t", S, B, "train")
    runs = []
    for mesh in (_mesh(1), _mesh(g)):
        step, structs = build_train_step(cfg, shape, mesh, StepConfig(
            optimizer=OPT))
        assert moe_ep.get_ep_mesh() is mesh
        ps, ss = param_specs(structs[0], mesh), param_specs(structs[1], mesh)
        p = place_params(params, mesh, ps)
        st = place_params(adamw_init(params, OPT), mesh, ss)
        loss0, grads = step.plan.loss_and_grads(p, place_batch(batch, mesh))
        losses = []
        for _ in range(3):
            p, st, loss = step(p, st, batch)
            losses.append(loss)
        runs.append((loss0, gather_params(grads, mesh, ps), losses,
                     gather_params(p, mesh, ps), gather_params(st, mesh, ss),
                     p))
        moe_ep.set_ep_mesh(None, ("data",))
    (l1, g1, ls1, p1, s1, _), (lg, gg, lsg, pg, sg, placed) = runs
    assert torch.equal(lg, l1) and torch.equal(lsg[0], ls1[0])
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert torch.equal(a, b), path
    leaf = dict(_flatten(placed))
    for path in _expert_paths(params):
        assert all(leaf[path + (str(i),)].device == _mesh(g).devices[i]
                   for i in range(g))
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        _flatten(p1), _flatten(params))) > 1e-3          # the steps moved
    for (path, a), (_, b) in zip(_flatten(dict(p=pg, o=sg)),
                                 _flatten(dict(p=p1, o=s1))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                   msg=str(path))
    torch.testing.assert_close(torch.stack(lsg), torch.stack(ls1),
                               rtol=1e-6, atol=1e-6)
