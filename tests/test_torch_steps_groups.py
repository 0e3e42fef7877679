"""Routed experts at rest in device groups (``launch/sharding.place_params``
/ ``gather_params``) through the model, the optimizer, the checkpoint and
the train step (``launch/steps.build_train_step``).

Every grouping runs on the CPU (``devices=["cpu"] * G``).  Held here, for
the smoke configs of both MoE archs (moonshot-v1-16b-a3b; deepseek-v3-671b,
whose MTP block holds experts outside the layer stacks), float32 params:

* ``place_params`` cuts each routed-expert leaf (params and AdamW moments)
  into G slices along the expert axis, the experts of each group's shards,
  and leaves every other leaf as it is; ``gather_params`` gives back the
  tree bitwise; with one group, without EP, or for a dense arch it changes
  nothing;
* a checkpoint of placed params and state saves each slice as a leaf of its
  own and loads back bitwise, each slice onto its target's device;
* the global norm over placed leaves is within 1e-6 relative of the norm
  over the whole ones (the per-slice sums associate differently);
* step 0 of ``build_train_step`` on a (2, 4) mesh of G = 2 and 4 groups,
  the experts placed: the loss and every gradient leaf bitwise with one
  group; three steps: params, optimizer state and losses within rtol =
  atol = 1e-6 (after the first update the global norm's association shows),
  with the slices still in their groups.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import gather_params, place_params
from repro_torch.launch.steps import StepConfig, build_train_step
from repro_torch.models import ShapeCfg, init_params, loss_fn, moe_ep
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


def _mesh(g):
    if g == 1:
        return ShardMesh((2, 4), ("data", "model"), device="cpu")
    return ShardMesh((2, 4), ("data", "model"), devices=["cpu"] * g)


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


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_place_and_gather_round_trip(arch, g):
    cfg, params = _params(arch)
    mesh = _mesh(g)
    moe_ep.set_ep_mesh(mesh, ("data",))
    state = adamw_init(params, OPT)
    experts = _expert_paths(params)
    assert experts and (arch != "deepseek-v3-671b" or any(
        "mtp" in p for p in experts))
    for tree in (params, state):
        placed = place_params(tree, mesh)
        flat = dict(_flatten(tree))
        for path, leaf in _flatten(placed):
            if path[:-1] in [("m",) + e for e in experts] + [
                    ("v",) + e for e in experts] + experts:
                whole = flat[path[:-1]]
                lo, hi = moe_ep.expert_spans(mesh, cfg.n_experts)[
                    int(path[-1])]
                assert torch.equal(leaf, whole.narrow(-3, lo, hi - lo))
                assert leaf.device == mesh.devices[int(path[-1])]
            else:
                assert leaf is flat[path]
        assert len(_flatten(placed)) == len(flat) + (g - 1) * sum(
            1 for p in flat if p in experts or p[1:] in experts)
        back = gather_params(placed)
        assert [p for p, _ in _flatten(back)] == list(flat)
        for path, leaf in _flatten(back):
            assert torch.equal(leaf, flat[path]), path


def test_place_params_keeps_one_group_and_dense_trees():
    cfg, params = _params("moonshot-v1-16b-a3b")
    moe_ep.set_ep_mesh(_mesh(1), ("data",))
    assert place_params(params, _mesh(1)) is params
    moe_ep.set_ep_mesh(None, ("data",))
    assert place_params(params, _mesh(2)) is params      # EP not engaged
    _, dense = _params("granite-34b")
    moe_ep.set_ep_mesh(_mesh(2), ("data",))
    placed = place_params(dense, _mesh(2))
    assert all(a is b for (_, a), (_, b) in zip(_flatten(placed),
                                                _flatten(dense)))


@pytest.mark.parametrize("g", [2, 4])
def test_checkpoint_of_placed_params_round_trips(g, tmp_path):
    cfg, params = _params("deepseek-v3-671b", seed=3)
    mesh = _mesh(g)
    moe_ep.set_ep_mesh(mesh, ("data",))
    tree = place_params(dict(p=params, o=adamw_init(params, OPT)), mesh)
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
    moe_ep.set_ep_mesh(mesh, ("data",))
    whole = float(_global_norm([x for _, x in _flatten(params)]))
    placed = float(_global_norm([x for _, x in _flatten(
        place_params(params, mesh))]))
    assert abs(placed - whole) <= 1e-6 * whole


def _step_grads(cfg, params, batch):
    """The loss and gradients the train step takes (``build_train_step``'s
    own lines), the gradient tree in ``params``'s structure."""
    leaves = [p.detach().requires_grad_() for _, p in _flatten(params)]
    loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch,
                   remat="full")
    return loss.detach(), _unflatten(params, iter(torch.autograd.grad(
        loss, leaves)))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_train_step_matches_one_group(arch, g):
    cfg, params = _params(arch, seed=7)
    batch = _batch(cfg, 7)
    shape = ShapeCfg("t", S, B, "train")
    runs = []
    for mesh in (_mesh(1), _mesh(g)):
        step, _ = build_train_step(cfg, shape, mesh, StepConfig(
            optimizer=OPT))
        assert moe_ep.get_ep_mesh() is mesh
        p = place_params(params, mesh)
        st = place_params(adamw_init(params, OPT), mesh)
        loss0, grads = _step_grads(cfg, p, batch)
        losses = []
        for _ in range(3):
            p, st, loss = step(p, st, batch)
            losses.append(loss)
        runs.append((loss0, gather_params(grads), losses, p, st))
        moe_ep.set_ep_mesh(None, ("data",))
    (l1, g1, ls1, p1, s1), (lg, gg, lsg, pg, sg) = runs
    assert torch.equal(lg, l1) and torch.equal(lsg[0], ls1[0])
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert torch.equal(a, b), path
    for path in _expert_paths(params):
        leaf = dict(_flatten(pg))
        assert all((path + (str(i),)) in leaf for i in range(g))
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        _flatten(p1), _flatten(params))) > 1e-3          # the steps moved
    for (path, a), (_, b) in zip(_flatten(gather_params(dict(p=pg, o=sg))),
                                 _flatten(dict(p=p1, o=s1))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6,
                                   msg=str(path))
    torch.testing.assert_close(torch.stack(lsg), torch.stack(ls1),
                               rtol=1e-6, atol=1e-6)
