"""The partitioned train, prefill and decode steps (``launch/steps.py`` over
``models/partitioned.py``) on a (2, 4) ``("data", "model")`` mesh of G
device groups on the CPU (``devices=["cpu"] * G``), float32 params.

For the smoke configs of minicpm-2b (MHA), granite-34b (MQA), moonshot-v1-
16b-a3b (MoE, EP over the 8 shards) and mamba2-2.7b (SSM), held here:

* ``place_params`` / ``place_batch`` / ``place_cache`` cut every leaf by its
  spec into the groups' ``[per_group, *block]`` stacks, and
  ``gather_params`` gives every tree back bitwise; with G = 8 (one shard a
  group) each group's bytes at rest equal ``per_device_bytes``;
* a checkpoint of placed params and AdamW state loads back bitwise, every
  block on its group's device;
* the global norm over placed gradients counts every block once: within
  1e-6 relative of the norm over the whole tree;
* with G = 2 and 4 against G = 1: the train step's loss and every
  gradient leaf at step 0, the prefill logits, the decode logits and new
  caches bitwise; three train steps' params, state and losses bitwise (the
  stated bar is rtol = atol = 1e-6); replicated blocks stay bitwise equal
  to each other;
* against the port's unpartitioned step (the one-device program: the (1, 1)
  mesh; for the MoE arch the same (2, 4) mesh with whole params, whose EP
  drops the same choices): loss, gradients, one step's params and state,
  prefill and decode logits and caches within 1e-4 of each leaf's largest
  magnitude; the default bf16 AdamW state within 2e-2 norm-relative;
* on a one-shard mesh nothing is placed and the step is today's;
* the collectives the step differentiates through (``core/mesh.py``: a
  tiled ``all_gather``, ``reduce_scatter``, ``psum``) against a loop over
  the shards, their gradients too, bitwise across groupings.

The reference's own partitioned steps are held in
``tests/test_torch_partitioned_ref.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt import load_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import _flatten, _unflatten, clone_tree
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import (cache_specs, gather_params,
                                         param_specs, per_device_bytes,
                                         place_batch, place_cache,
                                         place_params)
from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                      build_prefill_step, build_train_step,
                                      logits_spec)
from repro_torch.models import ShapeCfg, init_params, loss_fn, moe_ep
from repro_torch.models.serving import pad_params_for_serving, serving_padded
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import _global_norm

torch.set_num_threads(1)

ARCHS = ["minicpm-2b", "granite-34b", "moonshot-v1-16b-a3b", "mamba2-2.7b"]
B, S, POS = 8, 16, 5
TOL = 1e-4
OPT = AdamWConfig(state_dtype=torch.float32)


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


def _batch(cfg, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    toks = torch.from_numpy(toks.astype(np.int32))
    return dict(tokens=toks[:, :-1].contiguous(),
                labels=toks[:, 1:].contiguous())


def _state(params, seed=0):
    """A nonzero AdamW state past the schedule's warmup (step 3,000)."""
    rng = np.random.default_rng(seed)
    leaves = [p for _, p in _flatten(params)]
    m = _unflatten(params, iter(torch.from_numpy(rng.normal(
        0, 1e-3, p.shape).astype(np.float32)) for p in leaves))
    v = _unflatten(params, iter(torch.from_numpy(rng.uniform(
        0, 1e-5, p.shape).astype(np.float32)) for p in leaves))
    return dict(m=m, v=v, step=torch.tensor(3000, dtype=torch.int32))


def _cache(structs, seed=0):
    rng = np.random.default_rng(seed)
    return _unflatten(structs, iter(torch.from_numpy(
        (rng.normal(size=x.shape) * 0.1).astype(np.float32))
        for _, x in _flatten(structs)))


def _unpartitioned_mesh(cfg):
    return _mesh(1) if cfg.is_moe else _mesh(1, (1, 1))


def _same_trees(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def _close_trees(a, b, tol=TOL):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * max(float(y.float().abs().max()), 1e-30), \
            (path, err)


def _train(cfg, mesh, params, state, batch, steps=1, opt=OPT):
    """Step 0's loss and gradients, then ``steps`` train steps: whole
    trees back from the placed ones, and the placed results."""
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                   StepConfig(optimizer=opt))
    ps, ss = param_specs(structs[0], mesh), param_specs(structs[1], mesh)
    p, st = place_params(params, mesh, ps), place_params(state, mesh, ss)
    loss0, grads = fn.plan.loss_and_grads(p, place_batch(batch, mesh))
    losses = []
    for _ in range(steps):
        p, st, loss = fn(p, st, batch)
        losses.append(loss)
    moe_ep.set_ep_mesh(None, ("data",))
    return dict(loss0=loss0, grads=gather_params(grads, mesh, ps),
                params=gather_params(p, mesh, ps),
                state=gather_params(st, mesh, ss), losses=losses,
                placed=(p, st, ps, ss))


def _whole_step(cfg, params, state, batch, opt=OPT):
    """The unpartitioned program: loss, gradients, one step."""
    mesh = _unpartitioned_mesh(cfg)
    fn, _ = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                             StepConfig(optimizer=opt))
    leaves = [x.detach().requires_grad_() for _, x in _flatten(params)]
    loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch)
    grads = _unflatten(params, iter(torch.autograd.grad(loss, leaves)))
    # the step donates params and state: it takes copies
    p1, s1, loss1 = fn(clone_tree(params), clone_tree(state), batch)
    moe_ep.set_ep_mesh(None, ("data",))
    return loss.detach(), grads, p1, s1, loss1


# -- placement ---------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_place_and_gather_round_trip(arch):
    cfg, params = _params(arch)
    mesh = _mesh(4)
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                   StepConfig(optimizer=OPT))
    state = _state(params)
    for tree, specs in ((params, param_specs(structs[0], mesh)),
                        (state, param_specs(structs[1], mesh))):
        placed = place_params(tree, mesh, specs)
        for path, leaf in _flatten(placed):
            if path[-1] == "step":
                assert leaf.dim() == 0 and leaf.device == mesh.device
                continue
            g = int(path[-1])
            assert leaf.shape[0] == mesh.per_group
            assert leaf.device == mesh.devices[g]
        assert len(_flatten(placed)) == 4 * len(_flatten(tree)) - 3 * (
            "step" in tree)
        _same_trees(gather_params(placed, mesh, specs), tree)
    batch = _batch(cfg)
    pb = place_batch(batch, mesh)
    assert all(x.shape[:2] == (2, B // 2) for _, x in _flatten(pb))
    _same_trees({k: mesh.assemble(v, (("data",), None))
                 for k, v in pb.items()}, batch)
    dshape = ShapeCfg("d", S, B, "decode")
    _, (_, cs, _, _) = build_decode_step(cfg, dshape, mesh)
    cache = _cache(cs)
    placed = place_cache(cache, mesh, B)
    _same_trees(gather_params(placed, mesh, cache_specs(cs, mesh, B)), cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_at_rest_equal_per_device_bytes(arch):
    """G = 8 on the (2, 4) mesh: one shard a group."""
    cfg, params = _params(arch)
    mesh = _mesh(8)
    _, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                  StepConfig(optimizer=OPT))
    state = adamw_init(params, OPT)
    for tree, st in ((params, structs[0]), (state["m"], structs[1]["m"]),
                     (state["v"], structs[1]["v"])):
        specs = param_specs(st, mesh)
        want = per_device_bytes(tree, specs, mesh)
        got = [0] * 8
        for path, x in _flatten(place_params(tree, mesh, specs)):
            got[int(path[-1])] += x.numel() * x.element_size()
        assert got == [want] * 8
        whole = sum(x.numel() * x.element_size() for _, x in _flatten(tree))
        assert want < whole


@pytest.mark.parametrize("g", [2, 4])
def test_checkpoint_of_placed_params_and_state(g, tmp_path):
    cfg, params = _params("moonshot-v1-16b-a3b", seed=3)
    mesh = _mesh(g)
    _, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                  StepConfig(optimizer=OPT))
    tree = dict(p=place_params(params, mesh, param_specs(structs[0], mesh)),
                o=place_params(_state(params), mesh,
                               param_specs(structs[1], mesh)))
    save_checkpoint(str(tmp_path), 5, tree)
    blank = _unflatten(tree, iter(torch.zeros_like(x)
                                  for _, x in _flatten(tree)))
    back = load_checkpoint(str(tmp_path), 5, blank, verify=True)
    _same_trees(back, tree)
    assert all(a.device == b.device for (_, a), (_, b) in zip(
        _flatten(back), _flatten(tree)))


@pytest.mark.parametrize("arch", ARCHS)
def test_global_norm_counts_each_element_once(arch):
    cfg, params = _params(arch, seed=5)
    run = _train(cfg, _mesh(2), params, _state(params), _batch(cfg, 5),
                 steps=0)
    moe_ep.set_ep_mesh(_mesh(2), ("data",))
    fn, _ = build_train_step(cfg, ShapeCfg("t", S, B, "train"), _mesh(2),
                             StepConfig(optimizer=OPT))
    _, _, ps, _ = run["placed"]
    placed = place_params(run["grads"], _mesh(2), ps)
    got = float(fn.plan.global_norm(placed))
    whole = float(_global_norm([x for _, x in _flatten(run["grads"])]))
    assert abs(got - whole) <= 1e-6 * whole


# -- groups against one group -----------------------------------------------
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bitwise_with_one_group(arch, g):
    cfg, params = _params(arch, seed=7)
    state, batch = _state(params, 7), _batch(cfg, 7)
    one = _train(cfg, _mesh(1), params, state, batch, steps=3)
    got = _train(cfg, _mesh(g), params, state, batch, steps=3)
    assert torch.equal(got["loss0"], one["loss0"])
    _same_trees(got["grads"], one["grads"])
    assert torch.equal(torch.stack(got["losses"]), torch.stack(one["losses"]))
    _same_trees(got["params"], one["params"])
    _same_trees(got["state"], one["state"])
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        _flatten(got["params"]), _flatten(params))) > 1e-4   # it moved
    # every replica of a block holds the same bits
    mesh = _mesh(g)
    p, st, ps, _ = got["placed"]
    for (path, groups), (_, spec) in zip(
            [(q, x) for q, x in _flatten_placed(p)], _flatten_specs(ps)):
        blocks = [t for grp in groups for t in grp.unbind(0)]
        for s in range(mesh.size):
            first = next(r for r in range(mesh.size) if _same_block(
                mesh, spec, r, s))
            assert torch.equal(blocks[s], blocks[first]), (path, s)


def _flatten_placed(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in _flatten_placed(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _flatten_specs(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in _flatten_specs(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _same_block(mesh, spec, r, s):
    return all(mesh._block(e, r) == mesh._block(e, s) for e in spec)


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bitwise_with_one_group(arch, g):
    cfg, params = _params(arch, seed=9)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                              .astype(np.int32))
    tok1 = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                            .astype(np.int32))
    runs = []
    for mesh in (_mesh(1), _mesh(g)):
        pshape = ShapeCfg("p", S, B, "prefill")
        fn, structs = build_prefill_step(cfg, pshape, mesh)
        logits = fn(place_params(params, mesh, param_specs(structs[0],
                                                           mesh)),
                    dict(tokens=tokens))
        logits = mesh.assemble(logits, logits_spec(cfg, pshape, mesh))
        moe_ep.set_ep_mesh(None, ("data",))
        dshape = ShapeCfg("d", S, B, "decode")
        fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, mesh)
        pp = pad_params_for_serving(cfg, serving_padded(cfg, 4), params)
        dl, dc = fn(place_params(pp, mesh, param_specs(pst, mesh)),
                    _cache(cst, 9), tok1, POS)
        pc = serving_padded(cfg, 4)
        runs.append((logits, mesh.assemble(dl, logits_spec(
            pc, dshape, mesh, decode=True)),
            gather_params(dc, mesh, cache_specs(cst, mesh, B))))
        moe_ep.set_ep_mesh(None, ("data",))
    (l1, d1, c1), (lg, dg, cg) = runs
    assert torch.equal(lg, l1) and torch.equal(dg, d1)
    _same_trees(cg, c1)


# -- against the unpartitioned step -----------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unpartitioned(arch):
    cfg, params = _params(arch, seed=11)
    state, batch = _state(params, 11), _batch(cfg, 11)
    loss, grads, p1, s1, loss1 = _whole_step(cfg, params, state, batch)
    got = _train(cfg, _mesh(2), params, state, batch, steps=1)
    assert abs(float(got["loss0"]) - float(loss)) <= TOL * float(loss)
    assert abs(float(got["losses"][0]) - float(loss1)) <= TOL * float(loss1)
    _close_trees(got["grads"], grads)
    _close_trees(got["params"], p1)
    _close_trees(got["state"]["m"], s1["m"])
    _close_trees(got["state"]["v"], s1["v"])
    assert int(got["state"]["step"]) == int(s1["step"]) == 3001


def test_bf16_state_matches_unpartitioned():
    """The default bf16 AdamW state against the unpartitioned step's:
    norm-relative within 2e-2 (the reference's bf16 bar)."""
    cfg, params = _params("minicpm-2b", seed=13)
    opt = AdamWConfig(state_dtype=torch.bfloat16)
    state = _state(params, 13)
    state = dict(m=_unflatten(state["m"], iter(
        x.to(torch.bfloat16) for _, x in _flatten(state["m"]))),
        v=_unflatten(state["v"], iter(x.to(torch.bfloat16)
                                      for _, x in _flatten(state["v"]))),
        step=state["step"])
    batch = _batch(cfg, 13)
    _, _, p1, s1, _ = _whole_step(cfg, params, state, batch, opt)
    got = _train(cfg, _mesh(4), params, state, batch, steps=1, opt=opt)
    _close_trees(got["params"], p1)
    for k in ("m", "v"):
        for (path, a), (_, b) in zip(_flatten(got["state"][k]),
                                     _flatten(s1[k])):
            assert a.dtype == torch.bfloat16
            rel = float((a.float() - b.float()).norm()
                        / b.float().norm().clamp(min=1e-30))
            assert rel <= 2e-2, (k, path, rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unpartitioned(arch):
    cfg, params = _params(arch, seed=15)
    rng = np.random.default_rng(15)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S))
                              .astype(np.int32))
    tok1 = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                            .astype(np.int32))
    one = _unpartitioned_mesh(cfg)
    pshape, dshape = (ShapeCfg("p", S, B, "prefill"),
                      ShapeCfg("d", S, B, "decode"))
    fn, _ = build_prefill_step(cfg, pshape, one)
    want = fn(params, dict(tokens=tokens))
    moe_ep.set_ep_mesh(None, ("data",))
    mesh = _mesh(2)
    fn, structs = build_prefill_step(cfg, pshape, mesh)
    got = fn(place_params(params, mesh, param_specs(structs[0], mesh)),
             dict(tokens=tokens))
    _close_trees(mesh.assemble(got, logits_spec(cfg, pshape, mesh)), want)
    moe_ep.set_ep_mesh(None, ("data",))
    # decode: the padded serving layout on the (2, 4) mesh, the same
    # params and cache given to the one-device program
    fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, mesh)
    pc = serving_padded(cfg, 4)
    pp = pad_params_for_serving(cfg, pc, params)
    cache = _cache(cst, 15)
    dl, dc = fn(place_params(pp, mesh, param_specs(pst, mesh)), cache,
                tok1, POS)
    dl = mesh.assemble(dl, logits_spec(pc, dshape, mesh, decode=True))
    dc = gather_params(dc, mesh, cache_specs(cst, mesh, B))
    moe_ep.set_ep_mesh(None, ("data",))
    fn, _ = build_decode_step(pc, dshape, one, StepConfig(
        serving_head_pad=False))
    wl, wc = fn(pp, cache, tok1, POS)
    _close_trees(dl, wl)
    _close_trees(dc, wc)


def test_one_shard_mesh_places_nothing():
    cfg, params = _params("minicpm-2b")
    mesh = _mesh(1, (1, 1))
    assert place_params(params, mesh) is params
    batch = _batch(cfg)
    assert place_batch(batch, mesh) is batch
    fn, _ = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                             StepConfig(optimizer=OPT))
    assert fn.plan is None
    state = _state(params)
    p1, s1, loss = fn(clone_tree(params), state, batch)
    assert torch.equal(loss, loss_fn(cfg, params, batch))
    assert all(not isinstance(x, tuple) for _, x in _flatten(p1))


# -- the collectives' gradients (core/mesh.py) --------------------------------
def _coords(mesh):
    return [mesh.coords(s) for s in range(mesh.size)]


@pytest.mark.parametrize("g", [1, 2, 4])
def test_collectives_and_their_gradients(g):
    """On a (2, 4) mesh: a tiled ``all_gather`` over ``data``, over
    ``model`` and over both, a ``reduce_scatter`` and a ``psum``, each
    against a loop over the shards, and each one's gradient (a
    reduce-scatter, a gather, a psum) against the loop's autograd; every
    grouping bitwise with one group."""
    mesh = _mesh(g)
    rng = np.random.default_rng(g)
    x = torch.from_numpy(rng.normal(size=(8, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 6, 32)).astype(np.float32))
    cs = _coords(mesh)

    def loop_gather(xs, axes, dim):
        out = []
        for s, c in enumerate(cs):
            members = [r for r, cr in enumerate(cs) if all(
                cr[i] == c[i] for i, a in enumerate(mesh.axis_names)
                if a not in axes)]
            out.append(torch.cat([xs[r] for r in members], dim))
        return out

    for axes, dim in ((("data",), 0), (("model",), 1),
                      (("data", "model"), 1)):
        xs = [t.clone().requires_grad_() for t in x.unbind(0)]
        want = loop_gather(xs, axes, dim)
        groups = mesh.split(torch.stack(xs))
        got = mesh.all_gather(groups, axes, dim, dim=0, tiled=True)
        got_s = [t for grp in got for t in grp.unbind(0)]
        for a, b in zip(got_s, want):
            assert torch.equal(a, b)
        ws = [w[s, :a.shape[0], :a.shape[1]] for s, a in enumerate(want)]
        gw = torch.autograd.grad(sum((a * c).sum() for a, c in zip(
            want, ws)), xs)
        gg = torch.autograd.grad(sum((a * c).sum() for a, c in zip(
            got_s, ws)), xs)
        for a, b in zip(gg, gw):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    # reduce_scatter over model along dim 1 of [3, 8]: its gradient gathers
    y = [t.clone().requires_grad_() for t in w[:, :3, :8].unbind(0)]
    rs = mesh.reduce_scatter(mesh.split(torch.stack(y)), ("model",), 1,
                             dim=0)
    rs_s = [t for grp in rs for t in grp.unbind(0)]
    for s, c in enumerate(cs):
        tot = sum(y[r] for r, cr in enumerate(cs) if cr[0] == c[0])
        torch.testing.assert_close(rs_s[s], tot[:, 2 * c[1]:2 * c[1] + 2])
    (gy,) = torch.autograd.grad(rs_s[0].sum(), [y[0]])
    assert torch.equal(gy[:, :2], torch.ones(3, 2))
    assert torch.equal(gy[:, 2:], torch.zeros(3, 6))
    # psum over data: the gradient of one shard's result reaches its group
    xs = [t.clone().requires_grad_() for t in x.unbind(0)]
    ps = mesh.psum(mesh.split(torch.stack(xs)), ("data",), dim=0)
    ps_s = [t for grp in ps for t in grp.unbind(0)]
    gs = torch.autograd.grad(ps_s[1].sum(), xs)
    for s, c in enumerate(cs):
        assert torch.equal(gs[s], torch.full((3, 4), float(c[1] == 1)))


@pytest.mark.parametrize("g", [2, 4])
def test_collective_gradients_bitwise_with_one_group(g):
    mesh1, mesh = _mesh(1), _mesh(g)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(8, 5, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 10, 16)).astype(np.float32))
    runs = []
    for m in (mesh1, mesh):
        xs = [t.requires_grad_() for t in m.split(x.clone())]
        out = m.all_gather(tuple(xs), ("model",), 1, dim=0, tiled=True)
        out = m.all_gather(out, "data", 0, dim=0, tiled=True)
        out = m.psum(out, ("model",), dim=0)
        loss = sum((o * c).sum() for o, c in zip(out, m.split(w)))
        runs.append(m.join(torch.autograd.grad(loss, xs)))
    assert torch.equal(runs[1], runs[0])
