"""The tensor-parallel pieces of the partitioned program
(``models/partitioned.Partitioned``) on a (2, 4) ``("data", "model")`` mesh
of G = 1, 2 and 4 device groups on the CPU, smoke widths, float32:

* the vocab-parallel lookup (``Partitioned.lookup``) bitwise with the whole
  ``embed`` lookup;
* the vocab-parallel cross-entropy (``model.vocab_parallel_ce_sums``), its
  sums and its gradient within 1e-6 of ``model.masked_ce_sums``;
* the shared experts, the dropless routed experts over ``model`` (no EP),
  MLA (prefill and the absorbed decode, its ``ckv`` cache) and mamba2 over
  its SSM heads (chunked and decode, its ``conv`` and ``ssm`` cache
  leaves), each one layer on every shard's rows against the whole layer
  (``model._block_forward`` / ``layers``) within 1e-5 of the largest
  magnitude, and every grouping bitwise with one group;
* a spy on ``ShardMesh.all_gather`` during one train step's loss and
  gradients of each smoke arch (the MoE archs with EP and without): no leaf
  that the program splits over ``model`` is gathered over ``model``; the
  only leaves gathered over it are MLA's ``wdq`` and mamba2's ``conv_w`` /
  ``conv_b`` (the ``Partitioned`` docstring says why).
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.core.mesh import ShardMesh, spec_entry_axes
from repro_torch.launch.sharding import (cache_specs, param_specs,
                                         place_batch, place_cache,
                                         place_params)
from repro_torch.launch.steps import StepConfig, build_train_step
from repro_torch.models import ShapeCfg, init_cache, moe_ep
from repro_torch.models.layers import ffn_forward, moe_routed
from repro_torch.models.model import (_block_forward, masked_ce_sums,
                                      vocab_parallel_ce_sums)
from repro_torch.models.partitioned import Partitioned, _unstack

import torch_partitioned as tp

torch.set_num_threads(1)

B, S, POS = tp.B, tp.S, tp.POS
TOL = 1e-5
ALL_ARCHS = ["minicpm-2b", "granite-34b", "moonshot-v1-16b-a3b",
             "mamba2-2.7b"] + tp.ARCHS_B
# every leaf the program splits over ``model`` where its spec does
TP_LEAVES = {"embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
             "wu", "wg", "wd", "wuq", "wuk", "wuv", "shared_wu", "shared_wg",
             "shared_wd", "in_proj", "out_proj", "A_log", "D", "dt_bias",
             "proj"}
GATHERED_WHOLE = {"wdq", "conv_w", "conv_b"}


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    moe_ep.set_ep_mesh(None, ("data",))
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _rows(mesh, x, s):
    """Shard ``s``'s batch rows of a whole [B, ...] value."""
    return mesh.block_of(x, (("data",),), s)


def _plan(arch, g, seed=0, serving=False):
    cfg, params = tp.params(arch, seed)
    if serving:
        from repro_torch.models.serving import (pad_params_for_serving,
                                                serving_padded)
        pc = serving_padded(cfg, 4)
        params, cfg = pad_params_for_serving(cfg, pc, params), pc
    mesh = tp.mesh(g)
    specs = param_specs(params, mesh)
    return cfg, params, mesh, specs, Partitioned(cfg, mesh, specs)


def _layer0(params, placed, specs, kind):
    """Layer 0 of stack ``kind``: whole, and placed with its specs."""
    count = next(x for _, x in _flatten(params["stacks"][kind])).shape[0]
    lp, ls = _unstack(placed["stacks"][kind], specs["stacks"][kind],
                      count)[0]
    return _index0(params["stacks"][kind]), lp, ls


def _index0(tree):
    if isinstance(tree, dict):
        return {k: _index0(v) for k, v in tree.items()}
    return tree[0]


def _x(cfg, seed, s=S):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(B, s, cfg.d_model))
                            .astype(np.float32))


def _close(got, want, tol=TOL):
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


# -- embed and cross-entropy -------------------------------------------------
@pytest.mark.parametrize("g", [1, 2, 4])
def test_vocab_parallel_lookup_bitwise_with_whole(g):
    cfg, params, mesh, specs, plan = _plan("minicpm-2b", g)
    assert plan.vocab_tp
    toks = torch.from_numpy(np.random.default_rng(g).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    placed = place_params(params, mesh, specs)
    got = plan.lookup(placed, Partitioned.shards(
        place_batch(dict(tokens=toks), mesh)["tokens"]))
    whole = torch.nn.functional.embedding(toks.long(), params["embed"])
    for s, x in enumerate(got):
        assert torch.equal(x, _rows(mesh, whole, s))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_vocab_parallel_ce_and_its_gradient(m):
    """m shards of one row's vocab, a list of blocks each: the sums, the
    counts and the gradient against ``masked_ce_sums`` of the whole
    logits (ties in the row max included)."""
    rng = np.random.default_rng(m)
    v = 64
    logits = torch.from_numpy(rng.normal(size=(3, 5, v)).astype(np.float32)
                              * 4)
    logits[0, 0, 3] = logits[0, 0, v - 2] = logits[0, 0].max() + 1
    labels = torch.from_numpy(rng.integers(-1, v, (3, 5)).astype(np.int32))
    mask = labels >= 0
    whole = logits.clone().requires_grad_()
    t, c = masked_ce_sums(whole, labels, mask)
    (gw,) = torch.autograd.grad(t, whole)
    t = t.detach()
    blocks = [b.clone().requires_grad_() for b in logits.split(v // m, -1)]

    def reduce(op):
        return lambda vals: [op(torch.stack(vals), 0)] * len(vals)

    got = vocab_parallel_ce_sums(
        blocks, [labels] * m, [mask] * m, [i * (v // m) for i in range(m)],
        reduce(torch.sum), reduce(lambda x, d: torch.amax(x, d)))
    for gt, gc in got:
        assert abs(float(gt.detach()) - float(t)) <= 1e-6 * abs(float(t))
        assert int(gc) == int(c)
    gb = torch.autograd.grad(got[0][0], blocks)
    torch.testing.assert_close(torch.cat(gb, -1), gw, rtol=1e-6, atol=1e-6)


# -- the layers over ``model`` ---------------------------------------------
def _moe_case(g, zero):
    """deepseek's first MoE layer, EP off, with ``zero``'s down projection
    zeroed: the other part alone (per-shard outputs, whole output)."""
    cfg, params, mesh, specs, plan = _plan("deepseek-v3-671b", g, seed=3)
    params["stacks"]["moe"]["ffn"][zero] = torch.zeros_like(
        params["stacks"]["moe"]["ffn"][zero])
    placed = place_params(params, mesh, specs)
    whole, lp, ls = _layer0(params, placed, specs, "moe")
    x = _x(cfg, 3)
    got = plan.moe(lp["ffn"], ls["ffn"], [_rows(mesh, x, s)
                                          for s in range(mesh.size)])
    return cfg, mesh, whole["ffn"], x, got


@pytest.mark.parametrize("g", [1, 2, 4])
def test_shared_experts_over_model(g):
    cfg, mesh, p, x, got = _moe_case(g, "wd")      # routed experts give 0
    assert cfg.n_shared_experts
    want = ffn_forward(cfg, {k[len("shared_"):]: v for k, v in p.items()
                             if k.startswith("shared_")}, x)
    for s, y in enumerate(got):
        _close(y, _rows(mesh, want, s))
    if g > 1:
        one = _moe_case(1, "wd")[-1]
        assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("g", [1, 2, 4])
def test_dropless_experts_over_model(g):
    cfg, mesh, p, x, got = _moe_case(g, "shared_wd")   # shared give 0
    want = moe_routed(cfg, p, x).reshape(x.shape)
    for s, y in enumerate(got):
        _close(y, _rows(mesh, want, s))
    if g > 1:
        one = _moe_case(1, "shared_wd")[-1]
        assert all(torch.equal(a, b) for a, b in zip(got, one))


def _block_case(arch, kind, g, decode):
    """Layer 0 of ``kind`` through ``Partitioned.block`` on every shard's
    rows, and through ``_block_forward`` whole; with ``decode``, one token
    at ``POS`` against a random cache (the serving layout)."""
    cfg, params, mesh, specs, plan = _plan(arch, g, seed=5,
                                           serving=decode)
    placed = place_params(params, mesh, specs)
    whole, lp, ls = _layer0(params, placed, specs, kind)
    x = _x(cfg, 5, 1 if decode else S)
    xs = [_rows(mesh, x, s) for s in range(mesh.size)]
    if not decode:
        pos = torch.arange(S)[None, :]
        got, _ = plan.block(kind, lp, ls, xs, [pos] * mesh.size)
        want, _ = _block_forward(cfg, whole, x, pos, kind)
        return mesh, got, want, None, None
    cache = tp.cache(init_cache(cfg, B, S, dtype=torch.float32,
                                device="cpu"), 5)
    cspecs = cache_specs(cache, mesh, B)
    pc = place_cache(cache, mesh, B)
    count = next(x for _, x in _flatten(cache[kind])).shape[0]
    lc = _unstack(pc[kind], cspecs[kind], count)[0]
    plan.batch_entry = ("data",)
    posv = torch.full((1, 1), POS, dtype=torch.int32)
    got, nc = plan.block(kind, lp, ls, xs, [posv] * mesh.size, cache=lc,
                         cache_pos=POS, pos3=[None] * mesh.size)
    want, wc = _block_forward(cfg, whole, x, posv, kind,
                              cache=_index0(cache[kind]), cache_pos=POS)
    nc = {k: mesh.assemble(v, lc[1][k]) for k, v in nc.items()}
    return mesh, got, want, nc, wc


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("arch,kind", [("deepseek-v3-671b", "dense"),
                                       ("mamba2-2.7b", "ssm")])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_layer_over_model_matches_whole(g, arch, kind, decode):
    """MLA (deepseek's dense layer: MLA over heads, the dense FFN) and
    mamba2 over its heads, chunked and decode."""
    mesh, got, want, nc, wc = _block_case(arch, kind, g, decode)
    for s, y in enumerate(got):
        _close(y, _rows(mesh, want, s))
    if decode:
        assert sorted(nc) == sorted(wc)
        for k in nc:
            _close(nc[k], wc[k])
    if g > 1:
        _, one, _, nc1, _ = _block_case(arch, kind, 1, decode)
        assert all(torch.equal(a, b) for a, b in zip(got, one))
        if decode:
            assert all(torch.equal(nc[k], nc1[k]) for k in nc)


# -- the gathers of a train step --------------------------------------------
def _spy(monkeypatch, placed, specs):
    """Wrap ``ShardMesh.all_gather``: each call whose operand descends from
    a placed parameter leaf (by storage) records ``(leaf name, axes)``."""
    origin, seen, keep = {}, [], []
    for path, groups in _pairs(placed, specs):
        for t in groups:
            origin[t.untyped_storage().data_ptr()] = path[-1]
    real = ShardMesh.all_gather

    def all_gather(self, xs, axis, gather_axis, *, dim, tiled=False):
        out = real(self, xs, axis, gather_axis, dim=dim, tiled=tiled)
        name = origin.get(xs[0].untyped_storage().data_ptr())
        if name is not None:
            seen.append((name, spec_entry_axes(axis)))
            keep.append(out)              # no storage is reused meanwhile
            for o in out:
                origin[o.untyped_storage().data_ptr()] = name
        return out

    monkeypatch.setattr(ShardMesh, "all_gather", all_gather)
    return seen


def _pairs(tree, specs, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in _pairs(tree[k], specs[k], prefix + (k,))]
    return [(prefix, tree)] if isinstance(tree, tuple) else []


CASES = [(a, True) for a in ALL_ARCHS] + [
    (a, False) for a in ("moonshot-v1-16b-a3b", "deepseek-v3-671b")]


@pytest.mark.parametrize("arch,ep", CASES)
def test_no_tp_leaf_is_gathered_over_model(arch, ep, monkeypatch):
    cfg, params = tp.params(arch, seed=1)
    mesh = tp.mesh(2)
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                   StepConfig(optimizer=tp.OPT,
                                              expert_parallel=ep))
    specs = param_specs(structs[0], mesh)
    placed = place_params(params, mesh, specs)
    bt = place_batch(tp.batch(cfg, 1), mesh)
    seen = _spy(monkeypatch, placed, specs)
    loss, _ = fn.plan.loss_and_grads(placed, bt)
    assert torch.isfinite(loss)
    assert seen, "the spy saw no gather"
    over_model = {name for name, axes in seen if "model" in axes}
    assert not over_model & TP_LEAVES, sorted(over_model & TP_LEAVES)
    assert over_model <= GATHERED_WHOLE, sorted(over_model)
    if arch == "deepseek-v3-671b":
        assert "wdq" in over_model
    if cfg.is_ssm:
        assert {"conv_w", "conv_b"} <= over_model
