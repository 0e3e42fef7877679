"""The sequence-sharded layer carry of the partitioned train and prefill
steps (``StepConfig.seq_shard_acts``, the reference's Megatron sequence
parallelism: ``_constrain_maker`` in ``repro/launch/steps.py``).

Smoke configs of seven archs on a (2, 2) ``("data", "model")`` mesh on the
CPU, float32 params, inputs drawn with numpy from a seed
(``tests/torch_partitioned.py``): minicpm-2b (dense, TP), moonshot (MoE
under EP), deepseek-v3-671b (MLA, EP with a shared expert, MTP), zamba2-2.7b
(the hybrid stack), mamba2-2.7b, hubert-xlarge (frames in, no embed) and
qwen2-vl-72b (patch scatter, M-RoPE).  Held here:

* with the carry sharded against the same step without it: step 0's loss,
  the step's loss and the prefill logits bitwise (the forward sums the same
  stack: ``reduce_scatter`` and ``psum`` both ``torch.sum`` it over the
  mesh dims); every gradient within ``GRAD_TOL`` = 1e-5 of its leaf's
  largest magnitude, and so the new params and AdamW moments: the
  backward sums the shards' partial gradients at another point (the
  gather's reduce-scatter sums the normed input's partials before the
  norm's backward, where the psum's backward sums them after it), which
  moves float32 roundings (at most 1.9e-6 of a leaf's largest magnitude
  over these archs);
* G = 2 and 4 device groups bitwise with one group, the carry sharded;
* a spy on ``Partitioned.block`` and the mesh's collectives: between
  blocks each shard's carry is its ``[B/dp, S/m, D]`` block, gathered
  whole along S (``all_gather``) into each layer and reduce-scattered out;
* where ``model`` does not divide S the carry stays whole on every shard,
  bitwise with ``seq_shard_acts=False``.
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.core.mesh import ShardMesh, spec_entry_axes
from repro_torch.launch.sharding import (param_specs, place_batch,
                                         place_params)
from repro_torch.launch.steps import (StepConfig, build_prefill_step,
                                      build_train_step, logits_spec)
from repro_torch.models import ShapeCfg, moe_ep
from repro_torch.models.partitioned import Partitioned

import torch_partitioned as tp

torch.set_num_threads(1)

ARCHS = ["minicpm-2b", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "zamba2-2.7b", "mamba2-2.7b", "hubert-xlarge", "qwen2-vl-72b"]
B, S = tp.B, tp.S
SHAPE = (2, 2)
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _mesh(g):
    return tp.mesh(g, SHAPE)


def _step_cfg(sp):
    return StepConfig(optimizer=tp.OPT, seq_shard_acts=sp)


def _prefill(cfg, m, params, sp, pre):
    shape = ShapeCfg("p", S, B, "prefill")
    fn, structs = build_prefill_step(cfg, shape, m, _step_cfg(sp))
    out = fn(place_params(params, m, param_specs(structs[0], m)), pre)
    moe_ep.set_ep_mesh(None, ("data",))
    return m.assemble(out, logits_spec(cfg, shape, m))


def _run(arch, g, sp, steps=1):
    cfg, params = tp.params(arch, seed=3)
    got = tp.train(cfg, _mesh(g), params, tp.state(params, 3),
                   tp.batch(cfg, 3), steps=steps, step_cfg=_step_cfg(sp))
    got["logits"] = _prefill(cfg, _mesh(g), params, sp,
                             tp.batch(cfg, 4, kind="prefill"))
    return got


def _within(a, b, tol):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * max(float(y.float().abs().max()), 1e-30), \
            (path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_carry_matches_whole_carry(arch):
    on, off = _run(arch, 1, True), _run(arch, 1, False)
    assert torch.equal(on["loss0"], off["loss0"])
    assert torch.equal(on["losses"][0], off["losses"][0])
    assert torch.equal(on["logits"], off["logits"])
    _within(on["grads"], off["grads"], GRAD_TOL)
    _within(on["params"], off["params"], GRAD_TOL)
    for k in ("m", "v"):
        _within(on["state"][k], off["state"][k], GRAD_TOL)


@pytest.mark.parametrize("arch,g", [(a, g) for a in (
    "minicpm-2b", "moonshot-v1-16b-a3b", "zamba2-2.7b") for g in (2, 4)])
def test_sharded_carry_groups_bitwise(arch, g):
    one, grouped = _run(arch, 1, True, steps=2), _run(arch, g, True, steps=2)
    assert torch.equal(grouped["loss0"], one["loss0"])
    assert torch.equal(torch.stack(grouped["losses"]),
                       torch.stack(one["losses"]))
    assert torch.equal(grouped["logits"], one["logits"])
    for k in ("grads", "params", "state"):
        tp.same_trees(grouped[k], one[k])


def _spy(monkeypatch, cfg):
    """Record each block's output carry shapes, and each all-gather and
    reduce-scatter of a carry-shaped value (``[B/dp, s, D]`` a shard) along
    S over ``model``: (kind, operand shape, result shape) a shard."""
    seen = dict(carry=[], coll=[])
    real_block = Partitioned.block

    def block(self, *args, **kw):
        xs, nc = real_block(self, *args, **kw)
        seen["carry"].append({tuple(x.shape) for x in xs})
        return xs, nc
    monkeypatch.setattr(Partitioned, "block", block)

    def record(kind, xs, axes, along, out):
        x = xs[0][0]
        if along == 1 and spec_entry_axes(axes) == ("model",) \
                and x.dim() == 3 and x.shape[0] == B // SHAPE[0] \
                and x.shape[-1] == cfg.d_model:
            seen["coll"].append((kind, tuple(x.shape),
                                 tuple(out[0][0].shape)))
        return out
    gather, scatter = ShardMesh.all_gather, ShardMesh.reduce_scatter
    monkeypatch.setattr(
        ShardMesh, "all_gather",
        lambda self, xs, axes, along, *, dim, tiled=False: record(
            "all_gather", xs, axes, along,
            gather(self, xs, axes, along, dim=dim, tiled=tiled)))
    monkeypatch.setattr(
        ShardMesh, "reduce_scatter",
        lambda self, xs, axes, along, *, dim, tiled=True: record(
            "reduce_scatter", xs, axes, along,
            scatter(self, xs, axes, along, dim=dim, tiled=tiled)))
    return seen


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-2.7b",
                                  "hubert-xlarge"])
def test_carry_between_blocks_is_the_sequence_block(arch, monkeypatch):
    cfg, params = tp.params(arch, seed=5)
    m = _mesh(2)
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), m,
                                   _step_cfg(True))
    placed = place_params(params, m, param_specs(structs[0], m))
    bt = place_batch(tp.batch(cfg, 5), m)
    seen = _spy(monkeypatch, cfg)
    loss, _ = fn.plan.loss_and_grads(placed, bt)
    assert torch.isfinite(loss)
    dp, msize = SHAPE
    blk = (B // dp, S // msize, cfg.d_model)
    # every block, recomputed ones included, hands on the block
    assert seen["carry"] and all(c == {blk} for c in seen["carry"])
    whole = (B // dp, S, cfg.d_model)
    gathers = [c for c in seen["coll"] if c[0] == "all_gather"]
    scatters = [c for c in seen["coll"] if c[0] == "reduce_scatter"]
    assert gathers and all(c[1:] == (blk, whole) for c in gathers)
    assert scatters and all(c[1:] == (whole, blk) for c in scatters)


def test_whole_carry_where_model_does_not_divide_s(monkeypatch):
    """S = 6 on a 4-way ``model`` axis (the (2, 4) mesh): the reference's
    rule leaves the carry whole, and the step is bitwise the one with
    ``seq_shard_acts=False``."""
    cfg, params = tp.params("minicpm-2b", seed=7)
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 7))
                            .astype(np.int32))
    bt = dict(tokens=toks[:, :-1].contiguous(),
              labels=toks[:, 1:].contiguous())
    m = tp.mesh(2)
    runs = []
    for sp in (True, False):
        fn, structs = build_train_step(cfg, ShapeCfg("t", 6, B, "train"), m,
                                       _step_cfg(sp))
        assert not fn.plan.seq_sharded(6) and fn.plan.seq_sharded(8) == sp
        ps = param_specs(structs[0], m)
        seen = _spy(monkeypatch, cfg)
        loss, grads = fn.plan.loss_and_grads(place_params(params, m, ps),
                                             place_batch(bt, m))
        assert not seen["coll"]
        runs.append((loss, grads))
        monkeypatch.undo()
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2)
    tp.same_trees(g1, g2)
