"""The partitioned train, prefill and decode steps (``launch/steps.py`` over
``models/partitioned.py``) for the six archs ``tests/test_torch_partitioned.
py`` does not hold, on its cases: deepseek-v3-671b (MLA, MoE with a
shared expert under EP, MTP), zamba2-2.7b (the hybrid stack: mamba2 over
its heads, the shared attention block, its decode cache), qwen2-vl-72b
(M-RoPE, patch embeddings, q/k/v biases), nemotron-4-15b (relu2),
qwen1.5-110b (q/k/v biases) and hubert-xlarge (encoder, frames in, no
decode); smoke configs on a (2, 4) ``("data", "model")`` mesh of G device
groups on the CPU, float32 params.  Held here:

* placement round trip (G = 4) and bytes at rest equal to
  ``per_device_bytes`` (G = 8, one shard a group);
* G = 2 and 4 bitwise with G = 1: step 0's loss and gradients, three train
  steps, the prefill logits, the decode logits and new caches;
* within 1e-4 of each leaf's largest magnitude of the port's unpartitioned
  step (the one-device program; deepseek's MoE the same mesh with whole
  params, whose EP drops the same choices): loss, gradients, one step's
  params and AdamW state, prefill and decode;
* zamba2's decode cache rests exactly as the reference's ``cache_specs``
  places it: the shared attention's ``k``/``v`` with the batch whole, the
  sequence on ``data`` and ``hd`` on ``model``;
* without EP both MoE archs' routed experts run dropless over ``model``:
  bitwise with one group, within 1e-4 of the unpartitioned dropless step.
"""
import numpy as np
import pytest
import torch

from repro.launch import sharding as jax_sharding
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.sharding import (cache_specs, gather_params,
                                         param_specs, per_device_bytes,
                                         place_cache,
                                         place_params)
from repro_torch.launch.steps import (StepConfig, abstract_cache,
                                      build_decode_step, build_train_step)
from repro_torch.models import ShapeCfg, moe_ep
from repro_torch.optim import adamw_init

import torch_partitioned as tp

torch.set_num_threads(1)

ARCHS = tp.ARCHS_B
B, S = tp.B, tp.S


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _tokens(cfg, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))
                            .astype(np.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_place_and_gather_round_trip(arch):
    cfg, params = tp.params(arch)
    mesh = tp.mesh(4)
    _, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                  StepConfig(optimizer=tp.OPT))
    for tree, specs in ((params, param_specs(structs[0], mesh)),
                        (tp.state(params), param_specs(structs[1], mesh))):
        placed = place_params(tree, mesh, specs)
        for path, leaf in _flatten(placed):
            if path[-1] != "step":
                assert leaf.shape[0] == mesh.per_group
        tp.same_trees(gather_params(placed, mesh, specs), tree)
    moe_ep.set_ep_mesh(None, ("data",))
    if cfg.encoder_only:
        return
    _, (_, cs, _, _) = build_decode_step(cfg, ShapeCfg("d", S, B, "decode"),
                                         mesh)
    cache = tp.cache(cs)
    placed = place_cache(cache, mesh, B)
    tp.same_trees(gather_params(placed, mesh, cache_specs(cs, mesh, B)),
                  cache)


@pytest.mark.parametrize("arch", ARCHS)
def test_bytes_at_rest_equal_per_device_bytes(arch):
    cfg, params = tp.params(arch)
    mesh = tp.mesh(8)
    _, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                  StepConfig(optimizer=tp.OPT))
    st = adamw_init(params, tp.OPT)
    for tree, ss in ((params, structs[0]), (st["m"], structs[1]["m"]),
                     (st["v"], structs[1]["v"])):
        specs = param_specs(ss, mesh)
        want = per_device_bytes(tree, specs, mesh)
        got = [0] * 8
        for path, x in _flatten(place_params(tree, mesh, specs)):
            got[int(path[-1])] += x.numel() * x.element_size()
        assert got == [want] * 8
        assert want < sum(x.numel() * x.element_size()
                          for _, x in _flatten(tree))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_bitwise_with_one_group(arch, g):
    cfg, params = tp.params(arch, seed=7)
    st, bt = tp.state(params, 7), tp.batch(cfg, 7)
    one = tp.train(cfg, tp.mesh(1), params, st, bt, steps=3)
    got = tp.train(cfg, tp.mesh(g), params, st, bt, steps=3)
    assert torch.equal(got["loss0"], one["loss0"])
    tp.same_trees(got["grads"], one["grads"])
    assert torch.equal(torch.stack(got["losses"]), torch.stack(one["losses"]))
    tp.same_trees(got["params"], one["params"])
    tp.same_trees(got["state"], one["state"])
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        _flatten(got["params"]), _flatten(params))) > 1e-4   # it moved


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_bitwise_with_one_group(arch, g):
    cfg, params = tp.params(arch, seed=9)
    pre, tok1 = tp.batch(cfg, 9, "prefill"), _tokens(cfg, 9)
    one = tp.serve(cfg, tp.mesh(1), params, pre, tok1, 9)
    got = tp.serve(cfg, tp.mesh(g), params, pre, tok1, 9)
    assert torch.equal(got[0], one[0])
    if not cfg.encoder_only:
        assert torch.equal(got[1], one[1])
        tp.same_trees(got[2], one[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_unpartitioned(arch):
    cfg, params = tp.params(arch, seed=11)
    st, bt = tp.state(params, 11), tp.batch(cfg, 11)
    loss, grads, p1, s1, loss1 = tp.whole_step(cfg, params, st, bt)
    got = tp.train(cfg, tp.mesh(2), params, st, bt, steps=1)
    assert abs(float(got["loss0"]) - float(loss)) <= tp.TOL * float(loss)
    assert abs(float(got["losses"][0]) - float(loss1)) <= tp.TOL * float(
        loss1)
    tp.close_trees(got["grads"], grads)
    tp.close_trees(got["params"], p1)
    tp.close_trees(got["state"]["m"], s1["m"])
    tp.close_trees(got["state"]["v"], s1["v"])
    assert int(got["state"]["step"]) == int(s1["step"]) == 3001


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_unpartitioned(arch):
    cfg, params = tp.params(arch, seed=15)
    pre, tok1 = tp.batch(cfg, 15, "prefill"), _tokens(cfg, 15)
    want = tp.serve(cfg, tp.unpartitioned_mesh(cfg), params, pre, tok1, 15)
    got = tp.serve(cfg, tp.mesh(2), params, pre, tok1, 15)
    tp.close_trees(got[0], want[0])
    if not cfg.encoder_only:
        tp.close_trees(got[1], want[1])
        tp.close_trees(got[2], want[2])


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [i for k in sorted(tree)
                for i in _spec_leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def test_hybrid_cache_rests_as_the_reference_places_it():
    """zamba2's decode cache specs against the reference's ``cache_specs``
    (entry by entry, ``"data"`` equated with ``("data",)``), the quirk
    spelled out, and the placed blocks' shapes at G = 8."""
    import jax
    cfg = tp.params("zamba2-2.7b")[0]
    dshape = ShapeCfg("d", S, B, "decode")
    structs = abstract_cache(cfg, dshape)
    spec_mesh = MeshSpec({"data": 2, "model": 4})
    got = cache_specs(structs, spec_mesh, B)
    want = jax_sharding.cache_specs(jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(tuple(x.shape), np.float32), structs),
        spec_mesh, B)
    gl = _spec_leaves(got)
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [tuple(k.key for k in p) for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        assert [_axes(e) for e in a] == [_axes(e) for e in b], path
    k = got["hybrid_group"]["attn"]["k"]       # [count, B, S, hkv, hd]
    assert [_axes(e) for e in k] == [(), (), ("data",), (), ("model",)]
    mesh = tp.mesh(8)
    cache = tp.cache(structs)
    placed = place_cache(cache, mesh, B)
    n, hkv, hd = structs["hybrid_group"]["attn"]["k"].shape[0], \
        cfg.n_kv_heads, cfg.hd
    for grp in placed["hybrid_group"]["attn"]["k"]:
        assert tuple(grp.shape) == (1, n, B, S // 2, hkv, hd // 4)
    conv = placed["hybrid_group"]["ssm"]["conv"][0]
    assert conv.shape[3] == B // 2 and conv.shape[-1] == (
        cfg.d_inner + 2 * cfg.ssm_state) // 4
    want_bytes = per_device_bytes(cache, got, spec_mesh)
    for g in range(8):
        assert sum(x.numel() * x.element_size() for p, x in _flatten(placed)
                   if int(p[-1]) == g) == want_bytes


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_dropless_train_step(arch):
    """Without EP (``expert_parallel=False``) the routed experts run the
    dropless layer over each shard's own experts: step 0 and one step with
    G = 2 bitwise with G = 1, and within 1e-4 of the unpartitioned
    dropless step."""
    cfg, params = tp.params(arch, seed=13)
    st, bt = tp.state(params, 13), tp.batch(cfg, 13)
    sc = StepConfig(optimizer=tp.OPT, expert_parallel=False)
    one = tp.train(cfg, tp.mesh(1), params, st, bt, 1, sc)
    got = tp.train(cfg, tp.mesh(2), params, st, bt, 1, sc)
    assert torch.equal(got["loss0"], one["loss0"])
    tp.same_trees(got["grads"], one["grads"])
    tp.same_trees(got["params"], one["params"])
    loss, grads, p1, s1, loss1 = tp.whole_step(cfg, params, st, bt, sc)
    assert abs(float(got["loss0"]) - float(loss)) <= tp.TOL * float(loss)
    tp.close_trees(got["grads"], grads)
    tp.close_trees(got["params"], p1)
