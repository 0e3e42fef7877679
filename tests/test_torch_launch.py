"""The port's sharding rules and abstract inputs (``repro_torch/launch/
{mesh,sharding,steps}.py``) against the JAX package's.

Held here, at the published sizes of all ten archs: every param, batch and
cache spec equals the reference's ``PartitionSpec`` as a tuple, on the
single-pod (data 16, model 16) and multi-pod (pod 2, data 16, model 16)
meshes, with the EP mesh set and unset; ``sanitize_spec`` on the
reference's cases; ``batch_struct`` shapes and dtypes; and
``abstract_params``, ``abstract_opt_state`` and ``abstract_cache`` (meta
tensors) against ``jax.eval_shape``, tree for tree.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as jax_arch
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.models import SHAPES as J_SHAPES
from repro.models import moe_ep as jmoe
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_arch
from repro_torch.launch import sharding, steps
from repro_torch.launch.mesh import (MeshSpec, dp_axes, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import SHAPE_BY_NAME, cell_is_applicable, moe_ep
from repro_torch.optim import AdamWConfig

ARCHS = sorted(J_ARCHS)
MESHES = {"sp": {"data": 16, "model": 16},
          "mp": {"pod": 2, "data": 16, "model": 16}}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))
    jmoe.set_ep_mesh(None, ("data",))


def _jleaves(tree):
    """[(path, leaf)] of a JAX tree, leaves that are specs kept whole."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _pleaves(tree):
    return sharding._walk(tree)


def _norm(spec):
    """A spec as ``PartitionSpec`` compares it: a one-name tuple entry is
    that name (JAX's ``P(("data",))`` equals ``P("data")``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same_specs(port_tree, jax_tree):
    got, want = _pleaves(port_tree), _jleaves(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert _norm(g) == _norm(w), (path, g, w)


def _same_structs(port_tree, jax_tree):
    got, want = _pleaves(port_tree), _jleaves(jax_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.is_meta, path
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == DTYPES[str(w.dtype)], path


def test_sanitize_drops_nondividing_axes():
    mesh = MeshSpec({"data": 16, "model": 16})
    assert sharding.sanitize_spec(("model", "data"), (122753, 2304), mesh) \
        == (None, "data")
    assert sharding.sanitize_spec((("data", "model"), None), (256, 4),
                                  mesh) == (("data", "model"), None)
    # tuple entries shrink to their largest dividing prefix
    assert sharding.sanitize_spec((("data", "model"),), (16,), mesh) \
        == (("data",),)
    for spec, shape in ((("model", "data"), (122753, 2304)),
                        ((("data", "model"), None), (256, 4)),
                        ((("data", "model"),), (16,)),
                        (("model",), (48, 7))):
        assert _norm(sharding.sanitize_spec(spec, shape, mesh)) == _norm(
            jsh.sanitize_spec(P(*spec), shape, mesh))


def test_meshes():
    sp, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (sp.shape, sp.size, dp_axes(sp)) == (
        {"data": 16, "model": 16}, 256, ("data",))
    assert (mp.axis_names, mp.size, dp_axes(mp)) == (
        ("pod", "data", "model"), 512, ("pod", "data"))
    host = make_host_mesh(model=4, data=2, device="cpu")
    assert (host.shape, host.axis_names) == ((2, 4), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jsteps.abstract_params(jax_arch(arch))


@pytest.mark.parametrize("ep", [False, True], ids=["dense", "ep"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, ep):
    m = MeshSpec(MESHES[mesh])
    moe_ep.set_ep_mesh(m if ep else None, dp_axes(m))
    jmoe.set_ep_mesh(m if ep else None, dp_axes(m))
    got = sharding.param_specs(steps.abstract_params(get_arch(arch)), m)
    _same_specs(got, jsh.param_specs(_jax_params(arch), m))


CELLS = [(a, s.name) for a in ARCHS for s in J_SHAPES
         if cell_is_applicable(get_arch(a), SHAPE_BY_NAME[s.name])[0]]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_specs_match_reference(arch, shape, mesh):
    m = MeshSpec(MESHES[mesh])
    cfg, jcfg, sh = get_arch(arch), jax_arch(arch), SHAPE_BY_NAME[shape]
    gb = sh.global_batch
    batch, jbatch = steps.batch_struct(cfg, sh), jsteps.batch_struct(jcfg, sh)
    _same_structs(batch, jbatch)
    _same_specs(sharding.batch_specs(batch, m, gb),
                jsh.batch_specs(jbatch, m, gb))
    if sh.kind == "decode":
        cache, jcache = steps.abstract_cache(cfg, sh), \
            jsteps.abstract_cache(jcfg, sh)
        _same_structs(cache, jcache)
        _same_specs(sharding.cache_specs(cache, m, gb),
                    jsh.cache_specs(jcache, m, gb))
        assert _norm(steps.logits_spec(cfg, sh, m, decode=True)) == _norm(
            jsteps._logits_spec(jcfg, sh, m, decode=True))
    else:
        assert _norm(steps.logits_spec(cfg, sh, m)) == _norm(
            jsteps._logits_spec(jcfg, sh, m))


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "hubert-xlarge",
                                  "granite-34b"])
def test_batch_struct_fields(arch):
    cfg = get_arch(arch)
    b = steps.batch_struct(cfg, SHAPE_BY_NAME["train_4k"])
    if cfg.frontend == "audio":
        assert b["frames"].shape[-1] == cfg.d_model
        assert b["frames"].dtype == torch.bfloat16
    else:
        assert b["tokens"].shape == (256, 4096)
        assert b["tokens"].dtype == torch.int32
    if cfg.frontend == "vision":
        assert b["patch_embeds"].shape == (256, steps.N_PATCHES, cfg.d_model)
        assert "pos3" in b
    d = steps.batch_struct(cfg, SHAPE_BY_NAME["decode_32k"])
    assert d["tokens"].shape == (128, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_eval_shape(arch):
    cfg, jcfg = get_arch(arch), jax_arch(arch)
    _same_structs(steps.abstract_params(cfg), _jax_params(arch))
    for st, jst in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        opt = steps.abstract_opt_state(cfg, AdamWConfig(state_dtype=st))
        jopt = jsteps.abstract_opt_state(jcfg, JAdamWConfig(state_dtype=jst))
        _same_structs(opt, jopt)
    assert steps.StepConfig().optimizer.state_dtype == torch.bfloat16


def test_step_config_defaults_match_reference():
    got, want = steps.StepConfig(), jsteps.StepConfig()
    for f in ("remat", "seq_shard_acts", "expert_parallel",
              "serving_head_pad", "kv_chunk"):
        assert getattr(got, f) == getattr(want, f), f


def test_param_shardings_pair_specs_with_mesh():
    m = make_production_mesh()
    params = steps.abstract_params(get_arch("minicpm-2b"))
    pairs = _pleaves(sharding.param_shardings(params, m))
    specs = _pleaves(sharding.param_specs(params, m))
    assert [p for p, _ in pairs] == [p for p, _ in specs]
    assert all(mm is m and s == spec for (_, (mm, s)), (_, spec)
               in zip(pairs, specs))
    # per-device bytes: the embed [vocab, D] shards D over data only
    # (122,753 rows do not divide the model axis)
    e = params["embed"]
    assert sharding.spec_bytes(e, (None, ("data",)), m) == \
        e.numel() * 2 / 16
