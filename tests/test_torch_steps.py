"""The port's step builders (``repro_torch/launch/steps.py``) against the JAX
package's ``build_step`` (``repro/launch/steps.py``).

Both packages get the same params (the JAX init, converted), the same
AdamW state (``convert.opt_state_to_torch``) and the same batch and caches
(numpy, from a seed).  JAX compiles its step on a (1, 1) ``("data",
"model")`` mesh with Auto axes (the installed JAX makes explicit axes by
default, which its sequence-sharding constraint does not take); the port
runs on ``make_host_mesh(device="cpu")``, a (1, 1) ``ShardMesh``.  On that
mesh both engage expert parallelism with one shard, so the MoE arch runs
the EP path in both.

Held for a dense (granite-34b), an MoE (moonshot-v1-16b-a3b) and an SSM
(mamba2-2.7b) smoke arch, float32 params: the train step's loss, new
params and optimizer state (float32 state: within 1e-4 of each leaf's
largest magnitude; the default bf16 state: ``m`` and ``v`` norm-relative
within 2e-2, the reference's bf16 bar), the prefill's logits and the
decode step's logits and caches (1e-4 of the largest magnitude).  And
``build_decode_step`` on ``MeshSpec({"data": 1, "model": 16})`` pads a
36-head MHA config (minicpm-2b's head count) to 48 heads: its logits match
the unpadded JAX decode within rtol = atol = 2e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.launch import steps as jsteps
from repro.models import ShapeCfg as JShapeCfg
from repro.models import decode_step as jax_decode
from repro.models import init_params as jax_init
from repro.models import moe_ep as jmoe
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_arch
from repro_torch.convert import opt_state_to_torch, params_to_torch
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshSpec, make_host_mesh
from repro_torch.models import ShapeCfg, moe_ep
from repro_torch.models.serving import pad_params_for_serving
from repro_torch.optim import AdamWConfig

from torch_models import make_batch, max_rel, norm_rel

torch.set_num_threads(1)

ARCHS = ["granite-34b", "moonshot-v1-16b-a3b", "mamba2-2.7b"]
B, S = 2, 32
TOL = 1e-4
BF16_TOL = 2e-2
STATE = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))
    jmoe.set_ep_mesh(None, ("data",))


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = jax_arch(arch).smoke()
    return jax.tree_util.tree_map(
        np.asarray, jax_init(cfg, jax.random.key(0), dtype=jnp.float32))


def _state(params, dt, seed=0):
    """A nonzero AdamW state mid-run (step 3,000: past the WSD warmup)."""
    rng = np.random.default_rng(seed)
    jdt = STATE[dt][0]
    m = jax.tree_util.tree_map(lambda p: np.asarray(jnp.asarray(
        rng.normal(0, 1e-3, p.shape).astype(np.float32), jdt)), params)
    v = jax.tree_util.tree_map(lambda p: np.asarray(jnp.asarray(
        rng.uniform(0, 1e-5, p.shape).astype(np.float32), jdt)), params)
    return dict(m=m, v=v, step=np.asarray(3000, np.int32))


def _np(t):
    return t.detach().float().numpy()


def _close_trees(got, want, bar):
    got = _flatten(got)
    want = _flatten(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), want))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        bar(_np(g), w, path)


def _max_rel_bar(g, w, path):
    assert max_rel(g, w) <= TOL, (path, max_rel(g, w))


def _norm_bar(g, w, path):
    assert norm_rel(g, w) <= BF16_TOL, (path, norm_rel(g, w))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, dt):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    params = _params(arch)
    state = _state(params, dt)
    batch = make_batch(cfg, np.random.default_rng(1))
    jdt, tdt = STATE[dt]
    mesh = _jax_mesh()
    with mesh:
        jfn, _ = jsteps.build_step(
            jcfg, JShapeCfg("t", S, B, "train"), mesh,
            jsteps.StepConfig(optimizer=JAdamWConfig(state_dtype=jdt)))
        jp, js, jloss = jfn(jax.tree_util.tree_map(jnp.asarray, params),
                            jax.tree_util.tree_map(jnp.asarray, state),
                            jax.tree_util.tree_map(jnp.asarray, batch))
    fn, structs = steps.build_step(
        cfg, ShapeCfg("t", S, B, "train"), make_host_mesh(device="cpu"),
        steps.StepConfig(optimizer=AdamWConfig(state_dtype=tdt)))
    assert (moe_ep.get_ep_mesh() is not None) == cfg.is_moe
    tp, ts, loss = fn(params_to_torch(params, "cpu"),
                      opt_state_to_torch(state, "cpu"),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    _close_trees(tp, jp, _max_rel_bar)
    state_bar = _max_rel_bar if dt == "f32" else _norm_bar
    for k in ("m", "v"):
        assert all(x.dtype == tdt for _, x in _flatten(ts[k]))
        _close_trees(ts[k], js[k], state_bar)
    assert int(ts["step"]) == int(js["step"]) == 3001
    # the structs are the reference's abstract inputs, on meta
    assert all(x.is_meta for _, x in _flatten(structs))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    params = _params(arch)
    rng = np.random.default_rng(2)
    batch = make_batch(cfg, rng)
    batch.pop("labels")
    mesh = _jax_mesh()
    with mesh:
        jfn, _ = jsteps.build_step(jcfg, JShapeCfg("p", S, B, "prefill"),
                                   mesh)
        jlogits = jfn(jax.tree_util.tree_map(jnp.asarray, params),
                      jax.tree_util.tree_map(jnp.asarray, batch))
    fn, _ = steps.build_step(cfg, ShapeCfg("p", S, B, "prefill"),
                             make_host_mesh(device="cpu"))
    logits = fn(params_to_torch(params, "cpu"),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    assert max_rel(_np(logits), np.asarray(jlogits, np.float32)) <= TOL

    # decode at position 5 of a 32-deep cache holding random history
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    with mesh:
        jfn, (_, jcache_s, _, _) = jsteps.build_step(
            jcfg, JShapeCfg("d", S, B, "decode"), mesh)
        cache = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
            jcache_s)
        jl, jc = jfn(jax.tree_util.tree_map(jnp.asarray, params),
                     jax.tree_util.tree_map(jnp.asarray, cache),
                     jnp.asarray(tokens), jnp.int32(5))
    fn, _ = steps.build_step(cfg, ShapeCfg("d", S, B, "decode"),
                             make_host_mesh(device="cpu"))
    tl, tc = fn(params_to_torch(params, "cpu"),
                params_to_torch(cache, "cpu"), torch.from_numpy(tokens), 5)
    assert max_rel(_np(tl), np.asarray(jl, np.float32)) <= TOL
    _close_trees(tc, jc, _max_rel_bar)


def test_padded_decode_matches_unpadded_reference():
    """minicpm-2b's 36 MHA heads on a 16-way model axis: padded to 48."""
    jcfg = dataclasses.replace(jax_arch("minicpm-2b").smoke(), n_heads=36,
                               n_kv_heads=36)
    cfg = dataclasses.replace(get_arch("minicpm-2b").smoke(), n_heads=36,
                              n_kv_heads=36)
    params = jax.tree_util.tree_map(
        np.asarray, jax_init(jcfg, jax.random.key(3), dtype=jnp.float32))
    rng = np.random.default_rng(3)
    shape = ShapeCfg("d", S, B, "decode")
    fn, (params_s, cache_s, tok_s, pos_s) = steps.build_decode_step(
        cfg, shape, MeshSpec({"data": 1, "model": 16}),
        steps.StepConfig(serving_head_pad=True))
    padded_wq = params_s["stacks"]["dense"]["attn"]["wq"]
    assert padded_wq.shape[-2] == 48 and padded_wq.is_meta
    assert cache_s["dense"]["k"].shape[-2] == 48
    assert (tok_s.shape, pos_s.shape, pos_s.dtype) == ((B, 1), (),
                                                       torch.int32)

    # history in the 36 real heads; the padded heads' cache is zero
    hist = (rng.normal(size=(cfg.n_layers, B, S, 36, cfg.hd)) * 0.1
            ).astype(np.float32)
    jcache = dict(dense=dict(k=hist, v=hist[::-1].copy()))
    tokens = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    jl, _ = jax_decode(jcfg, jax.tree_util.tree_map(jnp.asarray, params),
                       jax.tree_util.tree_map(jnp.asarray, jcache),
                       jnp.asarray(tokens), jnp.int32(7))
    pad = np.zeros(hist.shape[:3] + (12, cfg.hd), np.float32)
    tcache = dict(dense=dict(
        k=torch.from_numpy(np.concatenate([hist, pad], axis=3)),
        v=torch.from_numpy(np.concatenate([hist[::-1], pad], axis=3))))
    pp = pad_params_for_serving(
        cfg, dataclasses.replace(cfg, n_heads=48, n_kv_heads=48,
                                 head_dim=cfg.hd),
        params_to_torch(params, "cpu"))
    tl, tc = fn(pp, tcache, torch.from_numpy(tokens), 7)
    assert tc["dense"]["k"].shape[-2] == 48
    np.testing.assert_allclose(_np(tl), np.asarray(jl, np.float32),
                               rtol=2e-4, atol=2e-4)
