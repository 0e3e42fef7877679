"""The port's partitioned steps against the reference's own: the JAX
package's ``build_step`` jitted with its ``in_shardings`` on a (2, 4)
``("data", "model")`` mesh of Auto axes over 8 forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``), computed once for
the module in a subprocess (about 10-20 s an arch).

For the smoke configs of minicpm-2b (MHA), granite-34b (MQA), moonshot-v1-
16b-a3b (MoE: both packages run EP over the 8 shards and drop the same
choices) and mamba2-2.7b (SSM), float32 params from the JAX init
(converted), the same mid-run float32 AdamW state, batch, decode cache and
tokens: the port's steps on the same mesh in two device groups on the CPU
(``devices=["cpu"] * 2``), the params, state, batch and cache placed by
the specs.  Held within 1e-4 of each leaf's largest magnitude: the train
step's loss, new params and AdamW moments; the prefill logits; the decode
logits and new caches (the serving layout, heads padded for the model
axis: granite's one kv head replicated to 4).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import (cache_specs, gather_params,
                                         param_specs, place_params)
from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                      build_prefill_step, build_train_step,
                                      logits_spec)
from repro_torch.models import ShapeCfg, meta_params, moe_ep
from repro_torch.models.serving import serving_padded
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["minicpm-2b", "granite-34b", "moonshot-v1-16b-a3b", "mamba2-2.7b"]
B, S, POS = 8, 16, 5
TOL = 1e-4

WORKER = r'''import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import time
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_arch
from repro.launch import steps
from repro.models import ShapeCfg, init_params, moe_ep
from repro.models.serving import pad_params_for_serving, serving_padded
from repro.optim import AdamWConfig
from repro_torch.ckpt.checkpoint import _flatten

B, S, POS = 8, 16, 5
out, archs = sys.argv[1], sys.argv[2:]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
f32 = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
for arch in archs:
    t0 = time.time()
    cfg = get_arch(arch).smoke()
    params = f32(init_params(cfg, jax.random.key(0), dtype=jnp.float32))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
    state = dict(
        m=jax.tree_util.tree_map(lambda p: rng.normal(0, 1e-3, p.shape)
                                 .astype(np.float32), params),
        v=jax.tree_util.tree_map(lambda p: rng.uniform(0, 1e-5, p.shape)
                                 .astype(np.float32), params),
        step=np.asarray(3000, np.int32))
    tok1 = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    res = {}
    with mesh:
        fn, _ = steps.build_step(cfg, ShapeCfg("t", S, B, "train"), mesh,
                                 steps.StepConfig(optimizer=AdamWConfig(
                                     state_dtype=jnp.float32)))
        p1, s1, loss = fn(jax.tree_util.tree_map(jnp.asarray, params),
                          jax.tree_util.tree_map(jnp.asarray, state),
                          jax.tree_util.tree_map(jnp.asarray, batch))
        res.update(loss=np.asarray(loss), p1=f32(p1), m1=f32(s1["m"]),
                   v1=f32(s1["v"]))
        fn, _ = steps.build_step(cfg, ShapeCfg("p", S, B, "prefill"), mesh)
        res["logits"] = np.asarray(fn(jax.tree_util.tree_map(
            jnp.asarray, params), dict(tokens=jnp.asarray(batch["tokens"]))),
            np.float32)
        fn, (_, cache_s, _, _) = steps.build_step(
            cfg, ShapeCfg("d", S, B, "decode"), mesh)
        padded = serving_padded(cfg, 4)
        pp = f32(pad_params_for_serving(cfg, padded, params))
        cache = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s.shape) * 0.1).astype(np.float32),
            cache_s)
        dl, dc = fn(jax.tree_util.tree_map(jnp.asarray, pp),
                    jax.tree_util.tree_map(jnp.asarray, cache),
                    jnp.asarray(tok1), jnp.int32(POS))
        res.update(dlogits=np.asarray(dl, np.float32), dcache=f32(dc))
    moe_ep.set_ep_mesh(None, ("data",))
    flat = {"/".join(p): np.asarray(x) for p, x in _flatten(dict(
        params=params, state=state, batch=batch, tok1=tok1,
        padded=pp, cache=cache, **res))}
    np.savez(os.path.join(out, arch + ".npz"), **flat)
    print(arch, "REF_OK", round(time.time() - t0, 1), flush=True)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("partitioned_ref")
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script), str(out)] + ARCHS,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0 and proc.stdout.count("REF_OK") == len(
        ARCHS), proc.stderr[-3000:]
    return {a: dict(np.load(out / f"{a}.npz")) for a in ARCHS}


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _tree(z, prefix, like):
    return _unflatten(like, iter(torch.from_numpy(
        z[prefix + "/" + "/".join(p)]) for p, _ in _flatten(like)))


def _close(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * float(want.abs().max()), (what, err)


def _mesh():
    return ShardMesh((2, 4), ("data", "model"), devices=["cpu"] * 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, reference):
    z = reference[arch]
    cfg = get_arch(arch).smoke()
    like = meta_params(cfg, torch.float32)
    params = _tree(z, "params", like)
    state = dict(m=_tree(z, "state/m", like), v=_tree(z, "state/v", like),
                 step=torch.tensor(3000, dtype=torch.int32))
    batch = {k: torch.from_numpy(z[f"batch/{k}"]) for k in ("tokens",
                                                           "labels")}
    mesh = _mesh()
    fn, (ps_, ss_, _) = build_train_step(
        cfg, ShapeCfg("t", S, B, "train"), mesh,
        StepConfig(optimizer=AdamWConfig(state_dtype=torch.float32)))
    ps, ss = param_specs(ps_, mesh), param_specs(ss_, mesh)
    p1, s1, loss = fn(place_params(params, mesh, ps),
                      place_params(state, mesh, ss), batch)
    want = float(z["loss"])
    assert abs(float(loss) - want) <= TOL * abs(want)
    p1, s1 = gather_params(p1, mesh, ps), gather_params(s1, mesh, ss)
    for name, tree in (("p1", p1), ("m1", s1["m"]), ("v1", s1["v"])):
        for path, x in _flatten(tree):
            key = name + "/" + "/".join(path)
            _close(x, torch.from_numpy(z[key]), key)
    assert int(s1["step"]) == 3001


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, reference):
    z = reference[arch]
    cfg = get_arch(arch).smoke()
    mesh = _mesh()
    pshape, dshape = (ShapeCfg("p", S, B, "prefill"),
                      ShapeCfg("d", S, B, "decode"))
    fn, (pst, _) = build_prefill_step(cfg, pshape, mesh)
    params = _tree(z, "params", pst)
    logits = fn(place_params(params, mesh, param_specs(pst, mesh)),
                dict(tokens=torch.from_numpy(z["batch/tokens"])))
    _close(mesh.assemble(logits, logits_spec(cfg, pshape, mesh)),
           torch.from_numpy(z["logits"]), "prefill logits")
    moe_ep.set_ep_mesh(None, ("data",))
    fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, mesh)
    padded = _tree(z, "padded", pst)
    cache = _tree(z, "cache", cst)
    dl, dc = fn(place_params(padded, mesh, param_specs(pst, mesh)), cache,
                torch.from_numpy(z["tok1"]), POS)
    _close(mesh.assemble(dl, logits_spec(serving_padded(cfg, 4), dshape,
                                         mesh, decode=True)),
           torch.from_numpy(z["dlogits"]), "decode logits")
    for path, x in _flatten(gather_params(dc, mesh,
                                          cache_specs(cst, mesh, B))):
        key = "dcache/" + "/".join(path)
        _close(x, torch.from_numpy(z[key]), key)
