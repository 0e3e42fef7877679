"""Helpers for the partitioned-step tests of the whole zoo
(``tests/test_torch_partitioned_b.py``, ``test_torch_partitioned_ref_b.py``,
``test_torch_partitioned_ref_c.py`` and ``test_torch_partitioned_tp.py``).
Not a test module.

Every arch's smoke config on a (2, 4) ``("data", "model")`` mesh of G device
groups on the CPU (``devices=["cpu"] * G``), float32 params; inputs drawn
with numpy from a seed: tokens and labels, hubert's frames, qwen2-vl's four
patch embeddings a row at distinct positions and its M-RoPE positions.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten, clone_tree
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import (cache_specs, gather_params,
                                         param_specs, place_batch,
                                         place_params)
from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                      build_prefill_step, build_train_step,
                                      logits_spec)
from repro_torch.models import ShapeCfg, loss_fn, moe_ep
from repro_torch.models.serving import pad_params_for_serving, serving_padded
from repro_torch.optim import AdamWConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the archs ``test_torch_partitioned.py`` does not hold
ARCHS_B = ["deepseek-v3-671b", "zamba2-2.7b", "qwen2-vl-72b",
           "nemotron-4-15b", "qwen1.5-110b", "hubert-xlarge"]
B, S, POS = 8, 16, 5
TOL = 1e-4
OPT = AdamWConfig(state_dtype=torch.float32)


def mesh(g, shape=(2, 4)):
    if g == 1:
        return ShardMesh(shape, ("data", "model"), device="cpu")
    return ShardMesh(shape, ("data", "model"), devices=["cpu"] * g)


def params(arch, seed=0):
    from repro_torch.models import init_params
    cfg = get_arch(arch).smoke()
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            dtype=torch.float32, device="cpu")


def np_batch(cfg, rng, kind="train"):
    """A train (or prefill: no labels) batch of ``cfg``'s inputs, numpy."""
    if cfg.frontend == "audio":
        batch = dict(frames=rng.normal(size=(B, S, cfg.d_model))
                     .astype(np.float32),
                     labels=rng.integers(0, cfg.vocab, (B, S))
                     .astype(np.int32))
    else:
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        batch = dict(tokens=toks[:, :-1].copy(), labels=toks[:, 1:].copy())
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(B, 4, cfg.d_model)).astype(np.float32)
        batch["patch_pos"] = np.stack([rng.choice(S, 4, replace=False)
                                       for _ in range(B)]).astype(np.int32)
    if cfg.mrope:
        batch["pos3"] = np.broadcast_to(np.arange(S)[None, None],
                                        (B, 3, S)).astype(np.int32).copy()
    if kind != "train":
        batch.pop("labels")
    return batch


def batch(cfg, seed=0, kind="train"):
    return {k: torch.from_numpy(v) for k, v in np_batch(
        cfg, np.random.default_rng(seed), kind).items()}


def state(params, seed=0):
    """A nonzero AdamW state past the schedule's warmup (step 3,000)."""
    rng = np.random.default_rng(seed)
    leaves = [p for _, p in _flatten(params)]
    m = _unflatten(params, iter(torch.from_numpy(rng.normal(
        0, 1e-3, p.shape).astype(np.float32)) for p in leaves))
    v = _unflatten(params, iter(torch.from_numpy(rng.uniform(
        0, 1e-5, p.shape).astype(np.float32)) for p in leaves))
    return dict(m=m, v=v, step=torch.tensor(3000, dtype=torch.int32))


def cache(structs, seed=0):
    rng = np.random.default_rng(seed)
    return _unflatten(structs, iter(torch.from_numpy(
        (rng.normal(size=x.shape) * 0.1).astype(np.float32))
        for _, x in _flatten(structs)))


def unpartitioned_mesh(cfg):
    """The one-device program: the (1, 1) mesh; an MoE arch keeps the (2,
    4) mesh with whole params, whose EP drops the same choices."""
    return mesh(1) if cfg.is_moe else mesh(1, (1, 1))


def same_trees(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def close_trees(a, b, tol=TOL):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        err = float((x.float() - y.float()).abs().max())
        assert err <= tol * max(float(y.float().abs().max()), 1e-30), \
            (path, err)


def train(cfg, m, params, st, bt, steps=1, step_cfg=None):
    """Step 0's loss and gradients, then ``steps`` train steps: whole
    trees back from the placed ones, and the placed results."""
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), m,
                                   step_cfg or StepConfig(optimizer=OPT))
    ps, ss = param_specs(structs[0], m), param_specs(structs[1], m)
    p, s = place_params(params, m, ps), place_params(st, m, ss)
    loss0, grads = fn.plan.loss_and_grads(p, place_batch(bt, m))
    losses = []
    for _ in range(steps):
        p, s, loss = fn(p, s, bt)
        losses.append(loss)
    moe_ep.set_ep_mesh(None, ("data",))
    return dict(loss0=loss0, grads=gather_params(grads, m, ps),
                params=gather_params(p, m, ps),
                state=gather_params(s, m, ss), losses=losses,
                placed=(p, s, ps, ss))


def whole_step(cfg, params, st, bt, step_cfg=None):
    """The unpartitioned program: loss, gradients, one step."""
    fn, _ = build_train_step(cfg, ShapeCfg("t", S, B, "train"),
                             unpartitioned_mesh(cfg),
                             step_cfg or StepConfig(optimizer=OPT))
    leaves = [x.detach().requires_grad_() for _, x in _flatten(params)]
    loss = loss_fn(cfg, _unflatten(params, iter(leaves)), bt)
    grads = _unflatten(params, iter(torch.autograd.grad(loss, leaves)))
    # the step donates params and state: it takes copies
    p1, s1, loss1 = fn(clone_tree(params), clone_tree(st), bt)
    moe_ep.set_ep_mesh(None, ("data",))
    return loss.detach(), grads, p1, s1, loss1


def serve(cfg, m, params, pre, tok1, cache_seed):
    """Prefill logits, and (but for an encoder) one decode step's logits
    and new cache from a random cache, all whole: on a mesh of more than
    one shard through placed params, on the one-device mesh whole."""
    pshape, dshape = (ShapeCfg("p", S, B, "prefill"),
                      ShapeCfg("d", S, B, "decode"))
    fn, structs = build_prefill_step(cfg, pshape, m)
    placed = m.size > 1
    p = place_params(params, m, param_specs(structs[0], m)) if placed \
        else params
    logits = fn(p, pre)
    if placed:
        logits = m.assemble(logits, logits_spec(cfg, pshape, m))
    moe_ep.set_ep_mesh(None, ("data",))
    if cfg.encoder_only:
        return logits, None, None
    pc = serving_padded(cfg, 4)
    pp = pad_params_for_serving(cfg, pc, params)
    if placed:
        fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, m)
        dl, dc = fn(place_params(pp, m, param_specs(pst, m)),
                    cache(cst, cache_seed), tok1, POS)
        dl = m.assemble(dl, logits_spec(pc, dshape, m, decode=True))
        dc = gather_params(dc, m, cache_specs(cst, m, B))
    else:
        fn, (_, cst, _, _) = build_decode_step(pc, dshape, m, StepConfig(
            serving_head_pad=False))
        dl, dc = fn(pp, cache(cst, cache_seed), tok1, POS)
    moe_ep.set_ep_mesh(None, ("data",))
    return logits, dl, dc


# -- the reference's partitioned steps, in a subprocess ---------------------
WORKER = r'''import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
sys.path.insert(0, "tests")
import time
import traceback
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_arch
from repro.launch import steps
from repro.models import ShapeCfg, init_params, moe_ep
from repro.models.serving import pad_params_for_serving, serving_padded
from repro.optim import AdamWConfig
from repro_torch.ckpt.checkpoint import _flatten
from torch_partitioned import B, POS, S, np_batch

out, archs = sys.argv[1], sys.argv[2:]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
f32 = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)
dev = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
for arch in archs:
    t0 = time.time()
    cfg = get_arch(arch).smoke()
    params = f32(init_params(cfg, jax.random.key(0), dtype=jnp.float32))
    rng = np.random.default_rng(1)
    batch = np_batch(cfg, rng)
    state = dict(
        m=jax.tree_util.tree_map(lambda p: rng.normal(0, 1e-3, p.shape)
                                 .astype(np.float32), params),
        v=jax.tree_util.tree_map(lambda p: rng.uniform(0, 1e-5, p.shape)
                                 .astype(np.float32), params),
        step=np.asarray(3000, np.int32))
    tok1 = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    pre = {k: v for k, v in batch.items() if k != "labels"}
    res, inputs = {}, dict(params=params, state=state, batch=batch,
                           tok1=tok1)
    try:
        with mesh:
            fn, _ = steps.build_step(
                cfg, ShapeCfg("t", S, B, "train"), mesh, steps.StepConfig(
                    optimizer=AdamWConfig(state_dtype=jnp.float32)))
            p1, s1, loss = fn(dev(params), dev(state), dev(batch))
            res.update(loss=np.asarray(loss), p1=f32(p1), m1=f32(s1["m"]),
                       v1=f32(s1["v"]))
            fn, _ = steps.build_step(cfg, ShapeCfg("p", S, B, "prefill"),
                                     mesh)
            res["logits"] = np.asarray(fn(dev(params), dev(pre)), np.float32)
            if not cfg.encoder_only:
                fn, (_, cache_s, _, _) = steps.build_step(
                    cfg, ShapeCfg("d", S, B, "decode"), mesh)
                padded = serving_padded(cfg, 4)
                pp = f32(pad_params_for_serving(cfg, padded, params))
                cache = jax.tree_util.tree_map(
                    lambda s: (rng.normal(size=s.shape) * 0.1)
                    .astype(np.float32), cache_s)
                dl, dc = fn(dev(pp), dev(cache), jnp.asarray(tok1),
                            jnp.int32(POS))
                res.update(dlogits=np.asarray(dl, np.float32),
                           dcache=f32(dc))
                inputs.update(padded=pp, cache=cache)
    except Exception:
        print(arch, "REF_FAILED", traceback.format_exc().replace(
            "\n", " | "), flush=True)
        continue
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    flat = {"/".join(p): np.asarray(x) for p, x in _flatten(dict(
        **inputs, **res))}
    np.savez(os.path.join(out, arch + ".npz"), **flat)
    print(arch, "REF_OK", round(time.time() - t0, 1), flush=True)
'''


def run_reference(out, archs):
    """The reference's partitioned train, prefill and decode steps of
    ``archs`` in one subprocess on 8 forced host devices: ``{arch: npz
    dict}``, or ``{arch: the failure's text}`` where the reference's step
    raised under the installed JAX."""
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script), str(out)] + archs,
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = {}
    for line in proc.stdout.splitlines():
        arch, _, rest = line.partition(" ")
        if rest.startswith("REF_OK"):
            got[arch] = dict(np.load(out / f"{arch}.npz"))
        elif rest.startswith("REF_FAILED"):
            got[arch] = rest
    assert sorted(got) == sorted(archs), proc.stdout[-3000:]
    return got


def _tree(z, prefix, like):
    return _unflatten(like, iter(torch.from_numpy(
        z[prefix + "/" + "/".join(p)]) for p, _ in _flatten(like)))


def _close_ref(got, want, what):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * float(want.abs().max()), (what, err)


def check_train_against_reference(arch, z):
    """The port's partitioned train step on the (2, 4) mesh in two groups
    against the reference's (``run_reference``'s ``z``): the loss, the new
    params and AdamW moments within ``TOL``."""
    from repro_torch.models import meta_params
    cfg = get_arch(arch).smoke()
    like = meta_params(cfg, torch.float32)
    prm = _tree(z, "params", like)
    st = dict(m=_tree(z, "state/m", like), v=_tree(z, "state/v", like),
              step=torch.tensor(3000, dtype=torch.int32))
    bt = {k[len("batch/"):]: torch.from_numpy(v) for k, v in z.items()
          if k.startswith("batch/")}
    m = mesh(2)
    fn, (ps_, ss_, _) = build_train_step(
        cfg, ShapeCfg("t", S, B, "train"), m, StepConfig(optimizer=OPT))
    ps, ss = param_specs(ps_, m), param_specs(ss_, m)
    p1, s1, loss = fn(place_params(prm, m, ps), place_params(st, m, ss), bt)
    moe_ep.set_ep_mesh(None, ("data",))
    want = float(z["loss"])
    assert abs(float(loss) - want) <= TOL * abs(want)
    p1, s1 = gather_params(p1, m, ps), gather_params(s1, m, ss)
    for name, tree in (("p1", p1), ("m1", s1["m"]), ("v1", s1["v"])):
        for path, x in _flatten(tree):
            key = name + "/" + "/".join(path)
            _close_ref(x, torch.from_numpy(z[key]), key)
    assert int(s1["step"]) == 3001


def check_serve_against_reference(arch, z):
    """The port's partitioned prefill and (but for an encoder) decode on
    the (2, 4) mesh in two groups against the reference's: the logits and
    the new caches within ``TOL``."""
    cfg = get_arch(arch).smoke()
    m = mesh(2)
    pshape, dshape = (ShapeCfg("p", S, B, "prefill"),
                      ShapeCfg("d", S, B, "decode"))
    fn, (pst, _) = build_prefill_step(cfg, pshape, m)
    prm = _tree(z, "params", pst)
    pre = {k[len("batch/"):]: torch.from_numpy(v) for k, v in z.items()
           if k.startswith("batch/") and k != "batch/labels"}
    logits = fn(place_params(prm, m, param_specs(pst, m)), pre)
    moe_ep.set_ep_mesh(None, ("data",))
    _close_ref(m.assemble(logits, logits_spec(cfg, pshape, m)),
               torch.from_numpy(z["logits"]), "prefill logits")
    if cfg.encoder_only:
        return
    fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, m)
    dl, dc = fn(place_params(_tree(z, "padded", pst), m,
                             param_specs(pst, m)),
                _tree(z, "cache", cst), torch.from_numpy(z["tok1"]), POS)
    moe_ep.set_ep_mesh(None, ("data",))
    _close_ref(m.assemble(dl, logits_spec(serving_padded(cfg, 4), dshape, m,
                                          decode=True)),
               torch.from_numpy(z["dlogits"]), "decode logits")
    for path, x in _flatten(gather_params(dc, m, cache_specs(cst, m, B))):
        key = "dcache/" + "/".join(path)
        _close_ref(x, torch.from_numpy(z[key]), key)
