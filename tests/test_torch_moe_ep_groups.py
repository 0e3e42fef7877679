"""The port's expert-parallel MoE over device groups
(``repro_torch/models/moe_ep.py`` on ``ShardMesh(..., devices=[...])``)
against the same layer with one group, and against the JAX package's EP.

Every grouping here runs on the CPU (``devices=["cpu"] * G``), which runs
the grouped code as it runs across cards.  Held here:

* on the (2, 4) and (1, 8) meshes, with G = 1, 2 and 4 groups, the routed
  experts whole or placed in the groups (``launch/sharding.place_params``:
  each shard's block of the EP rule, stacked per group),
  at capacity factor 1.25 (choices dropped) on a plain and a skewed router:
  the output, the kept mask and the gradient of every leaf (the expert
  slices included) are bitwise with the one-group mesh;
* at 1.25 the grouped layer matches JAX's own ``moe_forward_ep`` on 8
  forced host devices in a subprocess, as ``tests/test_torch_moe_ep.py``
  holds the one-group layer: the kept mask bitwise, the output within 1e-4
  of its largest magnitude;
* where the EP axes do not span the group boundaries (4 experts on a
  (2, 4) mesh: EP over ``model`` only), every group reads its span, from
  the whole weights or from the first of its shards that holds each
  expert block, and the layer agrees with one group to rtol = atol = 1e-6
  forward and, in each gradient, within 1e-6 of its largest magnitude (a
  replicated expert's rows then run as several products, and its gradient
  sums across the groups, or across the placed replicas);
* the placed experts stay off the dropless path, and the tokens must sit on
  the mesh's first device.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.sharding import param_specs, place_params
from repro_torch.models import layers, model, moe_ep

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x4": (2, 4), "1x8": (1, 8)}
GROUPS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    """Each test leaves the EP mesh (module state) unset."""
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _moe(seed=0, skew=0.0, n_experts=None):
    """moonshot's smoke MoE layer params from ``model._moe_params``."""
    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    if n_experts:
        cfg = dataclasses.replace(cfg, n_experts=n_experts)
    gen = torch.Generator().manual_seed(seed)
    p = model._moe_params(cfg, model._Init(gen, torch.float32,
                                           torch.device("cpu")))
    if skew:
        p["router"][:, :2] += skew
    return cfg, p


def _tokens(cfg, seed, b=8, s=16, offset=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(b, s, cfg.d_model)) + offset
                             ).astype(np.float32))


def _mesh(shape, g):
    if g == 1:
        return ShardMesh(shape, ("data", "model"), device="cpu")
    return ShardMesh(shape, ("data", "model"), devices=["cpu"] * g)


EXPERTS = ("wg", "wu", "wd")


def _place_experts(p, mesh):
    """One MoE layer's routed-expert leaves at rest by the EP rule
    (``place_params``), the router and the shared experts whole, as
    ``moe_forward_ep`` takes them; and the experts' specs."""
    specs = param_specs({"ffn": p}, mesh)["ffn"]
    placed = place_params({"ffn": p}, mesh)["ffn"]
    return ({k: placed[k] if k in EXPERTS else v for k, v in p.items()},
            {k: specs[k] for k in EXPERTS if k in p})


def _whole_grad(grads, mesh, spec):
    """A placed leaf's gradient as one tensor: summed over its replicas,
    each block from its first shard."""
    return mesh.assemble(mesh.psum_replicas(grads, spec), spec)


def _run(cfg, p, x0, mesh, placed):
    """The layer's output, its kept mask and the gradient of (y * y).sum()
    to x and to every leaf (placed blocks assembled), on ``mesh``."""
    moe_ep.set_ep_mesh(mesh, ("data",))
    tree = {"ffn": {k: v.clone() for k, v in p.items()}}
    specs = {}
    if placed:
        tree["ffn"], specs = _place_experts(tree["ffn"], mesh)
    leaves = {k: tuple(t.requires_grad_() for t in v) if isinstance(v, tuple)
              else v.requires_grad_() for k, v in tree["ffn"].items()}
    flat = [t for v in leaves.values()
            for t in (v if isinstance(v, tuple) else (v,))]
    x = x0.clone().requires_grad_()
    y = moe_ep.moe_forward_ep(cfg, leaves, x)
    grads = torch.autograd.grad((y * y).sum(), [x] + flat)
    it = iter(grads[1:])
    whole = {k: _whole_grad(tuple(next(it) for _ in v), mesh, specs[k])
             if isinstance(v, tuple) else next(it)
             for k, v in leaves.items()}
    with torch.no_grad():
        keep = torch.cat([r.keep for r in moe_ep.route_groups(cfg, leaves,
                                                              x0)])
    return y.detach(), keep, grads[0], whole


@pytest.mark.parametrize("placed", [False, True], ids=["whole", "placed"])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("skew", [0.0, 6.0], ids=["plain", "skewed"])
@pytest.mark.parametrize("mesh_key", sorted(MESHES))
def test_grouped_ep_bitwise_with_one_group(mesh_key, skew, g, placed):
    cfg, p = _moe(skew=skew)
    x0 = _tokens(cfg, 0)
    shape = MESHES[mesh_key]
    want = _run(cfg, p, x0, _mesh(shape, 1), False)
    got = _run(cfg, p, x0, _mesh(shape, g), placed)
    assert not want[1].all()                    # choices were dropped
    for a, b, what in zip(got[:3], want[:3], ("output", "keep", "grad x")):
        assert torch.equal(a, b), what
    assert got[3].keys() == want[3].keys()
    for k in want[3]:
        assert torch.equal(got[3][k], want[3][k]), k


def test_placed_slices_sit_on_their_groups():
    """Each group's blocks hold the experts its shards own, and the layer
    hands the group its blocks themselves (a view, no copy)."""
    cfg, p = _moe()
    mesh = _mesh((2, 4), 4)
    moe_ep.set_ep_mesh(mesh, ("data",))
    assert moe_ep.expert_spans(mesh, 8) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    placed, specs = _place_experts(p, mesh)
    own = moe_ep._group_index(mesh, ("data", "model"))
    for name in ("wg", "wu", "wd"):
        assert len(placed[name]) == 4
        for gi, (lo, hi) in enumerate(moe_ep.expert_spans(mesh, 8)):
            assert torch.equal(placed[name][gi].flatten(0, 1),
                               p[name][lo:hi])
            w = moe_ep._group_weight(placed[name], gi, (lo, hi),
                                     mesh.devices[gi],
                                     own[list(mesh.shards(gi))], 1)
            assert w.data_ptr() == placed[name][gi].data_ptr()
        assert torch.equal(mesh.assemble(placed[name], specs[name]),
                           p[name])
    for name in ("router", "shared_wu", "shared_wd"):
        assert placed[name] is p[name]


EP_WORKER = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys
sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs import get_arch
from repro.models import moe_ep

cfg = get_arch("moonshot-v1-16b-a3b").smoke()
mesh = jax.make_mesh((2, 4), ("data", "model"))
moe_ep.set_ep_mesh(mesh, ("data",))
inp = np.load(sys.argv[1])
p = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p_")}
x = jnp.asarray(inp["x"])
k = cfg.experts_per_token
n_shards, e_loc = 8, cfg.n_experts // 8


def keep_fn(x_loc, router):
    # the routing lines of the reference's local_fn (moe_ep.py:115-135)
    bl, sl, d = x_loc.shape
    t = bl * sl
    cap = max(int(t * k * moe_ep.CAPACITY_FACTOR) // n_shards, 8)
    xt = x_loc.reshape(t, d)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), router)
    gates, choice = jax.lax.top_k(jax.nn.sigmoid(logits), k)
    dest = choice.reshape(t * k) // e_loc
    order = jnp.argsort(dest)
    rank_sorted = jnp.arange(t * k) - jax.lax.cummax(
        jnp.where(jnp.concatenate([jnp.ones((1,), bool),
                                   dest[order][1:] != dest[order][:-1]]),
                  jnp.arange(t * k), 0))
    rank = jnp.zeros((t * k,), jnp.int32).at[order].set(
        rank_sorted.astype(jnp.int32))
    return (rank < cap)[None]


with mesh:
    out = jax.jit(lambda p, x: moe_ep.moe_forward_ep(cfg, p, x))(p, x)
    keep = jax.jit(shard_map(
        keep_fn, mesh=mesh, in_specs=(P("data", "model", None), P(None, None)),
        out_specs=P(("data", "model")), check_rep=False))(
            x, p["router"].astype(jnp.float32))
np.savez(sys.argv[2], out=np.asarray(out), keep=np.asarray(keep))
print("EP_OK")
"""


@pytest.mark.parametrize("skew", [0.0, 6.0], ids=["plain", "skewed"])
def test_grouped_ep_matches_jax_ep_with_drops(skew, tmp_path):
    """Two and four groups, the experts placed, against the reference's EP
    on 8 forced host devices: the kept mask bitwise with JAX's (the same
    drops) and the output within 1e-4 of the largest magnitude."""
    cfg, p = _moe(seed=1, skew=skew)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(8, 64, cfg.d_model)) + (0.5 if skew else 0.0)
         ).astype(np.float32)
    inp, outp = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(inp, x=x, **{f"p_{k}": v.numpy() for k, v in p.items()})
    script = tmp_path / "ep_worker.py"
    script.write_text(EP_WORKER)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, str(script), str(inp), str(outp)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "EP_OK" in proc.stdout, \
        proc.stderr[-3000:]
    want = np.load(outp)
    ref = want["out"]
    xt = torch.from_numpy(x)
    for g in (2, 4):
        mesh = _mesh((2, 4), g)
        moe_ep.set_ep_mesh(mesh, ("data",))
        pp, _ = _place_experts(p, mesh)
        with torch.no_grad():
            got = moe_ep.moe_forward_ep(cfg, pp, xt).numpy()
            keep = torch.cat([r.keep for r in
                              moe_ep.route_groups(cfg, pp, xt)]).numpy()
        np.testing.assert_array_equal(keep.reshape(-1),
                                      want["keep"].reshape(-1))
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), g
        assert not keep.all()                  # choices were dropped
        if skew:
            assert keep.mean() < 0.5


@pytest.mark.parametrize("g", [2, 4])
def test_ep_over_model_only_reads_each_span(g):
    """4 experts on a (2, 4) mesh: EP runs over ``model`` only, so the
    shards of ``data`` row 0 and row 1 hold the same experts, and a group
    may need every expert.  ``place_params`` then holds each expert block
    on both of its shards, each group reads its span from the first shard
    that holds each block, and the layer agrees with one group."""
    cfg, p = _moe(skew=6.0, n_experts=4)
    mesh = _mesh((2, 4), g)
    moe_ep.set_ep_mesh(mesh, ("data",))
    assert moe_ep.ep_axes(mesh, 4) == ("model",)
    spans = moe_ep.expert_spans(mesh, 4)
    assert spans == ([(0, 4)] * 2 if g == 2 else [(0, 2), (2, 4)] * 2)
    placed, specs = _place_experts(p, mesh)
    assert specs["wu"] == (("model",), None, None)
    assert [tuple(x.shape[:2]) for x in placed["wu"]] == [(8 // g, 1)] * g
    x0 = _tokens(cfg, 2)
    want = _run(cfg, p, x0, _mesh((2, 4), 1), False)
    got = _run(cfg, p, x0, mesh, True)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)
    for a, b, what in [(got[2], want[2], "x")] + [
            (got[3][k], want[3][k], k) for k in want[3]]:
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), what


def test_placed_experts_refuse_the_dropless_path():
    cfg, p = _moe()
    mesh = _mesh((2, 4), 2)
    moe_ep.set_ep_mesh(mesh, ("data",))
    placed, _ = _place_experts(p, mesh)
    moe_ep.set_ep_mesh(None, ("data",))
    with pytest.raises(ValueError, match="expert-parallel path"):
        layers.moe_forward(cfg, placed, _tokens(cfg, 0, 2, 8))


def test_grouped_ep_mesh_on_another_device_raises():
    cfg, p = _moe()
    moe_ep.set_ep_mesh(_mesh((2, 4), 2), ("data",))
    x = torch.zeros((4, 16, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="EP mesh on cpu"):
        moe_ep.moe_forward_ep(cfg, p, x)
