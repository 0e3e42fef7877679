"""The port's expert-parallel MoE (``repro_torch/models/moe_ep.py``) against
the JAX package's (``repro/models/moe_ep.py``) and against its own dropless
path.

Held here:

* ``ep_axes`` equals the reference's for every MoE arch on the (2, 4),
  (16, 16) and (2, 16, 16) meshes;
* ``moe_forward_ep`` on ``ShardMesh((2, 4), ("data", "model"), "cpu")`` at
  ``CAPACITY_FACTOR = 16`` (no choice dropped) matches the port's
  ``moe_forward`` within 5e-4 (the reference's own bar), forward and
  gradients, also where the batch does not divide the data axis;
* at the default 1.25, where choices are dropped, it matches JAX's own
  ``moe_forward_ep`` run on 8 forced host devices in a subprocess (as
  ``tests/test_serving_and_ep.py`` runs it): the kept mask bitwise and the
  output within 1e-4 of its largest magnitude (float32), for a plain and a
  skewed router (one that sends every token to the same two experts);
* ``_block_forward`` takes the EP path when an EP mesh is set.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import moe_ep as jmoe
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.models import forward
from repro_torch.models import layers, model, moe_ep
from repro_torch.models.moe_ep import TokenLayout

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_ARCHS = sorted(a for a, c in J_ARCHS.items() if c.is_moe)


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    """Each test leaves the EP mesh (module state, as in the reference)
    unset."""
    yield
    moe_ep.set_ep_mesh(None, ("data",))


class FakeMesh:
    """A JAX-mesh stand-in with ``shape``, ``axis_names`` and ``size``
    (``tests/test_launch.py``)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = [{"data": 2, "model": 4}, {"data": 16, "model": 16},
          {"pod": 2, "data": 16, "model": 16}]


@pytest.mark.parametrize("shape", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.values()))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_ep_axes_match_reference(arch, shape):
    mesh = FakeMesh(shape)
    for suffix in ("", "-smoke"):
        n = get_arch(arch + suffix).n_experts
        assert moe_ep.ep_axes(mesh, n) == jmoe.ep_axes(mesh, n)


def _moe(seed=0, skew=0.0, dtype=torch.float32):
    """moonshot's smoke MoE layer params from ``model._moe_params``."""
    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    gen = torch.Generator().manual_seed(seed)
    p = model._moe_params(cfg, model._Init(gen, dtype, torch.device("cpu")))
    if skew:
        p["router"][:, :2] += skew
    return cfg, p


def _ep_mesh():
    return ShardMesh((2, 4), ("data", "model"), device="cpu")


@pytest.mark.parametrize("b,s", [(4, 16), (3, 6)])
def test_ep_matches_dropless_at_cf16(b, s, monkeypatch):
    monkeypatch.setattr(moe_ep, "CAPACITY_FACTOR", 16.0)
    cfg, p = _moe()
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model)).astype(
        np.float32))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    outs, grads = [], []
    for ep in (False, True):
        moe_ep.set_ep_mesh(_ep_mesh() if ep else None, ("data",))
        x = x0.clone().requires_grad_()
        fn = moe_ep.moe_forward_ep if ep else layers.moe_forward
        y = fn(cfg, leaves, x)
        g = torch.autograd.grad((y * y).sum(), [x] + list(leaves.values()))
        outs.append(y.detach())
        grads.append(g)
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                               rtol=5e-4, atol=5e-4)
    for g1, g0 in zip(grads[1], grads[0]):
        np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=5e-4,
                                   atol=5e-4)


def test_token_layout_round_trips():
    mesh = _ep_mesh()
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).reshape(4, 8, 3)
    lay = TokenLayout.of(mesh, 4, 8, ("data",), "model")
    st = lay.split(x)
    assert st.shape == (8, 2, 2, 3)
    # shard (data 1, model 2) holds batch rows 2-3, sequence 4-5
    assert torch.equal(st[1 * 4 + 2], x[2:4, 4:6])
    assert torch.equal(lay.join(st), x)
    rep = TokenLayout.of(mesh, 3, 6, ("data",), "model")   # replicated
    assert (rep.nb, rep.ns) == (1, 1)
    assert torch.equal(rep.join(rep.split(x[:3, :6])), x[:3, :6])


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
from repro.models.layers import moe_forward

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
def test_ep_matches_jax_ep_with_drops(skew, tmp_path):
    cfg, p = _moe(seed=1, skew=skew)
    rng = np.random.default_rng(1)
    # skewed: a shared offset in every token lifts experts 0 and 1 for all
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

    mesh = _ep_mesh()
    moe_ep.set_ep_mesh(mesh, ("data",))
    xt = torch.from_numpy(x)
    lay = TokenLayout.of(mesh, 8, 64, ("data",), "model")
    st = lay.split(xt)
    n = st.shape[0]
    r = moe_ep.route(cfg, st.reshape(n, -1, cfg.d_model), p["router"], 8,
                     cfg.n_experts // 8)
    keep = r.keep.reshape(-1).numpy()
    np.testing.assert_array_equal(keep, want["keep"].reshape(-1))
    assert not keep.all()                      # choices were dropped
    if skew:
        assert keep.mean() < 0.5
    with torch.no_grad():
        got = moe_ep.moe_forward_ep(cfg, p, xt).numpy()
    ref = want["out"]
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_block_forward_takes_ep_when_set(monkeypatch):
    monkeypatch.setattr(moe_ep, "CAPACITY_FACTOR", 16.0)
    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    params = model.init_params(cfg, torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    calls = []
    real = model.moe_forward_ep

    def spy(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(model, "moe_forward_ep", spy)
    with torch.no_grad():
        ref = forward(cfg, params, dict(tokens=tokens), remat="none")
        assert not calls
        moe_ep.set_ep_mesh(_ep_mesh(), ("data",))
        out = forward(cfg, params, dict(tokens=tokens), remat="none")
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(calls) == n_moe
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=5e-4,
                               atol=5e-4)


def test_ep_mesh_on_another_device_raises():
    cfg, p = _moe()
    moe_ep.set_ep_mesh(ShardMesh((2, 4), ("data", "model"), device="cpu"),
                       ("data",))
    x = torch.zeros((4, 16, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="EP mesh on cpu"):
        moe_ep.moe_forward_ep(cfg, p, x)
