"""The host mesh and the compressed gradient all-reduce over device groups
(``repro_torch/launch/mesh.make_host_mesh``,
``repro_torch/optim/compress.compressed_psum``).

Held here, on the CPU:

* ``make_host_mesh`` takes the reference's ``(n // model, model)`` rule
  when ``data`` is not given (n the devices given, else the visible
  cards), passes ``devices`` through, spreads its shards with
  ``core/mesh.card_groups`` when no device is given (checked with a
  stand-in for the cards), keeps one group on a given device, and raises
  without a card;
* ``compressed_psum`` over G = 1, 2 and 4 groups (``devices=["cpu"] * G``,
  each group's tree of its shards) against the reference run as a ``vmap``
  over named axes, as ``tests/test_torch_substrate.py`` holds the one-group
  form: on a (4,) mesh over its axis and on a (2, 4) mesh over ``data``,
  with and without error feedback, the averages and the new error feedback
  bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as jax_compress
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch import mesh as host
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import compressed_psum

GROUPS = (1, 2, 4)


def test_host_mesh_on_a_given_device_is_one_group():
    m = make_host_mesh(model=4, data=2, device="cpu")
    assert (m.shape, m.axis_names, m.devices) == (
        (2, 4), ("data", "model"), (torch.device("cpu"),))
    assert make_host_mesh(device="cpu").shape == (1, 1)
    assert make_host_mesh(model=4, device="cpu").shape == (1, 4)


@pytest.mark.parametrize("g", [2, 4])
def test_host_mesh_passes_devices_through(g):
    m = make_host_mesh(model=2, data=2, devices=["cpu"] * g)
    assert (m.shape, m.n_groups, m.per_group) == ((2, 2), g, 4 // g)
    # data=None: one data row per ``model`` devices, as the reference
    assert make_host_mesh(model=2, devices=["cpu"] * g).shape == (g // 2 or
                                                                  1, 2)
    assert make_host_mesh(model=1, devices=["cpu"] * g).shape == (g, 1)


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_host_mesh_spreads_over_the_cards(cards, monkeypatch):
    """No device given: ``n // model`` data rows of the visible cards, the
    shards in ``card_groups``'s groups (a stand-in gives ``cards`` CPU
    groups, as many as divide the shards)."""
    calls = []

    def groups(n_shards, device):
        calls.append((n_shards, device))
        g = max(k for k in range(1, min(cards, n_shards) + 1)
                if n_shards % k == 0)
        return [torch.device("cpu")] * g

    monkeypatch.setattr(host, "card_groups", groups)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    m = make_host_mesh(model=2)
    assert m.shape == (max(cards // 2, 1), 2)
    assert calls == [(m.size, None)] and m.n_groups == min(cards, m.size)
    m = make_host_mesh(model=4, data=2)
    assert (m.shape, m.n_groups) == ((2, 4), cards)


def test_host_mesh_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh(model=4, data=2)


def _grads(rng, n):
    return dict(a=rng.normal(size=(n, 300)).astype(np.float32),
                b=dict(c=rng.normal(size=(n, 5, 7)).astype(np.float32),
                       d=(rng.normal(size=(n, 513)) * 1e-3).astype(
                           np.float32)))


def _split(tree, mesh):
    """A tree of [mesh.size, ...] arrays as one tree per device group."""
    leaves = [torch.from_numpy(x) for _, x in _flatten(tree)]
    per = [mesh.split(x) for x in leaves]

    def rebuild(t, it):
        if isinstance(t, dict):
            return {k: rebuild(t[k], it) for k in sorted(t)}
        return next(it)
    return tuple(rebuild(tree, iter([p[g] for p in per]))
                 for g in range(mesh.n_groups))


def _joined(trees, mesh):
    if mesh.n_groups == 1:
        trees = (trees,)
    flat = [[x for _, x in _flatten(t)] for t in trees]
    return [mesh.join(tuple(col)).numpy() for col in zip(*flat)]


@pytest.mark.parametrize("with_error", [False, True])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("layout", ["4", "2x4"])
def test_grouped_compressed_psum_matches_jax(layout, g, with_error):
    rng = np.random.default_rng(11)
    n = 4 if layout == "4" else 8
    grads = _grads(rng, n)
    error = (jax.tree_util.tree_map(
        lambda x: (rng.normal(size=x.shape) * 1e-3).astype(np.float32),
        grads) if with_error else None)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    je = None if error is None else jax.tree_util.tree_map(jnp.asarray, error)
    if layout == "4":
        shape, names, axis = (4,), ("dev",), "dev"
        ref = jax.vmap(lambda g_, e: jax_compress.compressed_psum(
            g_, "dev", e), axis_name="dev")(jg, je)
    else:
        shape, names, axis = (2, 4), ("data", "model"), "data"
        fold = lambda t: None if t is None else jax.tree_util.tree_map(
            lambda x: x.reshape((2, 4) + x.shape[1:]), t)
        inner = jax.vmap(lambda g_, e: jax_compress.compressed_psum(
            g_, "data", e), axis_name="model")
        ref = jax.vmap(inner, axis_name="data")(fold(jg), fold(je))
        ref = jax.tree_util.tree_map(
            lambda x: x.reshape((8,) + x.shape[2:]), ref)
    mesh = (ShardMesh(shape, names, device="cpu") if g == 1 else
            ShardMesh(shape, names, devices=["cpu"] * g))
    if g == 1:
        got = compressed_psum(
            jax.tree_util.tree_map(torch.from_numpy, grads), mesh, axis,
            None if error is None else jax.tree_util.tree_map(
                torch.from_numpy, error))
    else:
        got = compressed_psum(_split(grads, mesh), mesh, axis,
                              None if error is None else _split(error, mesh))
        assert len(got[0]) == len(got[1]) == g
    for out, want in zip(got, ref):
        want = [np.asarray(x) for _, x in _flatten(
            jax.tree_util.tree_map(np.asarray, want))]
        for a, b in zip(_joined(out, mesh), want):
            np.testing.assert_array_equal(a, b)


def test_grouped_compressed_psum_takes_one_tree_a_group():
    mesh = ShardMesh((4,), ("dev",), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="tuple of 2 gradient trees"):
        compressed_psum((dict(a=torch.zeros(2, 3)),), mesh, "dev")
