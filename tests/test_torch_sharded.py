"""The port's sharded fused driver against the JAX single-device fused run.

The JAX sharded driver gives no output on the installed JAX (its sharded
tests fail in ``shard_map``), and its own contract is bit-identity with the
single-device fused driver (``tests/sharded_stream_worker.py``, DESIGN.md
§2.5).  So the port's sharded ``run_stream``, on a ``ShardMesh`` of 8 shards
(``(8,)`` or ``(2, 4)``) on the CPU, is held to JAX's single-device
``run_stream(fused=True)`` on the same stream: the final state bitwise, the
per-interval outputs to rtol = atol = 1e-5 (slice 1's bar: torch and XLA
associate the apps' reductions differently).  The cases are those of the
worker that GS and TP reach: every layout, key skew, multi-partition
transactions, the partition and megakernel rungs, the hash-probe route, and
exchange overflow.  Each JAX reference runs once per (app, seed, rung,
stream options) in a module-scoped cache and is shared by the layouts held
to it.
"""
import itertools
import logging

import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.scheduler import DualModeEngine, EngineConfig

from torch_parity import assert_outputs_close, np_, port_store

MESH1 = ((8,), ("dev",))
MESH2 = ((2, 4), ("socket", "core"))
N_EVENTS, INTERVAL = 128, 32
LAYOUTS = [("shared_nothing", MESH1), ("shared_nothing", MESH2),
           ("shared_per_socket", MESH2), ("shared_everything", MESH1)]


@pytest.fixture(scope="module")
def reference():
    """(app, seed, rung, stream options) -> (stream, JAX store, outputs,
    final state) of JAX's single-device fused run, computed once."""
    cache = {}

    def get(app_name, seed=11, method="auto", gen=()):
        key = (app_name, seed, method, gen)
        if key not in cache:
            japp = J_APPS[app_name]
            stream = japp.gen_events(np.random.default_rng(seed), N_EVENTS,
                                     **dict(gen))
            jstore = japp.make_store()
            eng = JEngine(japp, jstore, JConfig(restructure_method=method))
            outs, vals = eng.run_stream(jstore.values, stream, INTERVAL,
                                        fused=True)
            cache[key] = (stream, jstore, outs, np.asarray(vals))
        return cache[key]
    return get


def _sharded(app_name, jstore, layout, mesh, *, slack=8.0, **cfg):
    shape, names = mesh
    return DualModeEngine(T_APPS[app_name], port_store(jstore),
                          EngineConfig(**cfg), device="cpu",
                          mesh=ShardMesh(shape, names, device="cpu"),
                          layout=layout, exchange_slack=slack)


def _check(ref, app_name, layout, mesh, what, *, slack=8.0, **cfg):
    stream, jstore, jouts, jvals = ref
    eng = _sharded(app_name, jstore, layout, mesh, slack=slack, **cfg)
    outs, vals = eng.run_stream(eng.init_store.values, stream, INTERVAL)
    st = eng.last_exchange_stats
    assert int(np.sum(st["dropped"])) == 0, f"{what}: unexpected drops"
    np.testing.assert_array_equal(np_(vals), jvals,
                                  err_msg=f"{what}: final state")
    assert_outputs_close(outs, jouts, what)
    return eng, outs, vals


RUNGS = {"gs": ["auto", "partition", "megakernel"], "tp": ["auto",
                                                           "partition"]}
CASES = [(a, m, lay, mesh) for a in ("gs", "tp") for m in RUNGS[a]
         for lay, mesh in LAYOUTS]


@pytest.mark.parametrize(
    "app_name,method,layout,mesh", CASES,
    ids=[f"{a}-{m}-{lay}-{'x'.join(map(str, mesh[0]))}"
         for a, m, lay, mesh in CASES])
def test_sharded_matches_single_device(reference, app_name, method, layout,
                                       mesh):
    ref = reference(app_name, method=method)
    reset_launches()
    _check(ref, app_name, layout, mesh, f"{app_name}/{layout}/{method}",
           restructure_method=method)
    assert all(v == 0 for v in LAUNCHES.values())   # the CPU takes twins


@pytest.mark.parametrize("case,seed,gen,method", [
    ("skew", 5, (("theta", 0.95),), "auto"),
    ("skew", 5, (("theta", 0.95),), "megakernel"),
    ("multipartition", 7, (("n_partitions", 16), ("mp_ratio", 0.5),
                           ("mp_len", 6)), "auto"),
    ("multipartition", 7, (("n_partitions", 16), ("mp_ratio", 0.5),
                           ("mp_len", 6)), "megakernel")])
def test_skew_and_multipartition(reference, case, seed, gen, method):
    ref = reference("gs", seed=seed, method=method, gen=gen)
    _check(ref, "gs", "shared_nothing", MESH1, f"gs/{case}/{method}",
           restructure_method=method)


PROBE_CASES = [("gs", "auto", "shared_nothing", MESH1),
               ("gs", "megakernel", "shared_nothing", MESH1),
               ("gs", "partition", "shared_everything", MESH1),
               ("tp", "partition", "shared_per_socket", MESH2),
               ("tp", "auto", "shared_nothing", MESH2)]


@pytest.mark.parametrize("app_name,method,layout,mesh", PROBE_CASES)
def test_hash_probe_route(reference, app_name, method, layout, mesh):
    """The probe route routes exactly like the direct-addressed gather:
    state, outputs and exchange stats bitwise equal to the gather run, and
    the state to the JAX single-device run."""
    ref = reference(app_name, method=method)
    what = f"{app_name}/{layout}/probe"
    e1, o1, v1 = _check(ref, app_name, layout, mesh, what,
                        restructure_method=method, use_hash_probe_route=True)
    assert e1._sharded.probe is not None
    e0, o0, v0 = _check(ref, app_name, layout, mesh, what + "/gather",
                        restructure_method=method)
    assert torch.equal(v1, v0)
    for a, b in zip(o1, o0):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k, v in e0.last_exchange_stats.items():
        np.testing.assert_array_equal(e1.last_exchange_stats[k], v,
                                      err_msg=k)


def test_overflow_is_counted_and_logged(caplog):
    """Slack 1.0 forces drops: the run completes, counts them and logs."""
    app = T_APPS["gs"]
    stream = app.gen_events(np.random.default_rng(9), 64)
    store = app.make_store(device="cpu")
    eng = DualModeEngine(app, store, EngineConfig(), device="cpu",
                         mesh=ShardMesh(*MESH1, device="cpu"),
                         exchange_slack=1.0)
    with caplog.at_level(logging.WARNING):
        outs, vals = eng.run_stream(store.values, stream, 32)
    st = eng.last_exchange_stats
    dropped = int(np.sum(st["dropped"]))
    assert dropped > 0 and len(outs) == 2
    assert torch.isfinite(vals).all()
    assert np.all(st["max_fill"] > st["capacity"])
    assert any("sharded exchange overflow: %d ops dropped" % dropped
               in r.getMessage() for r in caplog.records)
    # the shipped and the dropped ops are every valid op
    assert int(np.sum(st["shipped"])) + dropped == 64 * app.max_ops


@pytest.mark.parametrize("layout,mesh", LAYOUTS)
def test_exchange_stats(reference, layout, mesh):
    stream, jstore, _, _ = reference("gs")
    eng = _sharded("gs", jstore, layout, mesh, slack=4.0)
    eng.run_stream(eng.init_store.values, stream, INTERVAL)
    st = eng.last_exchange_stats
    n_i, n_dev = N_EVENTS // INTERVAL, 8
    n_route = 2 if layout == "shared_per_socket" else 8
    n_loc = INTERVAL // n_dev * 10
    cap = min(-(-n_loc // n_route) * 4, n_loc)
    assert int(st["capacity"]) == cap
    assert int(st["exchanged_rows_per_device"]) == n_dev * cap
    assert st["dropped"].shape == st["shipped"].shape == (n_i,)
    assert np.all(st["shipped"] + st["dropped"] == INTERVAL * 10)
    assert st["shard_load"].shape == (n_route if layout ==
                                      "shared_per_socket" else n_dev,)
    assert st["slot_load"].shape == (10_000,)
    assert int(st["shard_load"].sum()) == int(st["slot_load"].sum()) == \
        int(st["shipped"].sum())
    keys = np.asarray(stream["keys"]).reshape(-1)
    np.testing.assert_array_equal(st["slot_load"],
                                  np.bincount(keys, minlength=10_000))
    for v in st.values():
        assert np.asarray(v).dtype == np.int32


@pytest.mark.parametrize("layout,mesh", LAYOUTS)
def test_carry_round_trip(layout, mesh):
    store = T_APPS["tp"].make_store(device="cpu")
    vals = torch.randn(store.values.shape)
    vals[-1] = 0.0
    eng = DualModeEngine(T_APPS["tp"], store, device="cpu",
                         mesh=ShardMesh(*mesh, device="cpu"), layout=layout)
    carry = eng.carry_in(vals)
    assert torch.equal(eng.carry_out(carry), vals)
    assert eng.owners == ()
    eng.rebind_ownership(((0, 1), (1, 0)) if layout != "shared_everything"
                         else ())
    assert torch.equal(eng.carry_out(eng.carry_in(vals)), vals)


def test_stream_shorter_than_an_interval():
    store = T_APPS["gs"].make_store(device="cpu")
    eng = DualModeEngine(T_APPS["gs"], store, device="cpu",
                         mesh=ShardMesh(*MESH1, device="cpu"))
    stream = T_APPS["gs"].gen_events(np.random.default_rng(0), 10)
    outs, vals = eng.run_stream(store.values, stream, 16)
    assert outs == [] and torch.equal(vals, store.values)
    assert eng.last_exchange_stats["dropped"].shape == (0,)


def test_sharded_engine_rejects_what_it_does_not_run():
    app = T_APPS["gs"]
    store = app.make_store(device="cpu")
    mesh = ShardMesh(*MESH1, device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        DualModeEngine(app, store, EngineConfig(scheme="tstream_lockstep"),
                       device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="TStream/mvlk"):
        DualModeEngine(app, store, EngineConfig(scheme="lock"),
                       device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="socket, core"):
        DualModeEngine(app, store, device="cpu", mesh=mesh,
                       layout="shared_per_socket")
    with pytest.raises(ValueError, match="layout"):
        DualModeEngine(app, store, device="cpu", mesh=mesh, layout="numa")
    eng = DualModeEngine(app, store, device="cpu", mesh=mesh)
    stream = app.gen_events(np.random.default_rng(0), 64)
    with pytest.raises(ValueError, match="fused"):
        eng.run_stream(store.values, stream, 32, fused=False)
    with pytest.raises(ValueError, match="divide evenly"):
        eng.run_stream(store.values, stream, 36)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardMesh(*MESH1)


# ---------------------------------------------------------------------------
# the collectives against a loop over shards (the meaning of jax.lax's)
# ---------------------------------------------------------------------------
def _stack(mesh, fn):
    """Stacked [n_i, n_shards, ...] tensor from a per-shard function."""
    coords = list(itertools.product(*[range(s) for s in mesh.shape]))
    return torch.stack([fn(c) for c in coords], dim=1)


@pytest.mark.parametrize("shape,names,axes", [
    ((8,), ("dev",), ("dev",)), ((2, 4), ("socket", "core"),
                                 ("socket", "core")),
    ((2, 4), ("socket", "core"), ("socket",)),
    ((2, 4), ("socket", "core"), ("core",)), ((3, 2), ("a", "b"), ("b",))])
def test_collectives_match_their_definition(shape, names, axes):
    mesh = ShardMesh(shape, names, device="cpu")
    coords = list(itertools.product(*[range(s) for s in shape]))
    idx = {c: i for i, c in enumerate(coords)}
    group = [names.index(a) for a in axes]
    g_size = int(np.prod([shape[i] for i in group]))
    g = torch.Generator().manual_seed(len(coords) * 7 + g_size)
    x = torch.randn((3, mesh.size, g_size, 5), generator=g)

    def gid(c):   # row-major index within the group
        r = 0
        for i in group:
            r = r * shape[i] + c[i]
        return r

    def with_g(c, k):   # the shard of c's group with group index k
        c = list(c)
        for i in reversed(group):
            c[i] = k % shape[i]
            k //= shape[i]
        return tuple(c)

    want = _stack(mesh, lambda c: torch.stack(
        [x[:, idx[with_g(c, s)], gid(c)] for s in range(g_size)], dim=1))
    torch.testing.assert_close(mesh.all_to_all(x, axes, 1, 1, dim=1), want,
                               rtol=0, atol=0)
    for ax in axes:
        m = names.index(ax)

        def others(c, k, m=m):
            c = list(c)
            c[m] = k
            return tuple(c)
        want_g = _stack(mesh, lambda c: torch.stack(
            [x[:, idx[others(c, k)]] for k in range(shape[m])], dim=1))
        torch.testing.assert_close(mesh.all_gather(x, ax, 1, dim=1), want_g,
                                   rtol=0, atol=0)
    members = {c: [d for d in coords
                   if all(d[i] == c[i] for i in range(len(shape))
                          if i not in group)] for c in coords}
    want_s = _stack(mesh, lambda c: sum(x[:, idx[d]] for d in members[c]))
    want_m = _stack(mesh, lambda c: torch.stack(
        [x[:, idx[d]] for d in members[c]]).amax(0))
    torch.testing.assert_close(mesh.psum(x, axes, dim=1), want_s)
    torch.testing.assert_close(mesh.pmax(x, axes, dim=1), want_m, rtol=0,
                               atol=0)
