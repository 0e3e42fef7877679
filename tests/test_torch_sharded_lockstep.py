"""The port's sharded lockstep schedule against the single-device runs.

SL (gated, non-associative) and OB (non-associative) shard under
``shared_nothing`` on a 1-D mesh of 8 shards on the CPU.  The JAX sharded
driver gives no output on the installed JAX, and its own contract is
bit-identity with the single-device fused driver
(``tests/sharded_stream_worker.py``), so each run is held to JAX's
single-device ``_fused`` run of the same stream and to the port's own
single-device run: final state, per-op pre/post/success and the outputs,
all bitwise, with no op dropped by the exchange.  Under ``tstream``,
``tstream_lockstep`` and ``mvlk`` the reference evaluates SL and OB with the
same lockstep walk, so one JAX run per stream serves the three schemes
(``tests/test_torch_lockstep.py`` holds the port's schemes to JAX's one by
one).  The overdrawn SL stream drives the abort repass and, with
``max_dep_levels=0``, the residue branch, as the JAX worker does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.scheduler import DualModeEngine, EngineConfig

from torch_parity import assert_dict_equal, np_, port_store

N_DEV = 8
MESH = ((N_DEV,), ("dev",))


def overdraw(stream):
    """Amounts x 100: most transfers overdraw their source and abort."""
    stream["amount"] = (stream["amount"] * 100).astype(np.float32)


STREAMS = {
    # name: (app, seed, n_events, interval, mutate, store keys, theta)
    "sl": ("sl", 3, 96, 32, None, None, None),
    "ob": ("ob", 3, 96, 32, None, None, None),
    "sl_overdrawn": ("sl", 3, 96, 24, overdraw, None, None),
    "sl_skewed": ("sl", 5, 96, 32, None, 64, 0.99),
}


def _batched(stream, n_i, interval):
    return {k: np.asarray(v)[:n_i * interval].reshape(
        (n_i, interval) + np.asarray(v).shape[1:]) for k, v in stream.items()}


@pytest.fixture(scope="module")
def reference():
    """(stream name, JAX config) -> (stream, JAX store, per-op results,
    outputs, final state) of JAX's single-device fused run, computed once."""
    cache = {}

    def get(name, **cfg_kw):
        key = (name, tuple(sorted(cfg_kw.items())))
        if key not in cache:
            app_name, seed, n, interval, mutate, n_keys, theta = \
                STREAMS[name]
            japp = J_APPS[app_name]
            gen = {} if n_keys is None else dict(n_keys=n_keys, theta=theta)
            stream = japp.gen_events(np.random.default_rng(seed), n, **gen)
            if mutate is not None:
                mutate(stream)
            jstore = (japp.make_store() if n_keys is None
                      else japp.make_store(n_keys))
            eng = JEngine(japp, jstore, JConfig(**cfg_kw))
            n_i = n // interval
            batched = {k: jnp.asarray(v) for k, v in
                       _batched(stream, n_i, interval).items()}
            res, ebs, vals, _ = eng._fused(jnp.array(jstore.values,
                                                     copy=True),
                                           batched, jnp.int32(0))
            outs = eng._outs(res, ebs, n_i)
            cache[key] = (stream, jstore, interval,
                          {k: np.asarray(v) for k, v in res.items()},
                          outs, np.asarray(vals))
        return cache[key]
    return get


def _check(ref, app_name, what, **cfg_kw):
    """The sharded run against JAX's single-device run and the port's."""
    stream, jstore, interval, jres, jouts, jvals = ref
    tapp = T_APPS[app_name]
    cfg = EngineConfig(**cfg_kw)
    eng = DualModeEngine(tapp, port_store(jstore), cfg, device="cpu",
                         mesh=ShardMesh(*MESH, device="cpu"),
                         exchange_slack=8.0)
    reset_launches()
    outs, vals = eng.run_stream(eng.init_store.values, stream, interval)
    assert all(v == 0 for v in LAUNCHES.values())   # the CPU takes twins
    st = eng.last_exchange_stats
    assert int(np.sum(st["dropped"])) == 0, f"{what}: ops dropped"
    np.testing.assert_array_equal(np_(vals), jvals, err_msg=f"{what}: state")
    assert len(outs) == len(jouts)
    for i, (o, jo) in enumerate(zip(outs, jouts)):
        assert_dict_equal(o, {k: np.asarray(v) for k, v in jo.items()},
                          f"{what}: outputs[{i}]")
    # per-op results, through the driver's whole-stream program
    sh = eng._sharded
    n_i = len(outs)
    res, _, _, _ = sh._blocks_impl(
        sh.carry_in(eng.init_store.values),
        events_to_torch(_batched(stream, n_i, interval), "cpu"), 0)
    assert_dict_equal(res, jres, f"{what}: per-op results")

    # the port's single-device run of the same rung
    single = DualModeEngine(tapp, eng.init_store, cfg, device="cpu")
    souts, svals = single.run_stream(eng.init_store.values, stream, interval)
    assert torch.equal(svals, vals), f"{what}: single-device state"
    for o, so in zip(outs, souts):
        assert_dict_equal(o, so, f"{what}: single-device outputs")
    return eng, outs, st


CASES = [(a, s, m) for a in ("sl", "ob")
         for s in ("tstream", "tstream_lockstep", "mvlk")
         for m in ("auto", "partition", "packed")]


@pytest.mark.parametrize("app_name,scheme,method", CASES,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CASES])
def test_sharded_lockstep_matches_single_device(reference, app_name, scheme,
                                                method):
    eng, _, st = _check(reference(app_name), app_name,
                        f"{app_name}/{scheme}/{method}", scheme=scheme,
                        restructure_method=method)
    assert not eng._sharded.assoc
    assert eng.last_rung == ("packed" if method == "auto" else method)
    assert int(st["swept"]) > 0 and int(st["residue"]) == 0


@pytest.mark.parametrize("method", ["auto", "partition"])
def test_sharded_abort_repass(reference, method):
    """Amounts x 100 under ``abort_repass``: transfers abort, their whole
    transaction is masked on the repass, and the verdicts need the global
    success frontier."""
    ref = reference("sl_overdrawn", abort_repass=True)
    _, outs, _ = _check(ref, "sl", f"sl/abort_repass/{method}",
                        abort_repass=True, restructure_method=method)
    assert sum(int(np.sum(o["rejected"])) for o in outs) > 0


def test_sharded_residue_branch(reference):
    """``max_dep_levels=0`` leaves every gated chain unresolved: its ops run
    once, in global (ts, slot) order, over every shard's residue ops."""
    _, _, st = _check(reference("sl_overdrawn", max_dep_levels=0), "sl",
                      "sl/residue", max_dep_levels=0,
                      restructure_method="partition")
    assert int(st["residue"]) > 0


def test_sharded_dependency_cycles_with_repass(reference):
    """A skewed stream over 64 accounts: cycles inside an interval reach the
    residue sweep, on both passes of the abort repass."""
    _, _, st = _check(reference("sl_skewed", abort_repass=True), "sl",
                      "sl/skewed", abort_repass=True)
    assert int(st["residue"]) > 0


@pytest.mark.parametrize("layout,mesh", [
    ("shared_per_socket", ((2, 4), ("socket", "core"))),
    ("shared_everything", MESH),
    ("shared_nothing", ((2, 4), ("socket", "core")))])
@pytest.mark.parametrize("app_name,scheme", [("sl", "tstream"),
                                             ("gs", "mvlk")])
def test_lockstep_shards_only_shared_nothing_on_a_flat_mesh(layout, mesh,
                                                            app_name, scheme):
    app = T_APPS[app_name]
    with pytest.raises(ValueError, match="1-D mesh"):
        DualModeEngine(app, app.make_store(device="cpu"),
                       EngineConfig(scheme=scheme), device="cpu",
                       mesh=ShardMesh(*mesh, device="cpu"), layout=layout)


def test_pmin_is_the_min_over_the_group():
    mesh = ShardMesh((2, 4), ("socket", "core"), device="cpu")
    x = torch.randint(-50, 50, (3, 8, 5), generator=torch.Generator()
                      .manual_seed(0), dtype=torch.int32)
    (got,) = mesh.pmin((x,), ("core",), dim=1)
    want = x.reshape(3, 2, 4, 5).amin(2, keepdim=True).expand(3, 2, 4, 5)
    assert torch.equal(got, want.reshape(3, 8, 5))
    assert torch.equal(mesh.pmin((x,), ("socket", "core"), dim=1)[0],
                       x.amin(1, keepdim=True).expand_as(x))
