"""Live resharding on the port (``ShardedStream.reshard``, ``ckpt.reshard``,
the elastic service), held against the JAX package.

1. ``migration_plan`` gives the reference's arrays exactly, for several
   (old, new) placements and for the identity.
2. ``reshard`` moves a block carry onto a new placement: the canonical
   values are unchanged, the blocks are what ``carry_in`` builds under the
   new placement, and the rows shipped are the plan's movers.
3. ``ckpt.reshard`` loads a snapshot cut on a 4-shard engine onto an
   8-shard and a single-device one, and the restored runs finish as the
   uninterrupted one.
4. The elastic service on an 8-shard ``shared_nothing`` engine migrates
   mid-stream under a skew storm (calm, aligned Zipf theta 2.5, calm) with
   no exchange drop, for GS, SL, OB and TP under tstream and GS and OB under
   mvlk (the reference's ``tests/reshard_worker.py`` cases).  The JAX
   sharded driver gives no output on the installed JAX, so the run is held
   to the JAX single-device ``run_stream`` of the in-order events: state
   bitwise, outputs bitwise for SL and OB and to 1e-5 for GS and TP (the
   apps' post-processing reductions associate differently in torch), and
   bitwise with the port's own single-device run.
5. A crash at ``reshard.apply``, resume and replay equal the uninterrupted
   elastic run bit for bit, with the same controller plan.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.ownership import build_ownership as j_build_ownership
from repro.core.ownership import migration_plan as j_migration_plan
from repro.core.ownership import rebalance_ownership as j_rebalance
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig
from repro.core.types import make_store as j_make_store

from repro_torch.apps import ALL_APPS
from repro_torch.ckpt import checkpoint_steps, reshard, save_checkpoint
from repro_torch.core.intervals import PhasedReplaySource, WatermarkPolicy
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.ownership import build_ownership, migration_plan
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.faults import (RESHARD_APPLY, Fault, FaultPlane,
                                        InjectedCrashError)
from repro_torch.runtime.service import ServiceConfig, StreamService

from torch_parity import assert_outputs_close, port_store

INTERVAL = 64
JITTER = 4
N_SHARDS = 8
# reshard-only controller: every other knob's lattice is empty
CTL = ControllerConfig(window=4, sustain=2, cooldown=4, slack_widen=False,
                       reshard_imbalance=3.0, reshard_max_moves=24)


def mesh(n=N_SHARDS):
    return ShardMesh((n,), ("dev",), device="cpu")


# ---------------------------------------------------------------------------
# 1. migration_plan
# ---------------------------------------------------------------------------
def _placements(n_slots, n_owners, seed):
    """Three legal placements (bins keep their striped size): the striping,
    and two rebalances from seeded hot lists, the second on top of the
    first."""
    rng = np.random.default_rng(seed)
    out, cur = [()], ()
    for _ in range(2):
        hot = [(int(u), int(c)) for u, c in zip(
            rng.choice(n_slots, 12, replace=False),
            rng.integers(1, 50, 12))]
        load = rng.integers(0, 100, n_owners)
        cur = j_rebalance(n_slots, n_owners, cur, load, hot, max_moves=6)
        out.append(cur)
    return out


@pytest.mark.parametrize("n_slots,n_owners", [(40, 4), (37, 8), (10_000, 8)])
@pytest.mark.parametrize("pair", ["identity", "stripe->a", "a->b", "b->stripe"])
def test_migration_plan_matches_reference(n_slots, n_owners, pair):
    stripe, a, b = _placements(n_slots, n_owners, seed=n_slots + n_owners)
    assert a and b != a, "the seeded hot lists must move something"
    old, new = {"identity": (a, a), "stripe->a": (stripe, a),
                "a->b": (a, b), "b->stripe": (b, stripe)}[pair]
    jstore = j_make_store([n_slots], 2)
    tstore = port_store(jstore)
    want = j_migration_plan(j_build_ownership(jstore, n_owners, old),
                            j_build_ownership(jstore, n_owners, new))
    got = migration_plan(build_ownership(tstore, n_owners, old),
                         build_ownership(tstore, n_owners, new))
    for g, w, what in zip(got[:2], want[:2], ("dst", "nidx")):
        assert g.dtype == w.dtype == np.int32, what
        np.testing.assert_array_equal(g, w, err_msg=what)
    assert got[2] == want[2]
    if pair == "identity":
        assert got[2] == 1


# ---------------------------------------------------------------------------
# 2. reshard on block carries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app_name", ["gs", "tp"])
def test_reshard_moves_only_the_movers(app_name):
    app = ALL_APPS[app_name]
    store = app.make_store(device="cpu")
    eng = DualModeEngine(app, store, device="cpu", mesh=mesh())
    assert eng.reshardable
    sh = eng._sharded
    rng = np.random.default_rng(5)
    values = torch.from_numpy(rng.standard_normal(
        tuple(store.values.shape)).astype(np.float32))
    values[-1] = 0.0
    _, a, b = _placements(store.n_slots, N_SHARDS, seed=1)
    blocks = eng.carry_in(values)
    for overrides in (a, b, ()):
        dst, _, _ = migration_plan(sh.own,
                                   build_ownership(sh.store, N_SHARDS,
                                                   overrides))
        movers = int(np.sum(dst != np.arange(N_SHARDS)[:, None]))
        blocks, moved = eng.apply_resharding(blocks, overrides)
        assert moved == movers > 0
        assert eng.owners == overrides
        assert torch.equal(eng.carry_out(blocks), values)
        assert all(map(torch.equal, blocks, eng.carry_in(values)))
    same, moved = eng.apply_resharding(blocks, ())
    assert same is blocks and moved == 0


def test_reshard_rejected_where_it_cannot_migrate():
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    for kw in (dict(layout="shared_everything"),
               dict(cfg=EngineConfig(use_hash_probe_route=True))):
        eng = DualModeEngine(app, store, kw.pop("cfg", EngineConfig()),
                             device="cpu", mesh=mesh(), **kw)
        assert not eng.reshardable
        with pytest.raises(ValueError, match="live migration"):
            eng.apply_resharding(eng.carry_in(store.values), ((0, 1),))
    single = DualModeEngine(app, store, device="cpu")
    assert not single.reshardable
    carry, moved = single.apply_resharding(store.values, ((0, 1),))
    assert carry is store.values and moved == 0


# ---------------------------------------------------------------------------
# 3. ckpt.reshard: a 4-shard snapshot onto 8 shards and onto one device
# ---------------------------------------------------------------------------
def test_ckpt_reshard_across_meshes(tmp_path):
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    src = lambda: storm_source(app, {}, n_mod=4)
    cfg = lambda **kw: ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=JITTER), **kw)
    one = DualModeEngine(app, store, device="cpu")
    ref = StreamService(one, cfg()).run(src())

    eng4 = DualModeEngine(app, store, device="cpu", mesh=mesh(4),
                          exchange_slack=8.0)
    cut = StreamService(eng4, cfg(snapshot_every=4,
                                  ckpt_dir=str(tmp_path))).run(
        src(), max_intervals=8)
    assert cut.stats["drops"]["exchange"] == 0
    step = checkpoint_steps(str(tmp_path))[0]
    assert step == 8
    for n, target in ((8, DualModeEngine(app, store, device="cpu",
                                         mesh=mesh(8), exchange_slack=8.0)),
                      (1, DualModeEngine(app, store, device="cpu"))):
        restored = reshard(str(tmp_path), step, dict(values=store.values),
                           mesh(n), lambda t, m: {k: m.device for k in t})
        vals = restored["values"]
        assert isinstance(vals, torch.Tensor) and vals.device.type == "cpu"
        assert torch.equal(target.carry_out(target.carry_in(vals)), vals)
        rec = StreamService(target, cfg()).run(src(), values=vals,
                                               skip_intervals=step)
        assert rec.stats["drops"]["exchange"] == 0
        np.testing.assert_array_equal(rec.final_values, ref.final_values)
        for a, b in zip(rec.outputs, ref.outputs[step:]):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert len(rec.outputs) == len(ref.outputs) - step


def test_ckpt_reshard_places_each_leaf(tmp_path):
    tree = dict(a=np.arange(6, dtype=np.float32).reshape(2, 3),
                b=[np.ones(4, np.int32)])
    save_checkpoint(str(tmp_path), 3, tree)
    got = reshard(str(tmp_path), 3, tree, mesh(2),
                  lambda t, m: dict(a=m.device, b=["cpu"]))
    assert isinstance(got["a"], torch.Tensor)
    np.testing.assert_array_equal(got["a"].numpy(), tree["a"])
    np.testing.assert_array_equal(got["b"][0].numpy(), tree["b"][0])
    with pytest.raises(ValueError, match="leaves"):
        reshard(str(tmp_path), 3, tree, mesh(2), lambda t, m: dict(a="cpu"))


# ---------------------------------------------------------------------------
# 4. the elastic service, held to the JAX single-device run
# ---------------------------------------------------------------------------
def app_kwargs(app_name):
    # TP's segment table must stay divisible by align_mod
    return dict(n_segments=96) if app_name == "tp" else {}


def storm_source(app, base, seed=7, n_mod=N_SHARDS):
    """calm -> aligned-Zipf hot phase -> calm, all one seeded stream."""
    hot = dict(base, theta=2.5, align_mod=n_mod)
    return PhasedReplaySource(
        app.gen_events,
        [(4 * INTERVAL, base), (8 * INTERVAL, hot), (4 * INTERVAL, base)],
        seed=seed, arrival_batch=37, jitter=JITTER)


def elastic_cfg(**kw):
    return ServiceConfig(punct_interval=INTERVAL, chunk_intervals=2,
                         watermark=WatermarkPolicy(allowed_lateness=JITTER),
                         controller=CTL, **kw)


def elastic_engine(app_name, scheme, jstore):
    return DualModeEngine(ALL_APPS[app_name], port_store(jstore),
                          EngineConfig(scheme=scheme), device="cpu",
                          mesh=mesh(), exchange_slack=8.0)


def assert_outputs_identical(got, want, what):
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{what} {k} interval {i}")


@pytest.mark.parametrize("app_name,scheme", [
    ("gs", "tstream"), ("sl", "tstream"), ("ob", "tstream"),
    ("tp", "tstream"), ("gs", "mvlk"), ("ob", "mvlk")])
def test_elastic_service_migrates_bitwise(app_name, scheme):
    kw = app_kwargs(app_name)
    japp, app = J_APPS[app_name], ALL_APPS[app_name]
    jstore = japp.make_store(**kw)
    events = storm_source(app, kw).in_order_events
    j_outs, j_vals = JEngine(japp, jstore, JConfig(scheme=scheme)).run_stream(
        jstore.values, {k: jnp.asarray(v) for k, v in events.items()},
        INTERVAL, fused=True)
    one = DualModeEngine(app, port_store(jstore),
                         EngineConfig(scheme=scheme), device="cpu")
    outs_1, vals_1 = one.run_stream(one.init_store.values, events, INTERVAL)

    eng = elastic_engine(app_name, scheme, jstore)
    rec = StreamService(eng, elastic_cfg()).run(storm_source(app, kw))
    place = rec.stats["placement"]
    assert len(place["migrations"]) >= 1 and place["moved_rows"] > 0
    assert rec.migrations == place["migrations"]
    assert any(d["knob"] == "reshard" for d in rec.decisions)
    assert place["owners"] and eng.owners == tuple(
        (u, o) for u, o in place["owners"])
    assert rec.stats["drops"]["exchange"] == 0
    assert rec.stats["exchange"]["shipped"] > 0
    assert len(place["shard_events"]) == N_SHARDS
    assert any("x_shard" in r and "hot" in r for r in rec.chunk_records)

    np.testing.assert_array_equal(rec.final_values, np.asarray(j_vals))
    np.testing.assert_array_equal(rec.final_values, vals_1.numpy())
    assert_outputs_identical(rec.outputs, outs_1, "vs the port's one device")
    if app_name in ("sl", "ob"):
        assert_outputs_identical(rec.outputs, j_outs, "vs JAX")
    else:
        assert_outputs_close(rec.outputs, j_outs, "vs JAX")


# ---------------------------------------------------------------------------
# 5. crash at reshard.apply -> resume -> replay
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app_name,scheme", [("gs", "tstream"),
                                             ("sl", "tstream")])
def test_crash_at_reshard_apply_resumes_bitwise(tmp_path, app_name, scheme):
    """GS takes the associative rung; SL the lockstep path, whose resumed
    carry re-enters through ``carry_in`` under the rebound ownership."""
    kw = app_kwargs(app_name)
    japp, app = J_APPS[app_name], ALL_APPS[app_name]
    jstore = japp.make_store(**kw)
    events = storm_source(app, kw).in_order_events
    _, j_vals = JEngine(japp, jstore, JConfig(scheme=scheme)).run_stream(
        jstore.values, {k: jnp.asarray(v) for k, v in events.items()},
        INTERVAL, fused=True)
    fresh = lambda: elastic_engine(app_name, scheme, jstore)

    ref = StreamService(fresh(), elastic_cfg(
        snapshot_every=4, ckpt_dir=str(tmp_path / "ref"))).run(
            storm_source(app, kw))
    assert ref.stats["placement"]["migrations"]

    cfg = elastic_cfg(snapshot_every=4, ckpt_dir=str(tmp_path / "go"))
    plane = FaultPlane([Fault(site=RESHARD_APPLY, at=0, kind="crash")])
    svc = StreamService(fresh(), cfg)
    with pytest.raises(InjectedCrashError):
        svc.run(storm_source(app, kw), faults=plane)
    crashed = svc.last_run
    assert crashed.migrations and crashed.snapshots
    assert crashed.stats["placement"]["migrations"] == crashed.migrations
    assert os.path.isdir(tmp_path / "go")

    rec = StreamService(fresh(), cfg).resume(storm_source(app, kw))
    snap = rec.stats["replayed"] // INTERVAL
    assert snap == crashed.snapshots[-1]
    assert rec.stats["placement"]["migrations"], "resumed run never migrated"
    assert rec.stats["controller"]["plan"] == ref.stats["controller"]["plan"]
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    np.testing.assert_array_equal(rec.final_values, np.asarray(j_vals))
    assert_outputs_identical(rec.outputs, ref.outputs[snap:], "post-resume")
    assert_outputs_identical(crashed.outputs,
                             ref.outputs[:len(crashed.outputs)], "pre-crash")
