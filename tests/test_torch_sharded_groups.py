"""The sharded driver over device groups, on the CPU.

``ShardedStream`` runs the reference's per-device program once per device
group of its mesh (``ShardMesh(..., devices=[...])``), each group's shards
holding their own state blocks, with the collectives moving data between
groups.  On the CPU every group sits on ``"cpu"``, so the grouped code runs
here.  With G in {2, 4} groups of an 8-shard mesh the driver must be bit
for bit the one-group driver (G = 1: state, outputs, exchange stats and,
for the lockstep schedule, per-op results), since the CPU twins' segmented
scans are segment-relative and every collective is exact.  Its state is
also held to the JAX single-device fused run bitwise and its outputs to
rtol = atol = 1e-5 (SL and OB bitwise), the bars of the one-group sharded
tests (the JAX sharded driver gives no output on the installed JAX).

The cases: GS and TP under all three layouts and their rungs; SL and OB on
the lockstep schedule (plain, SL's abort repass, every gated chain left to
the residue sweep, and mvlk); the hash-probe route; ``run_chunk`` chained
over chunks; a live ``reshard`` of the block carry; the replicate-everything
``evaluate_sharded``; and the elastic service with a crash at
``reshard.apply``, resumed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.blotter import build_opbatch as j_build
from repro.core.engines import eval_tstream_scan as j_eval
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch.apps import ALL_APPS
from repro_torch.ckpt import checkpoint_steps, reshard
from repro_torch.convert import events_to_torch
from repro_torch.core.intervals import PhasedReplaySource, WatermarkPolicy
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.ownership import build_ownership, migration_plan
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.core.sharded import evaluate_sharded
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.runtime.faults import (RESHARD_APPLY, Fault, FaultPlane,
                                        InjectedCrashError)
from repro_torch.runtime.service import ServiceConfig, StreamService

from torch_parity import assert_outputs_close, np_, port_ops, port_store

N_EVENTS, INTERVAL = 128, 32
MESH1 = ((8,), ("dev",))
MESH2 = ((2, 4), ("socket", "core"))
LAYOUTS = {"shared_nothing": MESH1, "shared_per_socket": MESH2,
           "shared_everything": MESH1}
GROUPS = (2, 4)


def mesh_of(shape_names, g):
    shape, names = shape_names
    if g == 1:
        return ShardMesh(shape, names, device="cpu")
    return ShardMesh(shape, names, devices=["cpu"] * g)


def engine(app_name, store, g, *, layout="shared_nothing", mesh=MESH1,
           slack=8.0, **cfg):
    return DualModeEngine(ALL_APPS[app_name], store, EngineConfig(**cfg),
                          device="cpu", mesh=mesh_of(mesh, g), layout=layout,
                          exchange_slack=slack)


@pytest.fixture(scope="module")
def reference():
    """(app, rung, skewed, config) -> (stream, JAX store, outputs, final
    state) of JAX's single-device fused run, computed once.  Under
    ``abort_repass`` every amount is x 100, so most transfers overdraw and
    abort; ``skewed`` is SL on 64 accounts at theta 0.99, whose gated
    chains form cycles."""
    cache = {}

    def get(app_name, method="auto", skewed=False, **cfg):
        key = (app_name, method, skewed, tuple(sorted(cfg.items())))
        if key not in cache:
            japp = J_APPS[app_name]
            gen = dict(n_keys=64, theta=0.99) if skewed else {}
            stream = japp.gen_events(np.random.default_rng(11), N_EVENTS,
                                     **gen)
            if cfg.get("abort_repass"):
                stream["amount"] = (stream["amount"] * 100).astype(
                    np.float32)
            jstore = japp.make_store(64) if skewed else japp.make_store()
            eng = JEngine(japp, jstore, JConfig(restructure_method=method,
                                                **cfg))
            outs, vals = eng.run_stream(jstore.values, stream, INTERVAL,
                                        fused=True)
            cache[key] = (stream, jstore, outs, np.asarray(vals))
        return cache[key]
    return get


def per_op(eng, stream):
    """The sharded driver's per-op pre/post/success, back in flat per-op
    layout (the reverse exchange's output)."""
    sh = eng._sharded
    n_i = len(next(iter(stream.values()))) // INTERVAL
    ev = {k: np.asarray(v)[: n_i * INTERVAL].reshape(
        (n_i, INTERVAL) + np.asarray(v).shape[1:]) for k, v in stream.items()}
    res = sh._blocks_impl(sh.carry_in(eng.init_store.values),
                          events_to_torch(ev, "cpu"), 0)[0]
    return {k: v.clone() for k, v in res.items()}


def run_groups(ref, app_name, *, layout="shared_nothing", mesh=MESH1,
               lockstep=False, **cfg):
    """The run on G = 1, 2 and 4 groups: each grouped run bitwise with the
    one-group run, and that with the JAX single-device run."""
    stream, jstore, jouts, jvals = ref
    runs = {}
    for g in (1,) + GROUPS:
        eng = engine(app_name, port_store(jstore), g, layout=layout,
                     mesh=mesh, **cfg)
        outs, vals = eng.run_stream(eng.init_store.values, stream, INTERVAL)
        st = eng.last_exchange_stats
        assert int(np.sum(st["dropped"])) == 0
        runs[g] = (outs, vals, st, eng.last_rung,
                   per_op(eng, stream) if lockstep else None)
    outs1, vals1, st1, rung1, res1 = runs[1]
    for g in GROUPS:
        outs, vals, st, rung, res = runs[g]
        what = f"{app_name}/{layout}/G={g}"
        assert torch.equal(vals, vals1), what
        assert rung == rung1, what
        assert len(outs) == len(outs1) > 0
        for a, b in zip(outs, outs1):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=what)
        for k in st1:
            np.testing.assert_array_equal(st[k], st1[k], err_msg=f"{what} {k}")
        if res1 is not None:
            for k in res1:
                assert torch.equal(res[k], res1[k]), f"{what} per-op {k}"
    np.testing.assert_array_equal(np_(vals1), jvals)
    if lockstep:
        for a, b in zip(outs1, jouts):
            for k in b:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    else:
        assert_outputs_close(outs1, jouts, f"{app_name}/{layout} vs JAX")
    return runs


RUNGS = {"gs": ["auto", "partition", "megakernel"], "tp": ["auto",
                                                           "partition"]}
ASSOC = [(a, m, lay) for a in ("gs", "tp") for m in RUNGS[a]
         for lay in LAYOUTS]


@pytest.mark.parametrize("app_name,method,layout", ASSOC,
                         ids=[f"{a}-{m}-{lay}" for a, m, lay in ASSOC])
def test_grouped_associative_driver(reference, app_name, method, layout):
    run_groups(reference(app_name, method=method), app_name, layout=layout,
               mesh=LAYOUTS[layout], restructure_method=method)


LOCKSTEP = [("sl", "partition", {}), ("sl", "auto", {}),
            ("sl", "partition", {"skewed": True}),
            ("sl", "partition", {"abort_repass": True}),
            ("sl", "partition", {"max_dep_levels": 0}),
            ("sl", "partition", {"scheme": "mvlk"}),
            ("ob", "partition", {}), ("ob", "auto", {"scheme": "mvlk"})]


@pytest.mark.parametrize("app_name,method,cfg", LOCKSTEP,
                         ids=[f"{a}-{m}-" + ("-".join(f"{k}={v}" for k, v in
                                                      c.items()) or "plain")
                              for a, m, c in LOCKSTEP])
def test_grouped_lockstep_driver(reference, app_name, method, cfg):
    cfg = dict(cfg)
    ref = reference(app_name, method=method, **cfg)
    cfg.pop("skewed", None)
    runs = run_groups(ref, app_name, lockstep=True,
                      restructure_method=method, **cfg)
    st = runs[4][2]
    if cfg.get("max_dep_levels") == 0:
        assert int(st["residue"]) > 0, "no op reached the residue sweep"


@pytest.mark.parametrize("app_name,layout", [("gs", "shared_nothing"),
                                             ("tp", "shared_per_socket")])
def test_grouped_hash_probe_route(reference, app_name, layout):
    run_groups(reference(app_name), app_name, layout=layout,
               mesh=LAYOUTS[layout], use_hash_probe_route=True)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("app_name", ["gs", "sl"])
def test_grouped_run_chunk_chains(app_name, g):
    """Two chained chunks on a grouped engine equal its ``run_stream`` and
    the one-group chunks; the carry is a tuple of one tensor per group on
    its device, and a chunk does not write the carry it was given."""
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(2), 4 * INTERVAL)
    got = {}
    for n in (1, g):
        eng = engine(app_name, app.make_store(device="cpu"), n)
        outs, vals = eng.run_stream(eng.init_store.values, stream, INTERVAL)
        carry = eng.carry_in(eng.init_store.values)
        assert isinstance(carry, tuple) and len(carry) == n
        before = tuple(c.clone() for c in carry)
        chunks, stats = [], []
        for c in range(2):
            part = {k: v[c * 2 * INTERVAL:(c + 1) * 2 * INTERVAL].reshape(
                (2, INTERVAL) + v.shape[1:]) for k, v in stream.items()}
            res, ebs, nxt, st = eng.run_stream_chunk(
                carry, events_to_torch(part, "cpu"), c * 2 * INTERVAL)
            if c == 0:
                assert all(map(torch.equal, carry, before))
            chunks += eng.post_outputs(res, ebs, 2)
            stats.append(st["exchange"])
            carry = nxt
        assert torch.equal(eng.carry_out(carry), vals)
        for a, b in zip(chunks, outs):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        got[n] = (vals, chunks, stats)
    assert torch.equal(got[g][0], got[1][0])
    for a, b in zip(got[g][1], got[1][1]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(got[g][2], got[1][2]):
        for k in b:
            assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k]))


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_carry_round_trip(layout, g):
    store = ALL_APPS["tp"].make_store(device="cpu")
    vals = torch.randn(store.values.shape,
                       generator=torch.Generator().manual_seed(g))
    vals[-1] = 0.0
    one = engine("tp", store, 1, layout=layout, mesh=LAYOUTS[layout])
    eng = engine("tp", store, g, layout=layout, mesh=LAYOUTS[layout])
    carry = eng.carry_in(vals)
    assert len(carry) == g
    assert torch.equal(eng.carry_out(carry), vals)
    if layout == "shared_nothing":
        # the one-group blocks, cut at the groups' shards
        assert torch.equal(torch.cat(carry), one.carry_in(vals)[0])


@pytest.mark.parametrize("g", GROUPS)
def test_grouped_reshard_moves_the_carry(g):
    """A live migration of a grouped carry: the canonical values stay, the
    blocks are ``carry_in`` under the new placement, and the rows moved are
    the plan's movers and the one-group migration's."""
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    vals = torch.randn(store.values.shape,
                       generator=torch.Generator().manual_seed(5))
    vals[-1] = 0.0
    one, eng = engine("gs", store, 1), engine("gs", store, g)
    assert eng.reshardable
    hot = [(u, 50 - u) for u in range(0, 48, 8)]    # all on shard 0
    overrides = eng._sharded.owners
    from repro_torch.core.ownership import rebalance_ownership
    overrides = rebalance_ownership(store.n_slots, 8, overrides,
                                    np.array([600] + [10] * 7), hot,
                                    max_moves=6)
    assert overrides
    dst, _, _ = migration_plan(eng._sharded.own,
                               build_ownership(eng._sharded.store, 8,
                                               overrides))
    movers = int(np.sum(dst != np.arange(8)[:, None]))
    b1, m1 = one.apply_resharding(one.carry_in(vals), overrides)
    bg, mg = eng.apply_resharding(eng.carry_in(vals), overrides)
    assert mg == m1 == movers > 0
    assert eng.owners == one.owners == overrides
    assert torch.equal(eng.carry_out(bg), vals)
    assert all(map(torch.equal, bg, eng.carry_in(vals)))
    assert torch.equal(torch.cat(bg), b1[0])


@pytest.mark.parametrize("method", ["auto", "partition"])
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("app_name", ["gs", "tp"])
def test_grouped_evaluate_sharded(app_name, layout, g, method):
    japp = J_APPS[app_name]
    jstore = japp.make_store()
    ev = japp.gen_events(np.random.default_rng(3), 96)
    jops, _ = j_build(japp, jstore, {k: jnp.asarray(v) for k, v in ev.items()},
                      jnp.int32(0))
    _, want, _ = jax.jit(lambda s, o: j_eval(s, o, japp.funs,
                                             rowmajor_ts=True))(jstore, jops)
    got = {n: evaluate_sharded(port_store(jstore), port_ops(jops),
                               ALL_APPS[app_name].funs,
                               mesh_of(LAYOUTS[layout], n), layout,
                               restructure_method=method)
           for n in (1, g)}
    assert torch.equal(got[g], got[1])
    np.testing.assert_array_equal(got[g].numpy(), np.asarray(want)[:-1])


def _storm(app):
    return PhasedReplaySource(
        app.gen_events, [(4 * INTERVAL, {}),
                         (8 * INTERVAL, dict(theta=2.5, align_mod=8)),
                         (4 * INTERVAL, {})],
        seed=7, arrival_batch=37, jitter=4)


def _elastic_cfg(**kw):
    return ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=4),
        controller=ControllerConfig(window=4, sustain=2, cooldown=4,
                                    slack_widen=False, reshard_imbalance=3.0,
                                    reshard_max_moves=24), **kw)


@pytest.mark.parametrize("app_name", ["gs", "sl"])
def test_grouped_service_migrates_and_resumes(app_name, tmp_path):
    """The elastic service on 4 groups migrates live as the one-group one
    does, bit for bit, and equals the JAX single-device run; a crash at
    ``reshard.apply``, resumed from the last snapshot, replays to the same
    bits."""
    japp, app = J_APPS[app_name], ALL_APPS[app_name]
    jstore = japp.make_store()
    events = _storm(app).in_order_events
    _, j_vals = JEngine(japp, jstore, JConfig()).run_stream(
        jstore.values, {k: jnp.asarray(v) for k, v in events.items()},
        INTERVAL, fused=True)
    recs = {n: StreamService(engine(app_name, port_store(jstore), n),
                             _elastic_cfg()).run(_storm(app))
            for n in (1, 4)}
    rec = recs[4]
    assert rec.stats["placement"]["migrations"]
    untimed = lambda p: dict(p, migrations=[
        {k: v for k, v in m.items() if k != "apply_s"}
        for m in p["migrations"]])
    assert untimed(rec.stats["placement"]) == untimed(
        recs[1].stats["placement"])
    assert rec.stats["drops"]["exchange"] == 0
    np.testing.assert_array_equal(rec.final_values, recs[1].final_values)
    np.testing.assert_array_equal(rec.final_values, np.asarray(j_vals))
    for a, b in zip(rec.outputs, recs[1].outputs):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])

    fresh = lambda: engine(app_name, port_store(jstore), 4)
    cfg = _elastic_cfg(snapshot_every=4, ckpt_dir=str(tmp_path))
    svc = StreamService(fresh(), cfg)
    with pytest.raises(InjectedCrashError):
        svc.run(_storm(app), faults=FaultPlane([Fault(
            site=RESHARD_APPLY, at=0, kind="crash")]))
    crashed = svc.last_run
    res = StreamService(fresh(), cfg).resume(_storm(app))
    snap = res.stats["replayed"] // INTERVAL
    assert crashed.migrations and snap == crashed.snapshots[-1]
    np.testing.assert_array_equal(res.final_values, rec.final_values)
    for a, b in zip(res.outputs, rec.outputs[snap:]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_snapshot_restores_onto_a_grouped_mesh(tmp_path):
    """A snapshot cut on a one-group 8-shard service loads through
    ``ckpt.reshard`` onto the last group's device, and the 4-group service
    resumed from it finishes as the uninterrupted run."""
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    cfg = lambda **kw: ServiceConfig(
        punct_interval=INTERVAL, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=4), **kw)
    ref = StreamService(engine("gs", store, 1), cfg()).run(_storm(app))
    StreamService(engine("gs", store, 1), cfg(
        snapshot_every=4, ckpt_dir=str(tmp_path))).run(_storm(app),
                                                       max_intervals=8)
    (step,) = checkpoint_steps(str(tmp_path))[:1]
    target = engine("gs", store, 4)
    mesh = target._sharded.mesh
    got = reshard(str(tmp_path), step, dict(values=store.values), mesh,
                  lambda t, m: dict(values=m.devices[-1]))
    vals = got["values"]
    assert torch.equal(target.carry_out(target.carry_in(vals)), vals)
    rec = StreamService(target, cfg()).run(_storm(app), values=vals,
                                           skip_intervals=step)
    np.testing.assert_array_equal(rec.final_values, ref.final_values)
    for a, b in zip(rec.outputs, ref.outputs[step:]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
