"""The port's controller and ``rebalance_ownership`` against the reference.

``runtime/controller.py`` is a copy of the reference's pure-Python module,
and ``core/ownership.rebalance_ownership`` a copy of its numpy placement.
Held here: over seeded record windows (hypothesis) ``decide``, the folded
controller trace, ``replay_plan`` and ``restore`` equal the reference's;
the sharded plan moves ``chunk`` as the code stands (the reference's
property test asserts a slack-only sharded lattice, which the code does
not keep: ROADMAP C); ``rebalance_ownership`` returns the reference's
overrides.
"""
import copy

import numpy as np
from hypothesis import given, settings, strategies as st

from repro.core.ownership import rebalance_ownership as j_rebalance
from repro.runtime import controller as jc

from repro_torch.core.ownership import rebalance_ownership
from repro_torch.runtime import controller as tc


def mk_record(i, *, scheme="tstream", fail=0, ops=64, max_chain=1,
              qfill=0, x_drop=0, x_fill=0, x_cap=20, k=2, lat_s=0.01,
              x_shard=None, hot=None):
    r = dict(i=i, g0=i * k, k=k, events=k * 16, lat_s=lat_s, qfill=qfill,
             scheme=scheme, fail=fail, ops=ops, max_chain=max_chain,
             n_chains=1, rounds=1, x_drop=x_drop, x_ship=10, x_fill=x_fill,
             x_cap=x_cap)
    if x_shard is not None:
        r["x_shard"], r["hot"] = x_shard, hot or []
    return r


def _cfgs(mod, p):
    return mod.ControllerConfig(
        window=3, sustain=p["sustain"], cooldown=p["cooldown"],
        degrade_scheme="lock", degrade_chain_frac=0.5,
        degrade_fail_frac=0.25, slack_widen=True, slack_factor=2.0,
        slack_max=16.0, fill_widen=0.9, max_escalations=3,
        chunk_ladder=(1, 2, 4, 8, 16), backlog_grow=2.0,
        rung_ladder=("auto", "safe"), rung_chain_frac=0.6,
        reshard_imbalance=p["imbalance"], reshard_max_moves=4,
        grow_lat_s=0.02, shrink_lat_s=0.005, allow_timing=p["timing"])


record_st = st.builds(
    lambda scheme, fail, chain, qfill, drop, fill, lat, shard, hot: dict(
        scheme=scheme, fail=fail, max_chain=chain, qfill=qfill, x_drop=drop,
        x_fill=fill, lat_s=lat, x_shard=shard, hot=hot),
    st.sampled_from(["tstream", "lock"]), st.integers(0, 64),
    st.integers(0, 32), st.integers(0, 16), st.integers(0, 8),
    st.integers(0, 30), st.sampled_from([0.001, 0.01, 0.05]),
    st.lists(st.integers(0, 40), min_size=4, max_size=4),
    st.lists(st.tuples(st.integers(0, 63), st.integers(1, 20)),
             max_size=6))
cfg_st = st.fixed_dictionaries(dict(
    sustain=st.integers(1, 3), cooldown=st.integers(1, 6),
    snap=st.sampled_from([0, 4]), imbalance=st.sampled_from([0.0, 1.5]),
    timing=st.booleans()))


def _drive(mod, cfg, base, records, sharded, snap):
    ctl = mod.PlanController(cfg, base, sharded=sharded, snap_align=snap,
                             queue_cap=8, n_owners=4 if sharded else 0,
                             n_slots=64 if sharded else 0)
    window = []
    for j, r in enumerate(records):
        window.append(mk_record(j, **r))
        ctl.step(j * 2, window[-cfg.window:])
    return ctl


@settings(max_examples=60, deadline=None)
@given(params=cfg_st, records=st.lists(record_st, min_size=1, max_size=12),
       sharded=st.booleans())
def test_decide_and_trace_equal_the_reference(params, records, sharded):
    tcfg, jcfg = _cfgs(tc, params), _cfgs(jc, params)
    tbase = tc.Plan(scheme="tstream", rung="auto", slack=1.0, chunk=2)
    jbase = jc.Plan(scheme="tstream", rung="auto", slack=1.0, chunk=2)
    window = [mk_record(j, **r) for j, r in enumerate(records)]
    last = {"scheme": 0} if len(records) > 3 else {}
    kw = dict(sharded=sharded, esc_done=0, snap_align=params["snap"],
              queue_cap=8, n_owners=4 if sharded else 0,
              n_slots=64 if sharded else 0)
    frozen = copy.deepcopy(window)
    got = tc.decide(tcfg, tbase, window, 10, dict(last), init_plan=tbase,
                    **kw)
    want = jc.decide(jcfg, jbase, window, 10, dict(last), init_plan=jbase,
                     **kw)
    assert got == want
    assert window == frozen

    tctl = _drive(tc, tcfg, tbase, records, sharded, params["snap"])
    jctl = _drive(jc, jcfg, jbase, records, sharded, params["snap"])
    assert tctl.trace == jctl.trace
    assert tctl.plan.as_dict() == jctl.plan.as_dict()
    assert tctl.esc_done == jctl.esc_done
    assert tc.replay_plan(tbase, tctl.trace).as_dict() == \
        jc.replay_plan(jbase, jctl.trace).as_dict()
    fresh = tc.PlanController(tcfg, tbase, sharded=sharded,
                              snap_align=params["snap"], queue_cap=8)
    fresh.restore(tctl.trace, plan_check=tctl.plan.as_dict())
    assert fresh.last_switch == tctl.last_switch


def test_sharded_plan_moves_chunk_as_the_code_stands():
    """A sustained backlog on a sharded plan grows K: ``decide`` moves the
    chunk knob when sharded (DESIGN.md §2.9), in both packages."""
    params = dict(sustain=2, cooldown=1, snap=4, imbalance=0.0,
                  timing=False)
    window = [mk_record(j, qfill=4) for j in range(3)]
    base = tc.Plan(scheme="tstream", rung="auto", slack=1.0, chunk=2)
    got = tc.decide(_cfgs(tc, params), base, window, 8, {},
                    init_plan=base, sharded=True, esc_done=0, snap_align=4,
                    queue_cap=8)
    assert [(d["knob"], d["old"], d["new"]) for d in got] == \
        [("chunk", 2, 4)]
    jbase = jc.Plan(scheme="tstream", rung="auto", slack=1.0, chunk=2)
    assert got == jc.decide(_cfgs(jc, params), jbase, window, 8, {},
                            init_plan=jbase, sharded=True, esc_done=0,
                            snap_align=4, queue_cap=8)


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_owners=st.integers(1, 6),
       max_moves=st.integers(1, 6))
def test_rebalance_ownership_equals_the_reference(seed, n_owners,
                                                  max_moves):
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(n_owners, 80))
    overrides = sorted({(int(u), int(rng.integers(0, n_owners)))
                        for u in rng.integers(0, n_slots, 3)})
    overrides = sorted(dict(overrides).items())
    load = rng.integers(0, 100, n_owners)
    hot = [(int(u), int(c)) for u, c in zip(
        rng.integers(0, n_slots, 10), rng.integers(0, 50, 10))]
    got = rebalance_ownership(n_slots, n_owners, overrides, load, hot,
                              max_moves=max_moves)
    want = j_rebalance(n_slots, n_owners, overrides, load, hot,
                       max_moves=max_moves)
    assert got == want
