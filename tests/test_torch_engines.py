"""The port's engines against the JAX reference, one interval at a time.

``evaluate`` under every scheme (the segmented-scan path, the lockstep
walk, the sequential oracle and the baselines) must give the reference's
per-op results and new state bit for bit for GS and TP, and the staged
stages must agree stage by stage (the lockstep schemes and SL and OB are
held in ``test_torch_lockstep.py``); what still raises is pinned last.
"""
import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.blotter import build_opbatch as j_build
from repro.core.engines import evaluate as j_evaluate
from repro.core.engines import tstream_scan_coefs as j_coefs
from repro.core.engines import tstream_scan_plan as j_plan
from repro.core.restructure import megakernel_engaged as j_mega_engaged
from repro.core.restructure import restructure as j_restructure

from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.core.engines import (evaluate, tstream_scan_coefs,
                                      tstream_scan_plan)
from repro_torch.core.restructure import (megakernel_engaged,
                                          megakernel_fits, restructure)
from repro_torch.kernels.megakernel.ops import megakernel_smem_bytes

from torch_parity import (assert_dict_equal, np_, port_ops, port_store)

restructure_mod = importlib.import_module("repro_torch.core.restructure")


def _interval(app_name, n_events=48, seed=0):
    japp = J_APPS[app_name]
    stream = japp.gen_events(np.random.default_rng(seed), n_events)
    jstore = japp.make_store()
    jops, _ = j_build(japp, jstore,
                      {k: jnp.asarray(v) for k, v in stream.items()},
                      jnp.int32(0))
    return japp, jstore, jops, T_APPS[app_name], port_store(jstore)


@pytest.mark.parametrize("app_name", ["gs", "tp"])
@pytest.mark.parametrize("scheme", ["tstream", "tstream_scan", "lock",
                                    "tstream_lockstep", "mvlk", "pat",
                                    "nolock"])
def test_evaluate_bitwise(app_name, scheme):
    japp, jstore, jops, tapp, tstore = _interval(app_name)
    jres, jvals, jstats = jax.jit(lambda st, o: j_evaluate(
        st, o, japp.funs, scheme, associative_only=japp.associative_only,
        rowmajor_ts=True))(jstore, jops)
    tres, tvals, tstats = evaluate(
        tstore, port_ops(jops), tapp.funs, scheme,
        associative_only=tapp.associative_only, rowmajor_ts=True)
    np.testing.assert_array_equal(np_(tvals), np.asarray(jvals))
    assert_dict_equal(tres, {k: np.asarray(v) for k, v in jres.items()},
                      f"{app_name}/{scheme}")
    assert tstats.path == jstats.path and tstats.scheme == jstats.scheme
    for f in ("rounds", "n_chains", "max_chain"):
        assert int(getattr(tstats, f)) == int(getattr(jstats, f)), f


@pytest.mark.parametrize("app_name", ["gs", "tp"])
def test_scan_plan_and_coefs_bitwise(app_name):
    japp, jstore, jops, tapp, tstore = _interval(app_name, seed=3)
    pad = jstore.pad_uid

    def j_staged(st, o):
        pres = j_restructure(o, pad, rowmajor_ts=True, light=True,
                             method="partition")
        return j_coefs(j_plan(st, o, japp.funs, prestructured=pres))

    jp = jax.jit(j_staged)(jstore, jops)
    tpres = restructure(port_ops(jops), tstore.pad_uid, rowmajor_ts=True,
                        light=True, method="partition")
    tp = tstream_scan_coefs(tstream_scan_plan(tstore, port_ops(jops),
                                              tapp.funs, prestructured=tpres))
    for f in ("af", "bf", "afi", "bfi", "mx", "mxi", "is_max_s",
              "commit_pos", "commit_ok"):
        g, w = getattr(tp, f), getattr(jp, f)
        if w is None:
            assert g is None, f
            continue
        np.testing.assert_array_equal(np_(g), np.asarray(w), err_msg=f)


def test_later_schemes_raise_not_ported():
    """What still raises: the lockstep schedule (SL, OB) on a 2-D mesh or
    under a layout other than shared_nothing, a scheme or rung override on
    a sharded engine, the compiled-HLO text of a chunk (eager PyTorch has
    none: the cost attribution is ``chunk_cost``), and
    ``evaluate`` on a scheme it does not know.  (The chunk API and the
    service on a sharded engine, which raised here until ROADMAP A9.2 was
    ported, are held in ``test_torch_service_sharded.py``.)"""
    from repro_torch.core.mesh import ShardMesh
    from repro_torch.core.scheduler import DualModeEngine
    for app_name in ("sl", "ob"):
        app = T_APPS[app_name]
        store = app.make_store(device="cpu")
        for shape, names, layout in (
                ((2, 2), ("socket", "core"), "shared_nothing"),
                ((2, 2), ("socket", "core"), "shared_per_socket"),
                ((4,), ("dev",), "shared_everything")):
            with pytest.raises(ValueError, match="lockstep schedule"):
                DualModeEngine(app, store, device="cpu", layout=layout,
                               mesh=ShardMesh(shape, names, device="cpu"))
        eng = DualModeEngine(app, store, device="cpu",
                             mesh=ShardMesh((4,), ("dev",), device="cpu"))
        assert eng.ensure_variant() is None
        with pytest.raises(ValueError, match="plan variants"):
            eng.ensure_variant(scheme="lock")
        with pytest.raises(ValueError, match="plan variants"):
            eng.ensure_variant(restructure_method="partition")
        with pytest.raises(NotImplementedError, match="chunk_cost"):
            eng.chunk_lowered_text(eng.init_store.values, {})
    _, _, jops, tapp, tstore = _interval("gs", n_events=8)
    with pytest.raises(ValueError, match="unknown scheme"):
        evaluate(tstore, port_ops(jops), tapp.funs, "bogus")


def test_megakernel_engaged_matches_reference():
    for n_rows in (100, 1 << 15, 1 << 16):
        for slots in (128, 10_001, 1 << 15):
            for method in ("auto", "megakernel", "partition"):
                for has_max in (False, True):
                    for simple in (False, True):
                        kw = dict(method=method, has_max=has_max,
                                  funs_simple=simple)
                        assert megakernel_engaged(n_rows, slots, **kw) == \
                            j_mega_engaged(n_rows, slots, **kw), (n_rows,
                                                                  slots, kw)


H100_SMEM = 232_448     # an H100's opt-in shared memory per block (bytes)


@pytest.mark.parametrize("lanes", [1, 32])
def test_megakernel_fits_at_its_capacity(lanes):
    """The scan block holds 16 n W + 3 n bytes; the largest interval that
    fits is the last n within the limit, and the CPU (no limit) always
    fits."""
    cap = H100_SMEM // (16 * lanes + 3)
    assert megakernel_smem_bytes(cap, lanes) <= H100_SMEM
    assert megakernel_smem_bytes(cap + 1, lanes) > H100_SMEM
    assert megakernel_fits(cap, lanes, H100_SMEM)
    assert not megakernel_fits(cap + 1, lanes, H100_SMEM)
    assert megakernel_fits(cap + 1, lanes, None)
    assert megakernel_fits(1 << 24, lanes, None)


@pytest.mark.parametrize("lanes", [1, 32])
def test_megakernel_engaged_honours_the_capacity(lanes, caplog):
    """Under "auto" the band AND the capacity; a forced megakernel that does
    not fit takes the staged rung and logs why, once."""
    band = restructure_mod.autotune.mega_bounds("cpu")
    cap = H100_SMEM // (16 * lanes + 3)
    kw = dict(has_max=False, funs_simple=True, lanes=lanes)
    lo, slots = band["min_rows"], band["max_buckets"]
    # the band's edges with no limit (the CPU), as the reference has them
    assert megakernel_engaged(lo, slots, method="auto", **kw)
    assert not megakernel_engaged(lo - 1, slots, method="auto", **kw)
    assert not megakernel_engaged(lo, slots + 1, method="auto", **kw)
    # on the card the band lies beyond the capacity: "auto" never engages
    assert cap < lo
    for n in (lo, lo + 1, 40_000):
        assert not megakernel_engaged(n, slots, method="auto",
                                      smem_limit=H100_SMEM, **kw)
    # a force engages up to the capacity, not beyond it
    assert megakernel_engaged(cap, 10_001, method="megakernel",
                              smem_limit=H100_SMEM, **kw)
    restructure_mod._MEGA_FALLBACK_WARNED.clear()
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.core.restructure"):
        for _ in range(3):
            assert not megakernel_engaged(cap + 1, 10_001,
                                          method="megakernel",
                                          smem_limit=H100_SMEM, **kw)
    logged = [r for r in caplog.records if "shared memory" in r.message]
    assert len(logged) == 1, [r.message for r in caplog.records]
    assert f"{cap + 1} rows x {lanes} lanes" in logged[0].message
    # an ineligible store stays off whatever the limit
    assert not megakernel_engaged(cap, 10_001, method="megakernel",
                                  has_max=True, funs_simple=True,
                                  lanes=lanes, smem_limit=H100_SMEM)


def test_lock_oracle_gated_take():
    """The sequential sweep's CFun gate and the bounded TAKE: a gated op
    whose mate failed keeps its state and reports failure."""
    from repro_torch.core.types import CORE_FUNS, OpBatch, make_store
    from repro_torch.core.engines import eval_lock
    store = make_store([2], 1, init=torch.tensor([[5.0], [1.0], [0.0]]),
                       device="cpu")
    i32 = dict(dtype=torch.int32)
    ops = OpBatch(
        uid=torch.tensor([0, 1, 0, 1], **i32),
        ts=torch.tensor([0, 0, 1, 1], **i32),
        txn=torch.tensor([0, 0, 1, 1], **i32),
        slot=torch.tensor([0, 1, 0, 1], **i32),
        kind=torch.zeros(4, **i32),
        fun=torch.tensor([5, 3, 5, 3], **i32),        # take, then gated add
        gate=torch.tensor([-1, 0, -1, 2], **i32),
        operand=torch.tensor([[3.0], [3.0], [3.0], [3.0]]),
        valid=torch.ones(4, dtype=torch.bool))
    res, values, _ = eval_lock(store, ops, CORE_FUNS)
    # txn 0: take 3 of 5 succeeds, gated add runs; txn 1: take 3 of 2 fails
    assert values[:, 0].tolist() == [2.0, 4.0, 0.0]
    assert res["success"].tolist() == [True, True, False, False]
    assert res["pre"][:, 0].tolist() == [5.0, 1.0, 2.0, 4.0]
