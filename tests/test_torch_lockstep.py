"""The port's lockstep path and baselines against the JAX reference.

One interval of SL (gated TAKE) and OB (conditional bid) goes through the
reference's ``evaluate`` (``use_pallas=False``) and the port's, under every
scheme and every forced restructure rung: new state, per-op pre/post/
success and ``EngineStats.rounds``, ``n_chains`` and ``max_chain`` bitwise.
SL runs over a small, skewed store with its amounts x 10, so dependency
cycles leave chains to the sequential residue sweep and debits fail,
closing the gates of their credits; OB's bids reject.  Also: ``_chain_levels``
bitwise, the port's cut sweep bitwise with a sweep of every one of the
reference's ``ch.max_len`` rounds, and the general (non-LUT) affine
coefficients, alone and through the segmented-scan path.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.apps import ob as j_ob
from repro.core import types as j_types
from repro.core.blotter import build_opbatch as j_build
from repro.core.engines import _chain_levels as j_chain_levels
from repro.core.engines import affine_coeffs as j_affine_coeffs
from repro.core.engines import evaluate as j_evaluate
from repro.core.restructure import restructure as j_restructure

from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.apps import ob as t_ob
from repro_torch.core import types as t_types
from repro_torch.core.engines import (INF_LEVEL, _chain_levels,
                                      _empty_results, _sequential_sweep,
                                      affine_coeffs, apply_funs,
                                      eval_tstream_lockstep, evaluate)
from repro_torch.core.restructure import restructure

from torch_parity import assert_dict_equal, np_, port_ops, port_store

SCHEMES = ["tstream", "tstream_lockstep", "mvlk", "pat", "lock", "nolock"]
LOCKSTEP = ("tstream", "tstream_lockstep", "mvlk")
RUNGS = ["partition", "packed", "lexsort"]
# SL over 30 records at theta 0.99, amounts x 10: cycles among the gated
# credits, debits that fail; OB over 1,000 items: chains of several ops,
# bids that reject
STREAMS = dict(sl=dict(n_keys=30, theta=0.99), ob=dict(n_keys=1000,
                                                      theta=0.6))
AMOUNT_SCALE = 10.0
N_EVENTS = 64


@functools.lru_cache(maxsize=None)
def _interval(app_name):
    japp = J_APPS[app_name]
    kw = STREAMS[app_name]
    stream = japp.gen_events(np.random.default_rng(0), N_EVENTS, **kw)
    if app_name == "sl":
        stream["amount"] = (stream["amount"] * AMOUNT_SCALE).astype(
            np.float32)
    jstore = japp.make_store(kw["n_keys"])
    jops, _ = j_build(japp, jstore,
                      {k: jnp.asarray(v) for k, v in stream.items()},
                      jnp.int32(0))
    return japp, jstore, jops


def _port(app_name):
    _, jstore, jops = _interval(app_name)
    return T_APPS[app_name], port_store(jstore), port_ops(jops)


@pytest.mark.parametrize("app_name", ["sl", "ob"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("rung", RUNGS)
def test_evaluate_bitwise(app_name, scheme, rung):
    japp, jstore, jops = _interval(app_name)
    tapp, tstore, tops = _port(app_name)
    kw = dict(associative_only=japp.associative_only,
              has_gates=japp.has_gates, rowmajor_ts=True,
              restructure_method=rung)
    jres, jvals, jstats = jax.jit(lambda st, o: j_evaluate(
        st, o, japp.funs, scheme, **kw))(jstore, jops)
    tres, tvals, tstats = evaluate(tstore, tops, tapp.funs, scheme, **kw)
    np.testing.assert_array_equal(np_(tvals), np.asarray(jvals))
    assert_dict_equal(tres, {k: np.asarray(v) for k, v in jres.items()},
                      f"{app_name}/{scheme}/{rung}")
    assert (tstats.path, tstats.scheme) == (jstats.path, jstats.scheme)
    for f in ("rounds", "n_chains", "max_chain"):
        assert int(getattr(tstats, f)) == int(getattr(jstats, f)), f
    if scheme in LOCKSTEP:
        assert tstats.swept > 0
        if app_name == "sl":     # cycles went to the sequential sweep
            assert tstats.residue > 0
        else:                    # the padding chain's rounds were cut
            assert tstats.swept < int(tstats.max_chain)
    if scheme != "nolock":   # an SL debit or an OB bid failed
        assert not bool(tres["success"][tops.valid].all())
    if app_name == "sl" and scheme != "nolock":
        # a credit whose debit failed: its gate closed, its state kept
        closed = (tops.gate >= 0) & tops.valid & ~tres["success"]
        assert bool(closed.any())


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("max_levels", [0, 1, 3])
def test_chain_levels_bitwise(rung, max_levels):
    _, jstore, jops = _interval("sl")
    _, tstore, tops = _port("sl")
    pad, n = jstore.pad_uid, tops.n_ops
    jl, ju = jax.jit(lambda o: j_chain_levels(
        *j_restructure(o, pad, rowmajor_ts=True, method=rung), n,
        max_levels))(jops)
    sops, ch = restructure(tops, pad, rowmajor_ts=True, method=rung)
    lvl, unresolved = _chain_levels(sops, ch, n, max_levels)
    for got, want, what in ((lvl, jl, "levels"), (unresolved, ju,
                                                  "unresolved")):
        got, want = np_(got), np.asarray(want)
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    assert bool(unresolved.any())
    if max_levels:
        assert bool(((lvl > 0) & (lvl < INF_LEVEL)).any())


def _full_sweep(values, sops, ch, funs, chain_mask, results, n, pad_uid,
                rounds):
    """The reference's ``_lockstep_sweep`` round for round: every op of the
    batch evaluated in every one of ``rounds`` rounds, an inactive op sent
    to the pad state (reset to 0) and the sink row ``n``."""
    uid = sops.uid.long()
    for r in range(rounds):
        active = (ch.pos == r) & chain_mask[ch.seg_id.long()] & sops.valid
        cur = values[uid]
        mate = results["success"][:-1][sops.gate.clamp(min=0).long()]
        gate_ok = torch.where(sops.gate >= 0, mate, True)
        post, ok = apply_funs(funs, sops.fun, cur, sops.operand)
        post = torch.where(gate_ok[:, None], post, cur)
        ok = ok & gate_ok
        scat = torch.where(active, uid, pad_uid)
        values = values.index_put((scat,), torch.where(
            active[:, None], post, torch.zeros_like(post)))
        values[pad_uid] = 0.0
        sink = torch.where(active, ch.order.long(), n)
        results = {k: results[k].index_put((sink,), v)
                   for k, v in (("pre", cur), ("post", post),
                                ("success", ok))}
    return values, results


@pytest.mark.parametrize("app_name", ["sl", "ob"])
def test_cut_sweep_equals_the_full_sweep(app_name):
    """Sweeping only the rounds with an active op gives the bits of sweeping
    all ``ch.max_len`` rounds (for SL, all of them at every level)."""
    tapp, tstore, tops = _port(app_name)
    pad, n, levels = tstore.pad_uid, tops.n_ops, 3
    sops, ch = restructure(tops, pad, rowmajor_ts=True, method="partition")
    res, vals, stats = eval_tstream_lockstep(
        tstore, tops, tapp.funs, max_dep_levels=levels,
        has_gates=tapp.has_gates, prestructured=(sops, ch))

    full_rounds = int(ch.max_len)
    values = tstore.values.clone()
    results = _empty_results(n, tops.width, "cpu")
    if not tapp.has_gates:
        masks = [torch.ones(n, dtype=torch.bool)]
    else:
        lvl, unresolved = _chain_levels(sops, ch, n, levels)
        masks = [lvl == level for level in range(levels + 1)]
    for mask in masks:
        values, results = _full_sweep(values, sops, ch, tapp.funs, mask,
                                      results, n, pad, full_rounds)
    if tapp.has_gates:
        residue = ch.untake(unresolved[ch.seg_id.long()] & sops.valid)
        _sequential_sweep(values, tops, tapp.funs, results,
                          mask_flat=residue, pad_uid=pad)
    assert torch.equal(vals, values)
    assert_dict_equal(res, {k: v[:n] for k, v in results.items()}, app_name)
    assert 0 < stats.swept < full_rounds * len(masks)


JFUNS = j_types.ASSOC_FUNS + (j_ob.F_SET_PRICE, j_ob.F_ADD_QTY)
TFUNS = t_types.ASSOC_FUNS + (t_ob.F_SET_PRICE, t_ob.F_ADD_QTY)


def test_general_affine_coeffs_bitwise():
    """OB's set_price and add_qty declare no simple shape: each fun's affine
    map on the whole batch, selected by fun id (MAX is not affine: the
    identity)."""
    rng = np.random.default_rng(4)
    fid = rng.integers(0, len(JFUNS), 500).astype(np.int32)
    operand = rng.uniform(-50.0, 50.0, (500, 2)).astype(np.float32)
    ja, jb = jax.jit(lambda f, o: j_affine_coeffs(JFUNS, f, o))(fid, operand)
    ta, tb = affine_coeffs(TFUNS, torch.from_numpy(fid),
                           torch.from_numpy(operand))
    for got, want in ((ta, ja), (tb, jb)):
        got, want = np_(got), np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("rung", ["partition", "lexsort"])
def test_scan_path_with_general_affine_funs_bitwise(rung):
    """OB's interval with its conditional funs (take, bid) replaced by
    reads: every fun associative, two of them general affine, so the
    segmented-scan path runs on the general coefficients.  Every product
    has a factor in {0, 1}, so XLA's fused multiply-add rounds as the
    port does."""
    _, jstore, jops = _interval("ob")
    _, tstore, tops = _port("ob")
    jfuns = JFUNS[:5] + (j_types.F_READ, j_types.F_READ) + JFUNS[5:]
    tfuns = TFUNS[:5] + (t_types.F_READ, t_types.F_READ) + TFUNS[5:]
    kw = dict(associative_only=True, rowmajor_ts=True,
              restructure_method=rung)
    jres, jvals, _ = jax.jit(lambda st, o: j_evaluate(
        st, o, jfuns, "tstream_scan", **kw))(jstore, jops)
    tres, tvals, stats = evaluate(tstore, tops, tfuns, "tstream_scan", **kw)
    assert stats.path == "segscan"
    np.testing.assert_array_equal(np_(tvals), np.asarray(jvals))
    assert_dict_equal(tres, {k: np.asarray(v) for k, v in jres.items()},
                      f"general affine/{rung}")
    assert not torch.equal(tvals, tstore.values)
