"""The port's compute mode and restructure against the JAX reference.

``build_opbatch`` must give every OpBatch field bitwise for GS and TP, and
``restructure`` the same Chains and sorted view on every rung (partition,
packed, lexsort), one interval or a stack of them, on the cases of
``tests/test_restructure_parity.py``.  The rung choice must be the
reference's.
"""
import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.blotter import build_opbatch as j_build
from repro.core.restructure import commit_from_histogram as j_commit_hist
from repro.core.restructure import commit_index as j_commit_index
from repro.core.restructure import restructure as j_restructure
from repro.core.restructure import restructure_path as j_path
from repro.core.restructure import restructure_stream as j_restructure_stream
from repro.core.types import OpBatch

from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.blotter import build_opbatch
from repro_torch.core.restructure import (commit_from_histogram, commit_index,
                                          packed_stable_sort, restructure,
                                          restructure_path, restructure_stream)

from torch_parity import (CHAIN_FIELDS, OP_FIELDS, assert_dict_equal,
                          assert_fields_equal, np_, port_ops, port_store)


# ---------------------------------------------------------------------------
# compute mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app_name", ["gs", "tp"])
@pytest.mark.parametrize("stacked", [False, True])
def test_build_opbatch_bitwise(app_name, stacked):
    japp, tapp = J_APPS[app_name], T_APPS[app_name]
    stream = japp.gen_events(np.random.default_rng(5), 96)
    jstore = japp.make_store()
    tstore = port_store(jstore)
    if stacked:   # the fused driver's [n_intervals, interval] call
        ev = {k: v.reshape((3, 32) + v.shape[1:]) for k, v in stream.items()}
        ts = jnp.arange(3, dtype=jnp.int32) * 32 + 64
        jops, jebs = jax.vmap(lambda e, t: j_build(japp, jstore, e, t))(
            {k: jnp.asarray(v) for k, v in ev.items()}, ts)
        tops, tebs = build_opbatch(tapp, tstore, events_to_torch(ev, "cpu"),
                                   torch.from_numpy(np.array(ts)))
    else:
        jops, jebs = j_build(japp, jstore,
                             {k: jnp.asarray(v) for k, v in stream.items()},
                             jnp.int32(64))
        tops, tebs = build_opbatch(tapp, tstore,
                                   events_to_torch(stream, "cpu"), 64)
    assert_fields_equal(tops, jops, OP_FIELDS, "OpBatch")
    assert_dict_equal(tebs, {k: np.asarray(v) for k, v in jebs.items()},
                      "blotter payload")


# ---------------------------------------------------------------------------
# restructure
# ---------------------------------------------------------------------------
def mk_batch(uid: np.ndarray, valid: np.ndarray, max_ops: int = 4) -> OpBatch:
    """Row-major (ts, slot) batch around the given uid/valid columns."""
    n = uid.shape[0]
    idx = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(n)
    return OpBatch(
        uid=jnp.asarray(uid.astype(np.int32)),
        ts=jnp.asarray(idx // max_ops), txn=jnp.asarray(idx // max_ops),
        slot=jnp.asarray(idx % max_ops), kind=jnp.zeros((n,), jnp.int32),
        fun=jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
        gate=jnp.full((n,), -1, jnp.int32),
        operand=jnp.asarray(rng.uniform(size=(n, 2)).astype(np.float32)),
        valid=jnp.asarray(valid))


def _case(name: str):
    if name == "all_pad":
        return np.zeros((24,), np.int32), np.zeros((24,), bool), 7
    if name == "single_chain":
        return np.full((40,), 3, np.int32), np.ones((40,), bool), 9
    seed, n_slots, theta, pad_frac = name
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60)) * 4
    w = 1.0 / np.power(np.arange(1, n_slots + 1, dtype=np.float64), theta)
    uid = rng.choice(n_slots, size=n, p=w / w.sum())
    return uid, rng.uniform(size=n) > pad_frac, n_slots


CASES = [(s, *c) for s in (0, 1) for c in ((1, 0.0, 0.0), (7, 0.0, 0.1),
                                            (60, 0.6, 0.1), (300, 1.2, 0.5),
                                            (13, 0.6, 0.9))]
CASES += ["all_pad", "single_chain"]


@pytest.mark.parametrize("case", CASES, ids=str)
@pytest.mark.parametrize("method", ["partition", "packed", "lexsort"])
def test_restructure_bitwise_every_rung(case, method):
    uid, valid, pad = _case(case)
    jops = mk_batch(uid, valid)
    for light in (False, True):
        js, jc = j_restructure(jops, pad, rowmajor_ts=True, light=light,
                               method=method)
        ts_, tc = restructure(port_ops(jops), pad, rowmajor_ts=True,
                              light=light, method=method)
        assert_fields_equal(tc, jc, CHAIN_FIELDS, f"Chains[{method}]")
        assert_fields_equal(ts_, js, OP_FIELDS, f"sorted[{method}]")
    # commit maps: from the sorted column, and from the histogram
    p0, ok0 = j_commit_index(js.uid, pad + 1)
    p1, ok1 = commit_index(ts_.uid, pad + 1)
    np.testing.assert_array_equal(np_(p1), np.asarray(p0))
    np.testing.assert_array_equal(np_(ok1), np.asarray(ok0))
    if method == "partition":
        p2, ok2 = commit_from_histogram(tc.counts, tc.starts)
        p3, ok3 = j_commit_hist(jc.counts, jc.starts)
        np.testing.assert_array_equal(np_(p2), np.asarray(p3))
        np.testing.assert_array_equal(np_(ok2), np.asarray(ok3))


@pytest.mark.parametrize("method,geometry", [
    ("partition", True), ("partition", False), ("packed", True),
    ("lexsort", True)])
def test_restructure_stream_bitwise(method, geometry):
    rng = np.random.default_rng(5)
    n_i, n = 3, 256
    uid = rng.integers(0, 13, (n_i, n)).astype(np.int32)
    batches = [mk_batch(uid[i], rng.uniform(size=n) > 0.1) for i in range(n_i)]
    jops = OpBatch(*[jnp.stack([getattr(b, f.name) for b in batches])
                     for f in dataclasses.fields(OpBatch)])
    js, jc = j_restructure_stream(jops, 13, rowmajor_ts=True, method=method,
                                  geometry=geometry)
    ts_, tc = restructure_stream(port_ops(jops), 13, rowmajor_ts=True,
                                 method=method, geometry=geometry)
    assert_fields_equal(tc, jc, CHAIN_FIELDS, "Chains")
    assert_fields_equal(ts_, js, OP_FIELDS, "sorted")


def test_restructure_path_matches_reference(caplog):
    grid = [(n, pad) for n in (1, 100, 1 << 10, 1 << 18, 1 << 19, 5000)
            for pad in (0, 15, 16, 500, 10_000, 1 << 20)]
    for n, pad in grid:
        for method in ("auto", "partition", "packed", "lexsort",
                       "megakernel"):
            for rowmajor in (True, False):
                try:
                    want = j_path(n, pad, rowmajor_ts=rowmajor, method=method)
                except ValueError as e:
                    with pytest.raises(ValueError, match="rowmajor_ts"):
                        restructure_path(n, pad, rowmajor_ts=rowmajor,
                                         method=method)
                    assert "rowmajor_ts" in str(e)
                    continue
                got = restructure_path(n, pad, rowmajor_ts=rowmajor,
                                       method=method)
                assert got == want, (n, pad, method, rowmajor)
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.core.restructure"):
        assert restructure_path(1 << 19, 10_000, rowmajor_ts=True) == "lexsort"
        assert restructure_path(1 << 19, 10_000, rowmajor_ts=True,
                                x64=True) == "packed"
    assert any("x64" in r.message for r in caplog.records)


def test_packed_sort_64bit_needs_x64():
    n, m = 1 << 19, 10_000
    rng = np.random.default_rng(0)
    major = torch.from_numpy(rng.integers(0, m + 1, n).astype(np.int32))
    with pytest.raises(ValueError, match="x64"):
        packed_stable_sort(major, m)
    order, major_s, pos = packed_stable_sort(major, m, x64=True)
    ref = np.argsort(major.numpy(), kind="stable")
    np.testing.assert_array_equal(np_(order), ref)
    np.testing.assert_array_equal(np_(major_s), major.numpy()[ref])
    inv = np.empty(n, np.int64)
    inv[ref] = np.arange(n)
    np.testing.assert_array_equal(np_(pos), inv)
