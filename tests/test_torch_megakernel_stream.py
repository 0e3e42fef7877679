"""The stream megakernel's twin against the per-interval schedule, bitwise.

``fused_chain_eval`` takes a stack of K sorted intervals and evaluates them
in one call (on the CPU through its twin ``fused_chain_stream_ref``: scan
every interval, carry each slot through the intervals, apply every row).
Here it is held, in the final state and in every op's pre/post in flat
order, bit for bit, against

* a loop of the per-interval twin ``fused_chain_eval_ref``, and
* a ``jax.lax.scan`` over the JAX ``fused_chain_eval`` on the Pallas kernel
  in interpret mode (as ``tests/test_torch_megakernel.py`` runs it),

on a uid touched in non-adjacent intervals, an interval with no real op, a
hot chain as long as its interval, one interval, a batch of 4 problems, and
valid ops on the pad slot (which read its initial value in the first
interval and 0 after).
The engines that call it are held to the JAX single-device fused run:
``run_stream`` on the megakernel rung and a 4-shard ``shared_nothing`` run,
bitwise in state.  The CUDA kernel is held to the twin in
``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.engines import simple_affine_luts as j_luts
from repro.core.restructure import restructure as j_restructure
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig
from repro.core.types import F_ADD, F_NOP, F_PUT, F_READ, OpBatch
from repro.kernels.megakernel import fused_chain_eval as j_fused

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core import types as T
from repro_torch.core.engines import simple_affine_luts
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.restructure import restructure
from repro_torch.core.scheduler import (DualModeEngine, EngineConfig,
                                        _fused_impl)
from repro_torch.core.types import tree_index
from repro_torch.kernels.megakernel.ops import fused_chain_eval
from repro_torch.kernels.megakernel.ref import (fused_chain_eval_ref,
                                                fused_chain_stream_ref)

from torch_parity import (assert_dict_equal, assert_outputs_close, np_,
                          port_ops, port_store)

J_FUNS = (F_NOP, F_READ, F_PUT, F_ADD)
T_FUNS = (T.F_NOP, T.F_READ, T.F_PUT, T.F_ADD)
W = 2
CASES = ["non_adjacent", "empty_interval", "hot_chain", "k1", "batch4",
         "skewed", "pad_valid"]


def _case(name):
    """(uid, valid) of shape [K, (B,) N] and the number of real slots."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "non_adjacent":      # slot 3 in intervals 0 and 3 only
        k, n, s = 5, 24, 10
        uid = rng.choice([u for u in range(s) if u != 3], (k, n))
        uid[0, [2, 9, 17]] = 3
        uid[3, [0, 11]] = 3
        return uid, rng.random((k, n)) > 0.1, s
    if name == "empty_interval":    # interval 2 has no real op
        k, n, s = 4, 16, 6
        valid = rng.random((k, n)) > 0.2
        valid[2] = False
        return rng.integers(0, s, (k, n)), valid, s
    if name == "hot_chain":         # interval 1 is one chain of n ops
        k, n, s = 3, 32, 5
        uid = rng.integers(0, s, (k, n))
        uid[1] = 2
        valid = rng.random((k, n)) > 0.1
        valid[1] = True
        return uid, valid, s
    if name == "k1":
        return rng.integers(0, 8, (1, 40)), rng.random((1, 40)) > 0.1, 8
    if name == "pad_valid":         # valid ops on the pad slot: in interval
        k, n, s = 4, 24, 6          # 0, and in 2 as its longest chain
        uid = rng.integers(0, s, (k, n))
        uid[0, [1, 7]] = s
        uid[2, :14] = s
        return uid, rng.random((k, n)) > 0.1, s
    if name == "batch4":
        k, b, n, s = 4, 4, 20, 7
        return rng.integers(0, s, (k, b, n)), rng.random((k, b, n)) > 0.15, s
    s = 12                          # Zipf-skewed, long chains, padded tails
    p = 1.0 / np.arange(1, s + 1, dtype=np.float64)
    uid = rng.choice(s, (6, 100), p=p / p.sum())
    valid = rng.random((6, 100)) > 0.3
    return uid, valid, s


def _inputs(name):
    """numpy op columns [K, (B,) N], the state [(B,) S+1, W] (the pad slot's
    initial value is not 0) and the number of real slots."""
    uid, valid, s = _case(name)
    rng = np.random.default_rng(100 + CASES.index(name))
    n = uid.shape[-1]
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), uid.shape)
    cols = dict(uid=uid.astype(np.int32), ts=idx // 4, txn=idx // 4,
                slot=idx % 4, kind=np.zeros(uid.shape, np.int32),
                fun=rng.integers(0, len(J_FUNS), uid.shape).astype(np.int32),
                gate=np.full(uid.shape, -1, np.int32),
                operand=rng.normal(size=uid.shape + (W,)).astype(np.float32),
                valid=valid)
    lead = uid.shape[1:-1]
    values = rng.normal(size=lead + (s + 1, W)).astype(np.float32)
    return cols, values, s


def _port(cols, s):
    ops = T.OpBatch(**{k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in cols.items()})
    return restructure(ops, s, rowmajor_ts=True, light=True,
                       method="partition", geometry=False)


def _per_interval_loop(values, sops, ch, s, luts):
    """A loop of the per-interval twin; results back in flat layout."""
    a_lut, b_lut = luts
    out, v = [], values
    for k in range(sops.uid.shape[0]):
        chk = tree_index(ch, k)
        res, v, _ = fused_chain_eval_ref(v, tree_index(sops, k), chk, s,
                                         a_lut=a_lut, b_lut=b_lut)
        out.append({key: chk.untake(x) for key, x in res.items()})
    return {key: torch.stack([r[key] for r in out]) for key in out[0]}, v


def _jax_scan(cols, values, s):
    """``lax.scan`` over the JAX per-interval call on the Pallas kernel
    (interpret mode); flat-layout results ``[K, N, ...]`` and the state."""
    pad = s
    a_lut, b_lut = j_luts(J_FUNS)
    jops = OpBatch(**{k: jnp.asarray(v) for k, v in cols.items()})
    jsops, jch = jax.vmap(lambda o: j_restructure(
        o, pad, rowmajor_ts=True, light=True, method="partition",
        geometry=False))(jops)

    def body(v, xs):
        so, c = xs
        res, v, _ = j_fused(v, so, c, pad, a_lut=a_lut, b_lut=b_lut,
                            use_pallas=True, interpret=True)
        return v, res

    vals, res = jax.jit(lambda v, so, c: jax.lax.scan(body, v, (so, c)))(
        jnp.asarray(values), jsops, jch)
    inv = np.asarray(jch.inv)
    flat = {}
    for k, x in res.items():
        x = np.asarray(x)
        idx = inv.reshape(inv.shape + (1,) * (x.ndim - inv.ndim))
        flat[k] = np.take_along_axis(x, idx, axis=1)
    return flat, np.asarray(vals)


@pytest.mark.parametrize("case", CASES)
def test_stream_twin_matches_per_interval_loop(case):
    cols, values, s = _inputs(case)
    sops, ch = _port(cols, s)
    luts = simple_affine_luts(T_FUNS)
    v_in = torch.from_numpy(values.copy())
    reset_launches()
    res, vals, stats = fused_chain_eval(v_in, sops, ch, s, a_lut=luts[0],
                                        b_lut=luts[1])
    assert all(v == 0 for v in LAUNCHES.values())   # the CPU takes the twin
    assert torch.equal(v_in, torch.from_numpy(values))  # the caller's state
    assert stats.path == "megakernel"
    assert tuple(stats.max_chain.shape) == tuple(sops.uid.shape[:-1])
    want_res, want_vals = _per_interval_loop(torch.from_numpy(values.copy()),
                                             sops, ch, s, luts)
    assert torch.equal(vals, want_vals)
    assert_dict_equal(res, want_res, f"{case}: per-op results")
    assert float(vals[..., s, :].abs().max()) == 0.0   # the pad slot


@pytest.mark.parametrize("case", CASES)
def test_stream_twin_matches_jax_scan_of_pallas(case):
    cols, values, s = _inputs(case)
    sops, ch = _port(cols, s)
    ta, tb = simple_affine_luts(T_FUNS)
    res, vals, _ = fused_chain_stream_ref(torch.from_numpy(values.copy()),
                                          sops, ch, s, a_lut=ta, b_lut=tb)
    if values.ndim == 2:
        jres, jvals = _jax_scan(cols, values, s)
    else:   # independent problems: one scan each, stacked on axis 1
        runs = [_jax_scan({k: v[:, b] for k, v in cols.items()}, values[b],
                          s) for b in range(values.shape[0])]
        jres = {k: np.stack([r[0][k] for r in runs], axis=1)
                for k in runs[0][0]}
        jvals = np.stack([r[1] for r in runs])
    np.testing.assert_array_equal(np_(vals), jvals, err_msg="final state")
    assert_dict_equal(res, jres, f"{case}: per-op results")


GS_STREAMS = {   # (seed, generator options): hot keys recur across intervals
    "few_keys": (3, (("n_keys", 40), ("theta", 0.9))),
    "default": (4, ()),
}
N_INTERVALS, INTERVAL = 6, 32


def _gs_stream(name):
    seed, gen = GS_STREAMS[name]
    return J_APPS["gs"].gen_events(np.random.default_rng(seed),
                                   N_INTERVALS * INTERVAL, **dict(gen))


@pytest.mark.parametrize("name", sorted(GS_STREAMS))
def test_run_stream_megakernel_rung_matches_jax_fused(name):
    """GS ``run_stream`` on the megakernel rung (one stream call) against the
    JAX single-device fused run: state and per-op results bitwise."""
    stream = _gs_stream(name)
    japp, tapp = J_APPS["gs"], T_APPS["gs"]
    jstore = japp.make_store()
    jeng = JEngine(japp, jstore, JConfig(restructure_method="megakernel"))
    batched = {k: np.asarray(v).reshape((N_INTERVALS, INTERVAL)
                                        + np.asarray(v).shape[1:])
               for k, v in stream.items()}
    jres, jebs, jvals, _ = jeng._fused(
        jnp.array(jstore.values, copy=True),
        {k: jnp.asarray(v) for k, v in batched.items()}, jnp.int32(0))
    jouts = jeng._outs(jres, jebs, N_INTERVALS)

    tstore = port_store(jstore)
    cfg = EngineConfig(restructure_method="megakernel")
    outs, vals = DualModeEngine(tapp, tstore, cfg, device="cpu").run_stream(
        tstore.values, stream, INTERVAL)
    np.testing.assert_array_equal(np_(vals), np.asarray(jvals),
                                  err_msg="final state")
    assert_outputs_close(outs, jouts, f"gs/{name} outputs")
    res, _, _, _, _ = _fused_impl(tstore.values.clone(),
                                  events_to_torch(batched, "cpu"), 0,
                                  app=tapp, cfg=cfg, store=tstore)
    assert_dict_equal(res, {k: np.asarray(v) for k, v in jres.items()},
                      f"gs/{name} per-op results")


@pytest.mark.parametrize("name", sorted(GS_STREAMS))
def test_sharded_shared_nothing_megakernel_matches_jax_fused(name):
    """4 shards, ``shared_nothing``, megakernel rung (one stream call for
    every shard) against the JAX single-device fused run, bitwise in
    state."""
    stream = _gs_stream(name)
    japp, tapp = J_APPS["gs"], T_APPS["gs"]
    jstore = japp.make_store()
    jouts, jvals = JEngine(japp, jstore, JConfig()).run_stream(
        jstore.values, stream, INTERVAL, fused=True)
    tstore = port_store(jstore)
    eng = DualModeEngine(tapp, tstore,
                         EngineConfig(restructure_method="megakernel"),
                         device="cpu",
                         mesh=ShardMesh((4,), ("dev",), device="cpu"),
                         layout="shared_nothing", exchange_slack=8.0)
    outs, vals = eng.run_stream(tstore.values, stream, INTERVAL)
    assert int(np.sum(eng.last_exchange_stats["dropped"])) == 0
    np.testing.assert_array_equal(np_(vals), np.asarray(jvals),
                                  err_msg="final state")
    assert_outputs_close(outs, jouts, f"gs/{name} sharded outputs")
