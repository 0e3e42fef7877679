"""The slice-level parity check shared by ``test_torch_slice_*.py``.

Not a test module.  One seeded stream of 3 intervals x 64 events goes
through the JAX engine and the port's engine (on the CPU, so every kernel
wrapper takes its twin).  A check may size the store (``n_keys``), shape
the stream (``gen_kw``, ``mutate``) and set the engine (``cfg_kw``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.convert import events_to_torch
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.core.scheduler import _fused_impl, _stack, _step_impl

from torch_parity import (assert_dict_equal, assert_outputs_close, np_,
                          port_store)

METHODS = ["auto", "partition", "packed", "lexsort", "megakernel"]
INTERVAL, N_INTERVALS = 64, 3


def _stream(app_name, seed=11, **gen_kw):
    return J_APPS[app_name].gen_events(np.random.default_rng(seed),
                                       INTERVAL * N_INTERVALS + 5, **gen_kw)


def _jax_run(japp, jstore, stream, method, fused, cfg_kw):
    """Per-op results, outputs and final state of the JAX engine."""
    eng = JEngine(japp, jstore, JConfig(restructure_method=method, **cfg_kw))
    n = N_INTERVALS * INTERVAL
    if fused:
        batched = {k: jnp.asarray(np.asarray(v)[:n].reshape(
            (N_INTERVALS, INTERVAL) + np.asarray(v).shape[1:]))
            for k, v in stream.items()}
        res, ebs, values, _ = eng._fused(jnp.array(jstore.values, copy=True),
                                         batched, jnp.int32(0))
    else:
        res_l, ebs_l, values = [], [], jstore.values
        for i in range(N_INTERVALS):
            batch = {k: jnp.asarray(np.asarray(v)[i * INTERVAL:
                                                  (i + 1) * INTERVAL])
                     for k, v in stream.items()}
            st = dataclasses.replace(jstore, values=values)
            r, e, values, _ = eng._step(st, batch, jnp.int32(i * INTERVAL))
            res_l.append(r)
            ebs_l.append(e)
        res = {k: jnp.stack([r[k] for r in res_l]) for k in res_l[0]}
        ebs = {k: jnp.stack([e[k] for e in ebs_l]) for k in ebs_l[0]}
    outs = eng._outs(res, ebs, N_INTERVALS)
    return ({k: np.asarray(v) for k, v in res.items()}, outs,
            np.asarray(values))


def _port_res(tapp, tstore, stream, cfg, fused):
    """Per-op results and per-interval EngineStats of the port's drivers
    (the internals run_stream uses)."""
    n = N_INTERVALS * INTERVAL
    if fused:
        batched = {k: np.asarray(v)[:n].reshape(
            (N_INTERVALS, INTERVAL) + np.asarray(v).shape[1:])
            for k, v in stream.items()}
        res, _, _, stats, _ = _fused_impl(tstore.values.clone(),
                                          events_to_torch(batched, "cpu"), 0,
                                          app=tapp, cfg=cfg, store=tstore)
        return res, stats
    res_l, stats, values = [], [], tstore.values.clone()
    for i in range(N_INTERVALS):
        batch = {k: np.asarray(v)[i * INTERVAL:(i + 1) * INTERVAL]
                 for k, v in stream.items()}
        st = dataclasses.replace(tstore, values=values)
        r, _, values, s = _step_impl(st, events_to_torch(batch, "cpu"),
                                     i * INTERVAL, app=tapp, cfg=cfg)
        res_l.append(r)
        stats.append(s)
    return _stack(res_l), stats


def check_slice_against_reference(app_name, method, fused, *, n_keys=None,
                                  gen_kw=(), mutate=None, cfg_kw=(),
                                  exact_outputs=False):
    """Hold the port's run_stream to the JAX engine's on one stream.

    Final state and per-op results bitwise; outputs bitwise under
    ``exact_outputs``, else to 1e-5.  Returns the port's outputs and its
    per-interval EngineStats, for the caller to check what the run did.
    """
    japp, tapp = J_APPS[app_name], T_APPS[app_name]
    gen_kw, cfg_kw = dict(gen_kw), dict(cfg_kw)
    if n_keys is not None:
        gen_kw["n_keys"] = n_keys
    stream = _stream(app_name, **gen_kw)
    if mutate is not None:
        mutate(stream)
    jstore = japp.make_store() if n_keys is None else japp.make_store(n_keys)
    tstore = port_store(jstore)
    jres, jouts, jvals = _jax_run(japp, jstore, stream, method, fused, cfg_kw)

    cfg = EngineConfig(restructure_method=method, **cfg_kw)
    eng = DualModeEngine(tapp, tstore, cfg, device="cpu")
    outs, values = eng.run_stream(tstore.values, stream, INTERVAL,
                                  fused=fused)
    np.testing.assert_array_equal(np_(values), jvals, err_msg="final state")
    res, stats = _port_res(tapp, tstore, stream, cfg, fused)
    assert_dict_equal(res, jres, f"per-op results ({method}, fused={fused})")
    what = f"outputs ({method}, fused={fused})"
    if exact_outputs:
        assert len(outs) == len(jouts)
        for i, (o, jo) in enumerate(zip(outs, jouts)):
            assert_dict_equal(o, {k: np.asarray(v) for k, v in jo.items()},
                              f"{what}[{i}]")
    else:
        assert_outputs_close(outs, jouts, what)

    if not fused:   # the port's two drivers agree exactly
        outs_f, values_f = eng.run_stream(tstore.values, stream, INTERVAL,
                                          fused=True)
        assert torch.equal(values_f, values)
        for a, b in zip(outs_f, outs):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return outs, stats
