"""The slice end to end for GS: the port's run_stream against JAX's.

Under every ``restructure_method`` and both drivers (fused and host loop):
final state and per-op pre/post/success bitwise, post-processed outputs to
rtol = atol = 1e-5 (torch and XLA CPU associate the Sum reduction
differently), and the port's fused driver equal to its host loop.  At the
megakernel's "auto" band the plan's rung follows the device's shared
memory, and every rung gives the reference's state.
"""
import functools
import importlib

import numpy as np
import pytest

from repro.apps import ALL_APPS as J_APPS
from repro.core.scheduler import DualModeEngine as JEngine
from repro.core.scheduler import EngineConfig as JConfig

from repro_torch.apps import ALL_APPS as T_APPS
from repro_torch.core.scheduler import DualModeEngine, EngineConfig

from torch_parity import port_store
from torch_slice import METHODS, check_slice_against_reference

scheduler = importlib.import_module("repro_torch.core.scheduler")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("fused", [True, False])
def test_gs_slice_matches_reference(method, fused):
    check_slice_against_reference("gs", method, fused)


# GS at the megakernel's "auto" band: 4,000 events (40,000 rows) an interval
# over 10,001 slots, where the card's megakernel block cannot hold an
# interval (an H100 opts in to 232,448 B of shared memory per block).
BAND_INTERVAL, BAND_INTERVALS, H100_SMEM = 4000, 2, 232_448


@functools.lru_cache(maxsize=None)
def _band_reference(method):
    japp = J_APPS["gs"]
    stream = japp.gen_events(np.random.default_rng(5),
                             BAND_INTERVAL * BAND_INTERVALS)
    jstore = japp.make_store()
    eng = JEngine(japp, jstore, JConfig(restructure_method=method))
    _, values = eng.run_stream(jstore.values, stream, BAND_INTERVAL)
    return stream, jstore, np.asarray(values)


@pytest.mark.parametrize("method,smem_limit,rung", [
    ("auto", None, "megakernel"), ("auto", H100_SMEM, "packed"),
    ("megakernel", None, "megakernel"),
    ("megakernel", H100_SMEM, "partition")])
def test_gs_at_the_megakernel_band_matches_reference(monkeypatch, method,
                                                     smem_limit, rung):
    """2 intervals of 4,000 events (80,000 ops) on the twins equal the JAX
    fused run bitwise in state.  With no limit (the CPU) the megakernel
    twin takes them; with an H100's limit the plan takes the staged rung
    the card takes, "packed" under "auto", "partition" when forced."""
    stream, jstore, jvals = _band_reference(method)
    monkeypatch.setattr(scheduler, "smem_optin", lambda dev: smem_limit)
    eng = DualModeEngine(T_APPS["gs"], port_store(jstore),
                         EngineConfig(restructure_method=method),
                         device="cpu")
    _, values = eng.run_stream(eng.init_store.values, stream, BAND_INTERVAL)
    assert eng.last_rung == rung
    np.testing.assert_array_equal(values.numpy(), jvals)
