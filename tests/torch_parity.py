"""Helpers for the port's parity tests (``tests/test_torch_*.py``).

Data crosses between the JAX reference and the PyTorch port as numpy arrays
only.  Not a test module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.convert import store_from_numpy
from repro_torch.core.types import OpBatch as TOpBatch

# The suite runs in several worker processes beside JAX's own thread pools;
# the port's CPU tensors here are small, so one intra-op thread each keeps
# the workers from oversubscribing the cores.
torch.set_num_threads(1)

CHAIN_FIELDS = ("order", "inv", "seg_start", "seg_id", "pos", "seg_end",
                "n_chains", "max_len", "counts", "starts")
OP_FIELDS = ("uid", "ts", "txn", "slot", "kind", "fun", "gate", "operand",
             "valid")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def port_store(jstore, device="cpu"):
    """The port's StateStore holding a JAX store's state."""
    return store_from_numpy(np.asarray(jstore.values), jstore.table_base,
                            jstore.table_capacity, jstore.table_is_max,
                            device=device)


def port_ops(jops, device="cpu") -> TOpBatch:
    """A JAX OpBatch as the port's OpBatch (same dtypes)."""
    return TOpBatch(**{
        f.name: (None if getattr(jops, f.name) is None else
                 torch.from_numpy(np.array(getattr(jops, f.name))).to(device))
        for f in dataclasses.fields(TOpBatch)})


def assert_fields_equal(got, want, fields, what):
    """Every named field bitwise equal (dtype included); None on both sides
    passes."""
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if g is None or w is None:
            assert g is None and w is None, f"{what}.{f}: {g} vs {w}"
            continue
        g, w = np_(g), np_(w)
        assert g.dtype == w.dtype, f"{what}.{f}: dtype {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f}")


def assert_dict_equal(got, want, what):
    assert set(got) == set(want), (what, set(got), set(want))
    for k in want:
        g, w = np_(got[k]), np_(want[k])
        assert g.dtype == w.dtype, f"{what}[{k}]: dtype {g.dtype} vs {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what}[{k}]")


def assert_outputs_close(got, want, what, tol=1e-5):
    """Per-interval post-processed outputs to rtol = atol = ``tol``: torch
    and XLA CPU associate the apps' reductions differently, and their
    log1p / division implementations differ."""
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), (what, set(g), set(w))
        for k in w:
            gk, wk = np_(g[k]), np_(w[k])
            assert gk.shape == wk.shape, (what, i, k, gk.shape, wk.shape)
            np.testing.assert_allclose(gk.astype(np.float64),
                                       wk.astype(np.float64), rtol=tol,
                                       atol=tol, err_msg=f"{what}[{i}].{k}")


def need_card():
    """Skip unless a CUDA card is present (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)
