"""The replicate-everything baseline (``core/sharded.py::evaluate_sharded``)
against the JAX package.

Every shard receives the whole op batch, keeps its own ops, restructures
once and evaluates with ``eval_tstream_scan``; the layouts that share state
merge with a ``psum``.  Under all three layouts, for GS and TP (whose max
sketch tables give the local stores per-slot max flags), the new state must
equal the JAX single-device ``eval_tstream_scan`` of the same batch bit for
bit, whichever restructure rung runs.  (The JAX ``evaluate_sharded`` needs
the sharded ``shard_map`` path, which gives no output on the installed
JAX.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import ALL_APPS as J_APPS
from repro.core.blotter import build_opbatch as j_build
from repro.core.engines import eval_tstream_scan as j_eval

from repro_torch.apps import ALL_APPS
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.sharded import LAYOUTS, evaluate_sharded

from torch_parity import port_ops, port_store

MESHES = {"shared_nothing": ((8,), ("dev",)),
          "shared_nothing_2d": ((2, 4), ("socket", "core")),
          "shared_per_socket": ((2, 4), ("socket", "core")),
          "shared_everything": ((8,), ("dev",))}


def _batch(app_name, n_events=96, seed=3):
    japp = J_APPS[app_name]
    jstore = japp.make_store()
    ev = japp.gen_events(np.random.default_rng(seed), n_events)
    jops, _ = j_build(japp, jstore, {k: jnp.asarray(v) for k, v in ev.items()},
                      jnp.int32(0))
    _, want, _ = jax.jit(lambda s, o: j_eval(s, o, japp.funs,
                                             rowmajor_ts=True))(jstore, jops)
    return jstore, jops, np.asarray(want)[:-1]


@pytest.mark.parametrize("method", ["auto", "partition", "lexsort"])
@pytest.mark.parametrize("layout", sorted(MESHES))
@pytest.mark.parametrize("app_name", ["gs", "tp"])
def test_evaluate_sharded_bitwise(app_name, layout, method):
    jstore, jops, want = _batch(app_name)
    shape, names = MESHES[layout]
    got = evaluate_sharded(port_store(jstore), port_ops(jops),
                           ALL_APPS[app_name].funs,
                           ShardMesh(shape, names, device="cpu"),
                           layout.replace("_2d", ""),
                           restructure_method=method)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the batch changed some state, so the check is not of a no-op
    assert not np.array_equal(want, np.asarray(jstore.values)[:-1])


def test_evaluate_sharded_rejects_bad_layouts():
    jstore, jops, _ = _batch("gs", n_events=8)
    funs = ALL_APPS["gs"].funs
    assert LAYOUTS == ("shared_nothing", "shared_per_socket",
                       "shared_everything")
    with pytest.raises(ValueError, match="layout"):
        evaluate_sharded(port_store(jstore), port_ops(jops), funs,
                         ShardMesh((4,), ("dev",), device="cpu"), "bogus")
    with pytest.raises(ValueError, match="socket, core"):
        evaluate_sharded(port_store(jstore), port_ops(jops), funs,
                         ShardMesh((4,), ("dev",), device="cpu"),
                         "shared_per_socket")
