"""The megakernel's per-interval plain-PyTorch twin against the JAX
package, bitwise.

``fused_chain_eval_ref`` (one interval) is held against both the Pallas
kernel ``fused_chain_pallas`` (interpret mode, as the JAX package's own tests
run it) and the JAX ``fused_chain_eval_ref``, on the odd shapes of
``tests/test_megakernel.py``: a row count that is not a lane multiple with
skewed buckets, one chain, all padding, one row, a padded tail.  The stream
twin and the stream wrapper are held to it in
``test_torch_megakernel_stream.py``; the CUDA kernel is held against the
twins in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engines import simple_affine_luts as j_luts
from repro.core.restructure import restructure as j_restructure
from repro.core.types import F_ADD, F_NOP, F_PUT, F_READ, OpBatch, make_store
from repro.kernels.megakernel import fused_chain_eval as j_fused
from repro.kernels.megakernel import fused_chain_eval_ref as j_fused_ref

from repro_torch.core import types as T
from repro_torch.core.engines import simple_affine_luts
from repro_torch.core.restructure import restructure
from repro_torch.kernels.megakernel.ref import fused_chain_eval_ref

from torch_parity import assert_dict_equal, np_, port_ops

J_FUNS = (F_NOP, F_READ, F_PUT, F_ADD)
T_FUNS = (T.F_NOP, T.F_READ, T.F_PUT, T.F_ADD)


def _mk_batch(uid, valid, *, w=2, max_ops=4, seed=None):
    n = uid.shape[0]
    idx = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(n if seed is None else seed)
    return OpBatch(
        uid=jnp.asarray(uid.astype(np.int32)),
        ts=jnp.asarray(idx // max_ops), txn=jnp.asarray(idx // max_ops),
        slot=jnp.asarray(idx % max_ops), kind=jnp.zeros((n,), jnp.int32),
        fun=jnp.asarray(rng.integers(0, len(J_FUNS), n).astype(np.int32)),
        gate=jnp.full((n,), -1, jnp.int32),
        operand=jnp.asarray(rng.normal(size=(n, w)).astype(np.float32)),
        valid=jnp.asarray(valid))


def _mega_case(name):
    rng = np.random.default_rng(7)
    if name == "odd_n_skewed":
        s = 37
        p = 1.0 / np.arange(1, s + 1, dtype=np.float64)
        return rng.choice(s, size=160, p=p / p.sum()), rng.uniform(
            size=160) > 0.15, s
    if name == "single_chain":
        return np.full((40,), 3), np.ones((40,), bool), 8
    if name == "all_pad":
        return rng.integers(0, 8, 24), np.zeros((24,), bool), 8
    if name == "n1":
        return np.zeros((1,), np.int64), np.ones((1,), bool), 4
    valid = np.ones((100,), bool)
    valid[60:] = False
    return rng.integers(0, 5, 100), valid, 5


@pytest.mark.parametrize("case", ["odd_n_skewed", "single_chain", "all_pad",
                                  "n1", "mixed_pad_tail"])
def test_megakernel_twin_matches_pallas_and_ref(case):
    uid, valid, n_slots = _mega_case(case)
    jstore = make_store([n_slots], 2)
    values = np.random.default_rng(1).normal(
        size=(n_slots + 1, 2)).astype(np.float32)
    values[-1] = 0.0
    jops = _mk_batch(uid, valid)
    pad = jstore.pad_uid
    jsops, jch = jax.jit(lambda o: j_restructure(
        o, pad, rowmajor_ts=True, light=True, method="partition",
        geometry=False))(jops)
    a_lut, b_lut = j_luts(J_FUNS)
    want = dict(
        pallas=jax.jit(lambda v, so, c: j_fused(
            v, so, c, pad, a_lut=a_lut, b_lut=b_lut, use_pallas=True,
            interpret=True))(jnp.asarray(values), jsops, jch),
        ref=jax.jit(lambda v, so, c: j_fused_ref(
            v, so, c, pad, a_lut=a_lut, b_lut=b_lut))(
            jnp.asarray(values), jsops, jch))

    sops, ch = restructure(port_ops(jops), n_slots, rowmajor_ts=True,
                           light=True, method="partition", geometry=False)
    ta, tb = simple_affine_luts(T_FUNS)
    res, vals, stats = fused_chain_eval_ref(torch.from_numpy(values.copy()),
                                            sops, ch, n_slots, a_lut=ta,
                                            b_lut=tb)
    assert stats.path == "megakernel"
    for tag, (jres, jvals, _) in want.items():
        np.testing.assert_array_equal(np_(vals), np.asarray(jvals),
                                      err_msg=f"values vs {tag}")
        assert_dict_equal(res, {k: np.asarray(v) for k, v in jres.items()},
                          f"results vs {tag}")
