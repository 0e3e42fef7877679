"""The port's hash_probe twin and table against the JAX package.

The twin (the CPU path of ``ops.hash_probe``) must equal the JAX oracle
``hash_probe_ref`` and the Pallas kernel in interpret mode bit for bit, on
the cases of ``tests/test_kernels.py`` (present and absent keys); the port's
int32 table must be the JAX table's halves put together; and the hash must
agree on keys near and past 2^31.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hash_probe import kernel as jkernel
from repro.kernels.hash_probe import ops as jops
from repro.kernels.hash_probe import ref as jref

from repro_torch.convert import probe_table_from_halves
from repro_torch.kernels.hash_probe import ref as tref
from repro_torch.kernels.hash_probe.ops import hash_probe


def _case(n_keys, n_buckets):
    rng = np.random.default_rng(n_keys)
    keys = rng.choice(2**31 - 1, size=n_keys, replace=False).astype(np.int32)
    absent = rng.choice(2**31 - 1, size=200).astype(np.int32)
    absent = np.setdiff1d(absent, keys)[:100]
    lo, hi = jref.build_table(keys, n_buckets)
    return keys, absent, lo, hi


@pytest.mark.parametrize("n_keys,n_buckets", [(50, 64), (500, 256),
                                              (4000, 2048)])
def test_table_matches_reference_halves(n_keys, n_buckets):
    keys, _, lo, hi = _case(n_keys, n_buckets)
    table = tref.build_table(keys, n_buckets)
    assert table.dtype == np.int32 and table.shape == (n_buckets, tref.ASSOC)
    np.testing.assert_array_equal(table, probe_table_from_halves(lo, hi))
    # every key sits at the slot insert_keys reports
    t2, slot = tref.insert_keys(keys, n_buckets)
    np.testing.assert_array_equal(t2, table)
    np.testing.assert_array_equal(table.reshape(-1)[slot], keys)


@pytest.mark.parametrize("n_keys,n_buckets", [(50, 64), (500, 256),
                                              (4000, 2048)])
@pytest.mark.parametrize("which", ["present", "absent"])
def test_twin_matches_reference_and_kernel(n_keys, n_buckets, which):
    keys, absent, lo, hi = _case(n_keys, n_buckets)
    q = keys[: min(n_keys, 300)] if which == "present" else absent
    want_ref = np.asarray(jref.hash_probe_ref(jnp.asarray(q), jnp.asarray(lo),
                                              jnp.asarray(hi)))
    want_ker = np.asarray(jops.hash_probe(jnp.asarray(q), jnp.asarray(lo),
                                          jnp.asarray(hi), interpret=True))
    table = torch.from_numpy(probe_table_from_halves(lo, hi))
    got = hash_probe(torch.from_numpy(q), table)       # CPU: the twin
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_ref)
    np.testing.assert_array_equal(got.numpy(), want_ker)
    if which == "present":
        assert np.all(got.numpy() >= 0)
        np.testing.assert_array_equal(table.reshape(-1)[got.long()].numpy(),
                                      q)
    else:
        assert np.all(got.numpy() == -1)


@pytest.mark.parametrize("n_buckets", [64, 2500, 70_000])
def test_bucket_of_matches_reference_near_2_31(n_buckets):
    keys = np.array([0, 1, 65535, 65536, 2**31 - 2, 2**31 - 1, -1, -2,
                     -(2**31), -(2**31) + 1, 1234567891, -987654321],
                    dtype=np.int32)
    want = np.asarray(jkernel.bucket_of(jnp.asarray(keys), n_buckets))
    np.testing.assert_array_equal(
        tref.bucket_of(torch.from_numpy(keys), n_buckets).numpy(), want)
    np.testing.assert_array_equal(tref.bucket_of_np(keys, n_buckets), want)
    np.testing.assert_array_equal(
        tref.bucket_of_np(keys, n_buckets),
        jref.bucket_of_np(keys, n_buckets))


def test_negative_and_wrapping_queries_match_reference():
    """Queries past int32's sign bit probe like the reference (the table's
    empty ways hold -1, which the halves encode as 0xFFFF, 0xFFFF)."""
    keys = np.array([5, 2**31 - 1, 77, 2**30], dtype=np.int32)
    lo, hi = jref.build_table(keys, 64)
    q = np.array([-1, -7, 2**31 - 1, -(2**31), 77], dtype=np.int32)
    want = np.asarray(jref.hash_probe_ref(jnp.asarray(q), jnp.asarray(lo),
                                          jnp.asarray(hi)))
    got = hash_probe(torch.from_numpy(q),
                     torch.from_numpy(tref.build_table(keys, 64)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_overflow_raises_like_reference():
    """One bucket holds 8 keys: a ninth overflows in both packages."""
    keys = np.arange(9, dtype=np.int32)
    for build in (jref.build_table, tref.build_table):
        build(keys[:8], 1)
        with pytest.raises(RuntimeError, match="overflow"):
            build(keys, 1)


@pytest.mark.parametrize("n_keys,n_buckets", [(7, 1), (20, 3), (500, 256)])
def test_twin_takes_a_ragged_count_and_an_offset_view(n_keys, n_buckets):
    """A query count that is not a multiple of 4, a key view one element
    into its storage, and tables of fewer than 4 buckets (probes wrap more
    than once): the twin equals the reference and the Pallas kernel."""
    rng = np.random.default_rng(n_keys + n_buckets)
    keys = rng.choice(2**31 - 1, size=n_keys, replace=False).astype(np.int32)
    lo, hi = jref.build_table(keys, n_buckets)
    q = np.concatenate([rng.choice(keys, 298), [-1, 2**31 - 1, 12345]]
                       ).astype(np.int32)
    assert len(q) % 4 == 1
    want = np.asarray(jref.hash_probe_ref(jnp.asarray(q), jnp.asarray(lo),
                                          jnp.asarray(hi)))
    np.testing.assert_array_equal(
        want, np.asarray(jops.hash_probe(jnp.asarray(q), jnp.asarray(lo),
                                         jnp.asarray(hi), interpret=True)))
    table = torch.from_numpy(tref.build_table(keys, n_buckets))
    storage = torch.from_numpy(np.concatenate([[7], q]).astype(np.int32))
    view = storage[1:]
    assert view.storage_offset() == 1 and view.is_contiguous()
    np.testing.assert_array_equal(hash_probe(view, table).numpy(), want)
    np.testing.assert_array_equal(
        hash_probe(torch.from_numpy(q[:-2]), table).numpy(), want[:-2])
