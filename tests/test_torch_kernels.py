"""Each kernel's plain-PyTorch twin against the JAX package's Pallas kernel.

The Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU; the twins are what the port's wrappers run on a CPU tensor.
Bars: radix bitwise; segscan to rtol = atol = 1e-5 against the Pallas
kernel (its cross-block carry re-associates) and bitwise against the
reference's ``segmented_scan_affine``/``segmented_scan_max``.  The
megakernel's twin has its own file, ``test_torch_megakernel.py``; the
CUDA kernels are held against the twins in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.restructure import segmented_scan_affine as j_scan_affine
from repro.core.restructure import segmented_scan_max as j_scan_max
from repro.kernels.radix_partition import ops as j_rpops
from repro.kernels.radix_partition import ref as j_rpref
from repro.kernels.segscan import ops as j_segops

from repro_torch.kernels import runtime
from repro_torch.kernels.radix_partition.ops import radix_partition_rank
from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max
from repro_torch.kernels.segscan.ref import segscan_affine_ref, segscan_max_ref

from torch_parity import np_


# ---------------------------------------------------------------------------
# radix_partition
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,n_buckets", [
    (1, 1), (7, 3), (255, 128), (300, 129), (2500, 1000), (700, 2047),
    (2500, 10_001), (40_000, 201), (3000, 100_001), (1000, 1 << 20)])
def test_radix_twin_matches_reference(n, n_buckets):
    rng = np.random.default_rng(n * 7 + n_buckets)
    keys = rng.integers(0, n_buckets, n).astype(np.int32)
    r, c = radix_partition_rank(torch.from_numpy(keys), n_buckets)
    assert r.dtype == torch.int32 and c.dtype == torch.int32
    if j_rpops.kernel_fits(n_buckets, n) and n <= 3000:
        # the Pallas kernel (interpret) where its bucket bound holds
        r0, c0 = j_rpops.radix_partition_rank(jnp.asarray(keys), n_buckets,
                                              use_pallas=True, interpret=True)
    else:
        r0, c0 = j_rpref.radix_partition_rank_ref(jnp.asarray(keys), n_buckets)
    np.testing.assert_array_equal(np_(r), np.asarray(r0))
    np.testing.assert_array_equal(np_(c), np.asarray(c0))


def test_radix_twin_batched_matches_pallas():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 37, (5, 700)).astype(np.int32)
    r, c = radix_partition_rank(torch.from_numpy(keys), 37)
    r0, c0 = j_rpops.radix_partition_rank(jnp.asarray(keys), 37,
                                          use_pallas=True, interpret=True)
    np.testing.assert_array_equal(np_(r), np.asarray(r0))
    np.testing.assert_array_equal(np_(c), np.asarray(c0))


# ---------------------------------------------------------------------------
# segscan
# ---------------------------------------------------------------------------
def _segments(rng, n, avg_seg):
    flags = rng.random(n) < (1.0 / avg_seg)
    flags[0] = True
    return flags


@pytest.mark.parametrize("n,w,avg_seg", [
    (1, 1, 8), (300, 1, 1.5), (777, 32, 8), (2500, 2, 1000), (1024, 32, 40)])
def test_segscan_twins_match_pallas(n, w, avg_seg):
    rng = np.random.default_rng(n * 1000 + w)
    a = rng.uniform(0.0, 1.5, (n, w)).astype(np.float32)
    b = rng.uniform(-2.0, 2.0, (n, w)).astype(np.float32)
    m = rng.uniform(-5, 5, (n, w)).astype(np.float32)
    f = _segments(rng, n, avg_seg)
    A, B = segscan_affine(torch.from_numpy(a), torch.from_numpy(b),
                          torch.from_numpy(f))
    M = segscan_max(torch.from_numpy(m), torch.from_numpy(f))
    A0, B0 = j_segops.segscan_affine(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(f), interpret=True)
    M0 = j_segops.segscan_max(jnp.asarray(m), jnp.asarray(f), interpret=True)
    for got, want in ((A, A0), (B, B0), (M, M0)):
        np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n,w,avg_seg", [(5, 1, 2), (513, 32, 6),
                                         (3000, 3, 50)])
def test_segscan_twins_bitwise_vs_reference_scans(n, w, avg_seg):
    """Bitwise against the reference's sweeps on the coefficients the path
    feeds them: a in {0, 1} (every simple-affine fun), so each product is
    exact and XLA's fused multiply-add rounds as the twin does."""
    rng = np.random.default_rng(n + w)
    a = rng.integers(0, 2, (n, w)).astype(np.float32)
    b = rng.uniform(-50.0, 50.0, (n, w)).astype(np.float32)
    m = np.where(rng.random((n, w)) < 0.3, -np.inf,
                 rng.uniform(-5, 5, (n, w))).astype(np.float32)
    f = _segments(rng, n, avg_seg)
    A, B = segscan_affine_ref(torch.from_numpy(f), torch.from_numpy(a),
                              torch.from_numpy(b))
    M = segscan_max_ref(torch.from_numpy(f), torch.from_numpy(m))
    A0, B0 = jax.jit(j_scan_affine)(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(f))
    M0 = jax.jit(j_scan_max)(jnp.asarray(m), jnp.asarray(f))
    for got, want in ((A, A0), (B, B0), (M, M0)):
        np.testing.assert_array_equal(np_(got), np.asarray(want))


@pytest.mark.parametrize("w", [1, 32])
def test_segscan_twins_take_an_empty_stream(w):
    """N = 0 rows: empty results of the input's shape, as the reference's
    sweeps give (the twins' row shift once asked for a negative length)."""
    a = np.zeros((0, w), np.float32)
    f = np.zeros((0,), bool)
    A, B = segscan_affine(torch.from_numpy(a), torch.from_numpy(a),
                          torch.from_numpy(f))
    M = segscan_max(torch.from_numpy(a), torch.from_numpy(f))
    A0, B0 = jax.jit(j_scan_affine)(jnp.asarray(a), jnp.asarray(a),
                                    jnp.asarray(f))
    M0 = jax.jit(j_scan_max)(jnp.asarray(a), jnp.asarray(f))
    for got, want in ((A, A0), (B, B0), (M, M0)):
        assert tuple(got.shape) == tuple(want.shape) == (0, w)
        assert got.dtype == torch.float32


def test_segscan_flattened_stream_equals_per_interval():
    """One scan over a flattened stack of intervals gives each interval's
    own scan bit for bit (the sweep is segment-relative)."""
    rng = np.random.default_rng(3)
    bn, n, w = 4, 300, 2
    a = torch.from_numpy(rng.integers(0, 2, (bn, n, w)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-9, 9, (bn, n, w)).astype(np.float32))
    f = torch.from_numpy(np.stack([_segments(rng, n, 7) for _ in range(bn)]))
    A, B = segscan_affine(a.reshape(-1, w), b.reshape(-1, w), f.reshape(-1))
    for i in range(bn):
        Ai, Bi = segscan_affine(a[i], b[i], f[i])
        assert torch.equal(A.reshape(bn, n, w)[i], Ai)
        assert torch.equal(B.reshape(bn, n, w)[i], Bi)


# ---------------------------------------------------------------------------
# wrappers on the CPU take the twin and count no launch
# ---------------------------------------------------------------------------
def test_cpu_wrappers_take_twins_without_launch():
    runtime.reset_launches()
    keys = torch.randint(0, 9, (3, 50), dtype=torch.int32)
    radix_partition_rank(keys, 9)
    a = torch.rand(50, 3)
    f = torch.rand(50) < 0.2
    segscan_affine(a, a, f)
    segscan_max(a, f)
    assert all(v == 0 for v in runtime.LAUNCHES.values()), runtime.LAUNCHES
    with pytest.raises(ValueError, match="unsupported device"):
        radix_partition_rank(keys.to("meta"), 9)
