"""Workload generators shared by the benchmark applications (paper §VI-B).

Host-side numpy generators (the Parser operator): Zipf-skewed key choice,
multi-partition transaction mixes, deterministic seeding.  Keys within one
transaction are sampled *distinct* (the paper's record lists; also required
so a transaction never touches the same state twice, matching all four
applications' semantics).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def zipf_probs(n_keys: int, theta: float) -> np.ndarray:
    """P(k) ∝ 1/(k+1)^theta — the standard Zipfian access distribution."""
    w = 1.0 / np.power(np.arange(1, n_keys + 1, dtype=np.float64), theta)
    return w / w.sum()


def align_keys(keys: np.ndarray, n_keys: int, align_mod: int) -> np.ndarray:
    """Bijectively remap keys so the Zipf-hot head lands on ONE residue
    class mod ``align_mod`` (k -> align_mod*(k % K) + k//K, K = n_keys /
    align_mod): the hottest keys map to 0, align_mod, 2*align_mod, ...

    The round-robin ownership striping (``owner = uid % n_shards``)
    neutralises plain Zipf skew by construction; this adversarial
    permutation re-concentrates it on one shard — the skew-storm
    workload that elastic resharding exists to absorb.  Distinctness
    within a transaction is preserved (the map is a bijection).
    """
    if align_mod <= 1:
        return keys
    assert n_keys % align_mod == 0, (n_keys, align_mod)
    k_per = n_keys // align_mod
    return (align_mod * (keys % k_per) + keys // k_per).astype(keys.dtype)


def sample_keys(rng: np.random.Generator, n_events: int, ops_per_txn: int,
                n_keys: int, theta: float,
                align_mod: int = 0) -> np.ndarray:
    """[n_events, ops_per_txn] Zipf-skewed keys, distinct within a txn.

    ``align_mod`` > 1 post-permutes through :func:`align_keys` so the hot
    head collides on one residue class (skew-storm workloads)."""
    p = zipf_probs(n_keys, theta)
    if ops_per_txn == 1:
        out = rng.choice(n_keys, size=(n_events, 1), p=p).astype(np.int32)
        return align_keys(out, n_keys, align_mod)
    out = np.empty((n_events, ops_per_txn), np.int32)
    for i in range(n_events):
        out[i] = rng.choice(n_keys, size=ops_per_txn, replace=False, p=p)
    return align_keys(out, n_keys, align_mod)


def sample_multipartition_keys(
        rng: np.random.Generator, n_events: int, ops_per_txn: int,
        n_keys: int, theta: float, n_partitions: int,
        mp_ratio: float, mp_len: int) -> np.ndarray:
    """Keys honouring the paper's multi-partition mix: ``mp_ratio`` of the
    transactions touch exactly ``mp_len`` distinct partitions (hash = key %
    n_partitions); the rest stay within a single partition."""
    p = zipf_probs(n_keys, theta)
    keys = np.empty((n_events, ops_per_txn), np.int32)
    is_mp = rng.random(n_events) < mp_ratio
    key_part = np.arange(n_keys) % n_partitions
    part_pools = [np.flatnonzero(key_part == q) for q in range(n_partitions)]
    part_probs = [p[pool] / p[pool].sum() for pool in part_pools]
    for i in range(n_events):
        span = mp_len if is_mp[i] else 1
        span = min(span, n_partitions, ops_per_txn)
        parts = rng.choice(n_partitions, size=span, replace=False)
        ks: list = []
        for j in range(ops_per_txn):
            q = parts[j % span]
            pool, pp = part_pools[q], part_probs[q]
            while True:
                k = rng.choice(pool, p=pp)
                if k not in ks:
                    break
            ks.append(k)
        keys[i] = ks
    return keys
