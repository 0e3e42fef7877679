"""Plain-PyTorch twin of the hash_probe kernel, and the table it probes.

Reference: ``repro/kernels/hash_probe/{kernel,ref}.py``.  The table is an
int32 ``[n_buckets, ASSOC]`` array of keys with -1 in empty ways; a key
lives in the first free way of the first of ``MAX_PROBES`` consecutive
buckets (from its hash bucket on) that has one.  The reference keeps the
table as two float32 tables of 16-bit halves and gathers with a one-hot
matmul, a TPU workaround; ``convert.probe_table_from_halves`` turns those
halves into this table.

``hash_probe_ref`` is the CPU path of ``ops.hash_probe`` and the kernel's
oracle on the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

ASSOC = 8
MAX_PROBES = 4
_MULT = 2654435761  # Knuth multiplicative hash
_M32 = 0xFFFFFFFF


def _mul_lo32(k, m: int):
    """(k * m) mod 2^32 for k in [0, 2^32) without an int64 overflow: the
    16-bit halves of k each multiply into at most 48 bits."""
    lo, hi = k & 0xFFFF, k >> 16
    return (lo * m + (((hi * m) & 0xFFFF) << 16)) & _M32


def bucket_of(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """i32 hash bucket: ``((key mod 2^32)·MULT mod 2^32) >> 16 mod n_buckets``
    (in int64 with a 32-bit mask: torch has no general uint32 arithmetic)."""
    h = _mul_lo32(key.long() & _M32, _MULT) >> 16
    return (h % n_buckets).to(torch.int32)


def bucket_of_np(key: np.ndarray, n_buckets: int) -> np.ndarray:
    h = _mul_lo32(np.asarray(key).astype(np.int64) & _M32, _MULT) >> 16
    return (h % n_buckets).astype(np.int32)


def insert_keys(keys: np.ndarray, n_buckets: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Insert keys (distinct) in order with linear probing over buckets.

    Returns ``(table, slot)``: the int32 ``[n_buckets, ASSOC]`` key table
    (-1 = empty) and each key's flat slot ``bucket * ASSOC + way``.  Ways of
    a bucket fill in order and are never freed, so the first free way is
    the bucket's fill count.
    """
    keys = np.asarray(keys).astype(np.int64)
    table = np.full((n_buckets, ASSOC), -1, np.int32)
    fill = np.zeros(n_buckets, np.int64)
    slot = np.empty(len(keys), np.int64)
    for i, (k, b) in enumerate(zip(keys.tolist(),
                                   bucket_of_np(keys, n_buckets).tolist())):
        for p in range(MAX_PROBES):
            row = (b + p) % n_buckets
            way = int(fill[row])
            if way < ASSOC:
                table[row, way] = k
                fill[row] = way + 1
                slot[i] = row * ASSOC + way
                break
        else:
            raise RuntimeError("hash table overflow; grow n_buckets")
    return table, slot


def build_table(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """The int32 key table holding ``keys`` (see ``insert_keys``)."""
    return insert_keys(keys, n_buckets)[0]


def hash_probe_ref(keys: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """keys i32[N], table i32[n_buckets, ASSOC] -> slot i32[N] (-1 absent):
    the first matching way of the first probed bucket that holds the key."""
    n_buckets = table.shape[0]
    base = bucket_of(keys, n_buckets).long()
    q = keys.to(torch.int32)[:, None]
    found = torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    for p in range(MAX_PROBES):
        bkt = (base + p) % n_buckets
        match = table[bkt] == q                                   # [N, ASSOC]
        hit = match.any(dim=1)
        lane = torch.argmax(match.to(torch.int32), dim=1)
        slot = (bkt * ASSOC + lane).to(torch.int32)
        found = torch.where((found < 0) & hit, slot, found)
    return found
