"""Wrapper of the radix_partition kernel (``csrc/radix_partition.cu``).

``radix_partition_rank`` takes ``[N]`` or batched ``[BN, N]`` keys; the
batched call ranks a whole stream of stacked intervals in one launch (a
warp per row for many short rows over at most 4,096 keys, else a block per
row).  A CUDA tensor launches the kernel (or raises on an input it cannot
take); a CPU tensor takes the plain twin in ``ref.py``.  The kernel's shared
memory does not grow with the key space beyond that bound, so any
``n_buckets`` that fits an int32 is taken.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import LAUNCHES, check, check_tensor, on_card
from .ref import radix_partition_rank_ref

NAME = "radix_partition"
ITEMS = 8    # rows per thread in one of the kernel's chunks, at most
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"radix_partition_rank": [_P, _P, _P, _I, _I, _I, _I, _P]}


def default_threads(n: int) -> int:
    """Block size for rows of ``n`` keys: the fewest warps that hold a row
    at ``ITEMS`` rows a thread, at most 1,024 threads (a chunk of 8,192
    rows)."""
    return min(1024, max(32, -(-n // (32 * ITEMS)) * 32))


def radix_partition_rank(keys: torch.Tensor, n_buckets: int, *,
                         threads: int | None = None):
    """keys: i32[N] or i32[BN, N], values in [0, n_buckets).

    Returns ``(rank, counts)``: the stable within-bucket rank of each row
    (shape of ``keys``) and the per-batch histogram (``[n_buckets]`` /
    ``[BN, n_buckets]``), both int32.  ``threads`` overrides the block size
    (``default_threads``); it changes no bit.
    """
    if not on_card(keys, NAME):
        return radix_partition_rank_ref(keys, n_buckets)
    check(keys.dim() in (1, 2), NAME, f"keys must be [N] or [BN, N], got "
          f"{tuple(keys.shape)}")
    k2 = keys if keys.dim() == 2 else keys[None]
    check_tensor(k2, NAME, "keys", torch.int32, 2, keys.device)
    bn, n = k2.shape
    threads = threads or default_threads(n)
    check(threads % 32 == 0 and 32 <= threads <= 1024, NAME,
          f"threads={threads} must be a multiple of 32 in [32, 1024]")
    check(1 <= n_buckets < 2 ** 31, NAME,
          f"n_buckets={n_buckets} must lie in [1, 2^31)")
    check(bn < 2 ** 31 and n < 2 ** 31, NAME, f"shape {tuple(k2.shape)} "
          "exceeds the kernel's int32 sizes")
    rank = torch.empty_like(k2)
    counts = torch.empty((bn, n_buckets), dtype=torch.int32,
                         device=keys.device)
    if bn and n:     # the kernel writes every count, zeros included
        lib = _build.library(NAME, SIGNATURES)
        err = lib.radix_partition_rank(
            k2.data_ptr(), rank.data_ptr(), counts.data_ptr(), bn, n,
            n_buckets, threads, torch.cuda.current_stream(keys.device).cuda_stream)
        _build.check_launch(lib, err, NAME)
        LAUNCHES[NAME] += 1
    else:
        counts.zero_()
    if keys.dim() == 1:
        return rank[0], counts[0]
    return rank, counts
