"""Wrapper of the radix_partition kernel (``csrc/radix_partition.cu``).

``radix_partition_rank`` takes ``[N]`` or batched ``[BN, N]`` keys; the
batched call ranks a whole stream of stacked intervals in one launch (a
warp per row for many short rows over at most 4,096 keys, else a block per
row).  A CUDA tensor launches the kernel (or raises on an input it cannot
take); a CPU tensor takes the plain twin in ``ref.py``.  The kernel's shared
memory does not grow with the key space beyond that bound, so any
``n_buckets`` that fits an int32 is taken.  With no ``threads`` given, the
block size is the search's (``kernels/autotune.block_rows``, keyed by the
row length, the kernel's path and the batch rows).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, autotune
from ..runtime import LAUNCHES, check, check_tensor, costed, on_card
from .ref import radix_partition_rank_ref

NAME = "radix_partition"
ITEMS = 8    # rows per thread in one of the kernel's chunks, at most
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"radix_partition_rank": [_P, _P, _P, _I, _I, _I, _I, _P]}
# the kernel's choice of path (csrc/radix_partition.cu): a warp per row for
# rows and key spaces of at most 4,096 where the batch fills 4 rows a block
# on every SM; else one pass of counters for K <= 31; else the block sort
WARP_ROW_MAX = 4096
WARP_ROWS_PER_BLOCK = 4
ONE_PASS_MAX_BUCKETS = 31


def default_threads(n: int) -> int:
    """Block size for rows of ``n`` keys: the fewest warps that hold a row
    at ``ITEMS`` rows a thread, at most 1,024 threads (a chunk of 8,192
    rows)."""
    return min(1024, max(32, -(-n // (32 * ITEMS)) * 32))


def path(bn: int, n: int, n_buckets: int, sms: int) -> str:
    """The kernel's path for ``bn`` rows of ``n`` keys over ``n_buckets`` on
    a card of ``sms`` SMs: "warp_rows", "one_pass" or "sort"."""
    if (n_buckets <= WARP_ROW_MAX and n <= WARP_ROW_MAX
            and bn >= WARP_ROWS_PER_BLOCK * sms):
        return "warp_rows"
    return "one_pass" if n_buckets <= ONE_PASS_MAX_BUCKETS else "sort"


def _launch(keys, rank, counts, n_buckets, threads):
    """One launch over keys [BN, N] into rank and counts."""
    bn, n = keys.shape
    lib = _build.library(NAME, SIGNATURES)
    err = lib.radix_partition_rank(
        keys.data_ptr(), rank.data_ptr(), counts.data_ptr(), bn, n,
        n_buckets, threads, torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check_launch(lib, err, NAME)


def cost(keys: torch.Tensor, n_buckets: int):
    """(bytes, operations) of one call on ``keys`` ([N] or [BN, N]) over
    ``n_buckets``: each input read once and each output written once (keys
    in, ranks and counts out, 4 B each), one operation a key."""
    bn, n = (1, keys.shape[0]) if keys.dim() == 1 else tuple(keys.shape)
    return 4.0 * (2 * bn * n + bn * n_buckets), float(bn * n)


@costed(NAME, lambda out, keys, n_buckets, **_: cost(keys, n_buckets))
def radix_partition_rank(keys: torch.Tensor, n_buckets: int, *,
                         threads: int | None = None):
    """keys: i32[N] or i32[BN, N], values in [0, n_buckets).

    Returns ``(rank, counts)``: the stable within-bucket rank of each row
    (shape of ``keys``) and the per-batch histogram (``[n_buckets]`` /
    ``[BN, n_buckets]``), both int32.  ``threads`` overrides the block size
    (the search's, whose default is ``default_threads``); it changes no
    bit.
    """
    if not on_card(keys, NAME):
        return radix_partition_rank_ref(keys, n_buckets)
    check(keys.dim() in (1, 2), NAME, f"keys must be [N] or [BN, N], got "
          f"{tuple(keys.shape)}")
    k2 = keys if keys.dim() == 2 else keys[None]
    check_tensor(k2, NAME, "keys", torch.int32, 2, keys.device)
    bn, n = k2.shape
    if threads is not None:
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
        launch = functools.partial(_launch, k2, rank, counts, n_buckets)
        if threads is None:
            dev = keys.device
            sms = autotune.device_profile(dev)["sms"]
            threads = autotune.block_rows(
                NAME, n, dtype="int32", device=dev, launch=launch,
                variant=f"{path(bn, n, n_buckets, sms)}/bn"
                        f"{autotune.shape_bucket(bn)}")
        launch(threads)
        LAUNCHES[NAME] += 1
    else:
        counts.zero_()
    if keys.dim() == 1:
        return rank[0], counts[0]
    return rank, counts
