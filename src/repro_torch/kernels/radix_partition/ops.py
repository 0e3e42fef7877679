"""Wrapper of the radix_partition kernel (``csrc/radix_partition.cu``).

``radix_partition_rank`` takes ``[N]`` or batched ``[BN, N]`` keys; the
batched call ranks a whole stream of stacked intervals in one launch, one
block per interval.  A CUDA tensor launches the kernel (or raises on a shape
it cannot take); a CPU tensor takes the plain twin in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import LAUNCHES, check, check_tensor, on_card
from .ref import radix_partition_rank_ref

NAME = "radix_partition"
THREADS = 256
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "radix_partition_rank": [_P, _P, _P, _I, _I, _I, _I, _P],
    "radix_partition_smem_bytes": [_I],
}


def radix_partition_rank(keys: torch.Tensor, n_buckets: int, *,
                         threads: int | None = None):
    """keys: i32[N] or i32[BN, N], values in [0, n_buckets).

    Returns ``(rank, counts)``: the stable within-bucket rank of each row
    (shape of ``keys``) and the per-batch histogram (``[n_buckets]`` /
    ``[BN, n_buckets]``), both int32.  ``threads`` overrides the block size.
    """
    if not on_card(keys, NAME):
        return radix_partition_rank_ref(keys, n_buckets)
    check(keys.dim() in (1, 2), NAME, f"keys must be [N] or [BN, N], got "
          f"{tuple(keys.shape)}")
    k2 = keys if keys.dim() == 2 else keys[None]
    check_tensor(k2, NAME, "keys", torch.int32, 2, keys.device)
    threads = threads or THREADS
    check(threads % 32 == 0 and 32 <= threads <= 1024, NAME,
          f"threads={threads} must be a multiple of 32 in [32, 1024]")
    bn, n = k2.shape
    check(n_buckets >= 1, NAME, f"n_buckets={n_buckets} must be >= 1")
    check(bn < 2 ** 31 and n < 2 ** 31, NAME, f"shape {tuple(k2.shape)} "
          "exceeds the kernel's int32 sizes")
    rank = torch.empty_like(k2)
    counts = torch.empty((bn, n_buckets), dtype=torch.int32,
                         device=keys.device)
    if bn and n:
        lib = _build.library(NAME, SIGNATURES)
        smem = lib.radix_partition_smem_bytes(n_buckets)
        limit = _build.smem_optin(lib)
        check(smem <= limit, NAME, f"{n_buckets} buckets need {smem} B of "
              f"shared memory; a block holds at most {limit} B")
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
