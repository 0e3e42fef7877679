"""Plain-PyTorch twin of the radix_partition kernel.

The CPU path of ``ops.radix_partition_rank`` and the kernel's oracle on the
card.  A stable sort gives each row's sorted position; the histogram's
exclusive prefix turns it into the within-bucket rank.
"""
from __future__ import annotations

import torch


def radix_partition_rank_ref(keys: torch.Tensor, n_buckets: int):
    """keys: i32[..., N] in [0, n_buckets) -> (rank i32[..., N],
    counts i32[..., n_buckets]).

    ``rank[i]`` = number of rows j < i with ``keys[j] == keys[i]`` (the
    stable within-bucket rank); ``counts`` the key histogram.
    """
    k = keys.long()
    n = keys.shape[-1]
    order = torch.sort(k, dim=-1, stable=True).indices
    idx = torch.arange(n, device=keys.device).expand_as(k)
    pos = torch.empty_like(k).scatter_(-1, order, idx)
    counts = torch.zeros(keys.shape[:-1] + (n_buckets,), dtype=torch.int64,
                         device=keys.device)
    counts.scatter_add_(-1, k, torch.ones_like(k))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = pos - torch.gather(starts, -1, k)
    return rank.to(torch.int32), counts.to(torch.int32)
