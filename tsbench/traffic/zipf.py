"""Zipf-skewed keys, distinct within a transaction, drawn in bulk.

The port's ``apps/common.sample_keys`` draws each transaction's keys with
``rng.choice(replace=False, p)``, one Python call per event.  Here every key
is drawn at once by inverting the Zipf CDF, and a key that repeats within
its row is drawn again until none does.  Drawing a repeated slot again from
the whole distribution until it misses the row's other keys is the same as
drawing it from the keys the row has not used: the distribution of
``rng.choice(replace=False, p)``.  The draws are not the port's draw for
draw.
"""
from __future__ import annotations

import numpy as np
import torch


def zipf_probs(n_keys: int, theta: float) -> np.ndarray:
    """P(k) proportional to 1 / (k + 1) ** theta; key 0 is the hottest."""
    w = 1.0 / np.power(np.arange(1, n_keys + 1, dtype=np.float64), theta)
    return w / w.sum()


def _draw(gen: torch.Generator, cdf: torch.Tensor, n: int) -> torch.Tensor:
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=cdf.device)
    k = torch.searchsorted(cdf, u, right=True)
    return k.clamp_(max=cdf.numel() - 1)


def zipf_keys(gen: torch.Generator, n_rows: int, width: int, n_keys: int,
              theta: float) -> torch.Tensor:
    """int32 [n_rows, width] Zipf(theta) keys in [0, n_keys), distinct
    within each row, on the generator's device."""
    if width > n_keys:
        raise ValueError(f"{width} distinct keys a row from {n_keys} keys")
    dev = gen.device
    cdf = torch.from_numpy(np.cumsum(zipf_probs(n_keys, theta))).to(dev)
    keys = _draw(gen, cdf, n_rows * width).view(n_rows, width)
    while width > 1:
        srt, col = torch.sort(keys, dim=1)
        rep = torch.zeros_like(keys, dtype=torch.bool)
        rep[:, 1:] = srt[:, 1:] == srt[:, :-1]
        # the later copies of a repeated key, in the row's own columns
        again = torch.zeros_like(rep).scatter_(1, col, rep)
        n_again = int(again.sum())
        if n_again == 0:
            break
        keys[again] = _draw(gen, cdf, n_again)
    return keys.to(torch.int32)
