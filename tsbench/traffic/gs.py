"""Grep&Sum events (TStream paper Sec. VI-A, Fig. 5), drawn in bulk.

Each event is one transaction of ``ops`` accesses to distinct records,
Zipf(theta) over the table; a read event reads them all and sums what it
read, a write event writes a value to each.  The columns are those of the
port's ``apps/gs.gen_events``: ``keys`` int32 [n, ops], ``is_read`` bool [n],
``values`` float32 [n, ops] uniform in [value_low, value_high).
"""
from __future__ import annotations

import torch

from .zipf import zipf_keys


def generate(gen: torch.Generator, n_events: int, config: dict,
             traffic: dict) -> dict:
    """``n_events`` events on the generator's device: the table and the
    transaction length from ``config``, the mix from ``traffic``."""
    n_keys, ops = config["tables"][0], config["ops"]
    theta, read_ratio = traffic["theta"], traffic["read_ratio"]
    value_low, value_high = traffic["value_low"], traffic["value_high"]
    dev = gen.device
    keys = zipf_keys(gen, n_events, ops, n_keys, theta)
    is_read = torch.rand(n_events, generator=gen, device=dev) < read_ratio
    values = torch.rand((n_events, ops), generator=gen, device=dev)
    values = values * (value_high - value_low) + value_low
    return dict(keys=keys, is_read=is_read, values=values)
