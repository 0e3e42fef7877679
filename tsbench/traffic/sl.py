"""Streaming Ledger events (TStream paper Sec. VI-A, Fig. 6), drawn in bulk.

An event names a source and a destination account, a source and a
destination asset (each pair distinct, Zipf(theta) over its table), an
amount uniform in [amount_low, amount_high) and whether it is a transfer
(else a deposit).  The columns are those of the port's
``apps/sl.gen_events``.
"""
from __future__ import annotations

import torch

from .zipf import zipf_keys


def generate(gen: torch.Generator, n_events: int, config: dict,
             traffic: dict) -> dict:
    """``n_events`` events on the generator's device: the tables from
    ``config`` (accounts, assets), the mix from ``traffic``."""
    n_keys = config["tables"][0]
    theta, transfer_ratio = traffic["theta"], traffic["transfer_ratio"]
    amount_low, amount_high = traffic["amount_low"], traffic["amount_high"]
    dev = gen.device
    acct = zipf_keys(gen, n_events, 2, n_keys, theta)
    asset = zipf_keys(gen, n_events, 2, n_keys, theta)
    amount = torch.rand(n_events, generator=gen, device=dev)
    amount = amount * (amount_high - amount_low) + amount_low
    is_transfer = torch.rand(n_events, generator=gen,
                             device=dev) < transfer_ratio
    return dict(src_acct=acct[:, 0].contiguous(),
                dst_acct=acct[:, 1].contiguous(),
                src_asset=asset[:, 0].contiguous(),
                dst_asset=asset[:, 1].contiguous(),
                amount=amount, is_transfer=is_transfer)
