"""Streaming Ledger (SL) — paper §VI-A, Figure 6 (reference:
``repro/apps/sl.py``).

Deposit: top up an (account, asset) pair — 2 ADD ops.
Transfer: move balance from a (src account, src asset) pair to a dst pair —
4 ops: two conditional debits (bounded TAKE on the source records) and two
credits *gated* on the matching debit's success (the paper's CFun data
dependency; the heavy-dependency workload of §VI-C/D).

Tables: accounts + assets, 10k records each.  Non-associative (TAKE) and
gated, so it takes the lockstep path with level-wise dependency resolution.
Bodies are batched: event columns are ``[B, ...]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.blotter import AppSpec, Blotter
from ..core.types import CORE_FUNS, make_store
from .common import sample_keys

N_KEYS = 10_000
WIDTH = 1
MAX_OPS = 4
T_ACCT, T_ASSET = 0, 1


def make_sl_store(n_keys: int = N_KEYS, rng: np.random.Generator | None = None,
                  *, device=None):
    rng = rng or np.random.default_rng(1)
    init = np.zeros((2 * n_keys + 1, WIDTH), np.float32)
    init[: 2 * n_keys, 0] = rng.uniform(50.0, 500.0, 2 * n_keys)
    return make_store([n_keys, n_keys], WIDTH, init=torch.from_numpy(init),
                      device=device)


def gen_events(rng: np.random.Generator, n_events: int, *,
               n_keys: int = N_KEYS, theta: float = 0.6,
               transfer_ratio: float = 0.5,
               align_mod: int = 0) -> Dict[str, np.ndarray]:
    # [src, dst] distinct within each pair
    acct = sample_keys(rng, n_events, 2, n_keys, theta, align_mod=align_mod)
    asset = sample_keys(rng, n_events, 2, n_keys, theta, align_mod=align_mod)
    return dict(
        src_acct=acct[:, 0], dst_acct=acct[:, 1],
        src_asset=asset[:, 0], dst_asset=asset[:, 1],
        amount=rng.uniform(1.0, 50.0, n_events).astype(np.float32),
        is_transfer=(rng.random(n_events) < transfer_ratio),
    )


def pre_process(ev):
    return ev


def state_access(blt: Blotter, eb):
    f_add, f_take = blt.fun_id("add"), blt.fun_id("take")
    tr = eb["is_transfer"]
    amt = eb["amount"]
    fun01 = torch.where(tr, f_take, f_add).to(torch.int32)
    # deposits top up (ADD) the src pair; transfers debit (TAKE) it
    s0 = blt.read_modify(T_ACCT, eb["src_acct"], amt, fun01)
    s1 = blt.read_modify(T_ASSET, eb["src_asset"], amt, fun01)
    # credits to the dst pair exist only for transfers, gated on the debits
    blt.read_modify(T_ACCT, eb["dst_acct"], amt, f_add,
                    gate=torch.where(tr, s0, -1), valid=tr)
    blt.read_modify(T_ASSET, eb["dst_asset"], amt, f_add,
                    gate=torch.where(tr, s1, -1), valid=tr)


def post_process(eb, res):
    committed = res.success[..., 0] & res.success[..., 1]
    return dict(ok=committed,
                src_balance=res.post[..., 0, 0],
                rejected=eb["is_transfer"] & ~committed)


SL = AppSpec(
    name="sl", funs=CORE_FUNS, max_ops=MAX_OPS, width=WIDTH,
    make_store=make_sl_store, gen_events=gen_events,
    pre_process=pre_process, state_access=state_access,
    post_process=post_process, has_gates=True, may_abort=True,
)
