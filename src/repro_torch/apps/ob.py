"""Online Bidding (OB) — paper §VI-A, Figure 7 (reference:
``repro/apps/ob.py``).

Item state: [price, quantity].  Request mix 6:1:1 —
  bid   (len 1):  if bid_price >= price and qty >= req: qty -= req else reject
  alter (len 20): overwrite the price of 20 items
  top   (len 20): increase the quantity of 20 items

``bid`` is a user-defined conditional Fun (not associative), so OB takes
the lockstep path; a bid may be rejected (its success flag).  Bodies are
batched: event columns are ``[B, ...]``, a fun's lanes ``[..., W]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.blotter import AppSpec, Blotter
from ..core.types import CORE_FUNS, FunSpec, make_store
from .common import sample_keys

N_KEYS = 10_000
WIDTH = 2      # lanes: [price, quantity]
MAX_OPS = 20
BID, ALTER, TOP = 0, 1, 2


def _ok(pre):
    return torch.ones(pre.shape[:-1], dtype=torch.bool, device=pre.device)


def _f_bid(pre, operand):
    """operand = [bid_price, req_qty]."""
    ok = (operand[..., 0] >= pre[..., 0]) & (pre[..., 1] >= operand[..., 1])
    qty = pre[..., 1] - torch.where(ok, operand[..., 1], 0.0)
    return torch.stack([pre[..., 0], qty], -1), ok


def _f_set_price(pre, operand):
    return torch.stack([operand[..., 0], pre[..., 1]], -1), _ok(pre)


def _f_add_qty(pre, operand):
    return torch.stack([pre[..., 0], pre[..., 1] + operand[..., 1]], -1), \
        _ok(pre)


def _lanes(o, lanes):
    return o.new_tensor(lanes).expand(o.shape)


F_BID = FunSpec("bid", _f_bid)
F_SET_PRICE = FunSpec(
    "set_price", _f_set_price,
    affine=lambda o: (_lanes(o, [0.0, 1.0]), o * o.new_tensor([1.0, 0.0])))
F_ADD_QTY = FunSpec(
    "add_qty", _f_add_qty,
    affine=lambda o: (_lanes(o, [1.0, 1.0]), o * o.new_tensor([0.0, 1.0])))

OB_FUNS = CORE_FUNS + (F_BID, F_SET_PRICE, F_ADD_QTY)


def make_ob_store(n_keys: int = N_KEYS, rng: np.random.Generator | None = None,
                  *, device=None):
    rng = rng or np.random.default_rng(2)
    init = np.zeros((n_keys + 1, WIDTH), np.float32)
    init[:n_keys, 0] = rng.uniform(10.0, 100.0, n_keys)   # price
    init[:n_keys, 1] = rng.uniform(0.0, 1000.0, n_keys)   # quantity
    return make_store([n_keys], WIDTH, init=torch.from_numpy(init),
                      device=device)


def gen_events(rng: np.random.Generator, n_events: int, *,
               n_keys: int = N_KEYS, theta: float = 0.6,
               align_mod: int = 0) -> Dict[str, np.ndarray]:
    kind = rng.choice([BID, ALTER, TOP], size=n_events, p=[0.75, 0.125, 0.125])
    return dict(
        kind=kind.astype(np.int32),
        keys=sample_keys(rng, n_events, MAX_OPS, n_keys, theta,
                         align_mod=align_mod),
        prices=rng.uniform(10.0, 100.0, (n_events, MAX_OPS)).astype(np.float32),
        qtys=rng.uniform(1.0, 20.0, (n_events, MAX_OPS)).astype(np.float32),
    )


def pre_process(ev):
    return ev


def state_access(blt: Blotter, eb):
    f_bid = blt.fun_id("bid")
    f_set, f_addq = blt.fun_id("set_price"), blt.fun_id("add_qty")
    kind = eb["kind"]
    is_bid, is_alter = kind == BID, kind == ALTER
    fun = torch.where(is_bid, f_bid,
                      torch.where(is_alter, f_set, f_addq)).to(torch.int32)
    for j in range(MAX_OPS):
        operand = torch.stack([eb["prices"][:, j], eb["qtys"][:, j]], -1)
        # bids touch only their first item; alter/top touch all 20
        blt.read_modify(0, eb["keys"][:, j], operand, fun,
                        valid=True if j == 0 else ~is_bid)


def post_process(eb, res):
    is_bid = eb["kind"] == BID
    return dict(rejected=is_bid & ~res.success[..., 0],
                qty_after=res.post[..., 0, 1])


OB = AppSpec(
    name="ob", funs=OB_FUNS, max_ops=MAX_OPS, width=WIDTH,
    make_store=make_ob_store, gen_events=gen_events,
    pre_process=pre_process, state_access=state_access,
    post_process=post_process, has_gates=False, may_abort=True,
)
