"""Grep and Sum (GS) — paper §VI-A, Figure 5 (reference: ``repro/apps/gs.py``).

Grep issues one state transaction of 10 accesses per event: a read event
READs 10 records and forwards the values to Sum (fused, per §V operator
fusion); a write event WRITEs 10 records.  Table: 10k records.  Associative
(READ/PUT) and simple-affine with no max table, so the fused driver can take
the megakernel rung.  Bodies are batched: event columns are ``[B, ...]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.blotter import AppSpec, Blotter
from ..core.types import ASSOC_FUNS, OpKind, make_store
from .common import sample_keys, sample_multipartition_keys

TXN_LEN = 10
N_KEYS = 10_000
WIDTH = 1


def make_gs_store(n_keys: int = N_KEYS, rng: np.random.Generator | None = None,
                  *, device=None):
    rng = rng or np.random.default_rng(0)
    init = np.zeros((n_keys + 1, WIDTH), np.float32)
    init[:n_keys, 0] = rng.uniform(1.0, 100.0, n_keys)
    return make_store([n_keys], WIDTH, init=torch.from_numpy(init),
                      device=device)


def gen_events(rng: np.random.Generator, n_events: int, *,
               n_keys: int = N_KEYS, theta: float = 0.6,
               read_ratio: float = 0.5, n_partitions: int = 0,
               mp_ratio: float = 0.0, mp_len: int = 4,
               align_mod: int = 0) -> Dict[str, np.ndarray]:
    if n_partitions:
        keys = sample_multipartition_keys(rng, n_events, TXN_LEN, n_keys,
                                          theta, n_partitions, mp_ratio, mp_len)
    else:
        keys = sample_keys(rng, n_events, TXN_LEN, n_keys, theta,
                           align_mod=align_mod)
    return dict(
        keys=keys,
        is_read=(rng.random(n_events) < read_ratio),
        values=rng.uniform(1.0, 100.0, (n_events, TXN_LEN)).astype(np.float32),
    )


def pre_process(ev):
    return ev  # Parser already produced structured fields


def state_access(blt: Blotter, eb):
    f_read, f_put = blt.fun_id("read"), blt.fun_id("put")
    fun = torch.where(eb["is_read"], f_read, f_put).to(torch.int32)
    kind = torch.where(eb["is_read"], int(OpKind.READ),
                       int(OpKind.WRITE)).to(torch.int32)
    for j in range(TXN_LEN):
        blt.read_modify(0, eb["keys"][:, j], eb["values"][:, j], fun)
        blt.rows[-1]["kind"] = kind


def post_process(eb, res):
    # Sum operator: sum of returned values for read events; else pass-through.
    total = torch.sum(res.pre[..., 0], dim=-1) * eb["is_read"]
    return dict(sum=total, ok=torch.all(res.success, dim=-1))


GS = AppSpec(
    name="gs", funs=ASSOC_FUNS, max_ops=TXN_LEN, width=WIDTH,
    make_store=make_gs_store, gen_events=gen_events,
    pre_process=pre_process, state_access=state_access,
    post_process=post_process, has_gates=False, may_abort=False,
)
