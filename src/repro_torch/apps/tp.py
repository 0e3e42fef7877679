"""Toll Processing (TP) — Linear Road, paper §II and §VI-A (reference:
``repro/apps/tp.py``).

Road Speed, Vehicle Cnt and Toll Notification are fused into one operator;
per position report the transaction is::

  RMW  SpeedTable[seg]  += [speed, 1]        (running average as (sum, count))
  RMW  CountTable[seg]  |= onehot(vehicle)   (W-lane LPC sketch, max-combined)
  READ SpeedTable[seg]                       (same ts, later slot: the chain
  READ CountTable[seg]                        order gives the fresh version)

SpeedTable uses the affine ADD family and CountTable is max-typed, so the
fused driver takes the staged rung and runs both segmented scans.  Bodies
are batched: event columns are ``[B, ...]``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.blotter import AppSpec, Blotter
from ..core.types import ASSOC_FUNS, make_store
from .common import align_keys, zipf_probs

N_SEGMENTS = 100
WIDTH = 32          # LPC sketch lanes (also holds [sum, count] for speed)
MAX_OPS = 4
T_SPEED, T_CNT = 0, 1


def make_tp_store(n_segments: int = N_SEGMENTS, *, device=None, **_):
    return make_store([n_segments, n_segments], WIDTH,
                      is_max=[False, True], device=device)


def gen_events(rng: np.random.Generator, n_events: int, *,
               n_segments: int = N_SEGMENTS, theta: float = 0.2,
               n_vehicles: int = 5_000,
               align_mod: int = 0) -> Dict[str, np.ndarray]:
    p = zipf_probs(n_segments, theta)
    seg = rng.choice(n_segments, size=n_events, p=p).astype(np.int32)
    if align_mod > 1:
        seg = align_keys(seg, n_segments, align_mod)
    return dict(
        segment=seg,
        vehicle=rng.integers(0, n_vehicles, n_events).astype(np.int32),
        speed=rng.uniform(20.0, 120.0, n_events).astype(np.float32),
    )


def pre_process(ev):
    lane = ev["vehicle"] % WIDTH
    return dict(ev, lane=lane)


def state_access(blt: Blotter, eb):
    seg = eb["segment"]
    # Road Speed: running average of traffic speed
    speed_op = blt.zeros_lanes()
    speed_op[:, 0] = eb["speed"]
    speed_op[:, 1] = 1.0
    blt.read_modify(T_SPEED, seg, speed_op, "add")
    # Vehicle Cnt: LPC sketch update
    sketch = blt.zeros_lanes().scatter_(1, eb["lane"].long()[:, None], 1.0)
    blt.read_modify(T_CNT, seg, sketch, "max")
    # Toll Notification: read the *updated* congestion status
    s = blt.read(T_SPEED, seg)
    c = blt.read(T_CNT, seg)
    return s, c


def post_process(eb, res):
    speed_sum, cnt = res.pre[..., 2, 0], res.pre[..., 2, 1]
    avg_speed = speed_sum / torch.clamp(cnt, min=1.0)
    occupied = torch.sum(res.pre[..., 3, :] > 0.0, dim=-1, dtype=torch.int32)
    # LPC estimate of unique vehicles from lane occupancy
    frac = torch.clamp(occupied / WIDTH, 0.0, 1.0 - 1e-3)
    uniq = -WIDTH * torch.log1p(-frac)
    congested = (avg_speed < 40.0) & (uniq > 5.0)
    toll = torch.where(congested, 2.0 * (uniq - 5.0) ** 2,
                       torch.zeros_like(uniq))
    return dict(toll=toll, avg_speed=avg_speed, uniq=uniq)


TP = AppSpec(
    name="tp", funs=ASSOC_FUNS, max_ops=MAX_OPS, width=WIDTH,
    make_store=make_tp_store, gen_events=gen_events,
    pre_process=pre_process, state_access=state_access,
    post_process=post_process, has_gates=False, may_abort=False,
)
