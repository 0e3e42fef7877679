"""Fault-tolerant training loop: checkpoint/restart with exact resume
(reference: ``repro/runtime/ft.py``).

Determinism contract: the batch for step *i* is a pure function of
(data_seed, i), so after a crash, resuming from the last checkpoint replays
the identical data order, and the recovered run is bitwise identical to an
uninterrupted one.  That holds on the card only if ``step_fn`` is itself
deterministic there: the model's train path is written so
(``models/layers.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..ckpt import (latest_step, load_checkpoint, prune_checkpoints,
                    save_checkpoint)

Tree = Any


@dataclasses.dataclass
class TrainLoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    data_seed: int = 0
    keep_last: int = 3


class TrainLoop:
    """Driver around a train step with restart-from-checkpoint.

    ``step_fn(params, opt_state, batch) -> (params, opt_state, loss)`` on
    trees of tensors; checkpoints hold ``dict(params=..., opt=...)`` in the
    reference's format (``ckpt/``)."""

    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable,
                 make_batch: Callable[[int, np.random.Generator], Dict],
                 params: Tree, opt_state: Tree):
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.params = params
        self.opt_state = opt_state
        self.start_step = 0
        self.losses: list = []

    def try_resume(self) -> bool:
        last = latest_step(self.cfg.ckpt_dir)
        if last is None:
            return False
        tree = dict(params=self.params, opt=self.opt_state)
        restored = load_checkpoint(self.cfg.ckpt_dir, last, tree)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.start_step = last
        return True

    def _batch_for(self, step: int) -> Dict:
        # data order is a pure function of (seed, step): replay-exact resume
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.data_seed, step]))
        return self.make_batch(step, rng)

    def run(self, until: Optional[int] = None,
            crash_at: Optional[int] = None) -> Tree:
        until = until or self.cfg.max_steps
        for step in range(self.start_step, until):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self._batch_for(step)
            self.params, self.opt_state, loss = self.step_fn(
                self.params, self.opt_state, batch)
            self.losses.append(float(loss))
            done = step + 1
            if done % self.cfg.ckpt_every == 0 or done == until:
                save_checkpoint(self.cfg.ckpt_dir, done,
                                dict(params=self.params, opt=self.opt_state))
                self._gc()
        return self.params

    def _gc(self):
        prune_checkpoints(self.cfg.ckpt_dir, self.cfg.keep_last)
