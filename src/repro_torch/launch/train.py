"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``
(reference: ``repro/launch/train.py``).

Runs real steps on the CUDA card (``--device cpu`` to run on the CPU).
Integrates the substrate: the TStream-managed data pipeline, AdamW + WSD,
checkpoint/restart, deterministic replay.  The train step is deterministic
on the card by its choice of ops (``models/layers.py``), so a crashed and
resumed run ends bitwise equal to an uninterrupted one there too.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ckpt.checkpoint import _flatten, _unflatten
from ..configs import get_arch
from ..data import PipelineConfig, StreamingPipeline
from ..kernels.runtime import resolve_device
from ..models import ArchConfig, init_params, loss_fn
from ..optim import AdamWConfig, adamw_init, adamw_update_, wsd_schedule
from ..runtime import TrainLoop, TrainLoopConfig


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig, total_steps: int):
    """The launcher's step: loss and grads of every leaf (remat "dots"),
    the WSD rate of the optimizer's step count, one AdamW update.
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``; the
    params and AdamW state are donated (the reference's ``donate_argnums=
    (0, 1)``): written in place, leaf by leaf, and returned."""
    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for _, p in _flatten(params)]
        loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch,
                       remat="dots")
        grads = torch.autograd.grad(loss, leaves)
        lr = wsd_schedule(opt_state["step"], warmup=10,
                          stable=int(total_steps * 0.7),
                          decay=max(total_steps // 5, 1))
        with torch.no_grad():
            params, opt_state = adamw_update_(
                params, _unflatten(params, iter(grads)), opt_state, opt_cfg,
                lr_scale=lr)
        return params, opt_state, loss.detach()
    return train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    pipe = StreamingPipeline(PipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, batch=args.batch), device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, state_dtype=torch.float32)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    opt_state = adamw_init(params, opt_cfg)

    def make_batch(step, rng):
        return pipe.batch_for_step(step)

    loop = TrainLoop(
        TrainLoopConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        max_steps=args.steps),
        make_train_step(cfg, opt_cfg, args.steps), make_batch,
        params, opt_state)
    if args.resume and loop.try_resume():
        print(f"[train] resumed from step {loop.start_step}")

    t0 = time.time()
    loop.run()
    dt = time.time() - t0
    n = len(loop.losses)
    print(f"[train] {args.arch} on {dev}: {n} steps in {dt:.1f}s "
          f"({n / max(dt, 1e-9):.2f} steps/s)")
    print(f"[train] loss {loop.losses[0]:.4f} -> {loop.losses[-1]:.4f}")
    if not np.isfinite(loop.losses[-1]):
        raise RuntimeError(f"non-finite loss {loop.losses[-1]}")
    return loop.losses


if __name__ == "__main__":
    main()
