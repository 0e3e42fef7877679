"""End-to-end driver on the PyTorch port: train a ~100M-param dense LM for a
few hundred steps through the full stack (TStream data pipeline, AdamW+WSD,
checkpointing, crash-resume) on the CUDA card (reference:
``examples/train_100m.py``).

    PYTHONPATH=src python examples/torch/train_100m.py [--steps 300] \\
        [--ckpt-dir results/ckpt_100m] [--device cpu]

``main(argv, cfg=...)`` takes another model config (a test passes a tiny
one).  "Loss must fall" compares the mean of the first 10 losses with the
mean of the last 10, so it is checked when the run has at least 20 steps.
"""
import argparse
import dataclasses
import shutil
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.data import PipelineConfig, StreamingPipeline
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_, \
    wsd_schedule
from repro_torch.runtime import TrainLoop, TrainLoopConfig

SEQ_LEN, BATCH = 256, 8


def dense_100m():
    """~100M params: 8 layers, d=768, ffn 3072, vocab 32k."""
    base = get_arch("minicpm-2b")
    return dataclasses.replace(
        base, name="dense-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=12, head_dim=64, d_ff=3072, vocab=32_000,
        residual_scale=1.0)


def main(argv=None, cfg=None):
    """Train; returns ``dict(losses=..., ckpt_dir=..., seconds=...)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="results/ckpt_100m")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg or dense_100m()
    n = cfg.param_count()
    print(f"[100m] {cfg.name}: {n/1e6:.1f}M params on {dev}")

    pipe = StreamingPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ_LEN,
                                            batch=BATCH), device=dev)
    # keep the stream-side statistics engine hot during training
    ingest_rng = np.random.default_rng(1)
    pipe.ingest(ingest_rng, 256)
    print(f"[100m] mixture weights from TStream stats engine: "
          f"{np.round(pipe.mixture_weights()[:4], 4)} ...")

    opt_cfg = AdamWConfig(lr=3e-4, state_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.float32, device=dev)
    opt_state = adamw_init(params, opt_cfg)

    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for _, p in _flatten(params)]
        loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch,
                       remat="none")
        grads = torch.autograd.grad(loss, leaves)
        lr = wsd_schedule(opt_state["step"], warmup=20,
                          stable=args.steps - 80, decay=60)
        with torch.no_grad():     # params and state donated: in place
            params, opt_state = adamw_update_(
                params, _unflatten(params, iter(grads)), opt_state, opt_cfg,
                lr_scale=lr)
        return params, opt_state, loss.detach()

    shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    loop = TrainLoop(
        TrainLoopConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100,
                        max_steps=args.steps),
        train_step, lambda step, rng: pipe.batch_for_step(step),
        params, opt_state)

    t0 = time.time()
    loop.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    first = np.mean(loop.losses[:10])
    last = np.mean(loop.losses[-10:])
    tok_s = args.steps * BATCH * SEQ_LEN / dt
    print(f"[100m] {args.steps} steps in {dt/60:.1f} min "
          f"({tok_s:.0f} tok/s)")
    print(f"[100m] loss {first:.3f} -> {last:.3f}")
    if len(loop.losses) >= 20:
        assert last < first - 0.5, "loss must fall substantially"
        print("[100m] training learns ✓ (checkpoints in " + args.ckpt_dir
              + ")")
    else:
        print(f"[100m] {len(loop.losses)} steps: too few to hold the first "
              "10 losses against the last 10")
    return dict(losses=list(loop.losses), ckpt_dir=args.ckpt_dir, seconds=dt)


if __name__ == "__main__":
    main()
