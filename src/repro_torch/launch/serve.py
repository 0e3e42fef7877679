"""Serving launcher: batched prefill+decode with transactional session
state (``python -m repro_torch.launch.serve --arch <id>-smoke``; reference:
``repro/launch/serve.py``).

Every request's quota update runs as a TStream state transaction (a
``take`` on the session's token lane) on the port's engine, the lockstep
path: concurrent request handlers never partition or lock the session
store.  Runs on the CUDA card (``--device cpu`` to run on the CPU).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..core.blotter import AppSpec
from ..core.scheduler import DualModeEngine, EngineConfig
from ..core.types import CORE_FUNS, make_store
from ..kernels.runtime import resolve_device
from ..models import ArchConfig, decode_step, init_cache, init_params

N_SESSIONS = 1024


def _session_store(*, device=None, **_):
    return make_store([N_SESSIONS], 2, device=device)  # [tokens, requests]


def _no_events(rng, n):
    return {}


def _pre(ev):
    return ev


def _access(blt, eb):
    # debit the session's token quota; reject when exhausted (F_TAKE)
    n = eb["n_tokens"]
    blt.read_modify(0, eb["session"], torch.stack([n, -torch.ones_like(n)],
                                                  -1), "take")


def _post(eb, res):
    return dict(admitted=res.success[..., 0])


QUOTA_APP = AppSpec(
    name="serve_quota", funs=CORE_FUNS, max_ops=1, width=2,
    make_store=_session_store, gen_events=_no_events, pre_process=_pre,
    state_access=_access, post_process=_post,
)


def admit(batch: int, max_seq: int, rng: np.random.Generator, device
          ) -> np.ndarray:
    """One interval of quota transactions: ``batch`` requests of
    ``max_seq`` tokens each on random sessions with a quota of 1,000
    tokens.  Returns the admitted flags."""
    store = _session_store(device=device)
    quota = DualModeEngine(QUOTA_APP, store, EngineConfig(), device=device)
    values = store.values.clone()
    values[:, 0] = 1000.0                               # initial quota
    events = dict(
        session=rng.integers(0, N_SESSIONS, batch).astype(np.int32),
        n_tokens=np.full((batch,), float(max_seq), np.float32))
    out, _, _ = quota.step(values, events, 0)
    return out["admitted"]


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, gen_len: int):
    """Prefill ``prompt`` [B, P] token by token through the decode path
    (simple, exact), then decode ``gen_len`` tokens greedily.  The caches
    take the params' dtype.  Returns (generated [B, gen_len], the logits of
    every step [B, P + gen_len, V]): step i's logits follow token i of
    ``cat(prompt, generated)``."""
    b, plen = prompt.shape
    caches = init_cache(cfg, b, plen + gen_len,
                        dtype=params["lm_head"].dtype, device=prompt.device)
    steps = []
    with torch.no_grad():
        for i in range(plen):
            logits, caches = decode_step(cfg, params, caches,
                                         prompt[:, i:i + 1], i)
            steps.append(logits)
        generated = []
        tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
        for i in range(gen_len):
            generated.append(tok)
            logits, caches = decode_step(cfg, params, caches, tok, plen + i)
            steps.append(logits)
            tok = torch.argmax(logits[:, -1:], -1).to(torch.int32)
    return torch.cat(generated, 1), torch.cat(steps, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-34b-smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    max_seq = args.prompt_len + args.gen_len

    # transactional session accounting
    rng = np.random.default_rng(0)
    admitted = admit(args.batch, max_seq, rng, dev)
    print(f"[serve] admitted {int(np.sum(admitted))}/{args.batch} requests "
          "(quota txns)")

    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    t0 = time.time()
    gen, _ = generate(cfg, params, toks, args.gen_len)
    gen = gen.cpu().numpy()
    dt = time.time() - t0
    total = args.batch * max_seq
    print(f"[serve] {args.arch} on {dev}: {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s)")
    if gen.shape != (args.batch, args.gen_len):
        raise RuntimeError(f"generated {gen.shape}")
    print(f"[serve] sample continuation: {gen[0][:8].tolist()}")
    return dict(admitted=admitted, generated=gen)


if __name__ == "__main__":
    main()
