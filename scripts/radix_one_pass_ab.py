#!/usr/bin/env python3
"""A/B of radix_partition's one-pass path against its block sort, on a card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/radix_one_pass_ab.py [--iters N] [--rounds R]

For a key space of at most 5 bits (K <= 31) and rows that do not take the
warp-per-row path, ``csrc/radix_partition.cu`` ranks in one pass of digit
counters (``radix_rank_one_pass``); the block sort would take the same rows
in one digit pass.  The script builds the source twice into
``build/radix_ab/``: as it is (A), and with ``kOnePassBits`` set to 0, so
that every key space takes the sort (B).  At the launch shapes of the
driven runs that take the one-pass path, both are held bitwise against the
plain twin and timed with CUDA events (``chip_smoke.cuda_ms``), in the order
A, B, B, A for each round.  Prints one line per shape and order, then a JSON
line of the per-shape means, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import assert_equal, card_line, cuda_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.radix_partition import ops  # noqa: E402
from repro_torch.kernels.radix_partition.ref import (  # noqa: E402
    radix_partition_rank_ref)

# [BN, N], K: sharded GS shared_everything's exchange, the sharded capacity
# run's exchange, and the widest key space the one-pass path takes.
SHAPES = (((80, 1250), 5), ((20, 20000), 5), ((200, 5000), 31))
ONE_PASS = "constexpr int kOnePassBits = 5;"


def build(out_dir: str) -> dict:
    """The two libraries, compiled side by side."""
    os.makedirs(out_dir, exist_ok=True)
    src = (_build.CSRC / "radix_partition.cu").read_text()
    if src.count(ONE_PASS) != 1:
        raise RuntimeError(f"{ONE_PASS!r} not found once in the source")
    variants = {"A": src, "B": src.replace(
        ONE_PASS, "constexpr int kOnePassBits = 0;")}
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(out_dir, f"radix_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"radix_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in ops.SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def caller(lib, keys: torch.Tensor, k: int):
    """A call of ``lib``'s entry on ``keys``, into buffers made once."""
    bn, n = keys.shape
    rank = torch.empty_like(keys)
    counts = torch.empty((bn, k), dtype=torch.int32, device=keys.device)
    threads = ops.default_threads(n)
    stream = torch.cuda.current_stream(keys.device).cuda_stream

    def call():
        err = lib.radix_partition_rank(keys.data_ptr(), rank.data_ptr(),
                                       counts.data_ptr(), bn, n, k, threads,
                                       stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return rank, counts
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("radix_one_pass_ab: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    libs = build(os.path.join(ROOT, "build", "radix_ab"))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    means = {}
    for (bn, n), k in SHAPES:
        keys = torch.from_numpy(
            rng.integers(0, k, (bn, n)).astype(np.int32)).to(dev)
        r0, c0 = radix_partition_rank_ref(keys, k)
        calls = {name: caller(lib, keys, k) for name, lib in libs.items()}
        for name, call in calls.items():
            r, c = call()
            torch.cuda.synchronize()
            assert_equal(r, r0, f"{name} rank [{bn}, {n}] K={k}")
            assert_equal(c, c0, f"{name} counts [{bn}, {n}] K={k}")
        times = {"A": [], "B": []}
        for _ in range(args.rounds):
            for name in ("A", "B", "B", "A"):
                ms, _ = cuda_ms(calls[name], args.iters)
                times[name].append(ms)
                print(f"ab radix [{bn}, {n}] K={k} {name}: ms={ms} | {card}")
        label = f"[{bn}, {n}] K={k}"
        means[label] = {name: {"mean_ms": float(np.mean(t)),
                               "min_ms": float(np.min(t)),
                               "max_ms": float(np.max(t))}
                        for name, t in times.items()}
        print(f"ab radix {label}: one pass (A) mean {means[label]['A']} "
              f"| sort (B) mean {means[label]['B']}")
    print(json.dumps({"radix_one_pass_ab": means}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
