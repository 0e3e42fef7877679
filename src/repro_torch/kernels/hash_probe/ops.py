"""Wrapper of the hash_probe kernel (``csrc/hash_probe.cu``).

A CUDA tensor launches the kernel: where the table fits a block's shared
memory, blocks stage it there and loop over the queries; a larger table is
probed from L2, one query a thread.  No padding of the query count, and a
key view at any 4-byte offset.  A CPU tensor takes the plain twin in
``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import LAUNCHES, check, check_tensor, on_card
from .ref import ASSOC, hash_probe_ref

NAME = "hash_probe"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"hash_probe": [_P, _P, _P, _I, _I, _I, _P]}


def hash_probe(keys: torch.Tensor, table: torch.Tensor, *,
               threads: int | None = None) -> torch.Tensor:
    """keys i32[N], table i32[n_buckets, ASSOC] -> slot i32[N], -1 if absent.
    ``threads`` overrides the block size (1,024 threads where the table is
    staged, else 256); it changes no bit."""
    if not on_card(keys, NAME):
        return hash_probe_ref(keys, table)
    dev = keys.device
    check_tensor(keys, NAME, "keys", torch.int32, 1, dev)
    check_tensor(table, NAME, "table", torch.int32, 2, dev)
    check(table.shape[1] == ASSOC, NAME, f"table must be [n_buckets, {ASSOC}],"
          f" got {tuple(table.shape)}")
    check(table.data_ptr() % 16 == 0, NAME, "table must be 16-byte aligned")
    n_buckets, n = table.shape[0], keys.shape[0]
    check(n_buckets >= 1 and n_buckets * ASSOC < 2 ** 31, NAME,
          f"n_buckets={n_buckets} outside the kernel's int32 slots")
    check(n < 2 ** 31, NAME, f"{n} keys exceed the kernel's int32 sizes")
    if threads is not None:
        check(threads % 32 == 0 and 32 <= threads <= 1024, NAME,
              f"threads={threads} must be a multiple of 32 in [32, 1024]")
    out = torch.empty_like(keys)
    if n:
        lib = _build.library(NAME, SIGNATURES)
        err = lib.hash_probe(keys.data_ptr(), table.data_ptr(),
                             out.data_ptr(), n, n_buckets, threads or 0,
                             torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(lib, err, NAME)
        LAUNCHES[NAME] += 1
    return out
