"""Wrapper of the hash_probe kernel (``csrc/hash_probe.cu``).

A CUDA tensor launches the kernel: where the table fits a block's shared
memory, blocks stage it there and loop over the queries; a larger table is
probed from L2, one query a thread.  No padding of the query count, and a
key view at any 4-byte offset.  With no ``threads`` given, the block size
is the search's (``kernels/autotune.block_rows``, keyed by the query count
and whether the table is staged).  A CPU tensor takes the plain twin in
``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, autotune
from ..runtime import LAUNCHES, check, check_tensor, costed, on_card
from .ref import ASSOC, MAX_PROBES, bucket_of, hash_probe_ref

NAME = "hash_probe"
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"hash_probe": [_P, _P, _P, _I, _I, _I, _P]}
STAGED_BLOCKS_PER_SM = 2   # csrc/hash_probe.cu: kStagedBlocksPerSm


def staged(n_buckets: int, smem_optin: int) -> bool:
    """Whether the kernel stages a table of ``n_buckets`` in shared memory
    (two blocks of it must fit an SM's opt-in limit per block)."""
    return n_buckets * ASSOC * 4 * STAGED_BLOCKS_PER_SM <= smem_optin


def _launch(keys, table, out, threads):
    """One launch over keys into out."""
    lib = _build.library(NAME, SIGNATURES)
    with torch.cuda.device(keys.device):    # launch on the keys' card
        err = lib.hash_probe(
            keys.data_ptr(), table.data_ptr(), out.data_ptr(),
            keys.shape[0], table.shape[0], threads,
            torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check_launch(lib, err, NAME)


def cost(keys: torch.Tensor, table: torch.Tensor, slots: torch.Tensor):
    """(bytes, operations) of one call that found ``slots`` (it reads them,
    so it waits for the device): the keys in and the slots out (4 B each)
    and the table once; per key the hash (multiply, shift, modulo), per
    bucket probed an index (add, modulo), and the compares up to the
    matching way, or every way of every probe for a key not found."""
    n_buckets = table.shape[0]
    hit = slots.long()
    probes = (hit // ASSOC - bucket_of(keys, n_buckets).long()) % n_buckets + 1
    compares = (probes - 1) * ASSOC + hit % ASSOC + 1
    found = hit >= 0
    probes = torch.where(found, probes, MAX_PROBES)
    compares = torch.where(found, compares, MAX_PROBES * ASSOC)
    n_ops = float((3 + 2 * probes + compares).sum())
    return 8.0 * keys.shape[0] + 4.0 * table.numel(), n_ops


@costed(NAME, lambda out, keys, table, **_: cost(keys, table, out))
def hash_probe(keys: torch.Tensor, table: torch.Tensor, *,
               threads: int | None = None) -> torch.Tensor:
    """keys i32[N], table i32[n_buckets, ASSOC] -> slot i32[N], -1 if absent.
    ``threads`` overrides the block size (the search's, whose default is
    1,024 threads where the table is staged, else 256); it changes no
    bit."""
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
        launch = functools.partial(_launch, keys, table, out)
        if threads is None:
            st = staged(n_buckets, autotune.device_profile(dev)["smem_optin"])
            threads = autotune.block_rows(
                NAME, n, dtype="int32", device=dev, launch=launch,
                variant="staged" if st else "global", staged=st)
        launch(threads)
        LAUNCHES[NAME] += 1
    return out
