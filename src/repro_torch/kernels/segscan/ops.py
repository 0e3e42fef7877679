"""Wrappers of the segscan kernels (``csrc/segscan.cu``).

The kernels take the real lane width W (1 for GS, 32 for TP): no lane
padding.  Flags go in as one byte per row (a bool tensor).  A CUDA tensor
launches the kernel: one launch per scan, whose tiles hand their carries on
in a fixed order through status and carry words.  The wrapper allocates the
outputs and that scratch (the status words zeroed, one memset), sized for
the kernel's smallest tile.  With no ``threads`` given, the block size
is the search's (``kernels/autotune.block_rows``, keyed by the rows and the
lane width).  A CPU tensor takes the plain twin.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build, autotune
from ..runtime import LAUNCHES, check, check_tensor, costed, on_card
from .ref import segscan_affine_ref, segscan_max_ref

LIB = "segscan"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "segscan_affine": [_P] * 7 + [_L, _L, _I, _I, _P],
    "segscan_max": [_P] * 5 + [_L, _L, _I, _I, _P],
}
# The smallest tile of the kernel's geometries (csrc/segscan.cu: 256 rows x
# 32 lanes at W > 1, 4,096 rows at W = 1): the scratch has a slot for each.
MIN_TILE_ROWS = 256


def _check(name, seg_start, xs, threads):
    dev = xs[0].device
    for i, x in enumerate(xs):
        check_tensor(x, name, f"operand {i}", torch.float32, 2, dev)
        check(x.shape == xs[0].shape, name, f"operand shapes differ: "
              f"{tuple(x.shape)} vs {tuple(xs[0].shape)}")
    check_tensor(seg_start, name, "seg_start", torch.bool, 1, dev)
    n, w = xs[0].shape
    check(seg_start.shape[0] == n, name, f"seg_start has {seg_start.shape[0]}"
          f" rows, operands {n}")
    check(w < 2 ** 31, name, f"width {w} too large")
    if threads is not None:
        check(threads % 32 == 0 and 32 <= threads <= 1024, name,
              f"threads={threads} must be a multiple of 32 in [32, 1024]")
    return n, w


def _scratch(n, w, k, dev):
    """(status, carry, slots): the kernel's tile counter and one status word
    per tile slot, zeroed; K x 32 carry floats per slot."""
    slots = -(-n // MIN_TILE_ROWS) * -(-w // 32)
    status = torch.zeros((1 + slots,), dtype=torch.int32, device=dev)
    carry = torch.empty((slots, k, 32), dtype=torch.float32, device=dev)
    return status, carry, slots


def _affine(seg_start, a, b, A, B, threads):
    """One launch of the affine scan into A, B (fresh scratch each call)."""
    n, w = a.shape
    lib = _build.library(LIB, SIGNATURES)
    with torch.cuda.device(a.device):       # launch on the operands' card
        status, carry, slots = _scratch(n, w, 2, a.device)
        err = lib.segscan_affine(
            seg_start.data_ptr(), a.data_ptr(), b.data_ptr(), A.data_ptr(),
            B.data_ptr(), status.data_ptr(), carry.data_ptr(), slots, n, w,
            threads, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check_launch(lib, err, "segscan_affine")


def _max(seg_start, m, M, threads):
    """One launch of the max scan into M (fresh scratch each call)."""
    n, w = m.shape
    lib = _build.library(LIB, SIGNATURES)
    with torch.cuda.device(m.device):       # launch on the operands' card
        status, carry, slots = _scratch(n, w, 1, m.device)
        err = lib.segscan_max(
            seg_start.data_ptr(), m.data_ptr(), M.data_ptr(),
            status.data_ptr(), carry.data_ptr(), slots, n, w, threads,
            torch.cuda.current_stream(m.device).cuda_stream)
    _build.check_launch(lib, err, "segscan_max")


def _threads(name, launch, n, w, dev):
    """The search's block size for a scan of n rows x w lanes."""
    return autotune.block_rows(name, n, device=dev, variant=f"w{w}",
                               launch=launch)


def cost(x: torch.Tensor, kind: str):
    """(bytes, operations) of one scan of ``kind`` ("affine" or "max") over
    the rows ``x`` [N, W]: the flags (1 B a row) and the coefficients in,
    the scans out, each once (f32: two operands and two results for the
    affine scan, one each for the max); 3 operations a row and lane to
    compose an affine pair, 1 for a max."""
    n, w = x.shape
    if kind == "affine":
        return n + 16.0 * n * w, 3.0 * n * w
    if kind == "max":
        return n + 8.0 * n * w, 1.0 * n * w
    raise ValueError(f"kind={kind!r}: 'affine' or 'max'")


@costed("segscan_affine", lambda out, a, *_, **__: cost(a, "affine"))
def segscan_affine(a: torch.Tensor, b: torch.Tensor, seg_start: torch.Tensor,
                   *, threads: int | None = None):
    """Exclusive segmented affine scan.  a, b: f32[N, W]; seg_start: bool[N].
    Returns (A, B) f32[N, W]."""
    name = "segscan_affine"
    if not on_card(a, name):
        return segscan_affine_ref(seg_start, a, b)
    n, w = _check(name, seg_start, (a, b), threads)
    A, B = torch.empty_like(a), torch.empty_like(b)
    if n and w:
        launch = functools.partial(_affine, seg_start, a, b, A, B)
        launch(threads or _threads(name, launch, n, w, a.device))
        LAUNCHES[name] += 1
    return A, B


@costed("segscan_max", lambda out, m, *_, **__: cost(m, "max"))
def segscan_max(m: torch.Tensor, seg_start: torch.Tensor, *,
                threads: int | None = None):
    """Exclusive segmented max scan.  m: f32[N, W]; seg_start: bool[N]."""
    name = "segscan_max"
    if not on_card(m, name):
        return segscan_max_ref(seg_start, m)
    n, w = _check(name, seg_start, (m,), threads)
    M = torch.empty_like(m)
    if n and w:
        launch = functools.partial(_max, seg_start, m, M)
        launch(threads or _threads(name, launch, n, w, m.device))
        LAUNCHES[name] += 1
    return M
