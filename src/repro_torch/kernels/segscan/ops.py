"""Wrappers of the segscan kernels (``csrc/segscan.cu``).

The kernels take the real lane width W (1 for GS, 32 for TP): no lane
padding.  Flags go in as one byte per row (a bool tensor).  A CUDA tensor
launches the kernel, which allocates nothing itself: the wrapper allocates
the outputs and the per-tile scratch.  A CPU tensor takes the plain twin.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import LAUNCHES, check, check_tensor, on_card
from .ref import segscan_affine_ref, segscan_max_ref

LIB = "segscan"
THREADS = 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "segscan_affine": [_P] * 10 + [_L, _I, _I, _P],
    "segscan_max": [_P] * 6 + [_L, _I, _I, _P],
    "segscan_tile_rows": [],
}


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
    threads = threads or THREADS
    check(threads % 32 == 0 and 32 <= threads <= 1024, name,
          f"threads={threads} must be a multiple of 32 in [32, 1024]")
    return n, w, threads


def _scratch(lib, n, w, k, dev):
    n_tiles = -(-n // lib.segscan_tile_rows())
    f32 = dict(dtype=torch.float32, device=dev)
    return ([torch.empty((n_tiles, w), **f32) for _ in range(2 * k)],
            torch.empty((n_tiles,), dtype=torch.uint8, device=dev))


def segscan_affine(a: torch.Tensor, b: torch.Tensor, seg_start: torch.Tensor,
                   *, threads: int | None = None):
    """Exclusive segmented affine scan.  a, b: f32[N, W]; seg_start: bool[N].
    Returns (A, B) f32[N, W]."""
    name = "segscan_affine"
    if not on_card(a, name):
        return segscan_affine_ref(seg_start, a, b)
    n, w, threads = _check(name, seg_start, (a, b), threads)
    A, B = torch.empty_like(a), torch.empty_like(b)
    if n and w:
        lib = _build.library(LIB, SIGNATURES)
        (agg_a, agg_b, cin_a, cin_b), tile_flag = _scratch(lib, n, w, 2,
                                                           a.device)
        err = lib.segscan_affine(
            seg_start.data_ptr(), a.data_ptr(), b.data_ptr(), A.data_ptr(),
            B.data_ptr(), agg_a.data_ptr(), agg_b.data_ptr(), cin_a.data_ptr(),
            cin_b.data_ptr(), tile_flag.data_ptr(), n, w, threads,
            torch.cuda.current_stream(a.device).cuda_stream)
        _build.check_launch(lib, err, name)
        LAUNCHES[name] += 1
    return A, B


def segscan_max(m: torch.Tensor, seg_start: torch.Tensor, *,
                threads: int | None = None):
    """Exclusive segmented max scan.  m: f32[N, W]; seg_start: bool[N]."""
    name = "segscan_max"
    if not on_card(m, name):
        return segscan_max_ref(seg_start, m)
    n, w, threads = _check(name, seg_start, (m,), threads)
    M = torch.empty_like(m)
    if n and w:
        lib = _build.library(LIB, SIGNATURES)
        (agg, cin), tile_flag = _scratch(lib, n, w, 1, m.device)
        err = lib.segscan_max(
            seg_start.data_ptr(), m.data_ptr(), M.data_ptr(), agg.data_ptr(),
            cin.data_ptr(), tile_flag.data_ptr(), n, w, threads,
            torch.cuda.current_stream(m.device).cuda_stream)
        _build.check_launch(lib, err, name)
        LAUNCHES[name] += 1
    return M
