"""Plain-PyTorch twins of the segscan kernels: the reference's segment-relative
Hillis-Steele sweeps (``core/restructure.py``)."""
from __future__ import annotations

import torch

from ...core.restructure import segmented_scan_affine, segmented_scan_max


def segscan_affine_ref(flags: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """flags: bool[N]; a, b: f32[N, W] -> exclusive (A, B)."""
    return segmented_scan_affine(a, b, flags.reshape(-1) > 0, exclusive=True)


def segscan_max_ref(flags: torch.Tensor, m: torch.Tensor):
    """flags: bool[N]; m: f32[N, W] -> exclusive M."""
    return segmented_scan_max(m, flags.reshape(-1) > 0, exclusive=True)
