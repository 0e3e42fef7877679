"""Device resolution, launch counters and launch checks shared by the kernels.

``resolve_device`` is the port's one device rule: ``None`` means the CUDA
card, and a missing card raises.  Only an explicit ``device="cpu"`` runs on
the CPU, where every kernel wrapper takes its plain-PyTorch twin.

``LAUNCHES`` counts kernel launches per kernel.  A wrapper adds one where
it launches its kernel on the card and nowhere else, so a run can show that
it went through the kernels (``chip_smoke.py`` reads it).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

KERNELS = ("radix_partition", "segscan_affine", "segscan_max", "megakernel",
           "hash_probe")

LAUNCHES = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the CUDA card (raises without one); else the device given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def smem_optin(device: Union[str, torch.device]) -> Optional[int]:
    """Largest shared memory one block may opt in to on ``device`` (bytes),
    read from the device; None on the CPU, where the twins have no such
    limit."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(dev)
               .shared_memory_per_block_optin)


def on_card(x: torch.Tensor, name: str) -> bool:
    """Whether a wrapper launches its kernel (CUDA tensor) or its twin (CPU)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {x.device}")


def check(cond: bool, name: str, msg: str) -> None:
    """Raise ValueError on an input the kernel does not take."""
    if not cond:
        raise ValueError(f"{name}: {msg}")


def check_tensor(x: torch.Tensor, name: str, what: str, dtype: torch.dtype,
                 ndim: int, device: torch.device) -> None:
    check(x.dtype == dtype, name, f"{what} must be {dtype}, got {x.dtype}")
    check(x.dim() == ndim, name, f"{what} must have {ndim} dims, got "
          f"shape {tuple(x.shape)}")
    check(x.device == device, name, f"{what} on {x.device}, expected {device}")
    check(x.is_contiguous(), name, f"{what} must be contiguous")
