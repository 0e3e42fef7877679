"""TStream on PyTorch: the port of the JAX/Pallas reproduction to CUDA.

The package keeps the reference's module layout (``core``, ``apps``,
``kernels``) and its dtypes at every public surface.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``; there is no
fallback that hides a missing card (``kernels.runtime.resolve_device``).
"""
from .kernels.runtime import LAUNCHES, reset_launches, resolve_device

__all__ = ["LAUNCHES", "reset_launches", "resolve_device"]
