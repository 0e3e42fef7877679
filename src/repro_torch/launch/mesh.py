"""Production and host meshes (reference: ``repro/launch/mesh.py``).

Single pod : (data=16, model=16)          — 256 devices
Multi pod  : (pod=2, data=16, model=16)   — 512 devices; the ``pod`` axis
extends data parallelism across pods.

The port runs no 256- or 512-device program: ``make_production_mesh``
returns a device-free ``MeshSpec`` that the sharding rules and the dry run
read (``launch/dryrun.py`` traces the step on it with shape-only tensors).
``make_host_mesh`` gives a real ``core.mesh.ShardMesh``, every shard on one
device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from ..core.mesh import ShardMesh


class MeshSpec:
    """A mesh as data: ``shape`` maps each axis name to its size, in mesh
    order (as a JAX mesh's ``shape`` does)."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = {str(a): int(n) for a, n in dict(shape).items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.size = math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshSpec({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec({"pod": 2, "data": 16, "model": 16})
    return MeshSpec({"data": 16, "model": 16})


def make_host_mesh(model: int = 1, data: int = 1, device=None) -> ShardMesh:
    """A ``(data, model)`` mesh of stacked shards on ``device`` (None: the
    CUDA card).  The reference spreads its mesh over the host's devices;
    the port's shards are a tensor axis on one device, so the caller sets
    both axis sizes."""
    return ShardMesh((data, model), ("data", "model"), device=device)


def dp_axes(mesh) -> tuple:
    """Mesh axes carrying (FSDP) data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
