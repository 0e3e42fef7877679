"""Production and host meshes (reference: ``repro/launch/mesh.py``).

Single pod : (data=16, model=16)          — 256 devices
Multi pod  : (pod=2, data=16, model=16)   — 512 devices; the ``pod`` axis
extends data parallelism across pods.

The port runs no 256- or 512-device program: ``make_production_mesh``
returns a device-free ``MeshSpec`` that the sharding rules and the dry run
read (``launch/dryrun.py`` traces the step on it with shape-only tensors).
``make_host_mesh`` gives a real ``core.mesh.ShardMesh`` over the devices of
this process, as the reference's spreads over the host's devices: by
default its shards in device groups, one group a visible card
(``core/mesh.card_groups``); on one given device, one group.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core.mesh import ShardMesh, card_groups


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


def make_host_mesh(model: int = 1, data: int | None = None, device=None,
                   devices=None) -> ShardMesh:
    """A ``(data, model)`` mesh over this process's devices.  ``data=None``
    takes the reference's rule: ``n // model`` rows (at least one), n the
    devices (``devices``'s count, else the visible cards, one on a given
    device).  ``devices`` places the groups as given; else ``device=None``
    spreads the shards over the visible cards (``card_groups``: one group
    a card; no card raises), and a given device holds them all in one
    group."""
    if data is None:
        n = (len(devices) if devices is not None else
             torch.cuda.device_count() if device is None else 1)
        data = max(n // model, 1)
    if devices is None and device is None:
        devices = card_groups(data * model, None)
    return ShardMesh((data, model), ("data", "model"), device=device,
                     devices=devices)


def dp_axes(mesh) -> tuple:
    """Mesh axes carrying (FSDP) data parallelism."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
