"""Carry state and event streams across from the reference's form.

The system's counterpart of weights is its state: a store's tables.  These
helpers build the port's ``StateStore`` from a store's fields given as numpy
arrays (for example a JAX store's ``np.asarray(store.values)`` and its
static table fields), take one back to numpy, and move a numpy event stream
onto a device with its dtypes kept (int32 keys, float32 values, bool flags).
``probe_table_from_halves`` turns the reference's hash-probe table into the
port's, so that both packages can probe the same table.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.types import StateStore
from .kernels.runtime import resolve_device


def store_from_numpy(values: np.ndarray, table_base: Sequence[int],
                     table_capacity: Sequence[int],
                     table_is_max: Sequence[bool],
                     slot_is_max: Optional[np.ndarray] = None, *,
                     device) -> StateStore:
    """The port's StateStore from a store's fields; ``device=None`` is the
    CUDA card."""
    dev = resolve_device(device)
    vals = torch.from_numpy(np.array(values, dtype=np.float32)).to(dev)
    sm = (None if slot_is_max is None else
          torch.from_numpy(np.array(slot_is_max, dtype=bool)).to(dev))
    return StateStore(values=vals,
                      table_base=tuple(int(b) for b in table_base),
                      table_capacity=tuple(int(c) for c in table_capacity),
                      table_is_max=tuple(bool(m) for m in table_is_max),
                      slot_is_max=sm)


def store_to_numpy(store: StateStore) -> Dict:
    """A store's fields as numpy arrays and tuples (``store_from_numpy``'s
    arguments)."""
    return dict(
        values=store.values.detach().cpu().numpy(),
        table_base=tuple(store.table_base),
        table_capacity=tuple(store.table_capacity),
        table_is_max=tuple(store.table_is_max),
        slot_is_max=(None if store.slot_is_max is None
                     else store.slot_is_max.cpu().numpy()))


def events_to_torch(stream: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A numpy event stream as tensors on ``device`` with the same dtypes."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in stream.items()}


def probe_table_from_halves(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The reference's hash-probe table, two float32 tables of exact 16-bit
    key halves, as the port's int32 key table (empty halves ``0xFFFF`` ->
    -1)."""
    lo = np.asarray(lo).astype(np.int64)
    hi = np.asarray(hi).astype(np.int64)
    return ((hi << 16) | lo).astype(np.uint32).view(np.int32)
