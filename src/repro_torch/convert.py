"""Carry state and event streams across from the reference's form.

The system's counterpart of weights is its state: a store's tables.  These
helpers build the port's ``StateStore`` from a store's fields given as numpy
arrays (for example a JAX store's ``np.asarray(store.values)`` and its
static table fields), take one back to numpy, and move a numpy event stream
onto a device with its dtypes kept (int32 keys, float32 values, bool flags).
``probe_table_from_halves`` turns the reference's hash-probe table into the
port's, so that both packages can probe the same table.

For the model layer, weights are the same nested dicts on both sides:
``params_to_torch`` moves a tree of numpy arrays (a JAX tree through
``np.asarray``: params, KV/SSM caches or AdamW state) onto a device leaf by
leaf, and ``params_to_numpy`` brings one back.  ``opt_state_to_torch``
carries an AdamW state (``m``, ``v``, ``step``), so that a train step of
both packages starts from the same state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .ckpt.checkpoint import _flatten, _unflatten
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


def _leaf_to_torch(x, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16: take the bits (JAX's ml_dtypes array) as
        # int16 and view them as torch's bfloat16
        bits = np.array(arr).view(np.int16)
        return torch.from_numpy(bits).to(dev).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(dev)


def params_to_torch(tree: Any, device) -> Any:
    """A nested dict (or list/tuple) of numpy arrays as the same tree of
    tensors on ``device`` (None: the CUDA card), dtypes kept: bf16 stays
    bf16, int32 stays int32."""
    dev = resolve_device(device)
    return _unflatten(tree, iter(_leaf_to_torch(x, dev)
                                 for _, x in _flatten(tree)))


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors as the same tree of numpy arrays on the host.
    numpy has no bfloat16, so a bf16 leaf comes back as float32 holding the
    same values (exact)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _unflatten(tree, iter(leaf(x) for _, x in _flatten(tree)))


def opt_state_to_torch(state: Any, device) -> Dict[str, Any]:
    """An AdamW state of numpy arrays (``m`` and ``v`` mirroring the params,
    ``step`` a 0-d int32) as the port's ``adamw_init`` tree on ``device``
    (None: the CUDA card), dtypes kept (a bf16 state stays bf16)."""
    if set(state) != {"m", "v", "step"}:
        raise ValueError(f"an AdamW state has m, v and step, not "
                         f"{sorted(state)}")
    dev = resolve_device(device)
    return dict(m=params_to_torch(state["m"], dev),
                v=params_to_torch(state["v"], dev),
                step=_leaf_to_torch(state["step"], dev).to(torch.int32))
