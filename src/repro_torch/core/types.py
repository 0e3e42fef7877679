"""Core datatypes of the port (reference: ``repro/core/types.py``).

A punctuation interval's transactions are a structure of arrays, one flat row
per decomposed operation.  The dtypes are the reference's at every public
surface: int32 uids and indices, float32 values, bool flags.  Where the
reference registers pytrees, the port writes dataclasses of tensors; every
field may carry leading batch dimensions (``[n_intervals, N]`` on the fused
driver), with the row axis last among the index dimensions.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..kernels.runtime import resolve_device


class OpKind(enum.IntEnum):
    """Atomic operation kinds (paper Table III)."""

    NOP = 0
    READ = 1
    WRITE = 2
    READ_MODIFY = 3


# ---------------------------------------------------------------------------
# Fun registry.  ``apply`` maps (pre [..., W], operand [..., W]) to
# (post [..., W], success bool[...]); ``affine_simple`` is (a, b_is_operand)
# for the identity / set / add shapes, which the engines expand from a LUT.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FunSpec:
    name: str
    apply: Callable[[torch.Tensor, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor]]
    affine: Optional[Callable[[torch.Tensor],
                              Tuple[torch.Tensor, torch.Tensor]]] = None
    is_max: bool = False
    affine_simple: Optional[Tuple[float, bool]] = None

    @property
    def associative(self) -> bool:
        return self.affine is not None or self.is_max


def _ok(pre: torch.Tensor) -> torch.Tensor:
    return torch.ones(pre.shape[:-1], dtype=torch.bool, device=pre.device)


def _f_nop(pre, operand):
    return pre, _ok(pre)


def _f_read(pre, operand):
    return pre, _ok(pre)


def _f_put(pre, operand):
    return operand, _ok(pre)


def _f_add(pre, operand):
    return pre + operand, _ok(pre)


def _f_max(pre, operand):
    return torch.maximum(pre, operand), _ok(pre)


def _f_take(pre, operand):
    """Bounded take on lane 0: succeed iff pre[0] >= operand[0] (SL debit)."""
    ok = pre[..., 0] >= operand[..., 0]
    return pre - torch.where(ok[..., None], operand,
                             torch.zeros_like(operand)), ok


def _identity(o):
    return torch.ones_like(o), torch.zeros_like(o)


F_NOP = FunSpec("nop", _f_nop, affine=_identity, affine_simple=(1.0, False))
F_READ = FunSpec("read", _f_read, affine=_identity, affine_simple=(1.0, False))
F_PUT = FunSpec("put", _f_put, affine=lambda o: (torch.zeros_like(o), o),
                affine_simple=(0.0, True))
F_ADD = FunSpec("add", _f_add, affine=lambda o: (torch.ones_like(o), o),
                affine_simple=(1.0, True))
F_MAX = FunSpec("max", _f_max, is_max=True)
F_TAKE = FunSpec("take", _f_take)  # conditional: lockstep path only

CORE_FUNS: Tuple[FunSpec, ...] = (F_NOP, F_READ, F_PUT, F_ADD, F_MAX, F_TAKE)
ASSOC_FUNS: Tuple[FunSpec, ...] = (F_NOP, F_READ, F_PUT, F_ADD, F_MAX)


def tree_index(obj, i):
    """``obj[i]`` through a dataclass of tensors; None stays None.

    Takes one interval out of the fused driver's ``[n_intervals, ...]``
    stacks (the slice a ``lax.scan`` body sees in the reference).
    """
    if obj is None:
        return obj
    if isinstance(obj, torch.Tensor):
        return obj[i]
    if isinstance(obj, tuple):
        return tuple(tree_index(x, i) for x in obj)
    return dataclasses.replace(obj, **{
        f.name: tree_index(getattr(obj, f.name), i)
        for f in dataclasses.fields(obj) if f.init})


# ---------------------------------------------------------------------------
# OpBatch — flattened decomposed operations of one punctuation interval.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class OpBatch:
    """SoA of N = batch * max_ops decomposed operations (fields ``[..., N]``).

    ``uid`` global state id, ``ts`` the transaction's timestamp, ``txn`` its
    index in the interval, ``slot`` the op's slot in it, ``fun`` an index into
    the app's fun tuple, ``gate`` the flat index of the mate op whose success
    gates this op (-1 when ungated), ``operand`` the [..., N, W] lanes and
    ``valid`` the padding mask.  Light sorted views leave ts/txn/slot/kind/
    gate as None.
    """

    uid: torch.Tensor                # i32[..., N]
    ts: Optional[torch.Tensor]       # i32[..., N]
    txn: Optional[torch.Tensor]      # i32[..., N]
    slot: Optional[torch.Tensor]     # i32[..., N]
    kind: Optional[torch.Tensor]     # i32[..., N]
    fun: torch.Tensor                # i32[..., N]
    gate: Optional[torch.Tensor]     # i32[..., N]
    operand: torch.Tensor            # f32[..., N, W]
    valid: torch.Tensor              # bool[..., N]

    @property
    def n_ops(self) -> int:
        return self.uid.shape[-1]

    @property
    def width(self) -> int:
        return self.operand.shape[-1]


@dataclasses.dataclass
class OpResults:
    """Per-op outcomes in the pre-sort (txn, slot) layout."""

    pre: torch.Tensor      # f32[..., B, max_ops, W]
    post: torch.Tensor     # f32[..., B, max_ops, W]
    success: torch.Tensor  # bool[..., B, max_ops]


@dataclasses.dataclass
class StateStore:
    """Fixed-capacity keyed tables concatenated into one ``values[S+1, W]``.

    Slot S is the padding chain.  Table t owns slots
    ``[table_base[t], table_base[t] + table_capacity[t])``; ``table_is_max``
    marks max-typed tables, ``slot_is_max`` optionally overrides per slot.
    The sharded driver's local store may stack one block per shard
    (``values`` ``[n_shards, S+1, W]``, ``slot_is_max`` ``[n_shards, S+1]``;
    ``ownership.make_local_store``).
    """

    values: torch.Tensor                   # f32[S+1, W]
    table_base: tuple = ()
    table_capacity: tuple = ()
    table_is_max: tuple = ()
    slot_is_max: Optional[torch.Tensor] = None  # bool[S+1]

    @property
    def n_slots(self) -> int:
        return self.values.shape[-2] - 1

    @property
    def pad_uid(self) -> int:
        return self.values.shape[-2] - 1

    @property
    def device(self) -> torch.device:
        return self.values.device

    def uid_of(self, table: int, key: torch.Tensor) -> torch.Tensor:
        return (self.table_base[table] + key).to(torch.int32)

    def uid_is_max(self) -> torch.Tensor:
        """bool[S+1]: whether each slot belongs to a max-type table."""
        if self.slot_is_max is not None:
            return self.slot_is_max
        flags = torch.zeros(self.values.shape[-2], dtype=torch.bool,
                            device=self.values.device)
        for t, (b, c) in enumerate(zip(self.table_base, self.table_capacity)):
            if self.table_is_max[t]:
                flags[b:b + c] = True
        return flags

    def to(self, device) -> "StateStore":
        sm = None if self.slot_is_max is None else self.slot_is_max.to(device)
        return dataclasses.replace(self, values=self.values.to(device),
                                   slot_is_max=sm)


def make_store(capacities: Sequence[int], width: int,
               is_max: Sequence[bool] | None = None,
               init: torch.Tensor | None = None, *,
               device=None) -> StateStore:
    """Build a StateStore with the given per-table capacities.

    ``device=None`` is the CUDA card (raises without one).
    """
    dev = resolve_device(device)
    caps = tuple(int(c) for c in capacities)
    bases, acc = [], 0
    for c in caps:
        bases.append(acc)
        acc += c
    if init is None:
        vals = torch.zeros((acc + 1, width), dtype=torch.float32, device=dev)
    else:
        vals = torch.as_tensor(init, dtype=torch.float32).to(dev)
    if tuple(vals.shape) != (acc + 1, width):
        raise ValueError(f"init shape {tuple(vals.shape)} != {(acc + 1, width)}")
    im = tuple(bool(x) for x in (is_max or [False] * len(caps)))
    return StateStore(values=vals, table_base=tuple(bases),
                      table_capacity=caps, table_is_max=im)
