"""EventBlotter and programming API (reference: ``repro/core/blotter.py``).

An operator is the three-step procedure (paper F1)::

    eb  = pre_process(events)         # compute mode
    state_access(blt, eb)             # records ops; postponed (D1)
    out = post_process(eb, results)   # compute mode, after txn processing

The reference records one event at a time under ``jax.vmap``.  The port's
bodies are batched instead: every event column is ``[B, ...]`` and each
``Blotter`` call records one op slot for all B events at once, so there is no
``vmap`` over per-event ``.at[]`` bodies.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .types import FunSpec, OpBatch, OpKind, StateStore


class Blotter:
    """Op recorder for a batch of ``batch`` events (one op slot per call)."""

    def __init__(self, store: StateStore, funs: Tuple[FunSpec, ...],
                 max_ops: int, width: int, batch: int):
        self._store = store
        self._fun_index = {f.name: i for i, f in enumerate(funs)}
        self.max_ops = max_ops
        self.width = width
        self.batch = batch
        self.device = store.device
        self.rows: list = []

    # -- system-provided APIs (Table III) ---------------------------------
    def read(self, table: int, key, valid=True) -> int:
        return self._record(OpKind.READ, table, key, "read",
                            self.zeros_lanes(), -1, valid)

    def write(self, table: int, key, value, fun="put", gate=-1,
              valid=True) -> int:
        return self._record(OpKind.WRITE, table, key, fun,
                            self._lanes(value), gate, valid)

    def read_modify(self, table: int, key, operand, fun, gate=-1,
                    valid=True) -> int:
        return self._record(OpKind.READ_MODIFY, table, key, fun,
                            self._lanes(operand), gate, valid)

    def fun_id(self, name: str) -> int:
        """Index of a fun by name — for per-event fun selection."""
        return self._fun_index[name]

    def zeros_lanes(self) -> torch.Tensor:
        return torch.zeros((self.batch, self.width), dtype=torch.float32,
                           device=self.device)

    # ----------------------------------------------------------------------
    def _column(self, x, dtype) -> torch.Tensor:
        """A per-event column ``[B]`` from a scalar or a ``[B]`` tensor."""
        x = torch.as_tensor(x, device=self.device).to(dtype)
        return x.expand(self.batch).contiguous() if x.dim() == 0 else x

    def _lanes(self, value) -> torch.Tensor:
        """[B, W] operand lanes; a per-event scalar lands in lane 0."""
        v = torch.as_tensor(value, device=self.device).to(torch.float32)
        if v.dim() <= 1:
            out = self.zeros_lanes()
            out[:, 0] = v
            return out
        if tuple(v.shape) != (self.batch, self.width):
            raise ValueError(f"operand shape {tuple(v.shape)} != "
                             f"{(self.batch, self.width)}")
        return v

    def _record(self, kind: OpKind, table: int, key, fun,
                operand: torch.Tensor, gate, valid) -> int:
        """fun may be a name or a per-event fun index; gate/valid may be
        per-event (data-dependent op mixes)."""
        slot = len(self.rows)
        if slot >= self.max_ops:
            raise ValueError(f"max_ops={self.max_ops} exceeded")
        if isinstance(gate, int) and gate >= slot:
            raise ValueError("a gated op's mate must occupy an earlier slot")
        fun_id = self._fun_index[fun] if isinstance(fun, str) else fun
        key = self._column(key, torch.int32)
        self.rows.append(dict(
            uid=self._store.uid_of(table, key),
            kind=self._column(int(kind), torch.int32),
            fun=self._column(fun_id, torch.int32),
            gate=self._column(gate, torch.int32),
            operand=operand,
            valid=self._column(valid, torch.bool),
        ))
        return slot

    def finalize(self) -> Dict[str, torch.Tensor]:
        """Pad to max_ops and stack into ``[B, max_ops, ...]`` op rows."""
        rows = list(self.rows)
        while len(rows) < self.max_ops:
            rows.append(dict(
                uid=self._column(self._store.pad_uid, torch.int32),
                kind=self._column(int(OpKind.NOP), torch.int32),
                fun=self._column(0, torch.int32),
                gate=self._column(-1, torch.int32),
                operand=self.zeros_lanes(),
                valid=self._column(False, torch.bool),
            ))
        return {k: torch.stack([r[k] for r in rows], dim=1)
                for k in ("uid", "kind", "fun", "gate", "operand", "valid")}


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """A concurrent stateful streaming application (paper §VI-A)."""

    name: str
    funs: Tuple[FunSpec, ...]
    max_ops: int
    width: int
    make_store: Callable[..., StateStore]
    gen_events: Callable[..., Dict[str, np.ndarray]]
    pre_process: Callable
    state_access: Callable
    post_process: Callable
    has_gates: bool = False
    may_abort: bool = False

    @property
    def associative_only(self) -> bool:
        return all(f.associative for f in self.funs) and not self.has_gates


def build_opbatch(app: AppSpec, store: StateStore,
                  events: Dict[str, torch.Tensor],
                  ts_base) -> Tuple[OpBatch, Dict]:
    """Compute mode: batched pre_process + op registration (D1 postponing).

    ``ts_base`` is an int or a tensor of shape ``lead``; every event column
    is ``[*lead, batch, ...]``.  One interval (``lead = ()``) is the host
    loop's call; ``lead = (n_intervals,)`` is the fused driver's, which the
    reference vmaps.  Returns the OpBatch with fields ``[*lead, batch *
    max_ops]`` and the per-event blotter payloads ``[*lead, batch, ...]``.
    """
    ts_base = torch.as_tensor(ts_base, dtype=torch.int32, device=store.device)
    lead = tuple(ts_base.shape)
    nl = len(lead)
    batch = next(iter(events.values())).shape[nl]
    n_events = int(np.prod(lead, dtype=np.int64)) * batch
    flat = {k: v.reshape((n_events,) + tuple(v.shape[nl + 1:]))
            for k, v in events.items()}

    eb = app.pre_process(flat)
    blt = Blotter(store, app.funs, app.max_ops, app.width, n_events)
    app.state_access(blt, eb)
    rows = blt.finalize()

    n = batch * app.max_ops
    txn = torch.arange(batch, dtype=torch.int32,
                       device=store.device).repeat_interleave(app.max_ops)
    slot = torch.arange(app.max_ops, dtype=torch.int32,
                        device=store.device).repeat(batch)
    txn = txn.expand(lead + (n,))
    ts = ts_base[..., None] + txn
    gate_rel = rows["gate"].reshape(lead + (n,))
    gate = torch.where(gate_rel >= 0, txn * app.max_ops + gate_rel,
                       torch.full_like(gate_rel, -1))
    ops = OpBatch(
        uid=rows["uid"].reshape(lead + (n,)),
        ts=ts, txn=txn.contiguous(), slot=slot.expand(lead + (n,)).contiguous(),
        kind=rows["kind"].reshape(lead + (n,)),
        fun=rows["fun"].reshape(lead + (n,)),
        gate=gate,
        operand=rows["operand"].reshape(lead + (n, app.width)),
        valid=rows["valid"].reshape(lead + (n,)),
    )
    ebs = {k: v.reshape(lead + (batch,) + tuple(v.shape[1:]))
           for k, v in eb.items()}
    return ops, ebs
