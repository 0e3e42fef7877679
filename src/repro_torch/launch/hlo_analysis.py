"""Cost of a program from a recorded trace of its execution (reference:
``repro/launch/hlo_analysis.py``, which parses compiled XLA HLO).

Eager PyTorch has no compiled program text, so the port analyses a
**recorded trace of the executed program** instead.  ``ProgramTrace`` is a
``TorchDispatchMode``: while it is active on a thread, every aten op that
thread runs is recorded, and so is every hand-written kernel call (each
wrapper's cost hook, ``kernels/runtime.costed``) and every ``ShardMesh``
collective (``core/mesh.py``).  From the records ``analyze`` gives the
reference's keys:

* ``dot_flops``: 2·M·N·K for each ``mm``, ``bmm``, ``addmm`` and
  ``baddbmm`` (what ``torch.einsum``, ``@`` and ``F.linear`` lower to),
  plus each kernel call's operations (its ``cost()``, the count its bound
  reads);
* ``bytes_written``: the bytes of every op's outputs (views write nothing;
  an allocation without a fill writes nothing; a copy between the host and
  the card is a transfer, outside the program), each kernel call's
  ``cost()`` bytes (its inputs read once and outputs written once) and each
  collective's result;
* ``coll_bytes``: by collective kind, one shard's result bytes, as the
  reference's per-device HLO shows them;
* ``wire_bytes_per_device``: the reference's ring formulas
  (``repro/launch/dryrun.py`` ``parse_collectives``) over each
  collective's group of g shards: all-reduce 2·b·(g-1)/g, all-gather and
  all-to-all b·(g-1)/g.  A group of one shard moves nothing and is not
  recorded.

The trace also counts the program's **live bytes** (``live_bytes``, and
their most, ``peak_bytes``), the counterpart of the peak XLA's buffer
assignment gives (``compiled.memory_analysis()``): the summed ``nbytes`` of
the distinct storages alive while it records.  A storage counts once
however many views it has; it enters the count when an op's output first
shows it (a view's or an in-place op's output, which aliases an input,
adds nothing) or when ``hold`` is given the inputs it lies under, and
leaves it when it is freed (its weakref callback).  Storages allocated
inside ``opaque()`` count too: a collective's result and a kernel
wrapper's outputs are buffers the program holds.  So the count is eager
PyTorch's footprint of the traced program, every op's output its own
buffer, freed when the program drops its last reference: what a card's
allocator holds for it, short of an op's internal workspace (cuBLAS's),
which no aten op shows.

A kernel call counts once at its ``cost()``; the aten ops inside it (its
plain twin on the CPU, its output allocations on the card) are not
recorded, so the CPU and the card count the same for the same call.  Eager
execution has no while loops, so the reference's trip-count weighting is
implicit: a loop's body is recorded once per trip.  FLOPs and bytes are of
the whole program as it ran (over every shard of a stacked mesh; on the
one-shard form of a mesh, ``ShardMesh.one_shard``, shard 0's program, one
device's); keys ending in ``_per_device`` divide them by ``n_devices``.

A recording failure never breaks the traced program: it is kept in
``ProgramTrace.error`` and ``analyze`` raises it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import weakref
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..kernels.runtime import active_trace, set_active_trace

aten = torch.ops.aten

# (op, a-index, b-index): the two matmul operands of each op counted
_DOTS = {aten.mm.default: (0, 1), aten.bmm.default: (0, 1),
         aten.addmm.default: (1, 2), aten.baddbmm.default: (1, 2)}
# ops whose output is allocated but not written
_NO_WRITE = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}


def _dot_flops(func, args) -> float:
    ia, ib = _DOTS[func]
    a, b = args[ia], args[ib]
    # [.., M, K] @ [.., K, N]: 2 * batch * M * N * K
    return 2.0 * a.numel() * b.shape[-1]


def _out_bytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


def _is_transfer(func, args, out) -> bool:
    """A copy between devices (host <-> card): a transfer, not a write of
    the program (as in the reference, where it is outside the HLO)."""
    if func is aten._to_copy.default:
        return args[0].device != out.device
    if func is aten.copy_.default:
        return args[0].device != args[1].device
    return False


@functools.cache
def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


@functools.cache
def _aliases(func) -> bool:
    """Whether an op's outputs alias its inputs (a view or an in-place
    op): they show no new storage."""
    return any(r.alias_info is not None for r in func._schema.returns)


@dataclasses.dataclass
class OpRecord:
    name: str
    bytes_written: float
    flops: float


class ProgramTrace(TorchDispatchMode):
    """Records the program run on this thread while active (``with
    ProgramTrace() as trace: ...``): ``ops`` (aten ops, kernel calls as
    ``kernel:<name>``, collectives as their kind), ``kernels`` [(name,
    bytes, operations)] and ``collectives`` [(kind, one shard's result
    bytes, group size)]; ``live_bytes`` and ``peak_bytes`` (module
    docstring), the inputs counted through ``hold``.  A backward pass run
    on another thread (the autograd engine's thread of a card) is recorded
    too: that thread inherits the mode (``kernels/runtime.active_trace``),
    and a lock guards the count."""

    records_program = True

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.kernels: List[Tuple[str, float, float]] = []
        self.collectives: List[Tuple[str, float, int]] = []
        self.error = None
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = {}               # id -> (weakref, nbytes)
        self._lock = threading.RLock()    # a free may come mid-registration
        self._opaque = threading.local()  # per thread: the depth
        self._outer = None

    def __enter__(self):
        self._outer = active_trace()
        set_active_trace(self)
        return super().__enter__()

    def __exit__(self, *exc):
        set_active_trace(self._outer)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        try:
            if not _aliases(func):
                self._hold(out)
            if not getattr(self._opaque, "depth", 0):
                self._record(func, args, out)
        except Exception as e:           # never break the traced program
            self.error = self.error or e
        return out

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (the inputs a step is
        called on) as live; the live bytes after."""
        self._hold(tree)
        return self.live_bytes

    def _hold(self, out) -> None:
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t.untyped_storage())

    def _add(self, s) -> None:
        key, n = id(s), s.nbytes()
        with self._lock:
            if key in self._storages:
                return
            self._storages[key] = (weakref.ref(
                s, lambda _, key=key, n=n: self._free(key, n)), n)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key, n) -> None:
        with self._lock:
            self._storages.pop(key, None)
            self.live_bytes -= n

    def _record(self, func, args, out) -> None:
        if _is_view(func) or _is_transfer(func, args, out):
            return
        flops = _dot_flops(func, args) if func in _DOTS else 0.0
        written = 0 if func in _NO_WRITE else _out_bytes(out)
        self.ops.append(OpRecord(str(func.overloadpacket.__name__),
                                 float(written), flops))

    @contextlib.contextmanager
    def opaque(self):
        """Record none of the aten ops this thread runs inside (a kernel
        call or a collective is recorded as itself)."""
        depth = getattr(self._opaque, "depth", 0)
        self._opaque.depth = depth + 1
        try:
            yield
        finally:
            self._opaque.depth = depth

    def kernel(self, name: str, nbytes: float, n_ops: float) -> None:
        self.kernels.append((name, float(nbytes), float(n_ops)))
        self.ops.append(OpRecord(f"kernel:{name}", float(nbytes),
                                 float(n_ops)))

    def collective(self, kind: str, outs: Sequence[torch.Tensor],
                   n_shards: int, group: int) -> None:
        """One collective, by its result: a stacked tensor per device
        group of the mesh (``core/mesh.py``), every shard's together."""
        if group < 2:
            return
        total = sum(o.numel() * o.element_size() for o in outs)
        self.collectives.append((kind, total / n_shards, group))
        self.ops.append(OpRecord(kind, float(total), 0.0))


def _wire(kind: str, b: float, g: int) -> float:
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2 * b * frac
    if kind in ("all-gather", "all-to-all"):
        return b * frac
    if kind == "reduce-scatter":          # b: one shard's block of the sum
        return b * (g - 1)
    raise ValueError(f"unknown collective {kind!r}")


def analyze(trace: ProgramTrace, n_devices: int = 1) -> Dict:
    """The reference's ``analyze_hlo`` keys from a recorded trace, plus
    per-device figures and the kernel calls by name."""
    if trace.error is not None:
        raise RuntimeError("the program trace failed to record") \
            from trace.error
    flops = sum(r.flops for r in trace.ops)
    written = sum(r.bytes_written for r in trace.ops)
    coll: Dict[str, float] = defaultdict(float)
    wire = 0.0
    for kind, b, g in trace.collectives:
        coll[kind] += b
        wire += _wire(kind, b, g)
    kernels: Dict[str, Dict[str, float]] = {}
    for name, nbytes, n_ops in trace.kernels:
        k = kernels.setdefault(name, dict(calls=0, bytes=0.0, ops=0.0))
        k["calls"] += 1
        k["bytes"] += nbytes
        k["ops"] += n_ops
    n = max(int(n_devices), 1)
    return dict(dot_flops=flops, bytes_written=written, coll_bytes=dict(coll),
                wire_bytes_per_device=wire, dot_flops_per_device=flops / n,
                bytes_written_per_device=written / n, kernels=kernels)


def breakdown(trace: ProgramTrace, top: int = 15):
    """Top contributors to ``bytes_written``, summed by op: ``[(bytes,
    op, calls, flops)]``, largest first (the reference's profiling view:
    what to optimize next)."""
    rows: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0, 0.0])
    for r in trace.ops:
        row = rows[r.name]
        row[0] += r.bytes_written
        row[1] += 1
        row[2] += r.flops
    out = [(b, name, int(calls), f) for name, (b, calls, f) in rows.items()]
    out.sort(key=lambda x: (-x[0], x[1]))
    return out[:top]
