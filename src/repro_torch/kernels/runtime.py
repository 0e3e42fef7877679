"""Device resolution, launch counters and launch checks shared by the kernels.

``resolve_device`` is the port's one device rule: ``None`` means the CUDA
card, and a missing card raises.  Only an explicit ``device="cpu"`` runs on
the CPU, where every kernel wrapper takes its plain-PyTorch twin.

``LAUNCHES`` counts kernel launches per kernel.  A wrapper adds one where
it launches its kernel on the card and nowhere else, so a run can show that
it went through the kernels (``chip_smoke.py`` reads it).

``costed`` is each wrapper's cost hook: while a program trace
(``launch/hlo_analysis.ProgramTrace``) records on the calling thread, the
wrapper's call counts once, at the bytes and operations of its kernel's
``cost()``, and none of the aten ops inside it (the twin's on the CPU, the
output allocations on the card) is recorded.  With no trace it adds nothing
but one thread-local read and a read of the dispatch mode stack's depth.

``span`` is the engine's hook into the service's tracer: a span of the
tracer the service binds to the calling thread, or the shared null span,
which reads no clock, where none is bound.
"""
from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Tuple, Union

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


# -- the program trace's hook -------------------------------------------------
_ACTIVE = threading.local()


def active_trace():
    """The program trace recording on this thread, or None.  A backward
    pass on a card runs on the autograd engine's thread of that card, which
    inherits the trace's dispatch mode but not this module's thread-local:
    there the trace is the innermost of the thread's dispatch modes that
    records a program (``records_program``)."""
    trace = getattr(_ACTIVE, "trace", None)
    if trace is not None or not torch._C._len_torch_dispatch_stack():
        return trace
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if getattr(mode, "records_program", False):
            return mode
    return None


def set_active_trace(trace) -> None:
    _ACTIVE.trace = trace


def costed(name: str, cost_fn: Callable[..., Tuple[float, float]]):
    """Decorate a kernel wrapper: under an active trace, record one call of
    kernel ``name`` at ``cost_fn(result, *args, **kwargs)`` (bytes,
    operations), computed after the call, and hide the call's own aten ops
    from the trace."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            trace = active_trace()
            if trace is None:
                return fn(*args, **kwargs)
            with trace.opaque():
                out = fn(*args, **kwargs)
                nbytes, n_ops = cost_fn(out, *args, **kwargs)
            trace.kernel(name, nbytes, n_ops)
            return out
        return wrapper
    return wrap


# -- the service tracer's hook ------------------------------------------------
class _NullSpan:
    """The span of no tracer: reads no clock, allocates nothing."""

    __slots__ = ()

    def set(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Spans(threading.local):
    """This thread's bound tracer (``runtime/telemetry.Tracer.bound``) and
    its innermost open span; the class attributes answer for a thread that
    set neither."""

    tracer = None
    open = None


SPANS = _Spans()


def span(name: str, **args):
    """A span of the tracer bound to this thread, or the shared null span:
    code under the service (the engine's pure functions) emits spans
    without a tracer passed through it."""
    tr = SPANS.tracer
    return NULL_SPAN if tr is None else tr.span(name, **args)
