"""Kernel dispatch from the device: threads per block by a candidate search
(reference: ``repro/kernels/autotune.py``).

Every CUDA kernel of the port (``segscan_affine``, ``segscan_max``,
``radix_partition``, ``hash_probe`` and the ``megakernel``) takes one
tunable parameter, its threads per block.  The block size changes no bit
of any result: it only decides how many threads share a fixed division of
the work (``csrc/segscan.cu``, ``csrc/radix_partition.cu``,
``csrc/hash_probe.cu``).  This module chooses it per device:

1. **Candidates** -- ``candidates(kernel, profile)`` lists legal block
   sizes (multiples of the warp in [32, min(1024, max threads per block)])
   from ``device_profile``.  The FIRST entry is the default: the block
   size the wrapper launched with before the search existed, so a decision
   without a search reproduces those launches exactly.
2. **Microbenchmark on first use** -- ``decide()`` times the candidates
   (every candidate warmed, then the min of k interleaved runs, with CUDA
   events on the tensor's current stream) the first time a ``(kernel,
   shape_bucket, dtype, device_kind)`` key is seen on a CUDA tensor.  A CPU
   tensor never reaches the search (its wrapper takes the plain twin), and
   a call with no bench takes the default, recorded as ``source="default"``
   (the reference's "interpret-default").
3. **Caching** -- winners live in an in-process dict keyed by ``(kernel,
   shape_bucket, dtype, device_kind)``, under one process-wide lock (the
   streaming service launches from its executor thread); set
   ``REPRO_AUTOTUNE_CACHE=/path.json`` to round-trip them through a JSON
   file in the reference's schema (loaded lazily, written after every new
   decision).  The same key never benches twice in one process, nor across
   processes that share the file.
4. **Logging** -- every decision is logged once per process and key, and
   appended to ``REPRO_AUTOTUNE_LOG`` as a JSON line when that is set.  The
   two variables choose where decisions are stored, never which code runs.
5. **Forcing** -- ``force=<int>`` (from ``EngineConfig.kernel_block_params``
   through a wrapper's ``threads``) bypasses candidates, bench and cache;
   the wrappers do not call the search at all then.

A shape bucket covers a 2x range of row counts.  Where one bucket would
cover calls that take different paths through a kernel, the wrapper puts
what selects the path into the bucket string (``shape_bucket(n, variant)``):
the lane width for the segscans, the path and the batch rows for
radix_partition, staged or not for hash_probe.  The bench times the call's
own arguments through the library entry, not the wrapper, so it adds
nothing to ``kernels/runtime.LAUNCHES`` and records nothing in a program
trace; the first call of each key pays for it (``bench_seconds()``).

The module also holds the **device tables** of the restructure ladder:
``LADDER_BOUNDS`` (the counting-partition bounds of the "auto" rung,
``core/restructure.partition_fits``) and ``MEGA_BOUNDS`` (the megakernel's
auto band, ``core/restructure.megakernel_engaged``), keyed by device kind.
Only the reference's measured "cpu" row is here, and every other kind (an
H100's ``"nvidia h100 80gb hbm3"`` included) falls through to it, so the
card resolves the same rungs as the CPU; on the card the megakernel rung
also needs each interval to fit its block's shared memory
(``core/restructure.megakernel_fits``), which the band's intervals never
do.  A measured Hopper row waits for the benchmark.

    python -m repro_torch.kernels.autotune --dump [PATH] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import os
import threading
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .runtime import (KERNELS, active_trace, resolve_device,  # noqa: F401
                      set_active_trace, smem_optin)

log = logging.getLogger(__name__)

Device = Union[str, torch.device, None]

# ---------------------------------------------------------------------------
# Device tables: measured win bands -> dispatch bounds
# ---------------------------------------------------------------------------
# (max_buckets, min_rows): "auto" takes the partition rung when the key space
# is at most max_buckets and the batch at least min_rows.  The reference's
# measured host crossover (its BENCH_restructure.json).
LADDER_BOUNDS: Dict[str, Tuple[int, int]] = {
    "cpu": (16, 1 << 18),
}

# The megakernel's auto band: at least min_rows rows per interval and at most
# max_buckets slots (pad included); the reference's "cpu" row.
MEGA_BOUNDS: Dict[str, Dict] = {
    "cpu": dict(min_rows=1 << 15, max_buckets=1 << 14),
}


@functools.lru_cache(maxsize=None)
def _cuda_name(index: int) -> str:
    return torch.cuda.get_device_name(index)


def kind_of(device: Device = None) -> str:
    """The device kind of ``device``: a CUDA card's name in lower case, else
    "cpu" (the tables' fallback row); ``None`` is the port's default
    device, the card."""
    dev = resolve_device(None) if device is None else torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        return _canon_kind(_cuda_name(index))
    return "cpu"


def _canon_kind(device_kind: Device) -> str:
    if device_kind is None or isinstance(device_kind, torch.device):
        return kind_of(device_kind)
    return str(device_kind).strip().lower()


def _table_row(table: Dict[str, object], kind: str):
    if kind in table:
        return table[kind]
    # prefix match: a row "nvidia h100" would cover every H100 variant's name
    for k, v in table.items():
        if k != "cpu" and kind.startswith(k):
            return v
    return table["cpu"]


def ladder_bounds(device_kind: Device = None) -> Tuple[int, int]:
    """(max_buckets, min_rows) for the counting-partition auto rung."""
    return _table_row(LADDER_BOUNDS, _canon_kind(device_kind))


def mega_bounds(device_kind: Device = None) -> Dict:
    """Auto win band of the fused megakernel rung."""
    return _table_row(MEGA_BOUNDS, _canon_kind(device_kind))


# ---------------------------------------------------------------------------
# Device profile + candidate derivation
# ---------------------------------------------------------------------------
# The fixed profile of the CPU, whose wrappers take the plain twins: no SMs,
# no L2 or shared memory to read, and the block limits every CUDA card this
# port builds for (sm_90a) has.
CPU_PROFILE = dict(kind="cpu", platform="cpu", name="cpu", sms=None,
                   max_threads_per_block=1024, warp_size=32, l2_bytes=None,
                   smem_optin=None)


def device_profile(device: Device = None) -> Dict:
    """Hardware profile of one device: on a CUDA card, from
    ``torch.cuda.get_device_properties`` (name, SM count, max threads per
    block, warp size, L2 bytes) and ``runtime.smem_optin``; on the CPU, the
    fixed ``CPU_PROFILE`` (it touches no CUDA)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dict(CPU_PROFILE)
    return dict(_cuda_profile(dev.index if dev.index is not None
                              else torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _cuda_profile(index: int) -> Dict:
    dev = torch.device("cuda", index)
    props = torch.cuda.get_device_properties(dev)
    return dict(kind=kind_of(dev), platform="gpu", name=props.name,
                sms=int(props.multi_processor_count),
                max_threads_per_block=int(getattr(
                    props, "max_threads_per_block", 1024)),
                warp_size=int(getattr(props, "warp_size", 32)),
                l2_bytes=getattr(props, "L2_cache_size", None),
                smem_optin=smem_optin(dev))


# the bracket around each default: a 4x range of block sizes either way
BRACKET = (128, 256, 512, 1024)


def default_param(kernel: str, n: Optional[int] = None, *,
                  staged: bool = True) -> int:
    """The block size a wrapper launches with when nothing is searched:
    256 for the segscans, ``default_threads(n)`` for radix_partition (``n``
    keys a row), 1,024 for hash_probe where its table is staged in shared
    memory and 256 where it is not, 512 for the megakernel."""
    if kernel in ("segscan_affine", "segscan_max"):
        return 256
    if kernel == "radix_partition":
        if n is None:
            raise ValueError("radix_partition's default depends on the row "
                             "length: pass n")
        from .radix_partition.ops import default_threads
        return default_threads(int(n))
    if kernel == "hash_probe":
        return 1024 if staged else 256
    if kernel == "megakernel":
        return 512
    raise ValueError(f"unknown kernel {kernel!r}")


def candidates(kernel: str, profile: Optional[Dict] = None, *,
               n: Optional[int] = None, staged: bool = True
               ) -> Tuple[int, ...]:
    """Short candidate list of the kernel's threads per block.

    The FIRST entry is the default (``default_param``); the rest bracket it
    (``BRACKET``), deduplicated, each a multiple of the warp in [warp,
    min(1024, max threads per block)] of ``profile`` (``CPU_PROFILE`` when
    None: the same limits as the card's).
    """
    p = profile or CPU_PROFILE
    warp = int(p["warp_size"])
    top = min(1024, int(p["max_threads_per_block"]))
    first = default_param(kernel, n, staged=staged)
    out = []
    for c in (first,) + BRACKET:
        if c % warp == 0 and warp <= c <= top and c not in out:
            out.append(c)
    return tuple(out or (first,))


def shape_bucket(n: int, variant: str = "") -> str:
    """Power-of-two shape bucket: one tuning decision covers a 2x range of
    row counts (keying raw N would re-bench every distinct shape).
    ``variant`` names what else selects the kernel's path."""
    b = max(int(n) - 1, 1).bit_length()
    return f"2^{b}" + (f"/{variant}" if variant else "")


# ---------------------------------------------------------------------------
# The decision cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Decision:
    kernel: str
    shape_bucket: str
    dtype: str
    device_kind: str
    param: int
    source: str            # default | microbench | forced | disk
    candidates: Tuple[int, ...] = ()
    timings_us: Optional[Dict[str, float]] = None

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.kernel, self.shape_bucket, self.dtype, self.device_kind)


_LOCK = threading.RLock()
_CACHE: Dict[Tuple[str, str, str, str], Decision] = {}
_LOGGED: set = set()
_DISK_LOADED: set = set()  # cache paths already read this process
_BENCH_S = [0.0]           # seconds spent in microbenchmarks this process

_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
_LOG_ENV = "REPRO_AUTOTUNE_LOG"


def clear_cache() -> None:
    """Test hook: forget all in-process decisions (disk cache untouched)."""
    with _LOCK:
        _CACHE.clear()
        _LOGGED.clear()
        _DISK_LOADED.clear()
        _BENCH_S[0] = 0.0


def bench_seconds() -> float:
    """Seconds this process has spent timing candidates."""
    return _BENCH_S[0]


def _record(d: Decision) -> None:
    _CACHE[d.key] = d
    if d.key not in _LOGGED:
        _LOGGED.add(d.key)
        log.info("autotune: %s[%s,%s,%s] -> %d (%s)", d.kernel,
                 d.shape_bucket, d.dtype, d.device_kind, d.param, d.source)
        logp = os.environ.get(_LOG_ENV, "")
        if logp:
            try:
                with open(logp, "a") as f:
                    f.write(json.dumps(dataclasses.asdict(d)) + "\n")
            except OSError as e:  # artifact logging must never break dispatch
                log.warning("autotune: cannot append to %s: %s", logp, e)


def _disk_path(cache_path: Optional[str]) -> Optional[str]:
    return cache_path or os.environ.get(_CACHE_ENV) or None


def _load_disk(path: str) -> None:
    if path in _DISK_LOADED:
        return
    _DISK_LOADED.add(path)
    if not os.path.exists(path):
        return
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        log.warning("autotune: ignoring unreadable cache %s: %s", path, e)
        return
    if not isinstance(raw, dict):
        log.warning("autotune: ignoring cache %s: not a JSON object", path)
        return
    for rec in raw.get("decisions", []):
        try:
            d = Decision(kernel=rec["kernel"],
                         shape_bucket=rec["shape_bucket"],
                         dtype=rec["dtype"],
                         device_kind=rec["device_kind"],
                         param=int(rec["param"]), source="disk",
                         candidates=tuple(rec.get("candidates", ())))
        except (KeyError, TypeError, ValueError):
            continue  # skip malformed rows, keep the rest
        if d.key not in _CACHE:  # in-process decisions win over disk
            _CACHE[d.key] = d
    log.debug("autotune: loaded %d decisions from %s", len(raw.get(
        "decisions", [])), path)


def _save_disk(path: str) -> None:
    try:
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(dict(decisions=[dataclasses.asdict(d)
                                      for d in _CACHE.values()]), f, indent=2)
        os.replace(tmp, path)
    except OSError as e:
        log.warning("autotune: cannot write cache %s: %s", path, e)


def decisions_log() -> list:
    """All decisions made (or loaded) this process, as plain dicts."""
    with _LOCK:
        return [dataclasses.asdict(d) for d in _CACHE.values()]


# ---------------------------------------------------------------------------
# decide / kernel-facing lookups
# ---------------------------------------------------------------------------
def _microbench(cands: Tuple[int, ...],
                bench_fn: Callable[[int], float],
                iters: int = 3) -> Tuple[int, Dict[str, float]]:
    """Min-of-k interleaved timing of the candidate list.  ``bench_fn``
    runs one launch with the given parameter and returns its seconds (it
    must wait for the launch to finish)."""
    for c in cands:          # warm every candidate before timing any
        bench_fn(c)
    best: Dict[int, float] = {c: float("inf") for c in cands}
    for _ in range(iters):
        for c in cands:
            best[c] = min(best[c], bench_fn(c))
    winner = min(cands, key=lambda c: best[c])
    return winner, {str(c): best[c] * 1e6 for c in cands}


def decide(kernel: str, n: int, *, dtype: str = "float32",
           device_kind: Device = None,
           force: Optional[int] = None,
           bench_fn: Optional[Callable[[int], float]] = None,
           cache_path: Optional[str] = None,
           variant: str = "",
           profile: Optional[Dict] = None,
           staged: bool = True) -> Decision:
    """Resolve the kernel's threads per block for an ``n``-row launch.

    Resolution order: ``force`` (no cache interaction, logged once) ->
    in-process cache -> on-disk cache -> microbenchmark (with a
    ``bench_fn``: a CUDA call) or the deterministic default candidate (no
    bench).  ``variant`` joins the shape bucket (``shape_bucket``); the
    candidates are ``candidates(kernel, profile, n=n, staged=staged)``.
    """
    kind = _canon_kind(device_kind)
    bucket = shape_bucket(n, variant)
    if force is not None:
        d = Decision(kernel=kernel, shape_bucket=bucket, dtype=dtype,
                     device_kind=kind, param=int(force), source="forced")
        with _LOCK:
            if d.key + ("forced",) not in _LOGGED:
                _LOGGED.add(d.key + ("forced",))
                log.info("autotune: %s[%s,%s,%s] -> %d (forced)", kernel,
                         bucket, dtype, kind, int(force))
        return d

    key = (kernel, bucket, dtype, kind)
    with _LOCK:
        path = _disk_path(cache_path)
        if key not in _CACHE and path:
            _load_disk(path)
        if key in _CACHE:
            return _CACHE[key]

        cands = candidates(kernel, profile, n=n, staged=staged)
        if bench_fn is None:
            d = Decision(kernel=kernel, shape_bucket=bucket, dtype=dtype,
                         device_kind=kind, param=cands[0], source="default",
                         candidates=cands)
        else:
            winner, timings = _microbench(cands, bench_fn)
            d = Decision(kernel=kernel, shape_bucket=bucket, dtype=dtype,
                         device_kind=kind, param=winner, source="microbench",
                         candidates=cands, timings_us=timings)
        _record(d)
        if path:
            _save_disk(path)
        return d


def _default_bench(launch: Optional[Callable[[int], None]],
                   device: Device) -> Optional[Callable[[int], float]]:
    """Timing thunk of one CUDA call: ``launch(threads)`` enqueues the
    kernel once, through its library entry, on the call's own arguments.
    It runs between two CUDA events on the device's current stream and
    with the thread's program trace cleared, so it records nothing there
    and counts no launch.  None without a launch or off the card (decide()
    then takes the default)."""
    if launch is None or device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda":
        return None

    def bench(c: int) -> float:
        stream = torch.cuda.current_stream(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        trace = active_trace()
        set_active_trace(None)
        try:
            start.record(stream)
            launch(c)
            end.record(stream)
            end.synchronize()
        finally:
            set_active_trace(trace)
        s = start.elapsed_time(end) / 1e3
        _BENCH_S[0] += s
        return s
    return bench


def block_rows(kernel: str, n: int, *, force: Optional[int] = None,
               dtype: str = "float32", device: Device = None,
               variant: str = "", staged: bool = True,
               launch: Optional[Callable[[int], None]] = None) -> int:
    """The kernel-facing lookup: the threads per block of an ``n``-row
    launch on ``device`` (the reference's name, whose parameter there was
    rows per grid step).  The wrappers call it on a CUDA tensor when no
    ``threads`` is given, with ``launch`` the call's own kernel launch for
    the bench; the candidates are those of ``device_profile(device)``."""
    return decide(kernel, n, dtype=dtype, device_kind=kind_of(device),
                  force=force, bench_fn=_default_bench(launch, device),
                  variant=variant, profile=device_profile(device),
                  staged=staged).param


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(
        description="dump autotune decisions / device tables")
    ap.add_argument("--dump", nargs="?", const="", default="",
                    help="also write the decisions JSON to this path")
    ap.add_argument("--device", default=None,
                    help="'cpu' reads the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    path = _disk_path(None)
    if path:
        with _LOCK:
            _load_disk(path)
    kind = kind_of(dev)
    out = dict(profile=device_profile(dev), decisions=decisions_log(),
               ladder_bounds=ladder_bounds(kind), mega_bounds=mega_bounds(kind),
               bench_seconds=bench_seconds())
    text = json.dumps(out, indent=2)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(text)
    print(text)
    return out


if __name__ == "__main__":  # pragma: no cover
    main()
