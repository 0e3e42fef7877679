"""Dynamic restructuring (paper §IV-C1): transactions -> operation chains.

Reference: ``repro/core/restructure.py``.  A stable grouping by (state uid,
ts, slot) makes every chain a contiguous, timestamp-ordered segment.  The
backbone is the reference's ladder, resolved by ``restructure_path``: the
one-pass counting partition (``kernels/radix_partition``), else the packed
single-operand sort, else the three-key lexsort.  Every rung gives the same
output bit for bit.

Every function here works on any leading batch dimensions (row axis last),
so one call restructures a whole ``[n_intervals, N]`` stream: what the
reference vmaps is written out as a batch dimension.  Index columns stay
int32; torch's gathers and scatters get int64 copies at the call site.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from ..kernels import autotune
from ..kernels.megakernel.ops import megakernel_smem_bytes
from ..kernels.radix_partition.ops import radix_partition_rank
from ..kernels.radix_partition.ref import radix_partition_rank_ref
from .types import OpBatch

log = logging.getLogger(__name__)

# the reference's module constants: the bounds of the "cpu" row
PARTITION_MAX_BUCKETS, PARTITION_MIN_ROWS = autotune.ladder_bounds("cpu")

I32 = torch.int32


def take_along(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, *rest]`` per batch row: x ``[*lead, N, *rest]``, idx
    ``[*lead, M]`` -> ``[*lead, M, *rest]`` (indices must lie in range)."""
    nl = idx.dim() - 1
    rest = tuple(x.shape[nl + 1:])
    i = idx.long().reshape(tuple(idx.shape) + (1,) * len(rest))
    return torch.gather(x, nl, i.expand(tuple(idx.shape) + rest))


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


@dataclasses.dataclass
class Chains:
    """Operation chains over a sorted view of an OpBatch (fields ``[..., N]``).

    ``order`` sorted index -> original flat op index; ``inv`` its inverse;
    ``seg_start`` / ``seg_end`` the first / last op of each chain;
    ``seg_id`` chain id of each sorted op; ``pos`` position inside its
    chain; ``n_chains`` / ``max_len`` per batch; ``counts`` / ``starts`` the
    per-uid histogram and its exclusive prefix (partition rung only).
    """

    order: torch.Tensor
    inv: torch.Tensor
    seg_start: torch.Tensor
    seg_id: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    seg_end: Optional[torch.Tensor]
    n_chains: torch.Tensor
    max_len: torch.Tensor
    counts: Optional[torch.Tensor] = None
    starts: Optional[torch.Tensor] = None

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """Gather a flat (pre-sort) per-op array into sorted chain order."""
        return take_along(x, self.order)

    def untake(self, x_sorted: torch.Tensor) -> torch.Tensor:
        """Gather a sorted per-op array back into flat (pre-sort) layout."""
        return take_along(x_sorted, self.inv)


# ---------------------------------------------------------------------------
# Path selection: partition -> packed sort (32/64 bit) -> lexsort
# ---------------------------------------------------------------------------
RESTRUCTURE_METHODS = ("auto", "partition", "packed", "lexsort",
                       "megakernel")


def partition_fits(n_rows: int, n_buckets: int, *,
                   device_kind: str = "cpu") -> bool:
    """Whether "auto" picks the one-pass counting partition backbone, by the
    bounds of ``device_kind``'s row of ``kernels/autotune.LADDER_BOUNDS``."""
    max_buckets, min_rows = autotune.ladder_bounds(device_kind)
    return n_buckets <= max_buckets and int(n_rows) >= min_rows


def megakernel_fits(n_rows: int, lanes: int,
                    smem_limit: Optional[int]) -> bool:
    """Whether the megakernel's scan block holds an interval of ``n_rows``
    rows of ``lanes`` lanes within ``smem_limit`` bytes of shared memory.

    ``smem_limit`` is the opt-in limit of the device that launches the
    kernel (``kernels/runtime.smem_optin``); None (the CPU, whose twin has
    no capacity) always fits.
    """
    if smem_limit is None:
        return True
    return megakernel_smem_bytes(int(n_rows), int(lanes)) <= smem_limit


def megakernel_engaged(n_rows: int, n_slots_incl_pad: int, *,
                       method: str, has_max: bool, funs_simple: bool,
                       lanes: int = 1,
                       smem_limit: Optional[int] = None,
                       device_kind: str = "cpu") -> bool:
    """Whether the fused driver evaluates chains through the megakernel.

    Structural eligibility first (simple-affine funs, no max-typed table),
    then either an explicit ``method="megakernel"`` or, under "auto", the
    band of ``device_kind``'s row of ``kernels/autotune.MEGA_BOUNDS`` (the
    kind of the device that launches, beside its ``smem_limit``); in both
    cases the interval must fit the kernel's block (``megakernel_fits``).
    An ineligible or oversized force takes the staged partition path (the
    same results), logged once: a plan decision from shapes, made before
    any launch.
    """
    eligible = (not has_max) and funs_simple
    fits = megakernel_fits(n_rows, lanes, smem_limit)
    if method == "megakernel":
        if not eligible:
            _warn_mega_fallback(("has_max", has_max, funs_simple),
                                _ineligible_why(has_max, funs_simple))
        elif not fits:
            _warn_mega_fallback(
                ("capacity", int(n_rows), int(lanes), smem_limit),
                f"an interval of {int(n_rows)} rows x {int(lanes)} lanes "
                f"needs {megakernel_smem_bytes(int(n_rows), int(lanes))} B "
                f"of one block's shared memory, over the device's "
                f"{smem_limit} B")
        return eligible and fits
    if method != "auto" or not eligible:
        return False
    band = autotune.mega_bounds(device_kind)
    return (int(n_rows) >= band["min_rows"]
            and n_slots_incl_pad <= band["max_buckets"] and fits)


_MEGA_FALLBACK_WARNED = set()


def _ineligible_why(has_max: bool, funs_simple: bool) -> str:
    why = []
    if has_max:
        why.append("store has max-type tables")
    if not funs_simple:
        why.append("app registers non-simple affine functions")
    return "; ".join(why)


def _warn_mega_fallback(key, why: str) -> None:
    if key in _MEGA_FALLBACK_WARNED:
        return
    _MEGA_FALLBACK_WARNED.add(key)
    log.warning("restructure: method='megakernel' forced but %s — using the "
                "staged partition path (same results)", why)


def packed_sort_fits(n_rows: int, max_major: int, bits: int = 32) -> bool:
    """Whether (major, row-index) packs into one ``bits``-wide sort key."""
    idx_bits = max(n_rows - 1, 1).bit_length()
    major_bits = max(int(max_major), 1).bit_length()
    return idx_bits + major_bits <= bits


def restructure_path(n: int, pad_uid: int, *, rowmajor_ts: bool,
                     method: str = "auto", x64: bool = False,
                     device_kind: str = "cpu") -> str:
    """Resolve the restructure backbone for an (n, pad_uid) batch.

    The reference's ladder, rung for rung.  ``x64`` mirrors JAX's
    ``jax_enable_x64`` (off by default): without it a packed key wider than
    32 bits falls back to the lexsort, as in the reference, although torch
    sorts int64 keys natively.  ``device_kind`` is the kind of the device
    that runs the batch (``kernels/autotune.kind_of``), whose row of the
    ladder's bounds "auto" reads.
    """
    if method not in RESTRUCTURE_METHODS:
        raise ValueError(f"method={method!r}; choose from "
                         f"{RESTRUCTURE_METHODS}")
    if method in ("partition", "packed", "megakernel") and not rowmajor_ts:
        raise ValueError(
            f"method={method!r} needs rowmajor_ts=True: all replace the "
            "(ts, slot) tie-break with the flat row index, which is only "
            "equivalent when rows are already in (ts, slot) order")
    if method != "auto":
        path = "partition" if method == "megakernel" else method
    elif not rowmajor_ts:
        path = "lexsort"
    elif partition_fits(n, pad_uid + 1, device_kind=device_kind):
        path = "partition"
    elif packed_sort_fits(n, pad_uid, bits=32):
        path = "packed"
    elif packed_sort_fits(n, pad_uid, bits=64) and x64:
        path = "packed"
    else:
        if packed_sort_fits(n, pad_uid, bits=64):
            log.warning(
                "restructure: packed key for n=%d, max_major=%d needs more "
                "than 32 bits and x64 is off — falling back to the slow 3-key "
                "lexsort (pass x64=True for the packed 64-bit sort path).",
                n, pad_uid)
        else:
            log.warning(
                "restructure: packed key for n=%d, max_major=%d exceeds 64 "
                "bits — falling back to the 3-key lexsort.", n, pad_uid)
        path = "lexsort"
    log.debug("restructure: path=%s (n=%d, n_buckets=%d, rowmajor_ts=%s)",
              path, n, pad_uid + 1, rowmajor_ts)
    return path


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------
def packed_stable_sort(major: torch.Tensor, max_major: int, *,
                       x64: bool = False):
    """Stable sort of rows by an integer major key via ONE sort of
    ``major << idx_bits | index`` packed keys.

    ``major`` must lie in [0, max_major].  Returns ``(order, major_sorted,
    pos)`` with ``order`` the sorted -> original map and ``pos`` its inverse
    (by binary search over the unique keys).  Keys are int64 here; a key
    wider than 32 bits needs ``x64=True``, as the reference's uint64 pack
    needs ``jax_enable_x64``.  An int32 major and an int32 row count pack
    into at most 62 bits, so an int64 key keeps the unsigned order.
    """
    n = major.shape[-1]
    idx_bits = max(n - 1, 1).bit_length()
    if not packed_sort_fits(n, max_major, bits=32):
        if not packed_sort_fits(n, max_major, bits=63):
            raise ValueError(
                f"packed_stable_sort: (major, index) for n={n}, "
                f"max_major={max_major} exceeds an int64 key — use the "
                "lexsort path")
        if not x64:
            raise ValueError(
                f"packed_stable_sort: key for n={n}, max_major={max_major} "
                "needs a 64-bit pack but x64 is off — pass x64=True or use "
                "the lexsort path")
    idx = torch.arange(n, dtype=torch.int64, device=major.device)
    packed = (major.long() << idx_bits) | idx
    keys = torch.sort(packed, dim=-1).values
    pos = torch.searchsorted(keys, packed).to(I32)
    order = (keys & ((1 << idx_bits) - 1)).to(I32)
    major_s = (keys >> idx_bits).to(I32)
    return order, major_s, pos


def partition_permutation(major: torch.Tensor, rank: torch.Tensor,
                          counts: torch.Tensor):
    """(starts, pos, order) of the stable partition from its one-pass
    (rank, counts): exclusive bucket offsets, each row's sorted position by
    direct arithmetic, and the inverted permutation."""
    n = major.shape[-1]
    starts = (torch.cumsum(counts, dim=-1, dtype=I32) - counts).to(I32)
    pos = take_along(starts, major) + rank
    order = torch.zeros_like(major, dtype=I32).scatter_(
        -1, pos.long(), _arange(n, major).expand_as(major).contiguous())
    return starts, pos, order


def _flag_at(idx: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """bool[..., n] True at ``idx`` where ``keep`` (dropped elsewhere)."""
    out = torch.zeros(tuple(idx.shape[:-1]) + (n + 1,), dtype=torch.bool,
                      device=idx.device)
    tgt = torch.where(keep, idx, torch.full_like(idx, n)).long()
    out.scatter_(-1, tgt, torch.ones_like(tgt, dtype=torch.bool))
    return out[..., :n].contiguous()   # kernels take contiguous rows


def _partition_chains(major: torch.Tensor, n_buckets: int, *,
                      use_kernels: bool = True, geometry: bool = True,
                      threads: Optional[int] = None):
    """Stable counting partition: the chain geometry from ONE pass over the
    keys (rank + histogram), no sort.  Returns ``(order, major_sorted,
    Chains)``.  ``geometry=False`` skips seg_id/pos/seg_end, which only the
    staged scan path reads (the megakernel's light plan)."""
    n = major.shape[-1]
    lead = tuple(major.shape[:-1])
    if use_kernels:   # the kernel ranks [BN, N]: every batch row, one launch
        rank, counts = radix_partition_rank(major.reshape(-1, n), n_buckets,
                                            threads=threads)
        rank = rank.reshape(major.shape)
        counts = counts.reshape(lead + (n_buckets,))
    else:
        rank, counts = radix_partition_rank_ref(major, n_buckets)
    starts, inv, order = partition_permutation(major, rank, counts)
    major_s = take_along(major, order)
    nz = counts > 0
    seg_start = _flag_at(starts, nz, n)
    if geometry:
        seg_end = _flag_at(starts + counts - 1, nz, n)
        seg_id = torch.cumsum(seg_start, dim=-1, dtype=I32) - 1
        pos = _arange(n, major) - take_along(starts, major_s)
    else:
        seg_end = seg_id = pos = None
    chains = Chains(
        order=order, inv=inv, seg_start=seg_start, seg_id=seg_id, pos=pos,
        seg_end=seg_end, n_chains=torch.sum(nz, dim=-1, dtype=I32),
        max_len=torch.amax(counts, dim=-1), counts=counts, starts=starts)
    return order, major_s, chains


def _sorted_chains(uid_s: torch.Tensor, order: torch.Tensor,
                   inv: torch.Tensor) -> Chains:
    """Chain geometry from a sorted uid column (the sort backbones)."""
    n = uid_s.shape[-1]
    idx = _arange(n, uid_s).expand_as(uid_s)
    lead = tuple(uid_s.shape[:-1])
    ones = torch.ones(lead + (1,), dtype=torch.bool, device=uid_s.device)
    diff = uid_s[..., 1:] != uid_s[..., :-1]
    seg_start = torch.cat([ones, diff], dim=-1)
    seg_id = torch.cumsum(seg_start, dim=-1, dtype=I32) - 1
    start_idx = torch.cummax(torch.where(seg_start, idx, torch.zeros_like(idx)),
                             dim=-1).values
    pos = idx - start_idx
    seg_end = torch.cat([diff, ones], dim=-1)
    return Chains(order=order, inv=inv, seg_start=seg_start, seg_id=seg_id,
                  pos=pos, seg_end=seg_end, n_chains=seg_id[..., -1] + 1,
                  max_len=torch.amax(pos, dim=-1) + 1)


def _sorted_view(ops: OpBatch, uid_s: torch.Tensor, order: torch.Tensor,
                 light: bool) -> OpBatch:
    def take(x):
        return None if light else take_along(x, order)
    return OpBatch(
        uid=uid_s, ts=take(ops.ts), txn=take(ops.txn), slot=take(ops.slot),
        kind=take(ops.kind), fun=take_along(ops.fun, order),
        gate=take(ops.gate), operand=take_along(ops.operand, order),
        valid=take_along(ops.valid, order))


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1, stable=True).indices


def restructure(ops: OpBatch, pad_uid: int, *,
                rowmajor_ts: bool = False,
                light: bool = False,
                method: str = "auto",
                use_kernels: bool = True,
                geometry: bool = True,
                threads: Optional[int] = None,
                x64: bool = False) -> Tuple[OpBatch, Chains]:
    """Group the op batch (fields ``[..., N]``) into operation chains.

    Invalid (padding) ops go to the padding chain (uid = pad_uid) at the
    end; chain order within a state follows (ts, slot).  ``rowmajor_ts``
    promises that flat row order already equals (ts, slot) order, as
    ``build_opbatch`` lays it out; then the row index is the tie-break and
    ``restructure_path`` picks the backbone.  ``light`` gathers only the
    columns the scan path reads (uid, fun, operand, valid).  ``use_kernels``
    lets the partition rung call the radix kernel wrapper (which runs the
    kernel on a CUDA tensor and its twin on a CPU one); ``threads``
    overrides its block size.  ``geometry=False`` builds the megakernel's
    light plan.
    """
    uid = torch.where(ops.valid, ops.uid, torch.full_like(ops.uid, pad_uid))
    n = uid.shape[-1]
    path = restructure_path(n, pad_uid, rowmajor_ts=rowmajor_ts,
                            method=method, x64=x64,
                            device_kind=autotune.kind_of(uid.device))

    if path == "partition":
        order, uid_s, chains = _partition_chains(
            uid, pad_uid + 1, use_kernels=use_kernels, geometry=geometry,
            threads=threads)
    elif path == "packed":
        order, uid_s, inv = packed_stable_sort(uid, pad_uid, x64=x64)
        chains = _sorted_chains(uid_s, order, inv)
    else:
        # uid major, then ts, then slot: stable sorts from the minor key up
        order = _stable_argsort(ops.slot)
        order = take_along(order, _stable_argsort(take_along(ops.ts, order)))
        order = take_along(order, _stable_argsort(take_along(uid, order)))
        order = order.to(I32)
        uid_s = take_along(uid, order)
        inv = torch.zeros_like(order).scatter_(
            -1, order.long(), _arange(n, uid).expand_as(order).contiguous())
        chains = _sorted_chains(uid_s, order, inv)

    return _sorted_view(ops, uid_s, order, light), chains


# The stream driver's batched restructure: ``restructure`` already takes
# stacked ``[n_intervals, N]`` batches, and on the partition rung ranks them
# all in one kernel launch.
restructure_stream = restructure


def commit_index(uid_sorted: torch.Tensor, n_slots_incl_pad: int):
    """Per-state commit gather map from the sorted uid column.

    ``pos[u]`` = sorted index of the last op of chain ``u``; ``ok[u]`` =
    chain ``u`` has ops in this batch.  The partition rung gets the same map
    from its histogram (``commit_from_histogram``).
    """
    lead = tuple(uid_sorted.shape[:-1])
    slots = _arange(n_slots_incl_pad, uid_sorted).expand(
        lead + (n_slots_incl_pad,)).contiguous()
    pos = (torch.searchsorted(uid_sorted.contiguous(), slots, right=True)
           - 1).to(I32)
    safe = torch.clamp(pos, min=0)
    ok = (pos >= 0) & (take_along(uid_sorted, safe) == slots)
    return safe, ok


def commit_from_histogram(counts: torch.Tensor, starts: torch.Tensor):
    """Commit gather map from the partition histogram: the last op of chain
    ``u`` sits at ``starts[u] + counts[u] - 1``."""
    pos = torch.clamp(starts + counts - 1, min=0).to(I32)
    return pos, counts > 0


def _shift_rows(x: torch.Tensor, d: int, fill, ax: int) -> torch.Tensor:
    """x shifted d rows down along ``ax``, ``fill`` in the first d rows (all
    of them where x has fewer, as for an empty x)."""
    d = min(d, x.shape[ax])
    shape = list(x.shape)
    shape[ax] = d
    pad = torch.full(shape, fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x.narrow(ax, 0, x.shape[ax] - d)], dim=ax)


def segmented_scan_affine(a: torch.Tensor, b: torch.Tensor,
                          seg_start: torch.Tensor,
                          exclusive: bool = True
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented scan of affine maps f(v) = a*v + b under composition.

    a, b: ``[..., N, W]``; seg_start ``[..., N]``.  Composition (applied
    left to right): (a2,b2)∘(a1,b1) = (a2*a1, a2*b1+b2).  Returns per-op
    (A, B) with the state seen by op i = A_i * v0 + B_i (exclusive).

    The reference's explicit log-step Hillis-Steele sweep with segment-flag
    blocking, step for step: the association is fixed by each op's position
    within its segment, so a chain gives the same bits wherever it sits (a
    flattened stream of intervals included).  Products and sums are separate
    roundings; where every product has a factor in {0, 1} (all
    simple-affine funs) that equals XLA's fused multiply-add bit for bit.
    """
    ax = seg_start.dim() - 1
    n = a.shape[ax]
    f = seg_start
    a_inc, b_inc = a, b
    d = 1
    while d < n:
        ap = _shift_rows(a_inc, d, 1.0, ax)
        bp = _shift_rows(b_inc, d, 0.0, ax)
        fp = _shift_rows(f, d, True, ax)
        blocked = f[..., None]
        a_inc, b_inc = (torch.where(blocked, a_inc, a_inc * ap),
                        torch.where(blocked, b_inc, a_inc * bp + b_inc))
        f = f | fp
        d *= 2
    if not exclusive:
        return a_inc, b_inc
    starts = seg_start[..., None]
    a_exc = torch.where(starts, torch.ones_like(a_inc),
                        _shift_rows(a_inc, 1, 1.0, ax))
    b_exc = torch.where(starts, torch.zeros_like(b_inc),
                        _shift_rows(b_inc, 1, 0.0, ax))
    return a_exc, b_exc


def segmented_scan_max(m: torch.Tensor, seg_start: torch.Tensor,
                       exclusive: bool = True) -> torch.Tensor:
    """Segmented running max (max-type tables), the same sweep as the affine
    scan with identity -inf."""
    ax = seg_start.dim() - 1
    n = m.shape[ax]
    neg = float("-inf")
    f = seg_start
    m_inc = m
    d = 1
    while d < n:
        mp = _shift_rows(m_inc, d, neg, ax)
        fp = _shift_rows(f, d, True, ax)
        m_inc = torch.where(f[..., None], m_inc, torch.maximum(m_inc, mp))
        f = f | fp
        d *= 2
    if not exclusive:
        return m_inc
    return torch.where(seg_start[..., None], torch.full_like(m_inc, neg),
                       _shift_rows(m_inc, 1, neg, ax))
