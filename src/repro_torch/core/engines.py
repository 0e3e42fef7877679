"""Transaction-processing engines of the slice (reference: ``repro/core/engines.py``).

All engines share one contract::

    evaluate(store, ops, funs, ...) -> (results_flat, new_values, stats)

``results_flat`` is a dict of pre/post/success in the pre-sort flat layout
([N] rows aligned with (txn, slot)).  This slice ports the TStream segmented-
scan fast path (``tstream`` on associative apps, ``tstream_scan``) and the
``lock`` schedule, which doubles as the correctness oracle.  The lockstep
path and the mvlk, pat and nolock baselines come with ROADMAP A7.

The scan path is split in three stages so the fused driver hoists what does
not depend on state values out of its per-interval loop:

  plan    = tstream_scan_plan(...)        coefficients + commit gather map
  plan    = tstream_scan_coefs(plan)      exclusive segmented scans
  results = tstream_scan_execute(values, plan)   gather, apply, commit

The first two take any leading batch dimensions (the whole stream at once).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels.segscan import ops as segscan_ops
from .restructure import (Chains, commit_from_histogram, commit_index,
                          restructure, segmented_scan_affine,
                          segmented_scan_max, take_along)
from .types import FunSpec, OpBatch, StateStore

Prestructured = Tuple[OpBatch, Chains]

NOT_PORTED = ("is not ported yet: the lockstep path and the mvlk, pat and "
              "nolock schemes come with ROADMAP A7")


def _simple_shapes(funs: Tuple[FunSpec, ...]):
    return [f.affine_simple if f.affine is not None else (1.0, False)
            for f in funs]


def simple_affine_luts(funs: Tuple[FunSpec, ...], device=None):
    """(a_lut f32[n_funs], b_lut bool[n_funs]) when EVERY fun declares a
    simple affine shape (a in {0, 1}, b in {0, operand}; non-affine funs
    count as identity), else None.  The megakernel's precondition."""
    simple = _simple_shapes(funs)
    if not all(s is not None for s in simple):
        return None
    return (torch.tensor([s[0] for s in simple], dtype=torch.float32,
                         device=device),
            torch.tensor([s[1] for s in simple], dtype=torch.bool,
                         device=device))


def affine_coeffs(funs: Tuple[FunSpec, ...], fun_id: torch.Tensor,
                  operand: torch.Tensor):
    """Per-op (a, b) affine coefficients from the simple-affine LUTs;
    identity for non-affine funs."""
    luts = simple_affine_luts(funs, operand.device)
    if luts is None:
        raise NotImplementedError(
            "affine_coeffs for general (non-simple) affine funs " + NOT_PORTED)
    a_lut, b_lut = luts
    fid = fun_id.long()
    a = a_lut.to(operand.dtype)[fid][..., None].expand(operand.shape)
    b = torch.where(b_lut[fid][..., None], operand, torch.zeros_like(operand))
    return a, b


@dataclasses.dataclass
class EngineStats:
    """Structural parallelism counters for the executor cost model."""
    rounds: torch.Tensor          # sequential depth of the schedule
    n_chains: torch.Tensor        # parallel width available
    max_chain: torch.Tensor       # longest chain
    n_ops: int                    # total decomposed ops (incl. padding)
    scheme: str = ""
    path: str = ""                # "segscan" | "megakernel" | "sequential"


def scan_stats(ch: Chains, n: int, path: str) -> EngineStats:
    return EngineStats(
        rounds=torch.ceil(torch.log2(ch.max_len.to(torch.float32) + 1)),
        n_chains=ch.n_chains, max_chain=ch.max_len, n_ops=n,
        scheme="tstream", path=path)


@dataclasses.dataclass
class ScanPlan:
    """Values-independent plan of the segmented-scan path.

    ``af``/``bf``/``mx`` hold the per-op affine / max coefficients after
    ``tstream_scan_plan`` and their exclusive segmented scans after
    ``tstream_scan_coefs``; ``afi``/``bfi``/``mxi`` are the inclusive scans.
    ``commit_pos``/``commit_ok`` are the [S+1] per-state commit gather map.
    """

    sops: OpBatch
    ch: Chains
    af: torch.Tensor
    bf: torch.Tensor
    afi: Optional[torch.Tensor]
    bfi: Optional[torch.Tensor]
    mx: Optional[torch.Tensor]        # None when the store has no max tables
    mxi: Optional[torch.Tensor]
    is_max_s: Optional[torch.Tensor]
    commit_pos: torch.Tensor
    commit_ok: torch.Tensor


def tstream_scan_plan(store: StateStore, ops: OpBatch,
                      funs: Tuple[FunSpec, ...], *,
                      prestructured: Optional[Prestructured] = None,
                      rowmajor_ts: bool = False,
                      restructure_method: str = "auto",
                      use_kernels: bool = True) -> ScanPlan:
    bad = [f.name for f in funs if not f.associative]
    if bad:
        raise ValueError(
            f"tstream_scan requires associative funs; got {bad} — use the "
            "lockstep path instead")
    sops, ch = (restructure(ops, store.pad_uid, rowmajor_ts=rowmajor_ts,
                            light=True, method=restructure_method,
                            use_kernels=use_kernels)
                if prestructured is None else prestructured)
    has_max = any(store.table_is_max)

    # affine coefficients; max-table and invalid ops become identity
    a, b = affine_coeffs(funs, sops.fun, sops.operand)
    if has_max:
        flags = store.uid_is_max()
        is_max_s = take_along(flags.expand(tuple(sops.uid.shape[:-1])
                                           + tuple(flags.shape[-1:])),
                              sops.uid)
        neutralize = (is_max_s | ~sops.valid)[..., None]
    else:
        is_max_s = None
        neutralize = (~sops.valid)[..., None]
    a = torch.where(neutralize, torch.ones_like(a), a)
    b = torch.where(neutralize, torch.zeros_like(b), b)

    # max family (ops on non-max tables, READs and invalid ops -> -inf)
    m = None
    if has_max:
        is_max_fun = torch.tensor([f.is_max for f in funs], dtype=torch.bool,
                                  device=sops.fun.device)[sops.fun.long()]
        m = torch.where((is_max_s & is_max_fun & sops.valid)[..., None],
                        sops.operand, torch.full_like(sops.operand,
                                                      float("-inf")))

    n_slots = store.values.shape[-2]
    if ch.counts is not None and ch.counts.shape[-1] == n_slots:
        commit_pos, commit_ok = commit_from_histogram(ch.counts, ch.starts)
    else:
        commit_pos, commit_ok = commit_index(sops.uid, n_slots)
    return ScanPlan(sops=sops, ch=ch, af=a, bf=b, afi=None, bfi=None,
                    mx=m, mxi=None, is_max_s=is_max_s,
                    commit_pos=commit_pos, commit_ok=commit_ok)


def tstream_scan_coefs(plan: ScanPlan, *, use_kernels: bool = True,
                       threads: Optional[int] = None) -> ScanPlan:
    """Exclusive segmented scans of the planned coefficients, then the
    inclusive ones by composing each op's own coefficient on top.

    Takes one interval or a stack ``[n_intervals, N]``: the stack is scanned
    as one flattened stream (one kernel launch per scan under
    ``use_kernels``), which each interval's leading segment start isolates.
    The twins' sweep is segment-relative, so on the CPU that gives the same
    bits as per-interval scans; the CUDA affine scan associates by tile and
    agrees to 1e-5 (exact where every product has a factor in {0, 1}, as for
    GS; the max scan is exact).  ``threads`` overrides the kernel's block
    size, which changes no bit.
    """
    shape = plan.af.shape
    w = shape[-1]
    flags = plan.ch.seg_start.reshape(-1)
    a, b = plan.af.reshape(-1, w), plan.bf.reshape(-1, w)
    m = None if plan.mx is None else plan.mx.reshape(-1, w)
    if use_kernels:
        A, B = segscan_ops.segscan_affine(a.contiguous(), b.contiguous(),
                                          flags.contiguous(), threads=threads)
        M = (segscan_ops.segscan_max(m.contiguous(), flags.contiguous(),
                                     threads=threads)
             if m is not None else None)
    else:
        A, B = segmented_scan_affine(a, b, flags, exclusive=True)
        M = (segmented_scan_max(m, flags, exclusive=True)
             if m is not None else None)
    M = None if M is None else M.reshape(shape)
    return _compose_inclusive(plan, A.reshape(shape), B.reshape(shape), M)


def _compose_inclusive(plan: ScanPlan, A, B, M) -> ScanPlan:
    """inclusive = raw ∘ exclusive (the op applied on top of its pre)."""
    Ai = plan.af * A
    Bi = plan.af * B + plan.bf
    Mi = torch.maximum(M, plan.mx) if M is not None else None
    return dataclasses.replace(plan, af=A, bf=B, afi=Ai, bfi=Bi,
                               mx=M, mxi=Mi)


def tstream_scan_execute(values: torch.Tensor, plan: ScanPlan,
                         pad_uid: int, *, raw: bool = False):
    """Values-dependent stage for ONE interval: O(N) gathers and elementwise
    work plus one [S+1] select.  ``raw=True`` keeps results in sorted layout.

    ``values`` [S+1, W] with plan fields [N], or a stack of shard stores
    [B, S+1, W] with plan fields [B, N] (the sharded driver's interval of
    every shard).
    """
    sops, ch = plan.sops, plan.ch
    n = sops.uid.shape[-1]
    v0 = take_along(values, sops.uid)                          # [N, W]
    pre = plan.af * v0 + plan.bf
    post = plan.afi * v0 + plan.bfi
    if plan.mx is not None:
        mmask = plan.is_max_s[..., None]
        pre = torch.where(mmask, torch.maximum(v0, plan.mx), pre)
        post = torch.where(mmask, torch.maximum(v0, plan.mxi), post)

    # commit: the last op of each chain defines the new state value
    committed = take_along(post, plan.commit_pos)              # [S+1, W]
    new_values = torch.where(plan.commit_ok[..., None], committed, values)
    new_values[..., pad_uid, :] = 0.0

    # invalid (padding) ops record nothing
    vmask = sops.valid[..., None]
    res = dict(pre=torch.where(vmask, pre, torch.zeros_like(pre)),
               post=torch.where(vmask, post, torch.zeros_like(post)),
               success=sops.valid.clone())
    if not raw:
        res = {k: ch.untake(v) for k, v in res.items()}
    return res, new_values, scan_stats(ch, n, "segscan")


def eval_tstream_scan(store: StateStore, ops: OpBatch,
                      funs: Tuple[FunSpec, ...], *, use_kernels: bool = True,
                      prestructured: Optional[Prestructured] = None,
                      rowmajor_ts: bool = False,
                      restructure_method: str = "auto"):
    plan = tstream_scan_plan(store, ops, funs, prestructured=prestructured,
                             rowmajor_ts=rowmajor_ts,
                             restructure_method=restructure_method,
                             use_kernels=use_kernels)
    plan = tstream_scan_coefs(plan, use_kernels=use_kernels)
    return tstream_scan_execute(store.values, plan, store.pad_uid)


# ---------------------------------------------------------------------------
# Sequential oracle / LOCK schedule
# ---------------------------------------------------------------------------
def _empty_results(n: int, w: int, device):
    return dict(pre=torch.zeros((n + 1, w), dtype=torch.float32,
                                device=device),
                post=torch.zeros((n + 1, w), dtype=torch.float32,
                                 device=device),
                success=torch.zeros((n + 1,), dtype=torch.bool,
                                    device=device))


def _sequential_sweep(values, ops: OpBatch, funs, results, *, mask_flat,
                      pad_uid):
    """Apply ops one at a time in global (ts, slot) order (S2PL schedule).

    The reference's ``lax.scan`` over ops is a host loop here: the op
    columns come to the host once, the state stays on its device.
    """
    n = ops.n_ops
    order = torch.sort(ops.slot, stable=True).indices
    order = order[torch.sort(ops.ts[order], stable=True).indices].tolist()
    run_l = (mask_flat & ops.valid).tolist()
    uid_l, gate_l, fun_l = ops.uid.tolist(), ops.gate.tolist(), ops.fun.tolist()
    values = values.clone()
    res = {k: v.clone() for k, v in results.items()}
    for j in order:
        run = run_l[j]
        uid = uid_l[j] if run else pad_uid
        cur = values[uid].clone()
        gate = gate_l[j]
        post, ok = funs[fun_l[j]].apply(cur, ops.operand[j])
        if gate >= 0 and not bool(res["success"][gate]):
            post, ok = cur, torch.zeros_like(ok)
        values[uid] = post if run else values[pad_uid]
        values[pad_uid] = 0.0
        sink = j if run else n
        res["pre"][sink] = cur
        res["post"][sink] = post
        res["success"][sink] = ok
    return values, res


def eval_lock(store: StateStore, ops: OpBatch, funs):
    """LOCK baseline == sequential oracle (conflict-equivalent ts order)."""
    n = ops.n_ops
    results = _empty_results(n, ops.width, store.device)
    values, results = _sequential_sweep(
        store.values, ops, funs, results,
        mask_flat=torch.ones((n,), dtype=torch.bool, device=store.device),
        pad_uid=store.pad_uid)
    results = {k: v[:n] for k, v in results.items()}
    n_valid = torch.sum(ops.valid, dtype=torch.int32)
    stats = EngineStats(rounds=n_valid,
                        n_chains=torch.ones((), dtype=torch.int32),
                        max_chain=n_valid, n_ops=n, scheme="lock",
                        path="sequential")
    return results, values, stats


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
SCHEMES = ("tstream", "tstream_scan", "lock")

# schemes whose evaluation consumes the restructured (chain-sorted) view
CHAIN_SCHEMES = frozenset({"tstream", "tstream_scan"})


def evaluate(store: StateStore, ops: OpBatch, funs: Tuple[FunSpec, ...],
             scheme: str = "tstream", *, associative_only: bool = False,
             has_gates: bool = False, use_kernels: bool = True,
             prestructured: Optional[Prestructured] = None,
             rowmajor_ts: bool = False, restructure_method: str = "auto"):
    if scheme in ("tstream_lockstep", "mvlk", "pat", "nolock") or (
            scheme == "tstream" and not (associative_only and not has_gates)):
        raise NotImplementedError(f"scheme {scheme!r} on this app "
                                  + NOT_PORTED)
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; choose from {SCHEMES}")
    if scheme == "lock":
        return eval_lock(store, ops, funs)
    if prestructured is None:
        prestructured = restructure(ops, store.pad_uid,
                                    rowmajor_ts=rowmajor_ts,
                                    method=restructure_method,
                                    use_kernels=use_kernels)
    return eval_tstream_scan(store, ops, funs, use_kernels=use_kernels,
                             prestructured=prestructured)
