"""Transaction-processing engines (reference: ``repro/core/engines.py``).

All engines share one contract::

    evaluate(store, ops, funs, ...) -> (results_flat, new_values, stats)

``results_flat`` is a dict of pre/post/success in the pre-sort flat layout
([N] rows aligned with (txn, slot)).  Schemes, as in the reference:

* ``tstream``   associative apps take the segmented-scan path
                (``tstream_scan``); the others the lockstep path
                (``tstream_lockstep``): every chain walked in parallel, one
                op per chain per round, gated ops scheduled level by level
                and unresolved chains (dependency cycles) left to the
                sequential schedule;
* ``lock``      the sequential schedule in (ts, slot) order, which doubles
                as the correctness oracle;
* ``mvlk``      the lockstep walk, with rounds counted over writes only;
* ``pat``       partition-level locking (S-Store);
* ``nolock``    one parallel step, no ordering (incorrect by design).

The scan path is split in three stages so the fused driver hoists what does
not depend on state values out of its per-interval loop:

  plan    = tstream_scan_plan(...)        coefficients + commit gather map
  plan    = tstream_scan_coefs(plan)      exclusive segmented scans
  results = tstream_scan_execute(values, plan)   gather, apply, commit

The first two take any leading batch dimensions (the whole stream at once).
The lockstep walk visits only the rounds in which a valid op is active, and
only the ops active in each round; the rounds it skips change no value of
the reference's sweep (``_lockstep_sweep``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.segscan import ops as segscan_ops
from .restructure import (Chains, _stable_argsort, commit_from_histogram,
                          commit_index, restructure, segmented_scan_affine,
                          segmented_scan_max, take_along)
from .types import FunSpec, OpBatch, OpKind, StateStore

Prestructured = Tuple[OpBatch, Chains]

I32 = torch.int32


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
    """Per-op (a, b) affine coefficients; identity for non-affine funs.

    Where every fun declares a simple affine shape the coefficients come
    from two LUT gathers; otherwise each fun's ``affine`` is evaluated on the
    whole batch and selected by ``fun_id``, as the reference's vmapped switch
    does.
    """
    luts = simple_affine_luts(funs, operand.device)
    fid = fun_id.long()
    if luts is not None:
        a_lut, b_lut = luts
        a = a_lut.to(operand.dtype)[fid][..., None].expand(operand.shape)
        b = torch.where(b_lut[fid][..., None], operand,
                        torch.zeros_like(operand))
        return a, b
    a, b = torch.ones_like(operand), torch.zeros_like(operand)
    for k, f in enumerate(funs):
        if f.affine is None:
            continue
        ak, bk = f.affine(operand)
        sel = (fid == k)[..., None]
        a = torch.where(sel, ak.expand(operand.shape), a)
        b = torch.where(sel, bk.expand(operand.shape), b)
    return a, b


def apply_funs(funs: Tuple[FunSpec, ...], fun_id: torch.Tensor,
               pre: torch.Tensor, operand: torch.Tensor,
               present: Optional[Sequence[int]] = None):
    """Every op's fun on its (pre, operand): pre, operand ``[M, W]`` ->
    (post ``[M, W]``, success bool``[M]``).

    Each fun runs once on the whole batch and ``torch.where`` on ``fun_id``
    selects its rows: the funs are elementwise, so this gives the bits of
    the reference's vmapped ``lax.switch``.  ``present`` names the fun ids
    that occur, at least one (all of them when None); the others are not
    evaluated.
    """
    ids = range(len(funs)) if present is None else present
    post = ok = None
    for k in ids:
        pk, ok_k = funs[k].apply(pre, operand)
        if post is None:
            post, ok = pk, ok_k
            continue
        sel = fun_id == k
        post = torch.where(sel[..., None], pk, post)
        ok = torch.where(sel, ok_k, ok)
    return post, ok


@dataclasses.dataclass
class EngineStats:
    """Structural parallelism counters for the executor cost model."""
    rounds: torch.Tensor          # sequential depth of the schedule
    n_chains: torch.Tensor        # parallel width available
    max_chain: torch.Tensor       # longest chain
    n_ops: int                    # total decomposed ops (incl. padding)
    scheme: str = ""
    path: str = ""                # "segscan" | "megakernel" | "lockstep" | ...
    # the port's own schedule: lockstep rounds it ran (only those with an
    # active op), and ops it left to the sequential residue sweep
    swept: int = 0
    residue: int = 0


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


def _empty_results(n: int, w: int, device):
    """Per-op results in flat layout with one sink row ``n`` at the end."""
    return dict(pre=torch.zeros((n + 1, w), dtype=torch.float32,
                                device=device),
                post=torch.zeros((n + 1, w), dtype=torch.float32,
                                 device=device),
                success=torch.zeros((n + 1,), dtype=torch.bool,
                                    device=device))


# ---------------------------------------------------------------------------
# TStream lockstep path: parallel chains, sequential within a chain,
# level-wise resolution of CFun dependencies (paper §IV-C2 Case 2)
# ---------------------------------------------------------------------------
INF_LEVEL = 10 ** 6     # an unresolved level; compared as int32, as in JAX


def _segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Max of int32 ``x`` per segment over ``n`` segments.  An empty segment
    gives 0 where ``jax.ops.segment_max`` gives the int32 minimum; every
    caller masks empty segments, so the results agree."""
    return torch.zeros(n, dtype=x.dtype, device=x.device).scatter_reduce(
        0, seg, x, "amax", include_self=False)


def _chain_levels(sops: OpBatch, ch: Chains, n: int, max_levels: int):
    """Level-wise chain schedule for cross-chain CFun dependencies.

    level(C) = 0 if C has no gated op, else 1 + max(level(mate chain)).
    Chains whose level does not resolve within ``max_levels`` iterations
    (dependency cycles inside the batch) come out unresolved (``INF``) and
    go to the sequential sweep.
    """
    seg = ch.seg_id.long()
    seg_flat = ch.untake(ch.seg_id)           # chain of each flat op
    gated = (sops.gate >= 0) & sops.valid
    mate_chain = seg_flat[sops.gate.clamp(min=0).long()].long()
    chain_has_gate = _segment_max(gated.to(I32), seg, n) > 0
    zero = torch.zeros(n, dtype=I32, device=seg.device)
    lvl = torch.where(chain_has_gate, torch.full_like(zero, INF_LEVEL), zero)
    for _ in range(max_levels):
        pred_lvl = torch.where(gated, lvl[mate_chain],
                               torch.full_like(sops.gate, -1))
        need = _segment_max(
            torch.where(gated, torch.clamp(pred_lvl + 1, max=INF_LEVEL),
                        torch.zeros_like(pred_lvl)), seg, n)
        lvl = torch.where(chain_has_gate, torch.clamp(need, max=INF_LEVEL),
                          zero)
    return lvl, lvl >= INF_LEVEL


def _lockstep_sweep(values, sops: OpBatch, dst: torch.Tensor,
                    funs: Tuple[FunSpec, ...], group: torch.Tensor, results,
                    pad_uid: int, frontier: Optional[torch.Tensor] = None):
    """Walk chains in lockstep, in place on ``values`` and ``results``.

    ``group`` (sorted layout) gives each active op its round: a round of
    the reference's sweep applies the r-th op of every masked chain, and
    the rounds run in ascending ``group``; ``group < 0`` marks an op that
    no round activates.  Only the rounds that hold an active op run, and
    each on its active ops only: the reference writes an inactive op to the
    pad state, reset to 0 at once, and to the sink row ``n``, sliced off,
    so skipping either changes no result.  That holds as the pad row holds
    0 on entry, as every store and engine keeps it.  A round holds one op
    per state, so its scatters have no duplicate index.

    ``dst`` is each sorted op's row in ``results`` (``ch.order`` on one
    device).  A gated op reads its mate's success at row ``gate`` of
    ``results["success"]``, or of ``frontier`` when one is given (the
    sharded walk's merged success frontier).

    One host read per call: the round sizes, the funs that occur, and
    whether a gate or the pad state is involved.  Returns the number of
    rounds run.
    """
    run = group >= 0
    never = torch.iinfo(torch.int64).max
    sk, perm = torch.sort(torch.where(
        run, group.long(), torch.full_like(group, never, dtype=torch.int64)),
        stable=True)
    keys, sizes = torch.unique_consecutive(sk, return_counts=True)
    n_funs = len(funs)
    fun_hit = torch.zeros(n_funs, dtype=torch.int64, device=sk.device)
    fun_hit.index_add_(0, sops.fun.long(), run.long())
    gated = run & (sops.gate >= 0)
    flags = torch.stack([gated.any(), (run & (sops.uid == pad_uid)).any()])
    host = torch.cat([keys, sizes, fun_hit, flags.long()]).tolist()
    m = keys.numel()
    sizes = [c for k, c in zip(host[:m], host[m:2 * m]) if k != never]
    present = [k for k in range(n_funs) if host[2 * m + k] > 0]
    any_gate, any_pad = host[-2] > 0, host[-1] > 0
    if not sizes:
        return 0

    p = perm[:sum(sizes)]
    uid, fun, opnd = sops.uid[p].long(), sops.fun[p], sops.operand[p]
    dst = dst[p].long()
    if any_gate:
        gate = sops.gate[p]
        mate, ungated = gate.clamp(min=0).long(), gate < 0
    res_pre, res_post, res_ok = (results["pre"], results["post"],
                                 results["success"])
    mate_ok = res_ok if frontier is None else frontier
    a = 0
    for c in sizes:
        b = a + c
        u = uid[a:b]
        cur = values.index_select(0, u)
        post, ok = apply_funs(funs, fun[a:b], cur, opnd[a:b], present)
        if any_gate:
            # the mate's success, recorded by earlier rounds
            open_ = mate_ok.index_select(0, mate[a:b]) | ungated[a:b]
            post = torch.where(open_[:, None], post, cur)
            ok = ok & open_
        values.index_copy_(0, u, post)
        if any_pad:
            values[pad_uid] = 0.0
        d = dst[a:b]
        res_pre.index_copy_(0, d, cur)
        res_post.index_copy_(0, d, post)
        res_ok.index_copy_(0, d, ok)
        a = b
    return len(sizes)


def eval_tstream_lockstep(store: StateStore, ops: OpBatch,
                          funs: Tuple[FunSpec, ...], *,
                          max_dep_levels: int = 3, has_gates: bool = False,
                          prestructured: Optional[Prestructured] = None):
    sops, ch = (restructure(ops, store.pad_uid) if prestructured is None
                else prestructured)
    n = ops.n_ops
    values = store.values.clone()
    results = _empty_results(n, ops.width, store.device)
    never = torch.full_like(ch.pos, -1)

    if not has_gates:
        # the reference sweeps ch.max_len rounds, the padding chain's
        # included; past the last valid op no round is active
        swept = _lockstep_sweep(values, sops, ch.order, funs,
                                torch.where(sops.valid, ch.pos, never),
                                results, store.pad_uid)
        rounds, residue = ch.max_len, 0
    else:
        lvl, unresolved = _chain_levels(sops, ch, n, max_dep_levels)
        seg = ch.seg_id.long()
        lvl_s = lvl[seg]
        # levels 0..max_dep_levels in turn, each level's rounds in order
        in_level = sops.valid & (lvl_s <= max_dep_levels)
        key = lvl_s.clamp(max=max_dep_levels).long() * n + ch.pos
        swept = _lockstep_sweep(values, sops, ch.order, funs,
                                torch.where(in_level, key, -1),
                                results, store.pad_uid)
        # the reference's round count: each level's longest chain
        rounds = torch.zeros((), dtype=I32, device=store.device)
        for level in range(max_dep_levels + 1):
            at = (lvl_s == level) & sops.valid
            rounds = rounds + torch.amax(torch.where(at, ch.pos, never)) + 1
        # sequential fallback for ops in unresolved chains (cycles)
        unresolved_ops = ch.untake(unresolved[seg] & sops.valid)
        residue = _sequential_sweep(values, ops, funs, results,
                                    mask_flat=unresolved_ops,
                                    pad_uid=store.pad_uid)
        rounds = rounds + torch.sum(unresolved_ops, dtype=I32)

    res = {k: v[:n] for k, v in results.items()}
    stats = EngineStats(rounds=rounds, n_chains=ch.n_chains,
                        max_chain=ch.max_len, n_ops=n, scheme="tstream",
                        path="lockstep", swept=swept, residue=residue)
    return res, values, stats


# ---------------------------------------------------------------------------
# Sequential oracle / LOCK schedule
# ---------------------------------------------------------------------------
def _sequential_sweep(values, ops: OpBatch, funs, results, *, mask_flat,
                      pad_uid: int, sink: Optional[torch.Tensor] = None
                      ) -> int:
    """Apply the masked valid ops one at a time in global (ts, slot) order
    (the S2PL schedule), in place on ``values`` and ``results``.

    The reference's ``lax.scan`` visits every op and sends an unmasked one
    to the pad state and the sink row ``n``, which changes no result; here
    only the masked valid ops run.  Their columns come to the host in one
    read; the state and each gate's success stay on the device.  Op ``j``
    records at row ``sink[j]`` of ``results`` (``j`` when None), the space
    its gate indexes.  The order comes from two stable sorts, on slot and
    then on ts.  Returns the number of ops run.
    """
    order = _stable_argsort(ops.slot)
    order = order[_stable_argsort(ops.ts[order])]
    js = order[(mask_flat & ops.valid)[order]]
    rows = js if sink is None else sink[js]
    cols = torch.stack([rows.to(I32), ops.uid[js], ops.fun[js],
                        ops.gate[js]]).tolist()
    opnd = ops.operand[js]
    res_pre, res_post, res_ok = (results["pre"], results["post"],
                                 results["success"])
    for i, (j, uid, f, gate) in enumerate(zip(*cols)):
        cur = values[uid].clone()
        post, ok = funs[f].apply(cur, opnd[i])
        if gate >= 0:
            open_ = res_ok[gate]
            post = torch.where(open_, post, cur)
            ok = ok & open_
        values[uid] = post
        if uid == pad_uid:
            values[pad_uid] = 0.0
        res_pre[j] = cur
        res_post[j] = post
        res_ok[j] = ok
    return len(cols[0])


def eval_lock(store: StateStore, ops: OpBatch, funs):
    """LOCK baseline == sequential oracle (conflict-equivalent ts order)."""
    n = ops.n_ops
    results = _empty_results(n, ops.width, store.device)
    values = store.values.clone()
    _sequential_sweep(values, ops, funs, results,
                      mask_flat=torch.ones((n,), dtype=torch.bool,
                                           device=store.device),
                      pad_uid=store.pad_uid)
    results = {k: v[:n] for k, v in results.items()}
    n_valid = torch.sum(ops.valid, dtype=I32)
    stats = EngineStats(rounds=n_valid,
                        n_chains=torch.ones((), dtype=I32,
                                            device=store.device),
                        max_chain=n_valid, n_ops=n, scheme="lock",
                        path="sequential")
    return results, values, stats


# ---------------------------------------------------------------------------
# MVLK: multiversion — writes serialize per chain, reads resolve in parallel
# ---------------------------------------------------------------------------
def _masked_positions(mask: torch.Tensor, ch: Chains) -> torch.Tensor:
    """Position of each op among the *masked* ops of its chain."""
    m = mask.to(I32)
    inc = torch.cumsum(m, dim=-1, dtype=I32)
    seg_base = torch.cummax(torch.where(ch.seg_start, inc - m,
                                        torch.zeros_like(inc)),
                            dim=-1).values
    return inc - seg_base - m


def eval_mvlk(store: StateStore, ops: OpBatch, funs, *,
              has_gates: bool = False, max_dep_levels: int = 3,
              prestructured: Optional[Prestructured] = None):
    """Writes run as lockstep chains; READs are version lookups.

    The results are the lockstep walk's; the stats count rounds over the
    write chains only (reads do not occupy a round).
    """
    if prestructured is None:
        prestructured = restructure(ops, store.pad_uid)
    sops, ch = prestructured
    is_write = sops.kind != int(OpKind.READ)
    write_pos = _masked_positions(is_write, ch)
    write_depth = torch.amax(torch.where(is_write, write_pos,
                                         torch.full_like(write_pos, -1))) + 1
    res, values, st = eval_tstream_lockstep(
        store, ops, funs, has_gates=has_gates, max_dep_levels=max_dep_levels,
        prestructured=prestructured)
    stats = dataclasses.replace(st, rounds=write_depth, scheme="mvlk",
                                path="mv")
    return res, values, stats


# ---------------------------------------------------------------------------
# PAT: partition-level locking (S-Store)
# ---------------------------------------------------------------------------
def _shifted_differs(x: torch.Tensor) -> torch.Tensor:
    """bool[N]: True at 0 and where x differs from the row before."""
    first = torch.ones(1, dtype=torch.bool, device=x.device)
    return torch.cat([first, x[1:] != x[:-1]])


def eval_pat(store: StateStore, ops: OpBatch, funs, *,
             n_partitions: int = 16):
    """Partitions advance ts-ordered fronts; a transaction fires only when
    it holds the front of *every* partition it touches (S-Store's
    counter-guarded partition-lock acquisition).  A txn's ops within one
    partition are contiguous after the (partition, ts, slot) sort, so
    readiness reduces to: each of the txn's per-partition blocks starts at
    that partition's front.  The reference's ``while_loop`` is a host loop
    with one read a round, bounded by N rounds as there.
    """
    n, dev, pad = ops.n_ops, store.device, store.pad_uid
    i32 = dict(dtype=I32, device=dev)
    part = torch.where(ops.valid, ops.uid % n_partitions,
                       torch.full_like(ops.uid, n_partitions))
    # lexsort((slot, ts, part)): stable sorts from the minor key up
    order = _stable_argsort(ops.slot)
    order = order[_stable_argsort(ops.ts[order])]
    order = order[_stable_argsort(part[order])]
    part_s = part[order].long()
    seg_start = _shifted_differs(part_s)
    idx = torch.arange(n, **i32)
    zero = torch.zeros(n, **i32)
    pos = idx - torch.cummax(torch.where(seg_start, idx, zero), 0).values
    sop = OpBatch(**{f.name: getattr(ops, f.name)[order]
                     for f in dataclasses.fields(OpBatch)})
    # (txn, partition) blocks: a txn's ops in one partition are contiguous
    # (same ts) and run under one lock acquisition
    blk_start = seg_start | _shifted_differs(sop.txn)
    blk_start_idx = torch.cummax(torch.where(blk_start, idx, zero), 0).values
    blk_front_pos = pos[blk_start_idx.long()]
    blk_id = (torch.cumsum(blk_start, 0, dtype=I32) - 1).long()
    blk_len = torch.zeros(n, **i32).index_add_(
        0, blk_id, torch.ones(n, **i32))[blk_id]
    # same-uid runs inside a block execute sequentially (slot order)
    uidrun_start = blk_start | _shifted_differs(sop.uid)
    txn_s = sop.txn.long()
    txn_total = torch.zeros(n, **i32).index_add_(0, ops.txn.long(),
                                                 ops.valid.to(I32))
    part_len = torch.zeros(n_partitions + 1, **i32).index_add_(
        0, part_s, torch.ones(n, **i32))
    fun_hit = torch.zeros(len(funs), **i32).index_add_(
        0, sop.fun.long(), sop.valid.to(I32))
    present = [k for k, c in enumerate(fun_hit.tolist()) if c > 0]

    results = _empty_results(n, ops.width, dev)
    values = store.values.clone()
    front = torch.zeros(n_partitions + 1, **i32)
    fired = torch.zeros(n, dtype=torch.bool, device=dev)
    gated, mate = sop.gate >= 0, sop.gate.clamp(min=0).long()
    uid_l, dst = sop.uid.long(), order.long()
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    rounds = 0
    while rounds < n and bool((~fired & sop.valid).any()):
        # the op's block holds its partition's lock: the front lies inside
        # the block (a partially executed block keeps the lock)
        fr = front[part_s]
        block_at_front = (fr >= blk_front_pos) & (fr < blk_front_pos + blk_len)
        candidate = (block_at_front | fired) & sop.valid
        txn_cand = torch.zeros(n, **i32).index_add_(0, txn_s,
                                                    candidate.to(I32))
        ready = (txn_cand >= txn_total) & (txn_total > 0)
        prev_fired = torch.cat([no, fired[:-1]])
        fire = (block_at_front & ~fired & sop.valid & ready[txn_s]
                & (uidrun_start | prev_fired))
        cur = values[uid_l]
        # intra-txn gates: mates fire in the same round, ungated first
        post0, ok0 = apply_funs(funs, sop.fun, cur, sop.operand, present)
        succ_now = torch.zeros(n, dtype=torch.bool, device=dev).index_copy_(
            0, dst, ok0 & fire & ~gated)
        succ_known = succ_now | results["success"][:n]
        open_ = torch.where(gated, succ_known[mate], True)
        post = torch.where(open_[:, None], post0, cur)
        ok = ok0 & open_
        # fired ops touch distinct states; the rest write 0 to the pad state
        scat = torch.where(fire, uid_l, torch.full_like(uid_l, pad))
        values[scat] = torch.where(fire[:, None], post,
                                   torch.zeros_like(post))
        values[pad] = 0.0
        sink = torch.where(fire, dst, torch.full_like(dst, n))
        results["pre"][sink] = cur
        results["post"][sink] = post
        results["success"][sink] = ok
        fired = fired | fire
        front = front + torch.zeros(n_partitions + 1, **i32).index_add_(
            0, part_s, fire.to(I32))
        rounds += 1
    results = {k: v[:n] for k, v in results.items()}
    stats = EngineStats(rounds=torch.tensor(rounds, **i32),
                        n_chains=torch.tensor(n_partitions, **i32),
                        max_chain=torch.amax(part_len[:n_partitions]),
                        n_ops=n, scheme="pat", path="partition",
                        swept=rounds)
    return results, values, stats


# ---------------------------------------------------------------------------
# No-Lock upper bound (incorrect by design)
# ---------------------------------------------------------------------------
def eval_nolock(store: StateStore, ops: OpBatch, funs):
    n, pad = ops.n_ops, store.pad_uid
    vals = store.values
    pre = vals[torch.where(ops.valid, ops.uid,
                           torch.full_like(ops.uid, pad)).long()]
    post, ok = apply_funs(funs, ops.fun, pre, ops.operand)
    scat = torch.where(ops.valid & (ops.kind != int(OpKind.READ)), ops.uid,
                       torch.full_like(ops.uid, pad)).long()
    # the reference's scatter applies duplicate indices in order, so the
    # last op to write a state wins; name it, so the card agrees
    last = torch.full((vals.shape[0],), -1, dtype=I32, device=vals.device)
    last.scatter_reduce_(0, scat, torch.arange(n, dtype=I32,
                                               device=vals.device), "amax")
    values = torch.where((last >= 0)[:, None], post[last.clamp(min=0).long()],
                         vals)
    values[pad] = 0.0
    one = torch.ones((), dtype=I32, device=vals.device)
    stats = EngineStats(rounds=one, n_chains=one * n, max_chain=one,
                        n_ops=n, scheme="nolock", path="parallel")
    return dict(pre=pre, post=post, success=ok), values, stats


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------
SCHEMES = ("tstream", "tstream_scan", "tstream_lockstep", "lock", "mvlk",
           "pat", "nolock")

# schemes whose evaluation consumes the restructured (chain-sorted) view
CHAIN_SCHEMES = frozenset(
    {"tstream", "tstream_scan", "tstream_lockstep", "mvlk"})


def evaluate(store: StateStore, ops: OpBatch, funs: Tuple[FunSpec, ...],
             scheme: str = "tstream", *, associative_only: bool = False,
             has_gates: bool = False, n_partitions: int = 16,
             max_dep_levels: int = 3, use_kernels: bool = True,
             prestructured: Optional[Prestructured] = None,
             rowmajor_ts: bool = False, restructure_method: str = "auto"):
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; choose from {SCHEMES}")
    if scheme in CHAIN_SCHEMES and prestructured is None:
        prestructured = restructure(ops, store.pad_uid,
                                    rowmajor_ts=rowmajor_ts,
                                    method=restructure_method,
                                    use_kernels=use_kernels)
    lockstep = dict(has_gates=has_gates, max_dep_levels=max_dep_levels,
                    prestructured=prestructured)
    if scheme == "tstream_scan" or (scheme == "tstream" and associative_only
                                    and not has_gates):
        return eval_tstream_scan(store, ops, funs, use_kernels=use_kernels,
                                 prestructured=prestructured)
    if scheme in ("tstream", "tstream_lockstep"):
        return eval_tstream_lockstep(store, ops, funs, **lockstep)
    if scheme == "mvlk":
        return eval_mvlk(store, ops, funs, **lockstep)
    if scheme == "pat":
        return eval_pat(store, ops, funs, n_partitions=n_partitions)
    if scheme == "nolock":
        return eval_nolock(store, ops, funs)
    return eval_lock(store, ops, funs)
