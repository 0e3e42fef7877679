"""Plain-PyTorch twins of the megakernel.

``fused_chain_eval_ref`` evaluates ONE interval: the staged ``plan -> coefs
-> execute`` operation sequence inlined op for op (the same LUT coefficient
expansion, ``segmented_scan_affine`` and compose / apply / commit
arithmetic), so it equals the staged path bit for bit; results in sorted
layout.  It takes a leading batch of problems.

``fused_chain_stream_ref`` evaluates a stack of K intervals the way the
kernel does, in three phases: the scans of every interval at once, a Python
loop over the intervals that carries each slot's state through its chain's
composed map, and the apply of every row at once; results in flat layout.
It equals a loop of ``fused_chain_eval_ref`` bit for bit, and is the CPU path
of ``ops.fused_chain_eval`` and the kernel's oracle on the card.
"""
from __future__ import annotations

import torch


def fused_chain_eval_ref(values: torch.Tensor, sops, ch, pad_uid: int, *,
                         a_lut: torch.Tensor, b_lut: torch.Tensor):
    from ...core.engines import scan_stats
    from ...core.restructure import (commit_from_histogram,
                                     segmented_scan_affine, take_along)

    n = sops.uid.shape[-1]
    fid = sops.fun.long()
    a = a_lut.to(sops.operand.dtype)[fid][..., None].expand(sops.operand.shape)
    b = torch.where(b_lut[fid][..., None], sops.operand,
                    torch.zeros_like(sops.operand))
    neutralize = (~sops.valid)[..., None]
    a = torch.where(neutralize, torch.ones_like(a), a)
    b = torch.where(neutralize, torch.zeros_like(b), b)

    A, B = segmented_scan_affine(a, b, ch.seg_start, exclusive=True)
    Ai = a * A
    Bi = a * B + b

    v0 = take_along(values, sops.uid)
    pre = A * v0 + B
    post = Ai * v0 + Bi

    commit_pos, commit_ok = commit_from_histogram(ch.counts, ch.starts)
    committed = take_along(post, commit_pos)
    new_values = torch.where(commit_ok[..., None], committed, values)
    new_values[..., pad_uid, :] = 0.0

    vmask = sops.valid[..., None]
    res = dict(pre=torch.where(vmask, pre, torch.zeros_like(pre)),
               post=torch.where(vmask, post, torch.zeros_like(post)),
               success=sops.valid.clone())
    return res, new_values, scan_stats(ch, n, "megakernel")


def fused_chain_stream_ref(values: torch.Tensor, sops, ch, pad_uid: int, *,
                           a_lut: torch.Tensor, b_lut: torch.Tensor):
    """``ops.fused_chain_eval``'s twin: fields ``[K, (B,) N]``, values
    ``[(B,) S, W]`` with ``pad_uid = S - 1``; returns flat-layout results,
    the new values (a new tensor) and the stats of all K intervals."""
    from ...core.engines import scan_stats
    from ...core.restructure import (commit_from_histogram,
                                     segmented_scan_affine, take_along)

    n = sops.uid.shape[-1]
    fid = sops.fun.long()
    a = a_lut.to(sops.operand.dtype)[fid][..., None].expand(sops.operand.shape)
    b = torch.where(b_lut[fid][..., None], sops.operand,
                    torch.zeros_like(sops.operand))
    neutralize = (~sops.valid)[..., None]
    a = torch.where(neutralize, torch.ones_like(a), a)
    b = torch.where(neutralize, torch.zeros_like(b), b)

    # scan: every interval at once; each chain's last row gives its slot's map
    A, B = segmented_scan_affine(a, b, ch.seg_start, exclusive=True)
    Ai = a * A
    Bi = a * B + b
    last, touched = commit_from_histogram(ch.counts, ch.starts)
    m_a, m_b = take_along(Ai, last), take_along(Bi, last)

    # carry: interval after interval, the state each interval starts from
    v = values.clone()
    v0 = torch.empty((sops.uid.shape[0],) + tuple(values.shape),
                     dtype=values.dtype, device=values.device)
    for k in range(v0.shape[0]):
        v0[k] = v
        v = torch.where(touched[k][..., None], m_a[k] * v + m_b[k], v)
        v[..., pad_uid, :] = 0.0

    # apply: every row at once, then back to flat layout
    x = take_along(v0, sops.uid)
    vmask = sops.valid[..., None]
    pre = torch.where(vmask, A * x + B, torch.zeros_like(x))
    post = torch.where(vmask, Ai * x + Bi, torch.zeros_like(x))
    res = dict(pre=ch.untake(pre), post=ch.untake(post),
               success=ch.untake(sops.valid))
    return res, v, scan_stats(ch, n, "megakernel")
