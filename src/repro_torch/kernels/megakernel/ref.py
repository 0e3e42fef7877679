"""Plain-PyTorch twin of the megakernel: the staged pipeline, recomposed.

This is the staged ``plan -> coefs -> execute`` operation sequence inlined op
for op (the same LUT coefficient expansion, ``segmented_scan_affine`` and
compose / apply / commit arithmetic), so it equals the staged path bit for
bit.  It is the CPU path of ``ops.fused_chain_eval`` and the kernel's oracle
on the card, and takes the same leading batch of problems.
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
