"""Wrapper of the megakernel (``csrc/megakernel.cu``).

``fused_chain_eval`` is the megakernel rung's replacement for the staged
``tstream_scan_plan -> tstream_scan_coefs -> tstream_scan_execute`` pipeline
on one sorted interval: the same inputs (a sorted light OpBatch and its
partition Chains), the same outputs (sorted-layout results, new state values,
EngineStats), bit for bit.  It also takes a batch of independent problems
(the sharded driver's one interval of every shard): ``values`` ``[B, S, W]``
with op and chain fields ``[B, N]``.  A CUDA tensor launches the kernel, one
block per problem, which commits into ``values`` IN PLACE and returns it; a
shape whose interval does not fit one block's shared memory raises.  A CPU
tensor takes the plain twin, which returns a new tensor.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import LAUNCHES, check, check_tensor, on_card
from .ref import fused_chain_eval_ref

NAME = "megakernel"
THREADS = 1024
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "megakernel_fused_chain": [_P] * 10 + [_I] * 6 + [_P],
    "megakernel_smem_bytes": [_I, _I],
}


def fused_chain_eval(values: torch.Tensor, sops, ch, pad_uid: int, *,
                     a_lut: torch.Tensor, b_lut: torch.Tensor,
                     threads: int | None = None):
    """Evaluate all chains of a restructured interval (or of a batch of
    them) in one launch.

    values: f32[S, W] state (S includes the pad slot) or f32[B, S, W]; sops:
    sorted light OpBatch (fields [N] or [B, N]); ch: partition Chains (the
    twin reads counts/starts for the commit map).  a_lut/b_lut: the app's
    simple-affine LUTs (``engines.simple_affine_luts``).  Returns
    ``(res_sorted, new_values, stats)`` like ``tstream_scan_execute(...,
    raw=True)``.
    """
    if not on_card(values, NAME):
        return fused_chain_eval_ref(values, sops, ch, pad_uid,
                                    a_lut=a_lut, b_lut=b_lut)
    from ...core.engines import scan_stats

    dev = values.device
    lead = tuple(values.shape[:-2])
    check(len(lead) <= 1, NAME, f"values must be [S, W] or [B, S, W], got "
          f"{tuple(values.shape)}")
    check_tensor(values, NAME, "values", torch.float32, len(lead) + 2, dev)
    batch = lead[0] if lead else 1
    s, w = values.shape[-2:]
    n = sops.operand.shape[-2]
    check_tensor(sops.operand, NAME, "operand", torch.float32, len(lead) + 2,
                 dev)
    check(tuple(sops.operand.shape) == lead + (n, w), NAME,
          f"operand shape {tuple(sops.operand.shape)} does not match values "
          f"{tuple(values.shape)}")
    for what, x, dt in (("seg_start", ch.seg_start, torch.bool),
                        ("fun", sops.fun, torch.int32),
                        ("valid", sops.valid, torch.bool),
                        ("uid", sops.uid, torch.int32)):
        check_tensor(x, NAME, what, dt, len(lead) + 1, dev)
        check(tuple(x.shape) == lead + (n,), NAME, f"{what} has shape "
              f"{tuple(x.shape)}, not {lead + (n,)}")
    check_tensor(a_lut, NAME, "a_lut", torch.float32, 1, dev)
    check_tensor(b_lut, NAME, "b_lut", torch.bool, 1, dev)
    check(a_lut.shape == b_lut.shape, NAME, "a_lut and b_lut differ in size")
    check(0 <= pad_uid < s, NAME, f"pad_uid {pad_uid} outside {s} slots")
    threads = threads or THREADS
    check(threads % 32 == 0 and 32 <= threads <= 1024, NAME,
          f"threads={threads} must be a multiple of 32 in [32, 1024]")
    pre = torch.empty_like(sops.operand)
    post = torch.empty_like(sops.operand)
    if batch and n and w:
        lib = _build.library(NAME, SIGNATURES)
        smem = lib.megakernel_smem_bytes(n, w)
        limit = _build.smem_optin(lib)
        check(0 < smem <= limit, NAME, f"an interval of {n} rows x {w} lanes "
              f"needs {smem} B of shared memory; a block holds at most "
              f"{limit} B")
        err = lib.megakernel_fused_chain(
            ch.seg_start.data_ptr(), sops.fun.data_ptr(),
            sops.valid.data_ptr(), sops.uid.data_ptr(),
            sops.operand.data_ptr(), a_lut.data_ptr(), b_lut.data_ptr(),
            values.data_ptr(), pre.data_ptr(), post.data_ptr(), batch, n, w,
            s, pad_uid, threads, torch.cuda.current_stream(dev).cuda_stream)
        _build.check_launch(lib, err, NAME)
        LAUNCHES[NAME] += 1
    else:
        values[..., pad_uid, :] = 0.0
    res = dict(pre=pre, post=post, success=sops.valid.clone())
    return res, values, scan_stats(ch, n, "megakernel")
