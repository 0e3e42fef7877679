"""Wrapper of the megakernel (``csrc/megakernel.cu``).

``fused_chain_eval`` is the megakernel rung's replacement for the staged
``tstream_scan_plan -> tstream_scan_coefs -> tstream_scan_execute`` pipeline
run interval after interval: it takes a whole stack of K sorted intervals
(a light OpBatch and its partition Chains with a leading interval axis) and
returns what K per-interval evaluations would, bit for bit, with the per-op
results already in flat (pre-sort) order.  ``values`` is ``[S, W]`` with op
and chain fields ``[K, N]``, or a batch of independent problems (the sharded
driver's shards): ``values`` ``[B, S, W]`` with fields ``[K, B, N]``.  The
pad slot is the last slot.  A CUDA tensor launches the kernel's three phases
(scan, carry, apply), which commit the carried state into ``values`` IN
PLACE and return it; an interval that does not fit one block's shared
memory raises.  A CPU tensor takes the plain twin, which returns a new
tensor.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..runtime import (LAUNCHES, check, check_tensor, costed, on_card,
                       smem_optin)
from .ref import fused_chain_stream_ref

NAME = "megakernel"
THREADS = 512
PHASES = 3      # launches per call: scan, carry, apply
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "megakernel_stream": [_P] * 14 + [_I] * 7 + [_P],
    "megakernel_smem_bytes": [_I, _I],
}


def megakernel_smem_bytes(n: int, w: int) -> int:
    """Shared memory one scan block needs for an interval of ``n`` rows of
    ``w`` lanes: the library's ``megakernel_smem_bytes`` (``csrc/
    megakernel.cu``; a card test holds the two equal), in Python so that
    the rung choice reads it without building the kernels."""
    return min(16 * n * w + 3 * n, 2 ** 31 - 1)


def cost(values: torch.Tensor, sops, ch, pad_uid: int, n_luts: int):
    """(bytes, operations) of one call on this data (it reads ``ch.counts``
    and the ops' flags, so it waits for the device).

    Bytes: each input of the function read once and each output written
    once: per row its chain-start flag, valid, fun, uid and flat position
    (14 B) and its success flag (1 B); per row and lane its operand, pre
    and post (12 B); the state in and out (8 B a slot and lane); the LUTs.
    The slot histograms are left out: the function finds each chain's end
    from the flags, and only this design reads them.  Operations: the
    scan's 3 per row, lane and step for the ceil(log2 L) steps this data
    needs (L each interval's longest chain other than the pad chain, or
    the pad chain where a row of it is valid), 8 per row and lane to
    compose and apply, 2 per touched slot and lane for the carry."""
    w = values.shape[-1]
    rows = sops.uid.numel()
    pad_valid = (sops.valid & (sops.uid == pad_uid)).any(dim=-1)
    longest = torch.maximum(
        ch.counts[..., :pad_uid].amax(dim=-1),
        torch.where(pad_valid, ch.counts[..., pad_uid], 0)).double()
    steps = torch.ceil(torch.log2(torch.clamp(longest, min=1)))
    n = sops.uid.shape[-1]
    touched = int((ch.counts[..., :pad_uid] > 0).sum())
    nbytes = (15.0 * rows + 12.0 * rows * w + 8.0 * values.numel()
              + 5.0 * n_luts)
    n_ops = (3.0 * float(steps.sum()) * n * w + 8.0 * rows * w
             + 2.0 * touched * w)
    return nbytes, n_ops


@costed(NAME, lambda out, values, sops, ch, pad_uid, *, a_lut, **_: cost(
    values, sops, ch, pad_uid, a_lut.numel()))
def fused_chain_eval(values: torch.Tensor, sops, ch, pad_uid: int, *,
                     a_lut: torch.Tensor, b_lut: torch.Tensor,
                     threads: int | None = None):
    """Evaluate every chain of a stack of restructured intervals, interval
    after interval, carrying the state.

    values: f32[S, W] state (S includes the pad slot, ``pad_uid = S - 1``)
    or f32[B, S, W]; sops: sorted light OpBatch (fields [K, N] or
    [K, B, N]); ch: its partition Chains (seg_start, order, counts).
    a_lut/b_lut: the app's simple-affine LUTs
    (``engines.simple_affine_luts``).  ``threads`` sets the block size of
    the scan and apply phases.  Returns ``(res, new_values, stats)``:
    ``res`` holds pre/post ``[K, (B,) N, W]`` and success ``[K, (B,) N]`` in
    flat layout; ``stats`` covers all K intervals.
    """
    if not on_card(values, NAME):
        return fused_chain_stream_ref(values, sops, ch, pad_uid,
                                      a_lut=a_lut, b_lut=b_lut)
    from ...core.engines import scan_stats

    dev = values.device
    lead = tuple(values.shape[:-2])
    check(len(lead) <= 1, NAME, f"values must be [S, W] or [B, S, W], got "
          f"{tuple(values.shape)}")
    check_tensor(values, NAME, "values", torch.float32, len(lead) + 2, dev)
    batch = lead[0] if lead else 1
    s, w = values.shape[-2:]
    check(pad_uid == s - 1, NAME, f"pad_uid {pad_uid} must be the last of "
          f"{s} slots")
    k, n = sops.operand.shape[0], sops.operand.shape[-2]
    rows = (k,) + lead + (n,)
    check_tensor(sops.operand, NAME, "operand", torch.float32, len(rows) + 1,
                 dev)
    check(tuple(sops.operand.shape) == rows + (w,), NAME,
          f"operand shape {tuple(sops.operand.shape)} does not match values "
          f"{tuple(values.shape)}: expected {rows + (w,)}")
    for what, x, dt, shape in (
            ("seg_start", ch.seg_start, torch.bool, rows),
            ("order", ch.order, torch.int32, rows),
            ("counts", ch.counts, torch.int32, rows[:-1] + (s,)),
            ("fun", sops.fun, torch.int32, rows),
            ("valid", sops.valid, torch.bool, rows),
            ("uid", sops.uid, torch.int32, rows)):
        check(x is not None, NAME, f"{what} is missing (the partition rung's "
              "Chains carry it)")
        check_tensor(x, NAME, what, dt, len(shape), dev)
        check(tuple(x.shape) == shape, NAME, f"{what} has shape "
              f"{tuple(x.shape)}, not {shape}")
    check_tensor(a_lut, NAME, "a_lut", torch.float32, 1, dev)
    check_tensor(b_lut, NAME, "b_lut", torch.bool, 1, dev)
    check(a_lut.shape == b_lut.shape, NAME, "a_lut and b_lut differ in size")
    threads = threads or THREADS
    check(threads % 32 == 0 and 32 <= threads <= 1024, NAME,
          f"threads={threads} must be a multiple of 32 in [32, 1024]")
    check(k > 0 and batch > 0 and n > 0 and w > 0, NAME,
          f"nothing to evaluate: {k} intervals of {batch} problems x {n} "
          f"rows x {w} lanes")
    smem, limit = megakernel_smem_bytes(n, w), smem_optin(dev)
    check(smem <= limit, NAME, f"an interval of {n} rows x {w} lanes needs "
          f"{smem} B of shared memory; a block holds at most {limit} B")
    lib = _build.library(NAME, SIGNATURES)
    pre = torch.empty_like(sops.operand)
    post = torch.empty_like(sops.operand)
    success = torch.empty_like(sops.valid)
    work = torch.empty((k * batch * w * (2 * n + 3 * s),),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):            # launch on the state's card
        err = lib.megakernel_stream(
            ch.seg_start.data_ptr(), sops.fun.data_ptr(),
            sops.valid.data_ptr(), sops.uid.data_ptr(),
            sops.operand.data_ptr(), ch.order.data_ptr(),
            ch.counts.data_ptr(), a_lut.data_ptr(), b_lut.data_ptr(),
            values.data_ptr(), pre.data_ptr(), post.data_ptr(),
            success.data_ptr(), work.data_ptr(), k, batch, n, w, s, pad_uid,
            threads, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(lib, err, NAME)
    LAUNCHES[NAME] += PHASES
    res = dict(pre=pre, post=post, success=success)
    return res, values, scan_stats(ch, n, "megakernel")
