"""The dry run's per-device memory (``mem.temp_bytes``, ``mem.peak_bytes``):
the live-bytes count of ``launch/hlo_analysis.ProgramTrace``.

* **Exact counts on small programs over meta tensors**: a chain of ops
  (each output its own buffer, freed with its last reference); views and
  in-place ops (nothing new); the tensors autograd saves and frees in
  ``torch.autograd.grad``; a ``torch.utils.checkpoint`` block (its
  activations freed in the forward, recomputed in the backward);
  ``optim.adamw_update_`` against ``adamw_update`` (the in-place form adds
  no parameter- or moment-sized buffer: the copies are the whole
  difference); a ``ShardMesh.one_shard`` all-gather and reduce-scatter (one
  shard's result, also from inside the collective's opaque region); no
  lost update when many threads register and free at once (a card's
  backward runs on the autograd engine's thread).
* **Orderings on smoke cells**, traced as the dry run traces them: remat
  "full" peaks below remat "none" in a train step, and the donated decode
  (``decode_step_``) at least the cache's bytes below the functional one
  (``decode_step``, which copies the cache) on the same inputs.

The identities on every dry-run cell (the live bytes at the call equal
``argument_bytes``, ``peak_bytes == argument_bytes + temp_bytes``) are held
by ``tests/torch_dryrun.check_cell``.
"""
import sys
import threading

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_arch
from repro_torch.core.mesh import ShardMesh
from repro_torch.launch.hlo_analysis import ProgramTrace
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import StepConfig
from repro_torch.models import (ShapeCfg, decode_step, decode_step_,
                                meta_cache, meta_params, moe_ep)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, \
    adamw_update_

from torch_dryrun import traced

N = 1 << 16                        # elements of one float32 buffer
B = 4 * N                          # its bytes


def _meta(*shape, **kw):
    return torch.empty(shape or (N,), device="meta", **kw)


def _bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in _flatten(tree))


def test_a_chain_counts_each_output_until_it_is_freed():
    x = _meta()
    with ProgramTrace() as t:
        assert t.hold([x, {"a": x}]) == B          # one storage, held once
        y = x * 2
        z = y + 1
        assert t.live_bytes == 3 * B
        del y
        assert t.live_bytes == 2 * B
        w = torch.cat([z, z])
        assert (t.live_bytes, t.peak_bytes) == (4 * B, 4 * B)
        del z, w
        s = x.sum()
    assert t.live_bytes == B + 4 and t.peak_bytes == 4 * B
    assert s.shape == ()


def test_views_and_in_place_ops_add_nothing():
    x = _meta(256, 256)
    with ProgramTrace() as t:
        t.hold(x)
        y = x.exp()
        views = [y.view(-1), y.t(), y[3], y.unsqueeze(0), y.detach(),
                 y.reshape(16, -1), y.expand(2, 256, 256), y.narrow(0, 1, 9)]
        y.add_(1)
        y.mul_(x)
        torch.exp(x, out=y)
        y[0].zero_()
        assert (t.live_bytes, t.peak_bytes) == (2 * B, 2 * B)
        del y
        assert t.live_bytes == 2 * B              # the views hold it
        del views
        assert t.live_bytes == B


def test_autograd_frees_what_it_saved():
    a = _meta(requires_grad=True)
    with ProgramTrace() as t:
        t.hold(a)
        b = a.exp()                      # saved for its backward
        c = (b * b).sum()                # b * b freed, b already saved
        assert t.live_bytes == 2 * B + 4 and t.peak_bytes == 3 * B + 4
        del b
        assert t.live_bytes == 2 * B + 4           # the graph holds b
        (g,) = torch.autograd.grad(c, a)
        # the backward: ones (4), then b * b's two operand gradients and
        # their sum into b's buffer at once, then d(exp); the graph frees
        # b after
        assert t.live_bytes == 2 * B + 4
        assert t.peak_bytes == 5 * B + 8
    assert g.shape == a.shape


def _block(x):
    return torch.sin(torch.sin(x))


@pytest.mark.parametrize("remat", [False, True], ids=["saved", "remat"])
def test_a_checkpoint_block_frees_its_activations(remat):
    a = _meta(requires_grad=True)
    with ProgramTrace() as t:
        t.hold(a)
        out = (checkpoint(_block, a, use_reentrant=False) if remat
               else _block(a))
        # the output, and sin(a) saved for the outer sin unless recomputed
        assert t.live_bytes == (2 * B if remat else 3 * B)
        fwd = t.peak_bytes
        (g,) = torch.autograd.grad(out.sum(), a)
        assert t.live_bytes == 3 * B               # a, out, g
    assert fwd == 3 * B                            # sin(a) alive once
    # the backward adds cos of each sin and their products; the recompute
    # brings sin(a) back first
    assert t.peak_bytes == 5 * B + 8
    assert g.shape == a.shape


def _adam_inputs():
    params = dict(w=_meta(64, 1024, dtype=torch.bfloat16),
                  b=_meta(1024, dtype=torch.bfloat16))
    cfg = AdamWConfig(state_dtype=torch.float32)
    state = adamw_init(params, cfg)
    grads = {k: torch.empty_like(v) for k, v in params.items()}
    return params, grads, state, cfg


@pytest.mark.parametrize("inplace", [True, False], ids=["donated",
                                                        "functional"])
def test_adamw_in_place_adds_no_leaf_sized_buffer(inplace):
    params, grads, state, cfg = _adam_inputs()
    update = adamw_update_ if inplace else adamw_update
    with ProgramTrace() as t:
        held = t.hold([params, grads, state])
        update(params, grads, state, cfg)
    copies = 0 if inplace else _bytes([params, state])
    w32 = 64 * 1024 * 4                 # the largest leaf in float32
    # beside the copies: the largest leaf's float32 temporaries, six at
    # once (m32, v32, the update, p in float32, lr times the update and
    # the new p), and six 0-d ones (the step, its float, the norm, the
    # clip and the two bias corrections)
    assert t.peak_bytes - held - copies == 6 * w32 + 6 * 4


def test_one_shard_collectives_count_one_shards_result():
    mesh = ShardMesh.one_shard((4, 2), ("data", "model"))
    x = (torch.empty((1, 8, 16), device="meta"),)
    blk = 8 * 16 * 4
    with ProgramTrace() as t:
        t.hold(x)
        (g,) = mesh.all_gather(x, "data", 0, dim=0, tiled=True)
        assert t.live_bytes == blk + 4 * blk          # x and the gather
        (r,) = mesh.reduce_scatter(x, "data", 0, dim=0)
        assert t.live_bytes == 5 * blk + blk // 4
        del g
    assert tuple(r.shape) == (1, 2, 16)
    assert t.live_bytes == blk + blk // 4
    assert t.peak_bytes == 5 * blk + blk // 4
    assert [k for k, _, _ in t.collectives] == ["all-gather",
                                                "reduce-scatter"]


def test_the_count_holds_under_racing_threads():
    """A card's backward runs on the autograd engine's thread beside the
    caller's: threads registering the same storages and freeing their own
    at once count each storage once and lose no update."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace = ProgramTrace()
    shared = [torch.empty(1024, device="meta") for _ in range(32)]

    def churn():
        for i in range(400):
            trace.hold(shared[i % len(shared)])
            x = torch.empty(1024, device="meta")
            trace.hold(x)
            del x

    try:
        threads = [threading.Thread(target=churn) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert trace.live_bytes == len(shared) * 4096
    assert trace.peak_bytes <= (len(shared) + 16) * 4096


# -- orderings on smoke cells -------------------------------------------------
MESH = MeshSpec({"data": 2, "model": 2})


def test_remat_full_peaks_below_none():
    cfg = get_arch("minicpm-2b").smoke()
    shape = ShapeCfg("t", 64, 8, "train")
    peaks = {r: traced(cfg, shape, MESH, StepConfig(remat=r))[0].peak_bytes
             for r in ("full", "none")}
    assert peaks["full"] < peaks["none"], peaks


def test_donated_decode_counts_the_cache_below_the_functional_one():
    cfg = get_arch("minicpm-2b").smoke()
    params, cache = meta_params(cfg), meta_cache(cfg, 2, 256)
    tokens = _meta(2, 1, dtype=torch.int32)
    peaks = {}
    try:
        for name, step in (("donated", decode_step_),
                           ("functional", decode_step)):
            with torch.no_grad(), ProgramTrace() as t:
                held = t.hold([params, cache, tokens])
                step(cfg, params, cache, tokens, 100)
            peaks[name] = t.peak_bytes - held
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    assert peaks["functional"] - peaks["donated"] >= _bytes(cache), peaks
