"""The CUDA kernels against their plain-PyTorch twins, on the card.

Every test here needs an NVIDIA card: it is marked ``cuda``, checks for the
card itself and skips without one.  The file imports no JAX, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: radix_partition, the megakernel (a stack of intervals, of one problem
or a batch, against its stream twin and against a loop of the per-interval
twin) and hash_probe bitwise; segscan_affine to rtol = atol = 1e-5 (the
kernel associates a segment's sums differently from the twin's Hillis-Steele
sweep), segscan_max bitwise where a case says so (a max is exact under any
association), and each scan bitwise from call to call.  Shapes the kernels
cannot take raise.  The sharded driver on the
card is held to the single-device driver on the card: bitwise on the
megakernel rung, to rtol = atol = 1e-5 where the staged rung's segscans run
(their association depends on where a chain lies among the kernel's tiles).
Its lockstep schedule (SL, OB) is bitwise with the single-device card run,
and the chunked service with ``run_stream`` on the card (TP to 1e-5).  The
service on a sharded engine migrates live under a skew storm, bitwise with
the single-device card run, and the replicate-everything baseline
(``evaluate_sharded``) matches the single-device card evaluation (GS
bitwise, TP to 1e-5).  The launch layer: expert-parallel MoE on the card
keeps the CPU's choices bit for bit at the default capacity, the padded
decode matches the unpadded one, and a chunk's traced cost
(``chunk_cost``) on the card equals the CPU's.  The kernel-dispatch search
(``kernels/autotune``) benches every candidate on a key's first call,
counts and traces nothing of it, reuses the decision, and reads it back
from the disk cache; its winner equals the default bit for bit.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS
from repro_torch.core import types as T
from repro_torch.core.engines import simple_affine_luts
from repro_torch.core.restructure import restructure
from repro_torch.core.mesh import ShardMesh
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.core.types import tree_index
from repro_torch.kernels.hash_probe.ops import hash_probe
from repro_torch.kernels.hash_probe.ref import build_table, hash_probe_ref
from repro_torch.kernels.megakernel.ops import fused_chain_eval
from repro_torch.kernels.megakernel.ref import (fused_chain_eval_ref,
                                                fused_chain_stream_ref)
from repro_torch.kernels.radix_partition.ops import radix_partition_rank
from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max
from repro_torch.kernels.segscan.ref import segscan_affine_ref, segscan_max_ref

from torch_parity import assert_outputs_close, need_card

pytestmark = pytest.mark.cuda

FUNS = (T.F_NOP, T.F_READ, T.F_PUT, T.F_ADD)


@pytest.mark.parametrize("bn,n,k", [(1, 1, 1), (200, 5000, 10_001),
                                    (3, 9000, 201), (200, 2000, 201),
                                    (2, 300, 50_000), (3, 5000, 100_001),
                                    (2, 3000, 1 << 20), (3, 12_000, 10_001),
                                    (2, 40_000, 5), (4, 12_000, 1),
                                    (800, 500, 3), (800, 2000, 101),
                                    (3, 5000, 127), (3, 5000, 128),
                                    (600, 1000, 4096), (600, 700, 4097),
                                    (140, 3000, 16_384), (140, 3000, 16_385),
                                    (140, 8192, 50), (140, 8193, 50)])
def test_radix_partition_matches_twin(bn, n, k):
    """Random keys, then rows of one key (every rank in one run); rows of
    12,000 and 40,000 keys span more than one staged chunk."""
    dev = need_card()
    g = torch.Generator().manual_seed(bn * n + k)
    random_keys = torch.randint(0, k, (bn, n), generator=g, dtype=torch.int32)
    one_key = torch.full((bn, n), k - 1, dtype=torch.int32)
    for keys in (random_keys.to(dev), one_key.to(dev)):
        reset_launches()
        r, c = radix_partition_rank(keys, k)
        r0, c0 = radix_partition_rank_ref(keys, k)
        assert LAUNCHES["radix_partition"] == 1
        assert torch.equal(r, r0) and torch.equal(c, c0)
        r1, c1 = radix_partition_rank(keys[0], k)      # one interval
        assert torch.equal(r1, r0[0]) and torch.equal(c1, c0[0])


def test_radix_partition_raises_on_what_it_cannot_take():
    """The key space has no cap (K = 2^20 ranks like the twin); a wrong
    dtype or layout raises."""
    dev = need_card()
    keys = torch.randint(0, 1 << 20, (2, 1000), dtype=torch.int32).to(dev)
    r, c = radix_partition_rank(keys, 1 << 20)
    r0, c0 = radix_partition_rank_ref(keys, 1 << 20)
    assert torch.equal(r, r0) and torch.equal(c, c0)
    keys = torch.zeros((2, 10), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        radix_partition_rank(keys.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        radix_partition_rank(keys.t(), 4)


@pytest.mark.parametrize("n,w,avg", [(1, 1, 2), (1000, 1, 3),
                                     (400_000, 32, 5), (77_777, 3, 500),
                                     (300_000, 1, 1e9)])
def test_segscan_matches_twin(n, w, avg):
    dev = need_card()
    g = torch.Generator().manual_seed(n + w)
    a = (torch.rand(n, w, generator=g) * 1.5).to(dev)
    b = ((torch.rand(n, w, generator=g) - 0.5) * 4).to(dev)
    f = (torch.rand(n, generator=g) < 1.0 / avg).to(dev)
    reset_launches()
    A, B = segscan_affine(a, b, f)
    M = segscan_max(b, f)
    assert LAUNCHES["segscan_affine"] == 1 and LAUNCHES["segscan_max"] == 1
    A0, B0 = segscan_affine_ref(f, a, b)
    M0 = segscan_max_ref(f, b)
    torch.testing.assert_close(A, A0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(B, B0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(M, M0, rtol=1e-5, atol=1e-5)


# The kernel's tiles (csrc/segscan.cu): 4,096 rows at W = 1, else 256 rows of
# a group of 32 lanes, scanned in chunks of 16 rows.
TILE_ROWS = {1: 4096, 32: 256}


def _segscan_inputs(n, w, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.rand(n, w, generator=g) * 1.5
    b = (torch.rand(n, w, generator=g) - 0.5) * 4
    return a, b


def _check_segscan(a, b, f):
    """Both scans against their twins: affine to 1e-5, max bitwise; one
    launch each."""
    reset_launches()
    A, B = segscan_affine(a, b, f)
    M = segscan_max(b, f)
    assert LAUNCHES["segscan_affine"] == 1 and LAUNCHES["segscan_max"] == 1
    A0, B0 = segscan_affine_ref(f, a, b)
    torch.testing.assert_close(A, A0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(B, B0, rtol=1e-5, atol=1e-5)
    assert torch.equal(M, segscan_max_ref(f, b))


@pytest.mark.parametrize("w", [1, 2, 3, 31, 32, 33, 64])
def test_segscan_at_every_width(w):
    """Widths below, at and across one lane group of 32; 5,000 rows is a
    multiple of no tile."""
    dev = need_card()
    a, b = _segscan_inputs(5000, w, w)
    g = torch.Generator().manual_seed(100 + w)
    f = torch.rand(5000, generator=g) < 0.05
    _check_segscan(a.to(dev), b.to(dev), f.to(dev))


@pytest.mark.parametrize("w", [1, 32])
@pytest.mark.parametrize("where", ["tiles", "chunks"])
def test_segscan_starts_on_tile_boundaries(w, where):
    """Segment starts exactly on every tile's first row (or on every chunk's
    first row) and nowhere else, over a ragged last tile."""
    dev = need_card()
    rows = TILE_ROWS[w]
    n = 5 * rows + 77
    a, b = _segscan_inputs(n, w, n)
    step = rows if where == "tiles" else 16
    f = torch.arange(n) % step == 0
    _check_segscan(a.to(dev), b.to(dev), f.to(dev))


@pytest.mark.parametrize("w", [1, 32])
def test_segscan_startless_run_across_many_tiles(w):
    """Starts at rows 0 and 50, then none for 250 tiles: each of those tiles
    waits on its predecessor's carry; then a start mid-tile and a ragged
    end."""
    dev = need_card()
    rows = TILE_ROWS[w]
    n = rows * 300 + 5
    a, b = _segscan_inputs(n, w, 7 + w)
    f = torch.zeros(n, dtype=torch.bool)
    f[[0, 50, rows * 250 + 3]] = True
    _check_segscan(a.to(dev), b.to(dev), f.to(dev))


@pytest.mark.parametrize("w", [1, 32])
def test_segscan_empty_stream(w):
    """N = 0: empty results of the input's shape, and no launch."""
    dev = need_card()
    a = torch.zeros((0, w), device=dev)
    f = torch.zeros((0,), dtype=torch.bool, device=dev)
    reset_launches()
    A, B = segscan_affine(a, a, f)
    M = segscan_max(a, f)
    assert A.shape == B.shape == M.shape == (0, w)
    assert LAUNCHES["segscan_affine"] == 0 and LAUNCHES["segscan_max"] == 0


@pytest.mark.parametrize("n,w,avg", [(400_000, 32, 5), (60_000, 32, 1e9),
                                     (1_000_000, 1, 5000)])
def test_segscan_is_deterministic(n, w, avg):
    """Five calls of each scan on the same input give the same bits: the
    carry across tiles is chained in a fixed order, never read early."""
    dev = need_card()
    a, b = _segscan_inputs(n, w, n + w)
    g = torch.Generator().manual_seed(n)
    f = torch.rand(n, generator=g) < 1.0 / avg
    a, b, f = a.to(dev), b.to(dev), f.to(dev)
    A, B = segscan_affine(a, b, f)
    M = segscan_max(b, f)
    for _ in range(4):
        A1, B1 = segscan_affine(a, b, f)
        assert torch.equal(A1, A) and torch.equal(B1, B)
        assert torch.equal(segscan_max(b, f), M)


def _mega_case(name, dev):
    rng = np.random.default_rng(7)
    if name == "odd_n_skewed":
        s = 37
        p = 1.0 / np.arange(1, s + 1, dtype=np.float64)
        uid, valid = rng.choice(s, 160, p=p / p.sum()), rng.random(160) > .15
    elif name == "single_chain":
        s, uid, valid = 8, np.full((40,), 3), np.ones((40,), bool)
    elif name == "all_pad":
        s, uid, valid = 8, rng.integers(0, 8, 24), np.zeros((24,), bool)
    elif name == "n1":
        s, uid, valid = 4, np.zeros((1,), np.int64), np.ones((1,), bool)
    else:   # a GS-sized interval: 5,000 rows over 10,000 slots
        s = 10_000
        uid, valid = rng.integers(0, s, 5000), rng.random(5000) > .01
    n = uid.shape[0]
    idx = torch.arange(n, dtype=torch.int32)
    ops = T.OpBatch(
        uid=torch.from_numpy(uid.astype(np.int32)), ts=idx // 4,
        txn=idx // 4, slot=idx % 4, kind=torch.zeros(n, dtype=torch.int32),
        fun=torch.from_numpy(rng.integers(0, len(FUNS), n).astype(np.int32)),
        gate=torch.full((n,), -1, dtype=torch.int32),
        operand=torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)),
        valid=torch.from_numpy(valid))
    ops = T.OpBatch(**{k: v.to(dev) for k, v in vars(ops).items()})
    sops, ch = restructure(ops, s, rowmajor_ts=True, light=True,
                           method="partition", geometry=False,
                           use_kernels=False)
    return sops, ch, s


def _fields(x, fn):
    """``fn`` applied to every tensor field of an OpBatch or Chains."""
    return type(x)(**{k: None if v is None else fn(v)
                      for k, v in vars(x).items()})


def _stack1(x):
    """A one-interval stack (leading axis of 1) of a plan's fields."""
    return _fields(x, lambda v: v[None])


def _assert_per_interval(res, vals, values, sops, ch, s, a_lut, b_lut):
    """A stream call's results against a loop of the per-interval twin,
    untaken to flat layout, bitwise."""
    v = values
    for k in range(sops.uid.shape[0]):
        chk = tree_index(ch, k)
        r0, v, _ = fused_chain_eval_ref(v, tree_index(sops, k), chk, s,
                                        a_lut=a_lut, b_lut=b_lut)
        for key in r0:
            assert torch.equal(res[key][k], chk.untake(r0[key])), (k, key)
    assert torch.equal(vals, v)


def _stream_case(k, b, n, s, invalid, theta, dev, w=1, dead=None,
                 on_pad=()):
    """A stack of K sorted intervals of ``b`` problems (``b = 0``: values
    [S+1, W], no batch axis) over ``s`` real slots, Zipf-skewed uids; the
    interval ``dead`` holds padding only; for each ``(interval, m)`` of
    ``on_pad`` the interval's first m ops are on the pad slot."""
    rng = np.random.default_rng(k * n + s)
    lead = (k, b) if b else (k,)
    p = 1.0 / np.arange(1, s + 1, dtype=np.float64) ** theta
    uid = rng.choice(s, lead + (n,), p=p / p.sum())
    for kk, m in on_pad:
        uid[kk, ..., :m] = s
    idx = torch.arange(n, dtype=torch.int32).expand(lead + (n,))
    ops = T.OpBatch(
        uid=torch.from_numpy(uid.astype(np.int32)), ts=idx // 10,
        txn=idx // 10, slot=idx % 10,
        kind=torch.zeros(lead + (n,), dtype=torch.int32),
        fun=torch.from_numpy(rng.integers(0, len(FUNS), lead + (n,)).astype(
            np.int32)),
        gate=torch.full(lead + (n,), -1, dtype=torch.int32),
        operand=torch.from_numpy(rng.normal(size=lead + (n, w)).astype(
            np.float32)),
        valid=torch.from_numpy(rng.random(lead + (n,)) >= invalid))
    if dead is not None:
        ops.valid[dead] = False
    ops = _fields(ops, lambda v: v.contiguous().to(dev))
    sops, ch = restructure(ops, s, rowmajor_ts=True, light=True,
                           method="partition", geometry=False,
                           use_kernels=False)
    values = torch.from_numpy(rng.normal(size=lead[1:] + (s + 1, w)).astype(
        np.float32)).to(dev)
    return sops, ch, values


@pytest.mark.parametrize("shape", ["gs", "sharded_gs"])
def test_stream_megakernel_matches_twins_at_main_path_shapes(shape):
    """The whole stream in one call at GS's shape (200 intervals x 5,000
    rows, W = 1, 10,001 slots) and at sharded GS's (200 x 4 shards x 2,504
    received rows, half of them padding, 2,501 slots a shard): bitwise
    against the stream twin and against a loop of the per-interval twin."""
    dev = need_card()
    if shape == "gs":
        s, b = 10_000, 0
        sops, ch, values = _stream_case(200, 0, 5000, s, 0.01, 0.6, dev)
    else:
        s, b = 2500, 4
        sops, ch, values = _stream_case(200, 4, 2504, s, 0.5, 0.6, dev)
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    reset_launches()
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, s, a_lut=a_lut,
                                    b_lut=b_lut)
    assert LAUNCHES["megakernel"] == 3
    res0, vals0, _ = fused_chain_stream_ref(values.clone(), sops, ch, s,
                                            a_lut=a_lut, b_lut=b_lut)
    assert torch.equal(vals, vals0)
    for key in res0:
        assert torch.equal(res[key], res0[key]), key
    _assert_per_interval(res, vals, values.clone(), sops, ch, s, a_lut, b_lut)
    for threads in (64, 1024):
        r1, v1, _ = fused_chain_eval(values.clone(), sops, ch, s,
                                     a_lut=a_lut, b_lut=b_lut,
                                     threads=threads)
        assert torch.equal(v1, vals)
        for key in r1:
            assert torch.equal(r1[key], res[key]), (threads, key)


def test_stream_megakernel_padding_interval_and_lanes():
    """A stack with an interval of padding only, W = 3 lanes and hot chains:
    bitwise against a loop of the per-interval twin."""
    dev = need_card()
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    sops, ch, values = _stream_case(7, 0, 300, 50, 0.3, 1.1, dev, w=3,
                                    dead=3)
    assert int(ch.counts[3, :50].sum()) == 0
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, 50,
                                    a_lut=a_lut, b_lut=b_lut)
    _assert_per_interval(res, vals, values.clone(), sops, ch, 50, a_lut,
                         b_lut)


@pytest.mark.parametrize("b", [0, 3])
def test_stream_megakernel_valid_rows_on_the_pad_slot(b):
    """Valid ops on the pad slot, in the first interval (they read its
    initial value) and in a later one whose pad chain is its longest chain
    (they read 0): bitwise against both twins."""
    dev = need_card()
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    sops, ch, values = _stream_case(5, b, 400, 60, 0.1, 0.8, dev, w=2,
                                    on_pad=((0, 9), (2, 250)))
    assert bool((sops.valid & (sops.uid == 60))[0].any())
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, 60,
                                    a_lut=a_lut, b_lut=b_lut)
    res0, vals0, _ = fused_chain_stream_ref(values.clone(), sops, ch, 60,
                                            a_lut=a_lut, b_lut=b_lut)
    assert torch.equal(vals, vals0)
    for key in res0:
        assert torch.equal(res[key], res0[key]), key
    _assert_per_interval(res, vals, values.clone(), sops, ch, 60, a_lut,
                         b_lut)


@pytest.mark.parametrize("case", ["odd_n_skewed", "single_chain", "all_pad",
                                  "n1", "gs_sized"])
def test_megakernel_matches_twin(case):
    """One interval (K = 1) against the per-interval twin, bitwise."""
    dev = need_card()
    sops, ch, s = _mega_case(case, dev)
    sops, ch = _stack1(sops), _stack1(ch)
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    values = torch.randn(s + 1, 2, device=dev)
    reset_launches()
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, s,
                                    a_lut=a_lut, b_lut=b_lut)
    assert LAUNCHES["megakernel"] == 3
    _assert_per_interval(res, vals, values.clone(), sops, ch, s, a_lut, b_lut)


def test_megakernel_raises_when_the_interval_overflows_a_block():
    dev = need_card()
    sops, ch, s = _mega_case("gs_sized", dev)
    sops, ch = _stack1(sops), _stack1(ch)
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    wide = T.OpBatch(**{**vars(sops),
                        "operand": sops.operand.repeat(1, 1, 8).contiguous()})
    with pytest.raises(ValueError, match="shared memory"):
        fused_chain_eval(torch.zeros(s + 1, 16, device=dev), wide, ch, s,
                         a_lut=a_lut, b_lut=b_lut)


@pytest.mark.parametrize("threads", [32, 96, 1024])
def test_kernels_at_other_block_sizes(threads):
    """The block size (``EngineConfig.kernel_block_params``) changes no bit:
    no kernel's association depends on it."""
    dev = need_card()
    g = torch.Generator().manual_seed(threads)
    keys = torch.randint(0, 10_001, (3, 5000), generator=g,
                         dtype=torch.int32).to(dev)
    r, c = radix_partition_rank(keys, 10_001, threads=threads)
    r0, c0 = radix_partition_rank(keys, 10_001)
    assert torch.equal(r, r0) and torch.equal(c, c0)
    many = torch.randint(0, 101, (600, 300), generator=g,
                         dtype=torch.int32).to(dev)   # a warp per row
    for k in (keys % 101, many):
        r, c = radix_partition_rank(k, 101, threads=threads)
        r0, c0 = radix_partition_rank_ref(k, 101)
        assert torch.equal(r, r0) and torch.equal(c, c0)
    a = torch.rand(40_000, 32, generator=g).to(dev)
    b = torch.randn(40_000, 32, generator=g).to(dev)
    f = (torch.rand(40_000, generator=g) < 0.2).to(dev)
    for x, y in zip(segscan_affine(a, b, f, threads=threads),
                    segscan_affine(a, b, f)):
        assert torch.equal(x, y)
    assert torch.equal(segscan_max(b, f, threads=threads), segscan_max(b, f))
    sops, ch, s = _mega_case("gs_sized", dev)
    sops, ch = _stack1(sops), _stack1(ch)
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    values = torch.randn(s + 1, 2, device=dev)
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, s, a_lut=a_lut,
                                    b_lut=b_lut, threads=threads)
    res0, vals0, _ = fused_chain_eval(values.clone(), sops, ch, s,
                                      a_lut=a_lut, b_lut=b_lut)
    assert torch.equal(vals, vals0)
    for k in res0:
        assert torch.equal(res[k], res0[k]), k
    with pytest.raises(ValueError, match="multiple of 32"):
        segscan_max(b, f, threads=48)


@pytest.mark.parametrize("app_name,method,interval,rung", [
    ("gs", "megakernel", 128, "megakernel"), ("tp", "partition", 128,
                                              "partition"),
    ("gs", "partition", 128, "partition"), ("gs", "auto", 4000, "packed"),
    ("gs", "megakernel", 4000, "partition")])
def test_engine_on_card_matches_cpu(app_name, method, interval, rung):
    """The port on the card (kernels) against the port on the CPU (twins):
    the final state bitwise for GS (its READ and PUT compose exactly on
    every rung) and where the path holds no segscan, else to rtol = atol =
    1e-5; outputs to 1e-5.  At 4,000 GS events (40,000 rows) an interval
    the megakernel's block cannot hold an interval, so "auto" and a forced
    megakernel take a staged rung on the card and launch no megakernel."""
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(11),
                            max(4 * 128, 2 * interval))
    cfg = EngineConfig(restructure_method=method)
    runs = {}
    for d in (dev, torch.device("cpu")):
        store = app.make_store(device=d)
        reset_launches()
        eng = DualModeEngine(app, store, cfg, device=d)
        runs[d.type] = eng.run_stream(store.values, stream, interval)
        if d.type == "cuda":
            assert eng.last_rung == rung
            assert LAUNCHES["radix_partition"] == int(rung != "packed")
            staged = rung != "megakernel"
            # one stream call of three launches, not one per interval
            assert LAUNCHES["megakernel"] == (0 if staged else 3)
            assert LAUNCHES["segscan_affine"] == (1 if staged else 0)
    (o1, v1), (o0, v0) = runs["cuda"], runs["cpu"]
    if app_name == "gs" or rung == "megakernel":
        assert torch.equal(v1.cpu(), v0)
    else:
        torch.testing.assert_close(v1.cpu(), v0, rtol=1e-5, atol=1e-5)
    assert_outputs_close(o1, o0, f"{app_name} card vs cpu")


def _overdraw(stream):
    stream["amount"] = (stream["amount"] * 100).astype(np.float32)


@pytest.mark.parametrize("app_name,abort_repass", [
    ("sl", False), ("ob", False), ("sl", True)])
def test_lockstep_app_on_card_matches_cpu(app_name, abort_repass):
    """SL and OB take the lockstep path.  Forced "partition" on the card
    launches radix_partition once for the stream and nothing else, and the
    final state and every output are bitwise with the CPU run (the walk is
    elementwise, no scan): on an overdrawn SL stream under the abort
    repass too, where transfers abort."""
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(11), 4 * 128)
    if abort_repass:
        _overdraw(stream)
    cfg = EngineConfig(restructure_method="partition",
                       abort_repass=abort_repass)
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng = DualModeEngine(app, app.make_store(device=d), cfg, device=d)
        reset_launches()
        runs[d.type] = eng.run_stream(eng.init_store.values, stream, 128)
        if d.type == "cuda":
            assert eng.last_rung == "partition"
            assert dict(LAUNCHES) == dict(radix_partition=1, segscan_affine=0,
                                          segscan_max=0, megakernel=0,
                                          hash_probe=0)
            assert all(s.path == "lockstep" and s.swept > 0
                       for s in eng.last_stats)
    (o1, v1), (o0, v0) = runs["cuda"], runs["cpu"]
    assert torch.equal(v1.cpu(), v0)
    for a, b in zip(o1, o0):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if abort_repass:
        assert sum(int(o["rejected"].sum()) for o in o0) > 0


@pytest.mark.parametrize("app_name", ["sl", "ob"])
@pytest.mark.parametrize("scheme", ["tstream_lockstep", "mvlk", "pat"])
def test_baselines_on_card_match_lock_oracle(app_name, scheme):
    """The lockstep walk and the mvlk and pat schedules on the card against
    the sequential lock schedule on the CPU (4 x 64 events): the state and
    the outputs to rtol = atol = 1e-5, as the reference holds its schemes
    to its oracle."""
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(7), 256)
    got = DualModeEngine(app, app.make_store(device=dev),
                         EngineConfig(scheme=scheme), device=dev)
    ref = DualModeEngine(app, app.make_store(device="cpu"),
                         EngineConfig(scheme="lock"), device="cpu")
    o1, v1 = got.run_stream(got.init_store.values, stream, 64)
    o0, v0 = ref.run_stream(ref.init_store.values, stream, 64)
    torch.testing.assert_close(v1.cpu(), v0, rtol=1e-5, atol=1e-5)
    assert_outputs_close(o1, o0, f"{app_name}/{scheme} vs lock")


@pytest.mark.parametrize("app_name", ["sl", "ob"])
def test_nolock_on_card_matches_cpu(app_name):
    """nolock lets the last op to write a state win, on the card as on the
    CPU: bitwise."""
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(7), 256)
    runs = []
    for d in (dev, torch.device("cpu")):
        eng = DualModeEngine(app, app.make_store(device=d),
                             EngineConfig(scheme="nolock"), device=d)
        runs.append(eng.run_stream(eng.init_store.values, stream, 64))
    (o1, v1), (o0, v0) = runs
    assert torch.equal(v1.cpu(), v0)
    for a, b in zip(o1, o0):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_megakernel_smem_formula_matches_library():
    """The rung choice's Python formula of the scan block's shared memory
    is the library's, over a grid of (rows, lanes)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.megakernel import ops as mops
    need_card()
    lib = _build.library(mops.NAME, mops.SIGNATURES)
    for n in (1, 7, 500, 5000, 12_234, 12_235, 40_000, 1 << 20):
        for w in (1, 2, 3, 32, 33, 128):
            assert mops.megakernel_smem_bytes(n, w) == \
                lib.megakernel_smem_bytes(n, w), (n, w)


@pytest.mark.parametrize("n_keys,n_buckets,n_queries", [
    (10_000, 2500, 1_000_000), (200, 64, 400_000), (50, 64, 1),
    (4000, 2048, 1000), (10_000, 2500, 999_999), (7, 1, 30), (20, 3, 1003),
    (40_000, 10_000, 100_003)])
def test_hash_probe_matches_twin(n_keys, n_buckets, n_queries):
    """Present, absent and sign-bit keys; ragged query counts; fewer than 4
    buckets (probes wrap); a table too large to stage in shared memory
    (10,000 buckets, 320 KB); and every query view one element into its
    storage."""
    dev = need_card()
    rng = np.random.default_rng(n_keys + n_queries)
    keys = (np.arange(n_keys, dtype=np.int32) if n_keys != 4000 else
            rng.choice(2**31 - 1, n_keys, replace=False).astype(np.int32))
    table = torch.from_numpy(build_table(keys, n_buckets)).to(dev)
    q = rng.choice(keys, n_queries).astype(np.int32)
    if n_queries >= 8:   # absent keys, and keys past the sign bit
        q[:4] = [-1, -(2**31), 2**31 - 1, n_keys + 3]
    q = torch.from_numpy(q).to(dev)
    reset_launches()
    got = hash_probe(q, table)
    assert LAUNCHES["hash_probe"] == 1
    want = hash_probe_ref(q, table)
    assert torch.equal(got, want)
    for threads in (32, 96, 256, 1024):   # either kernel's default too
        assert torch.equal(hash_probe(q, table, threads=threads), want)
    storage = torch.empty(n_queries + 1, dtype=torch.int32, device=dev)
    storage[1:] = q
    view = storage[1:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(hash_probe(view, table), want)


def test_hash_probe_raises_on_what_it_cannot_take():
    dev = need_card()
    table = torch.full((64, 8), -1, dtype=torch.int32, device=dev)
    q = torch.zeros(10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        hash_probe(q.long(), table)
    with pytest.raises(ValueError, match="n_buckets"):
        hash_probe(q, table[:, :4].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        hash_probe(q, table, threads=48)


def test_batched_megakernel_matches_twin_and_single_calls():
    """One call over a batch of problems (the sharded driver's interval of
    every shard) equals the twins and one call per problem, bitwise."""
    dev = need_card()
    rng = np.random.default_rng(3)
    b, s, n = 4, 2000, 1500
    idx = torch.arange(n, dtype=torch.int32).repeat(b, 1)
    uid = rng.integers(0, s, (b, n))
    uid[1] = 5                                       # one long chain
    ops = T.OpBatch(
        uid=torch.from_numpy(uid.astype(np.int32)), ts=idx // 4,
        txn=idx // 4, slot=idx % 4,
        kind=torch.zeros((b, n), dtype=torch.int32),
        fun=torch.from_numpy(rng.integers(0, len(FUNS), (b, n)).astype(
            np.int32)),
        gate=torch.full((b, n), -1, dtype=torch.int32),
        operand=torch.from_numpy(rng.normal(size=(b, n, 2)).astype(
            np.float32)),
        valid=torch.from_numpy(rng.random((b, n)) > 0.1))
    ops = T.OpBatch(**{k: v.to(dev) for k, v in vars(ops).items()})
    sops, ch = restructure(ops, s, rowmajor_ts=True, light=True,
                           method="partition", geometry=False,
                           use_kernels=False)
    sops, ch = _stack1(sops), _stack1(ch)
    a_lut, b_lut = simple_affine_luts(FUNS, dev)
    values = torch.randn(b, s + 1, 2, device=dev)
    reset_launches()
    res, vals, _ = fused_chain_eval(values.clone(), sops, ch, s,
                                    a_lut=a_lut, b_lut=b_lut)
    assert LAUNCHES["megakernel"] == 3
    _assert_per_interval(res, vals, values.clone(), sops, ch, s, a_lut, b_lut)
    for i in range(b):
        def one(x):
            return _fields(x, lambda v: v[:, i].contiguous())
        r1, v1, _ = fused_chain_eval(values[i].clone(), one(sops), one(ch), s,
                                     a_lut=a_lut, b_lut=b_lut)
        assert torch.equal(v1, vals[i])
        for k in r1:
            assert torch.equal(r1[k], res[k][:, i]), k


@pytest.mark.parametrize("app_name,method,layout,shape,names,probe", [
    ("gs", "megakernel", "shared_nothing", (4,), ("dev",), True),
    ("gs", "megakernel", "shared_per_socket", (2, 2), ("socket", "core"),
     False),
    ("gs", "partition", "shared_everything", (4,), ("dev",), False),
    ("tp", "partition", "shared_per_socket", (2, 2), ("socket", "core"),
     True)])
def test_sharded_on_card_matches_single_device_on_card(
        app_name, method, layout, shape, names, probe):
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(11), 4 * 128)
    store = app.make_store(device=dev)
    cfg = EngineConfig(restructure_method=method, use_hash_probe_route=probe)
    o0, v0 = DualModeEngine(app, store, cfg, device=dev).run_stream(
        store.values, stream, 128)
    eng = DualModeEngine(app, store, cfg, device=dev,
                         mesh=ShardMesh(shape, names, device=dev),
                         layout=layout, exchange_slack=8.0)
    reset_launches()
    o1, v1 = eng.run_stream(store.values, stream, 128)
    assert int(np.sum(eng.last_exchange_stats["dropped"])) == 0
    assert LAUNCHES["radix_partition"] == 2       # exchange + restructure
    assert LAUNCHES["hash_probe"] == (1 if probe else 0)
    if method == "megakernel":
        # shared_nothing: one stream call; a merging layout one per interval
        calls = 1 if layout == "shared_nothing" else 4
        assert LAUNCHES["megakernel"] == 3 * calls
        assert torch.equal(v1, v0)
    else:
        assert LAUNCHES["segscan_affine"] == 1
        torch.testing.assert_close(v1, v0, rtol=1e-5, atol=1e-5)
    assert_outputs_close(o1, o0, f"{app_name}/{layout} sharded vs single")


@pytest.mark.parametrize("app_name,method,case", [
    ("sl", "partition", "plain"), ("sl", "auto", "plain"),
    ("ob", "partition", "plain"), ("sl", "partition", "abort_repass"),
    ("sl", "partition", "residue")])
def test_sharded_lockstep_on_card_matches_single_device_on_card(
        app_name, method, case):
    """The sharded lockstep schedule (4 shards, shared_nothing) on the card:
    state and outputs bitwise with the single-device card run and with the
    sharded CPU run, no op dropped; the exchange's owner bucketing launches
    radix_partition once, and forced "partition" once more to restructure.
    ``abort_repass`` and ``residue`` (max_dep_levels=0) run the overdrawn
    stream."""
    dev = need_card()
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(11), 4 * 128)
    cfg = dict(restructure_method=method)
    if case != "plain":
        _overdraw(stream)
        cfg.update(abort_repass=True) if case == "abort_repass" else \
            cfg.update(max_dep_levels=0)
    cfg = EngineConfig(**cfg)
    store = app.make_store(device=dev)
    o0, v0 = DualModeEngine(app, store, cfg, device=dev).run_stream(
        store.values, stream, 128)
    runs = {}
    for d in (dev, torch.device("cpu")):
        eng = DualModeEngine(app, app.make_store(device=d), cfg, device=d,
                             mesh=ShardMesh((4,), ("dev",), device=d),
                             exchange_slack=8.0)
        reset_launches()
        runs[d.type] = eng.run_stream(eng.init_store.values, stream, 128)
        st = eng.last_exchange_stats
        assert int(np.sum(st["dropped"])) == 0
        if d.type == "cuda":
            assert LAUNCHES["radix_partition"] == (
                2 if method == "partition" else 1)
            assert eng.last_rung == ("partition" if method == "partition"
                                     else "packed")
            if case == "residue":
                assert int(st["residue"]) > 0
    (o1, v1), (oc, vc) = runs["cuda"], runs["cpu"]
    assert torch.equal(v1, v0)
    assert torch.equal(v1.cpu(), vc)
    for a, b, c in zip(o1, o0, oc):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)


@pytest.mark.parametrize("app_name,method", [
    ("gs", "megakernel"), ("tp", "partition"), ("sl", "partition")])
def test_service_on_card_matches_run_stream_on_card(app_name, method):
    """One chunked service run per path against ``run_stream`` on the card:
    GS on the megakernel rung (one stream call, three launches, a chunk)
    and SL on the lockstep path bitwise; TP on the staged rung within
    rtol = atol = 1e-5 (the affine segscan associates by tile, and a chunk
    puts chains at other tile offsets than the whole stream)."""
    from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
    from repro_torch.runtime.service import ServiceConfig, StreamService
    dev = need_card()
    app = ALL_APPS[app_name]
    eng = DualModeEngine(app, app.make_store(device=dev),
                         EngineConfig(restructure_method=method), device=dev)
    src = ReplaySource(app.gen_events, 8 * 128, seed=3, arrival_batch=100,
                       jitter=20)
    o0, v0 = eng.run_stream(eng.init_store.values, src.in_order_events, 128)
    reset_launches()
    rec = StreamService(eng, ServiceConfig(
        punct_interval=128, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=20))).run(src)
    assert len(rec.outputs) == 8 and rec.stats["processed"] == 8 * 128
    if method == "megakernel":
        assert LAUNCHES["megakernel"] == 3 * 4
    else:
        assert LAUNCHES["radix_partition"] == 4
    if app_name == "tp":
        assert LAUNCHES["segscan_affine"] == LAUNCHES["segscan_max"] == 4
        np.testing.assert_allclose(rec.final_values, v0.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert_outputs_close(rec.outputs, o0, "tp service vs run_stream")
    else:
        np.testing.assert_array_equal(rec.final_values, v0.cpu().numpy())
        for a, b in zip(rec.outputs, o0):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_elastic_service_on_card_matches_single_device_on_card():
    """The service on a 4-shard shared_nothing engine on the card (GS,
    megakernel rung) live-migrates under an aligned skew storm with no op
    dropped; state and outputs bitwise with the single-device card run.
    Each chunk launches radix_partition for the exchange and the
    restructure and one megakernel stream call; each migration one more
    radix_partition for its moved rows."""
    from repro_torch.core.intervals import PhasedReplaySource, WatermarkPolicy
    from repro_torch.runtime.controller import ControllerConfig
    from repro_torch.runtime.service import ServiceConfig, StreamService
    dev = need_card()
    app = ALL_APPS["gs"]
    cfg = EngineConfig(restructure_method="megakernel")
    src = PhasedReplaySource(
        app.gen_events, [(4 * 128, {}),
                         (8 * 128, dict(theta=2.5, align_mod=4)),
                         (4 * 128, {})], seed=7, arrival_batch=100, jitter=20)
    one = DualModeEngine(app, app.make_store(device=dev), cfg, device=dev)
    o0, v0 = one.run_stream(one.init_store.values, src.in_order_events, 128)
    eng = DualModeEngine(app, app.make_store(device=dev), cfg, device=dev,
                         mesh=ShardMesh((4,), ("dev",), device=dev),
                         exchange_slack=4.0)
    reset_launches()
    rec = StreamService(eng, ServiceConfig(
        punct_interval=128, chunk_intervals=2,
        watermark=WatermarkPolicy(allowed_lateness=20),
        controller=ControllerConfig(
            window=4, sustain=2, cooldown=4, slack_widen=False,
            reshard_imbalance=3.0, reshard_max_moves=24))).run(src)
    migs = rec.stats["placement"]["migrations"]
    assert migs and rec.stats["placement"]["moved_rows"] > 0
    assert rec.stats["drops"]["exchange"] == 0
    assert LAUNCHES["megakernel"] == 3 * 8
    assert LAUNCHES["radix_partition"] == 2 * 8 + len(migs)
    np.testing.assert_array_equal(rec.final_values, v0.cpu().numpy())
    for a, b in zip(rec.outputs, o0):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(rec.outputs) == len(o0) == 16


@pytest.mark.parametrize("app_name", ["gs", "tp"])
@pytest.mark.parametrize("layout,shape,names", [
    ("shared_nothing", (4,), ("dev",)),
    ("shared_per_socket", (2, 2), ("socket", "core")),
    ("shared_everything", (4,), ("dev",))])
def test_evaluate_sharded_on_card_matches_single_device(app_name, layout,
                                                        shape, names):
    """The replicate-everything baseline on the card, forced "partition":
    one radix_partition launch (every shard's local batch at once) and one
    segscan_affine; the new state bitwise with the single-device card
    evaluation for GS, to rtol = atol = 1e-5 for TP (the affine segscan
    associates by tile)."""
    from repro_torch.convert import events_to_torch
    from repro_torch.core.blotter import build_opbatch
    from repro_torch.core.engines import eval_tstream_scan
    from repro_torch.core.sharded import evaluate_sharded
    dev = need_card()
    app = ALL_APPS[app_name]
    store = app.make_store(device=dev)
    ev = app.gen_events(np.random.default_rng(5), 500)
    ops, _ = build_opbatch(app, store, events_to_torch(ev, dev), 0)
    _, want, _ = eval_tstream_scan(store, ops, app.funs, rowmajor_ts=True,
                                   restructure_method="partition")
    reset_launches()
    got = evaluate_sharded(store, ops, app.funs,
                           ShardMesh(shape, names, device=dev), layout,
                           restructure_method="partition")
    assert LAUNCHES["radix_partition"] == 1
    assert LAUNCHES["segscan_affine"] == 1
    if app_name == "gs":
        assert torch.equal(got, want[:-1])
    else:
        torch.testing.assert_close(got, want[:-1], rtol=1e-5, atol=1e-5)


def test_pipeline_on_card_matches_cpu():
    """The data pipeline's TStream stats on the card: 20 intervals of 64
    documents, one segscan_affine launch each (the packed rung: no radix
    launch), state and outputs bitwise with the CPU run (the sums are of
    integers below 2**24, exact in any order)."""
    from repro_torch.data import PipelineConfig, StreamingPipeline
    dev = need_card()
    runs = {}
    for d in (dev, torch.device("cpu")):
        reset_launches()
        pipe = StreamingPipeline(PipelineConfig(), device=d)
        rng = np.random.default_rng(3)
        outs = [pipe.ingest(rng, 64) for _ in range(20)]
        runs[d.type] = (pipe.stats_values.cpu(), outs, dict(LAUNCHES),
                        pipe.engine.last_rung)
    (v1, o1, l1, r1), (v0, o0, _, _) = runs["cuda"], runs["cpu"]
    assert torch.equal(v1, v0) and r1 == "packed"
    assert l1["segscan_affine"] == 20 and l1["radix_partition"] == 0
    for a, b in zip(o1, o0):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["minicpm-2b", "moonshot-v1-16b-a3b",
                                  "zamba2-2.7b", "deepseek-v3-671b"])
def test_train_step_on_card_is_deterministic(arch):
    """Three bf16 train steps (the launcher's step: remat "dots", AdamW,
    WSD) from the same init, run twice on the card: params, optimizer
    state and losses bitwise equal (the exact-resume contract needs it)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import PipelineConfig, StreamingPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = need_card()
    cfg = get_arch(arch).smoke()
    opt = AdamWConfig(lr=3e-3)
    step = make_train_step(cfg, opt, 10)
    pipe = StreamingPipeline(PipelineConfig(vocab=cfg.vocab, seq_len=64,
                                            batch=4), device=dev)
    runs = []
    for _ in range(2):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)
        state, losses = adamw_init(params, opt), []
        for i in range(3):
            params, state, loss = step(params, state, pipe.batch_for_step(i))
            losses.append(loss)
        runs.append((params, state, losses))
    from repro_torch.ckpt.checkpoint import _flatten
    (p0, s0, l0), (p1, s1, l1) = runs
    assert all(torch.isfinite(x) for x in l0)
    for (path, a), (_, b) in zip(_flatten([p0, s0, l0]),
                                 _flatten([p1, s1, l1])):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch,tol", [("granite-34b", 2e-2),
                                      ("mamba2-2.7b", 5e-2)])
def test_decode_matches_prefill_on_card(arch, tol):
    """The serve launcher's decode loop on the card, float32 params: each
    step's logits against ``forward`` over the same tokens, at the
    reference's bars (dense 2e-2, SSM 5e-2)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import forward, init_params
    dev = need_card()
    cfg = get_arch(arch).smoke()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.float32, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32)).to(dev)
    gen, steps = generate(cfg, params, prompt, 8)
    with torch.no_grad():
        full = forward(cfg, params, dict(tokens=torch.cat([prompt, gen], 1)),
                       remat="none")
    torch.testing.assert_close(steps, full, rtol=tol, atol=tol)


def test_ep_on_card_matches_cpu_kept_mask_bitwise():
    """Expert-parallel MoE on a (2, 4) mesh at the default capacity factor
    1.25, where choices are dropped: the card's kept mask equals the CPU's
    bit for bit and the output agrees within 1e-4 of its largest
    magnitude (float32)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model, moe_ep
    dev = need_card()
    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    p = model._moe_params(cfg, model._Init(torch.Generator().manual_seed(1),
                                           torch.float32, torch.device("cpu")))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(8, 64, cfg.d_model)).astype(np.float32))
    runs = {}
    try:
        for d in ("cpu", dev):
            mesh = make_host_mesh(model=4, data=2, device=d)
            moe_ep.set_ep_mesh(mesh, ("data",))
            pd = {k: v.to(d) for k, v in p.items()}
            lay = moe_ep.TokenLayout.of(mesh, 8, 64, ("data",), "model")
            st = lay.split(x.to(d))
            r = moe_ep.route(cfg, st.reshape(8, -1, cfg.d_model),
                             pd["router"], 8, cfg.n_experts // 8)
            with torch.no_grad():
                out = moe_ep.moe_forward_ep(cfg, pd, x.to(d))
            runs[torch.device(d).type] = (r.keep.cpu(), out.cpu())
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    (k1, o1), (k0, o0) = runs["cuda"], runs["cpu"]
    assert torch.equal(k1, k0) and not bool(k0.all())
    assert float((o1 - o0).abs().max()) <= 1e-4 * float(o0.abs().max())


def test_padded_decode_on_card_matches_unpadded():
    """``build_decode_step`` on a 16-way model axis pads a 36-head MHA
    config to 48 heads; its logits on the card match the unpadded decode
    on the card within rtol = atol = 2e-4 (float32)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.launch.steps import StepConfig, build_decode_step
    from repro_torch.models import ShapeCfg, decode_step, init_cache, \
        init_params
    from repro_torch.models.serving import pad_params_for_serving, \
        serving_padded
    dev = need_card()
    cfg = dataclasses.replace(get_arch("minicpm-2b").smoke(), n_heads=36,
                              n_kv_heads=36)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                         dtype=torch.float32, device=dev)
    fn, _ = build_decode_step(cfg, ShapeCfg("d", 16, 2, "decode"),
                              MeshSpec({"data": 1, "model": 16}),
                              StepConfig())
    padded = serving_padded(cfg, 16)
    assert padded.n_heads == 48
    pp = pad_params_for_serving(cfg, padded, params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 1)).astype(np.int32)).to(dev)
    c0 = init_cache(cfg, 2, 16, dtype=torch.float32, device=dev)
    c1 = init_cache(padded, 2, 16, dtype=torch.float32, device=dev)
    for pos in range(3):
        with torch.no_grad():
            l0, c0 = decode_step(cfg, params, c0, tokens, pos)
        l1, c1 = fn(pp, c1, tokens, pos)
        torch.testing.assert_close(l1, l0, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("app_name,method", [("gs", "megakernel"),
                                             ("gs", "partition"),
                                             ("tp", "partition")])
def test_chunk_cost_on_card_equals_cpu(app_name, method):
    """``chunk_cost`` of the same chunk on the card and on the CPU: the same
    kernel calls at the same ``cost()``, the same FLOPs and bytes written
    (a kernel call's own aten ops are not recorded on either side, and a
    copy between host and card is a transfer)."""
    from repro_torch.convert import events_to_torch
    from repro_torch.launch.hlo_analysis import analyze
    dev = need_card()
    app = ALL_APPS[app_name]
    ev = app.gen_events(np.random.default_rng(4), 4 * 256)
    costs = {}
    for d in ("cpu", dev):
        store = app.make_store(device=d)
        batched = events_to_torch({k: v.reshape((4, 256) + v.shape[1:])
                                   for k, v in ev.items()}, d)
        eng = DualModeEngine(app, store,
                             EngineConfig(restructure_method=method), device=d)
        reset_launches()
        _, trace = eng.chunk_cost(store.values, batched, 0)
        c = analyze(trace)
        costs[torch.device(d).type] = (trace.kernels, c["dot_flops"],
                                       c["bytes_written"], dict(LAUNCHES))
    (k1, f1, b1, l1), (k0, f0, b0, _) = costs["cuda"], costs["cpu"]
    assert k1 == k0 and f1 == f0 and b1 == b0
    assert l1["radix_partition"] == 1


# -- the kernel-dispatch search (kernels/autotune) on the card ----------------
def _search_call(kernel, dev):
    """(call(threads), twin(), exact): one wrapper call of ``kernel`` at a
    main-path shape and its plain twin; ``exact`` whether the twin's bar is
    bitwise."""
    g = torch.Generator().manual_seed(11)
    if kernel in ("segscan_affine", "segscan_max"):
        n, w = 60_000, 32
        flags = (torch.rand(n, generator=g) < 0.2).to(dev)
        a = torch.rand((n, w), generator=g).to(dev)
        b = torch.randn((n, w), generator=g).to(dev)
        if kernel == "segscan_affine":
            return (lambda t=None: segscan_affine(a, b, flags, threads=t),
                    lambda: segscan_affine_ref(flags, a, b), False)
        return (lambda t=None: (segscan_max(b, flags, threads=t),),
                lambda: (segscan_max_ref(flags, b),), True)
    if kernel == "radix_partition":
        keys = torch.randint(0, 10_001, (20, 5000), generator=g,
                             dtype=torch.int32).to(dev)
        return (lambda t=None: radix_partition_rank(keys, 10_001, threads=t),
                lambda: radix_partition_rank_ref(keys, 10_001), True)
    keys = np.arange(10_000, dtype=np.int32)
    table = torch.from_numpy(build_table(keys, 2500)).to(dev)
    q = torch.from_numpy(np.random.default_rng(11).choice(keys, 100_000)
                         .astype(np.int32)).to(dev)
    return (lambda t=None: (hash_probe(q, table, threads=t),),
            lambda: (hash_probe_ref(q, table),), True)


def _outs(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kernel", ["segscan_affine", "segscan_max",
                                    "radix_partition", "hash_probe"])
def test_autotune_benches_every_candidate_on_card(kernel):
    """The first unforced call of a key benches every candidate, takes one
    of them (a timing each), counts one launch and agrees with the twin; a
    second call does not bench; the winner equals the default bit for bit."""
    from repro_torch.kernels import autotune
    dev = need_card()
    call, twin, exact = _search_call(kernel, dev)
    autotune.clear_cache()
    reset_launches()
    got = call()
    assert LAUNCHES[kernel] == 1
    (d,) = [d for d in autotune.decisions_log() if d["kernel"] == kernel]
    assert d["source"] == "microbench" and d["device_kind"] == \
        torch.cuda.get_device_name(dev).lower()
    assert d["param"] in d["candidates"]
    assert sorted(map(int, d["timings_us"])) == sorted(d["candidates"])
    assert all(np.isfinite(t) and t > 0 for t in d["timings_us"].values())
    spent = autotune.bench_seconds()
    assert spent > 0
    again = call()
    assert autotune.bench_seconds() == spent and LAUNCHES[kernel] == 2
    default = call(d["candidates"][0])
    for x, y, z, r in zip(_outs(got), _outs(again), _outs(default),
                          _outs(twin())):
        assert torch.equal(x, y) and torch.equal(x, z)
        if exact:
            assert torch.equal(x, r)
        else:
            torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-5)


def test_autotune_bench_leaves_launches_and_trace():
    """A bench inside a traced call records nothing in the program trace and
    counts no launch: the traced program is the same with and without it."""
    from repro_torch.kernels import autotune
    from repro_torch.launch.hlo_analysis import ProgramTrace
    dev = need_card()
    call, _, _ = _search_call("segscan_affine", dev)
    traces = []
    for fresh in (True, False):
        if fresh:
            autotune.clear_cache()
        reset_launches()
        with ProgramTrace() as trace:
            call()
        assert LAUNCHES["segscan_affine"] == 1
        traces.append(([(r.name, r.bytes_written, r.flops)
                        for r in trace.ops], trace.kernels))
    assert autotune.bench_seconds() > 0
    assert traces[0] == traces[1]
    assert [k[0] for k in traces[0][1]] == ["segscan_affine"]


def test_autotune_disk_round_trip_on_card(tmp_path, monkeypatch):
    """Decisions benched on the card come back from the disk cache in a
    fresh cache without a bench, and the next call launches with them."""
    from repro_torch.kernels import autotune
    dev = need_card()
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    call, _, _ = _search_call("radix_partition", dev)
    autotune.clear_cache()
    first = call()
    (d,) = autotune.decisions_log()
    with open(path) as f:
        assert [r["param"] for r in json.load(f)["decisions"]] == [d["param"]]
    autotune.clear_cache()
    second = call()
    (d2,) = autotune.decisions_log()
    assert d2["source"] == "disk" and d2["param"] == d["param"]
    assert autotune.bench_seconds() == 0.0
    for x, y in zip(first, second):
        assert torch.equal(x, y)
