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
"""
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
