"""The port's kernel-dispatch search (``repro_torch.kernels.autotune``).

Counterparts of ``tests/test_autotune.py``: one microbenchmark per (kernel,
shape bucket, dtype, device kind) per process, the device kind in the key,
the disk round trip, forcing, logging, and ``kernel_block_params`` pinning
without a search.  The port's parameter is threads per block and its
"default" source is the reference's "interpret-default" (a call with no
bench: the CPU).  Parity with ``repro.kernels.autotune``: the shape bucket,
the device tables, and a disk cache that either package loads from the
other.  On the CPU no wrapper consults the search (its twin runs instead).
"""
import importlib
import json
import logging
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import autotune as j_autotune
from repro_torch.apps import ALL_APPS
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.kernels import autotune
from repro_torch.kernels.hash_probe import ops as probe_ops
from repro_torch.kernels.radix_partition import ops as radix_ops

H100_KIND = "nvidia h100 80gb hbm3"
H100_SMEM = 232_448     # an H100's opt-in shared memory per block (bytes)


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_AUTOTUNE_LOG", raising=False)
    autotune.clear_cache()
    j_autotune.clear_cache()
    yield
    autotune.clear_cache()
    j_autotune.clear_cache()


def make_bench(table=None):
    """bench_fn stub: records calls, returns scripted timings."""
    calls = []

    def bench(c):
        calls.append(c)
        return float(table.get(c, 1.0)) if table else 1.0

    bench.calls = calls
    return bench


# -- the ten counterparts of tests/test_autotune.py ---------------------------
def test_microbench_picks_fastest_candidate():
    bench = make_bench({256: 5e-6, 128: 1e-6, 512: 5e-6, 1024: 5e-6})
    d = autotune.decide("segscan_affine", 1 << 12, bench_fn=bench,
                        device_kind="testkind")
    assert d.source == "microbench"
    assert d.param == 128
    assert set(map(int, d.timings_us)) == set(d.candidates)
    # every candidate warmed once, then 3 interleaved rounds
    assert len(bench.calls) == 4 * len(d.candidates)


def test_cached_decision_reused_without_rebench():
    bench = make_bench()
    d1 = autotune.decide("segscan_affine", 1000, bench_fn=bench,
                         device_kind="testkind")
    assert d1.source == "microbench" and bench.calls
    n_calls = len(bench.calls)
    # 900 and 1000 share the 2^10 shape bucket -> pure cache hit
    d2 = autotune.decide("segscan_affine", 900, bench_fn=bench,
                         device_kind="testkind")
    assert d2 is d1
    assert len(bench.calls) == n_calls
    # a different bucket re-benches once
    autotune.decide("segscan_affine", 5000, bench_fn=bench,
                    device_kind="testkind")
    assert len(bench.calls) > n_calls
    # so does another path through the kernel in the same n bucket
    n_calls = len(bench.calls)
    autotune.decide("segscan_affine", 1000, bench_fn=bench,
                    device_kind="testkind", variant="w32")
    assert len(bench.calls) > n_calls


def test_device_kind_is_part_of_the_key():
    bench_a = make_bench({256: 1e-6, 128: 5e-6, 512: 5e-6, 1024: 5e-6})
    bench_b = make_bench({256: 5e-6, 128: 5e-6, 512: 1e-6, 1024: 5e-6})
    da = autotune.decide("segscan_affine", 1 << 12, bench_fn=bench_a,
                         device_kind="kind-a")
    db = autotune.decide("segscan_affine", 1 << 12, bench_fn=bench_b,
                         device_kind="kind-b")
    assert da.key != db.key
    assert (da.param, db.param) == (256, 512)
    # both live in the cache simultaneously
    assert autotune.decide("segscan_affine", 1 << 12,
                           device_kind="kind-a").param == 256
    assert autotune.decide("segscan_affine", 1 << 12,
                           device_kind="kind-b").param == 512


@pytest.mark.parametrize("kernel,n,staged,shipped", [
    ("segscan_affine", 1 << 12, True, 256),
    ("segscan_max", 1 << 12, True, 256),
    ("radix_partition", 500, True, 64),
    ("radix_partition", 1 << 12, True, 512),
    ("radix_partition", 5000, True, 640),
    ("radix_partition", 1 << 20, True, 1024),
    ("hash_probe", 1 << 12, True, 1024),
    ("hash_probe", 1 << 12, False, 256),
    ("megakernel", 1 << 12, True, 512),
])
def test_default_is_deterministic_and_matches_shipped_launches(
        kernel, n, staged, shipped):
    # no bench never times anything: the decision is the first candidate ==
    # the block size the wrapper launched with before the search, every
    # process
    variant = ("staged" if staged else "global") if kernel == "hash_probe" \
        else ""
    d = autotune.decide(kernel, n, device_kind="testkind", staged=staged,
                        variant=variant)
    assert d.source == "default"
    assert d.param == shipped == d.candidates[0]
    if kernel == "radix_partition":
        assert shipped == radix_ops.default_threads(n)
    again = autotune.decide(kernel, n, device_kind="testkind",
                            staged=staged, variant=variant)
    assert again.param == shipped


def test_disk_cache_round_trip(tmp_path):
    path = str(tmp_path / "tune.json")
    bench = make_bench({256: 5e-6, 128: 1e-6, 512: 5e-6, 1024: 5e-6})
    d1 = autotune.decide("segscan_affine", 1 << 12, bench_fn=bench,
                         device_kind="testkind", cache_path=path)
    assert d1.param == 128
    with open(path) as f:
        stored = json.load(f)["decisions"]
    assert any(r["param"] == 128 and r["kernel"] == "segscan_affine"
               for r in stored)

    # a fresh process (cleared cache) with the same disk cache must make
    # the SAME decision without benching at all
    autotune.clear_cache()
    bench2 = make_bench({256: 1e-6, 128: 9e-6, 512: 9e-6, 1024: 9e-6})
    d2 = autotune.decide("segscan_affine", 1 << 12, bench_fn=bench2,
                         device_kind="testkind", cache_path=path)
    assert d2.source == "disk"
    assert d2.param == 128
    assert not bench2.calls


@pytest.mark.parametrize("garbage", ["{not json", "[1, 2]",
                                     '{"decisions": [{"kernel": 1}]}'])
def test_disk_cache_ignores_garbage(tmp_path, garbage):
    path = str(tmp_path / "tune.json")
    with open(path, "w") as f:
        f.write(garbage)
    d = autotune.decide("segscan_affine", 1 << 12, device_kind="testkind",
                        cache_path=path)
    assert d.param == 256  # fell through to the default, no crash


def test_forced_override_beats_cache_and_never_benches():
    d1 = autotune.decide("segscan_affine", 1 << 9, device_kind="testkind")
    bench = make_bench()
    d2 = autotune.decide("segscan_affine", 1 << 9, force=192, bench_fn=bench,
                         device_kind="testkind")
    assert d2.source == "forced" and d2.param == 192
    assert not bench.calls
    # the cache is untouched by the forced call
    d3 = autotune.decide("segscan_affine", 1 << 9, device_kind="testkind")
    assert d3.param == d1.param
    assert autotune.block_rows("segscan_affine", 1 << 9, force=64,
                               device="cpu") == 64


def test_decisions_logged_once_per_key(caplog):
    with caplog.at_level(logging.INFO, logger="repro_torch.kernels.autotune"):
        autotune.decide("segscan_affine", 1 << 12, device_kind="testkind")
        autotune.decide("segscan_affine", 1 << 12, device_kind="testkind")
    hits = [r for r in caplog.records if "autotune:" in r.getMessage()]
    assert len(hits) == 1


def test_decision_log_artifact(tmp_path, monkeypatch):
    logp = str(tmp_path / "decisions.jsonl")
    monkeypatch.setenv("REPRO_AUTOTUNE_LOG", logp)
    autotune.decide("segscan_affine", 1 << 12, device_kind="testkind")
    autotune.decide("hash_probe", 1 << 10, dtype="int32",
                    device_kind="testkind")
    with open(logp) as f:
        recs = [json.loads(line) for line in f]
    assert {r["kernel"] for r in recs} == {"segscan_affine", "hash_probe"}


def test_engineconfig_pins_block_params_without_autotune(monkeypatch):
    """The fused driver with every block parameter pinned through
    ``EngineConfig.kernel_block_params`` never consults the search, and
    pinning the defaults reproduces the default run bit for bit."""
    app = ALL_APPS["gs"]
    stream = app.gen_events(np.random.default_rng(3), 64)
    store = app.make_store(device="cpu")
    ref_eng = DualModeEngine(app, store, EngineConfig(), device="cpu")
    outs_ref, vals_ref = ref_eng.run_stream(store.values, stream, 16,
                                            fused=True)

    def boom(*a, **kw):  # any lookup is a pin violation
        raise AssertionError("autotune consulted despite pinned params")

    monkeypatch.setattr(autotune, "block_rows", boom)
    monkeypatch.setattr(autotune, "decide", boom)
    cfg = EngineConfig(kernel_block_params=(("segscan", 256),
                                            ("radix_partition", 256),
                                            ("hash_probe", 1024)))
    assert cfg.block_param("segscan") == 256
    assert cfg.block_param("megakernel") is None
    eng = DualModeEngine(app, store, cfg, device="cpu")
    outs, vals = eng.run_stream(store.values, stream, 16, fused=True)
    assert torch.equal(vals, vals_ref)
    for a, b in zip(outs, outs_ref):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# -- parity with repro.kernels.autotune ---------------------------------------
@settings(max_examples=300, deadline=None)
@given(st.integers(min_value=1, max_value=1 << 24))
def test_shape_bucket_matches_reference(n):
    assert autotune.shape_bucket(n) == j_autotune.shape_bucket(n)
    assert autotune.shape_bucket(n, "w32") == j_autotune.shape_bucket(n) + \
        "/w32"


@pytest.mark.parametrize("kind", ["cpu", "CPU ", H100_KIND, "NVIDIA H100 PCIe",
                                  "testkind", "gpu"])
def test_device_tables_match_reference(kind):
    """The port keeps the reference's "cpu" row only: "cpu" and any kind
    neither table knows (an H100 included) read the reference's cpu row."""
    assert autotune.ladder_bounds(kind) == j_autotune.ladder_bounds(kind) \
        == j_autotune.ladder_bounds("cpu")
    assert autotune.mega_bounds(kind) == j_autotune.mega_bounds(kind) \
        == j_autotune.mega_bounds("cpu")


def test_device_tables_read_by_the_ladder():
    restructure = importlib.import_module("repro_torch.core.restructure")
    assert (restructure.PARTITION_MAX_BUCKETS,
            restructure.PARTITION_MIN_ROWS) == autotune.ladder_bounds("cpu")
    mb, mr = autotune.ladder_bounds(H100_KIND)
    for kind in ("cpu", H100_KIND):
        assert restructure.partition_fits(mr, mb, device_kind=kind)
        assert not restructure.partition_fits(mr - 1, mb, device_kind=kind)
        assert not restructure.partition_fits(mr, mb + 1, device_kind=kind)


def test_disk_cache_shared_with_reference(tmp_path):
    """A cache written by either package is loaded by the other into the
    same keys and params, without a bench."""
    path = str(tmp_path / "tune.json")
    j_bench = make_bench({256: 9e-6, 128: 1e-6, 512: 9e-6, 1024: 9e-6})
    jd = j_autotune.decide("segscan", 1 << 12, bench_fn=j_bench,
                           interpret=False, device_kind="testkind",
                           cache_path=path)
    bench = make_bench({256: 9e-6, 128: 9e-6, 512: 1e-6, 1024: 9e-6})
    pd = autotune.decide("hash_probe", 1 << 10, dtype="int32", bench_fn=bench,
                         device_kind="testkind", cache_path=path)
    assert (jd.param, pd.param) == (128, 512)
    # the port wrote the file last: it holds both decisions
    autotune.clear_cache()
    j_autotune.clear_cache()
    none = make_bench()
    got = autotune.decide("segscan", 1 << 12, bench_fn=none,
                          device_kind="testkind", cache_path=path)
    assert (got.key, got.param, got.source) == (jd.key, 128, "disk")
    jgot = j_autotune.decide("hash_probe", 1 << 10, dtype="int32",
                             bench_fn=none, interpret=False,
                             device_kind="testkind", cache_path=path)
    assert (jgot.key, jgot.param, jgot.source) == (pd.key, 512, "disk")
    assert not none.calls
    mine = {tuple(d[k] for k in ("kernel", "shape_bucket", "dtype",
                                 "device_kind")): d["param"]
            for d in autotune.decisions_log()}
    assert mine[jd.key] == 128


# -- the port's own rules ------------------------------------------------------
@pytest.mark.parametrize("app_name,method", [("gs", "megakernel"),
                                             ("gs", "partition"),
                                             ("tp", "partition")])
def test_cpu_run_never_consults_the_search(app_name, method):
    app = ALL_APPS[app_name]
    store = app.make_store(device="cpu")
    stream = app.gen_events(np.random.default_rng(1), 96)
    eng = DualModeEngine(app, store, EngineConfig(restructure_method=method),
                         device="cpu")
    eng.run_stream(store.values, stream, 32, fused=True)
    assert autotune.decisions_log() == []
    assert autotune.bench_seconds() == 0.0


def test_cpu_profile_touches_no_cuda(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("CUDA touched for a CPU profile")

    monkeypatch.setattr(torch.cuda, "get_device_properties", boom)
    monkeypatch.setattr(torch.cuda, "get_device_name", boom)
    assert autotune.device_profile("cpu") == autotune.CPU_PROFILE
    assert autotune.kind_of("cpu") == "cpu"
    assert autotune._default_bench(lambda t: None, "cpu") is None
    assert autotune._default_bench(None, "cpu") is None


def test_candidates_are_legal_and_lead_with_the_default():
    small = dict(autotune.CPU_PROFILE, max_threads_per_block=512)
    for kernel in autotune.KERNELS:
        for n in (1, 500, 5000, 1 << 20):
            for prof in (None, small):
                c = autotune.candidates(kernel, prof, n=n)
                assert len(set(c)) == len(c)
                top = (prof or autotune.CPU_PROFILE)["max_threads_per_block"]
                assert all(x % 32 == 0 and 32 <= x <= top for x in c)
                first = autotune.default_param(kernel, n)
                assert c[0] == first or first > top
                assert set(autotune.BRACKET) - set(c) <= {1024}
    with pytest.raises(ValueError, match="pass n"):
        autotune.candidates("radix_partition")
    with pytest.raises(ValueError, match="unknown kernel"):
        autotune.candidates("segscan")


def test_radix_and_probe_paths_follow_the_kernels():
    """The bucket strings name the path each kernel's C entry picks
    (``csrc/radix_partition.cu``, ``csrc/hash_probe.cu``), at its edges."""
    sms = 132
    assert radix_ops.path(528, 4096, 4096, sms) == "warp_rows"
    assert radix_ops.path(527, 4096, 4096, sms) == "sort"
    assert radix_ops.path(528, 4097, 31, sms) == "one_pass"
    assert radix_ops.path(528, 4096, 4097, sms) == "sort"
    assert radix_ops.path(1, 1 << 20, 31, sms) == "one_pass"
    assert radix_ops.path(1, 10, 32, sms) == "sort"
    # sharded GS [800, 2,504] K 2,501 and shared_everything [80, 2,504]
    # K 10,001 share the n bucket but not the path
    assert autotune.shape_bucket(2504) == "2^12"
    assert radix_ops.path(800, 2504, 2501, sms) == "warp_rows"
    assert radix_ops.path(80, 2504, 10_001, sms) == "sort"
    cap = H100_SMEM // (8 * 4 * 2)
    assert probe_ops.staged(cap, H100_SMEM)
    assert not probe_ops.staged(cap + 1, H100_SMEM)
    assert probe_ops.staged(2500, H100_SMEM)


def test_concurrent_decisions_bench_each_key_once():
    """Many threads deciding the same keys at once: each key benches once
    and every thread sees the one decision."""
    calls = []
    lock = threading.Lock()

    def bench(c):
        with lock:
            calls.append(c)
        return 1e-6 * c

    keys = [("segscan_affine", 1 << b) for b in range(8, 12)]
    seen, errors = [], []

    def worker():
        try:
            for kernel, n in keys:
                seen.append(autotune.decide(kernel, n, bench_fn=bench,
                                            device_kind="testkind"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    n_cands = len(autotune.candidates("segscan_affine"))
    assert len(calls) == 4 * n_cands * len(keys)
    assert {d.param for d in seen} == {128}
    assert len({id(d) for d in seen}) == len(keys)


def test_dump_cli_reads_the_device_and_the_cache(tmp_path, monkeypatch,
                                                capsys):
    path = str(tmp_path / "tune.json")
    autotune.decide("segscan_max", 1 << 12, bench_fn=make_bench(),
                    device_kind="testkind", cache_path=path)
    autotune.clear_cache()
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    out_path = str(tmp_path / "dump.json")
    out = autotune.main(["--dump", out_path, "--device", "cpu"])
    assert out["profile"] == autotune.CPU_PROFILE
    assert out["ladder_bounds"] == j_autotune.ladder_bounds("cpu")
    assert out["mega_bounds"] == j_autotune.mega_bounds("cpu")
    assert [d["kernel"] for d in out["decisions"]] == ["segscan_max"]
    with open(out_path) as f:
        assert json.load(f) == json.loads(capsys.readouterr().out)
