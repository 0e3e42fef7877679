"""The benchmark's yardstick on the CPU: the generators, the references,
the frozen costs, the imports and BENCHMARK.json itself."""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tsbench import harness
from tsbench.cost import radix_partition, segscan_affine
from tsbench.reference import gs as ref_gs
from tsbench.reference import sl as ref_sl
from tsbench.traffic import gs as gen_gs
from tsbench.traffic import sl as gen_sl
from tsbench.traffic.zipf import zipf_keys, zipf_probs

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _cfg(name):
    return harness.load(f"configs/{name}.json")


def _traffic(cell):
    return harness.load(f"workloads/{cell}.json")["traffic"]


# -- generators ------------------------------------------------------------
def test_zipf_marginals_and_distinct_keys():
    from repro_torch.apps.common import zipf_probs as port_probs
    np.testing.assert_array_equal(zipf_probs(10_000, 0.6),
                                  port_probs(10_000, 0.6))
    g = torch.Generator().manual_seed(7)
    keys = zipf_keys(g, 100_000, 10, 10_000, 0.6).numpy()
    assert keys.dtype == np.int32 and keys.min() >= 0 and keys.max() < 10_000
    srt = np.sort(keys, axis=1)
    assert not (srt[:, 1:] == srt[:, :-1]).any()
    freq = np.bincount(keys.ravel(), minlength=10_000) / keys.size
    p = zipf_probs(10_000, 0.6)
    # 20 bins of equal mass under the Zipf law: each holds its twentieth
    edge = np.searchsorted(np.cumsum(p), np.arange(1, 20) / 20)
    mass = [b.sum() for b in np.split(freq, edge)]
    np.testing.assert_allclose(mass, [b.sum() for b in np.split(p, edge)],
                               rtol=0.03)
    np.testing.assert_allclose(freq[:5], p[:5], rtol=0.05)


@pytest.mark.parametrize("app,cell", [("gs", "gs-paper.batch"),
                                      ("sl", "sl-ledger.batch")])
def test_generators_give_the_ports_columns(app, cell):
    from repro_torch.apps import ALL_APPS
    cfg = _cfg(harness.load(f"workloads/{cell}.json")["config"])
    gen = {"gs": gen_gs, "sl": gen_sl}[app]
    ours = gen.generate(torch.Generator().manual_seed(3), 64, cfg,
                        _traffic(cell))
    port = ALL_APPS[app].gen_events(np.random.default_rng(3), 64)
    assert sorted(ours) == sorted(port)
    for k, v in port.items():
        assert ours[k].numpy().dtype == v.dtype, k
        assert tuple(ours[k].shape) == v.shape, k


# -- references on hand-worked streams ------------------------------------
def test_gs_reference_by_hand():
    state = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    blocks = [dict(keys=np.array([[0, 1], [1, 2]], np.int32),
                   is_read=np.array([True, False]),
                   values=np.array([[9, 9], [10, 20]], np.float32)),
              dict(keys=np.array([[2, 1], [3, 0]], np.int32),
                   is_read=np.array([True, False]),
                   values=np.array([[9, 9], [30, 40]], np.float32))]
    out, final = ref_gs.run(state, blocks)
    # read 0,1 -> 1+2; write 1:=10, 2:=20; read 2,1 -> 20+10; write
    np.testing.assert_array_equal(out["sum"], [3.0, 0.0, 30.0, 0.0])
    assert out["ok"].all()
    np.testing.assert_array_equal(final, [40.0, 10.0, 20.0, 30.0])


def test_sl_reference_by_hand():
    # accounts 0..2 (slots 0-2), assets 0..2 (slots 3-5)
    state = np.array([10, 5, 0, 7, 1, 0], np.float32)
    ev = dict(src_acct=np.array([0, 1, 2], np.int32),
              dst_acct=np.array([1, 2, 0], np.int32),
              src_asset=np.array([0, 1, 0], np.int32),
              dst_asset=np.array([2, 2, 1], np.int32),
              amount=np.array([4.0, 6.0, 0.5], np.float32),
              is_transfer=np.array([True, True, False]))
    out, final = ref_sl.run(state, [ev])
    # 1: debits 10-4, 7-4 both ok; credits acct1 += 4 -> 9, asset2 += 4
    # 2: account 1 holds 9 >= 6 ok -> 3; asset 1 holds 1 < 6 rejected,
    #    so only the account credit fires: acct2 += 6
    # 3: deposit 0.5 to account 2 and asset 0
    np.testing.assert_array_equal(out["ok"], [True, False, True])
    np.testing.assert_array_equal(out["rejected"], [False, True, False])
    np.testing.assert_array_equal(out["src_balance"], [6.0, 3.0, 6.5])
    np.testing.assert_array_equal(final, [6, 3, 6.5, 3.5, 1, 4])


@pytest.mark.parametrize("app,cell,n", [("gs", "gs-paper.batch", 4000),
                                        ("sl", "sl-ledger.batch", 4000)])
def test_control_in_bfloat16_fails(app, cell, n):
    """The reference in bfloat16, in the program's place, is not correct by
    the limits the configuration states; the float32 reference is."""
    cfg = _cfg(harness.load(f"workloads/{cell}.json")["config"])
    gen = {"gs": gen_gs, "sl": gen_sl}[app]
    ref = {"gs": ref_gs, "sl": ref_sl}[app]
    g = torch.Generator().manual_seed(11)
    lo, hi = cfg["init"]
    state = (torch.rand(sum(cfg["tables"]), generator=g) * (hi - lo)
             + lo).numpy()
    ev = {k: v.numpy() for k, v in gen.generate(g, n, cfg,
                                                _traffic(cell)).items()}
    blocks = [{k: v[: n // 2] for k, v in ev.items()},
              {k: v[n // 2:] for k, v in ev.items()}]
    want, want_state = ref.run(state, blocks)

    def correct(dtype):
        got, got_state = ref.run(state, blocks, dtype=dtype)
        nums = harness.compare(ref.OUTPUTS, got, want, got_state,
                               want_state, 0)
        return all(v <= cfg["limits"][k] for k, v in nums.items())
    assert correct("float32")
    assert not correct("bfloat16")


# -- frozen costs ----------------------------------------------------------
@pytest.mark.parametrize("rows,lanes,bound_ms", [
    (1_000_000, 1, 0.0051), (400_000, 32, 0.0613), (800_000, 1, 0.0041)])
def test_segscan_cost_meets_the_kernel_table(rows, lanes, bound_ms):
    """Bounds of the kernel table (PERF.md) at 3.35 TB/s, and the port's
    own formula at the same shape."""
    from repro_torch.kernels.segscan.ops import cost as port_cost
    nbytes, ops = segscan_affine.cost(rows, lanes)
    assert round(max(nbytes / 3.35e12, ops / 6.7e13) * 1e3, 4) == bound_ms
    assert (nbytes, ops) == port_cost(torch.empty(rows, lanes), "affine")


@pytest.mark.parametrize("bn,n,k,bound_ms", [
    (200, 5_000, 10_001, 0.0048), (200, 2_000, 201, 0.0010),
    (10, 40_000, 10_001, 0.0011)])
def test_radix_cost_meets_the_kernel_table(bn, n, k, bound_ms):
    from repro_torch.kernels.radix_partition.ops import cost as port_cost
    nbytes, ops = radix_partition.cost(bn, n, k)
    assert round(max(nbytes / 3.35e12, ops / 6.7e13) * 1e3, 4) == bound_ms
    keys = torch.empty((bn, n), dtype=torch.int32)
    assert (nbytes, ops) == port_cost(keys, k)


# -- imports ---------------------------------------------------------------
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(HERE).as_posix() for p in HERE.rglob("*.py")
    if "__pycache__" not in p.parts))
def test_no_jax_and_no_program_in_the_yardstick(path):
    names = list(_imports(HERE / path))
    assert not harness.forbidden_modules(names), names
    if path.split("/")[0] in ("reference", "cost", "traffic"):
        assert not any(n.split(".")[0] == "repro_torch" for n in names)


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reprox", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "flax", "jaxlib.xla"]) == [
        "flax", "jax", "jaxlib", "repro"]


# -- BENCHMARK.json --------------------------------------------------------
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def test_benchmark_names_units_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names), names
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("tsbench/")
        assert (HERE.parent / c["file"]).exists()
        assert harness.load(c["file"][len("tsbench/"):])["reduced"] == \
            c["reduced"]
    for w in BENCH["workloads"]:
        cell = harness.load(f"workloads/{w['name']}.json")
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert len(w["why"]) <= 200 and w["chips"] == cell["chips"] == 1
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51 and (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_cell_reports_what_the_contract_asks():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in BENCH["end_to_end"]}
    assert e2e["setup_s"] == cells
    for cell in cells:
        assert any(cell in ws for n, ws in e2e.items() if n != "setup_s")
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(e2e[m["moves"]]), m["name"]
