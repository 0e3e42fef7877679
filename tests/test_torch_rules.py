"""Rules of the port that no parity test states.

* The port and ``chip_smoke.py`` import neither ``jax`` nor the reference
  package ``repro``.
* Entry points default to the CUDA card: without one they raise; only an
  explicit ``device="cpu"`` runs on the CPU.
* ``run_stream`` leaves the caller's state tensor as it was.
* ``EngineConfig.kernel_block_params`` reaches every kernel wrapper of the
  path as its ``threads`` argument.
* ``chip_smoke.py`` fails, and prints no result, without a card and when it
  stands alone in a directory.
* Every kernel that counts launches has a CUDA source, a wrapper and a
  plain-PyTorch twin.
"""
import ast
import importlib
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.apps import ALL_APPS
from repro_torch.convert import (events_to_torch, store_from_numpy,
                                 store_to_numpy)
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.core.types import make_store
from repro_torch.kernels.runtime import KERNELS, LAUNCHES, resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    bad = {r for r in _imported_roots(path)} & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_device_default_is_the_card():
    app = ALL_APPS["gs"]
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_store([4], 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.make_store()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store_from_numpy(np.zeros((5, 1), np.float32), (0,), (4,), (False,),
                         device=None)
    store = app.make_store(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DualModeEngine(app, store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DualModeEngine(app, store, device="cuda")
    assert DualModeEngine(app, store, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("method", ["megakernel", "partition"])
@pytest.mark.parametrize("fused", [True, False])
def test_run_stream_leaves_callers_values(method, fused):
    app = ALL_APPS["gs"]
    store = app.make_store(device="cpu")
    before = store.values.clone()
    stream = app.gen_events(np.random.default_rng(2), 64)
    eng = DualModeEngine(app, store, EngineConfig(restructure_method=method),
                         device="cpu")
    outs1, v1 = eng.run_stream(store.values, stream, 32, fused=fused)
    assert torch.equal(store.values, before)
    assert not torch.equal(v1, before)
    outs2, v2 = eng.run_stream(store.values, stream, 32, fused=fused)
    assert torch.equal(v1, v2)
    for a, b in zip(outs1, outs2):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("app_name,method,wrappers", [
    ("gs", "megakernel", {"radix_partition_rank": 64,
                          "fused_chain_eval": 128}),
    ("tp", "partition", {"radix_partition_rank": 64, "segscan_affine": 512,
                         "segscan_max": 512})])
def test_kernel_block_params_reach_the_wrappers(app_name, method, wrappers,
                                                monkeypatch):
    """``EngineConfig.kernel_block_params`` arrives at each wrapper of the
    path as ``threads``, and leaves the results as they were."""
    restructure = importlib.import_module("repro_torch.core.restructure")
    scheduler = importlib.import_module("repro_torch.core.scheduler")
    segscan_ops = importlib.import_module("repro_torch.kernels.segscan.ops")
    seen = {}

    def spy(module, name):
        real = getattr(module, name)

        def call(*args, threads=None, **kw):
            seen.setdefault(name, set()).add(threads)
            return real(*args, threads=threads, **kw)
        monkeypatch.setattr(module, name, call)

    spy(restructure, "radix_partition_rank")
    spy(segscan_ops, "segscan_affine")
    spy(segscan_ops, "segscan_max")
    spy(scheduler, "fused_chain_eval")
    app = ALL_APPS[app_name]
    store = app.make_store(device="cpu")
    stream = app.gen_events(np.random.default_rng(5), 96)
    params = (("radix_partition", 64), ("segscan", 512), ("megakernel", 128))
    runs = []
    for block in ((), params):
        seen.clear()
        cfg = EngineConfig(restructure_method=method,
                           kernel_block_params=block)
        runs.append(DualModeEngine(app, store, cfg, device="cpu").run_stream(
            store.values, stream, 32))
        want = ({k: {None} for k in wrappers} if not block else
                {k: {v} for k, v in wrappers.items()})
        assert seen == want
    (o0, v0), (o1, v1) = runs
    assert torch.equal(v0, v1)
    for a, b in zip(o0, o1):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_stream_shorter_than_an_interval():
    app = ALL_APPS["tp"]
    store = app.make_store(device="cpu")
    stream = app.gen_events(np.random.default_rng(0), 10)
    eng = DualModeEngine(app, store, device="cpu")
    for fused in (True, False):
        outs, values = eng.run_stream(store.values, stream, 16, fused=fused)
        assert outs == [] and torch.equal(values, store.values)


def test_step_matches_host_loop_interval():
    app = ALL_APPS["tp"]
    store = app.make_store(device="cpu")
    stream = app.gen_events(np.random.default_rng(4), 32)
    eng = DualModeEngine(app, store, device="cpu")
    outs, values = eng.run_stream(store.values, stream, 32, fused=False)
    out1, v1, stats = eng.step(store.values, stream, 0)
    assert torch.equal(v1, values)
    for k in outs[0]:
        np.testing.assert_array_equal(out1[k], outs[0][k])
    assert stats.path == "segscan"


def test_convert_round_trip_keeps_dtypes():
    store = ALL_APPS["tp"].make_store(device="cpu")
    back = store_from_numpy(**store_to_numpy(store), device="cpu")
    assert torch.equal(back.values, store.values)
    assert (back.table_base, back.table_capacity, back.table_is_max) == (
        store.table_base, store.table_capacity, store.table_is_max)
    ev = events_to_torch(ALL_APPS["gs"].gen_events(
        np.random.default_rng(0), 4), "cpu")
    assert (ev["keys"].dtype, ev["values"].dtype, ev["is_read"].dtype) == (
        torch.int32, torch.float32, torch.bool)


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs = [_run_smoke(tmp_path, alone)]
    if not torch.cuda.is_available():
        runs.append(_run_smoke(ROOT, ROOT / "chip_smoke.py"))
    for proc in runs:
        assert proc.returncode != 0, proc.stdout[-2000:]
        assert '"ok"' not in proc.stdout, proc.stdout[-2000:]


@pytest.mark.parametrize("name", KERNELS)
def test_every_kernel_has_source_wrapper_and_twin(name):
    """``runtime.KERNELS`` names each launch counter; the two segscans share
    one source and one module directory."""
    stem = "segscan" if name.startswith("segscan_") else name
    port = ROOT / "src" / "repro_torch"
    assert (port / "csrc" / f"{stem}.cu").is_file()
    for f in ("ops.py", "ref.py"):
        assert (port / "kernels" / stem / f).is_file(), f
    assert name in LAUNCHES
    importlib.import_module(f"repro_torch.kernels.{stem}.ops")
    importlib.import_module(f"repro_torch.kernels.{stem}.ref")
