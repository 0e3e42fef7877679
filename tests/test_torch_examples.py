"""The five example programs on the port (``examples/torch/*.py``), on the CPU.

Each runs through its ``main([..., "--device", "cpu"])``.  quickstart, toll
and ledger run at their defaults and their final states are held to the JAX
package's run of the same seed and sizes (``repro``'s API): the counter app
and SL bitwise, TP to 1e-5 (the port's standing bars).  The streaming
service runs once with ``--inject-restart --corrupt-latest``, once with
``--storm --devices 4`` and once with ``--perfetto-out``; the trainer at a
tiny config for 3 steps (finite losses, a checkpoint written).
"""
import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

from repro.apps import SL as J_SL
from repro.apps import TP as J_TP
from repro.core import DualModeEngine as JEngine
from repro.core import EngineConfig as JConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        f"example_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name: str):
    return load(ROOT / "examples" / "torch" / f"{name}.py")


def jax_run(app, store, stream, interval, **cfg):
    outs, values = JEngine(app, store, JConfig(**cfg)).run_stream(
        store.values, stream, punct_interval=interval)
    return outs, np.asarray(values)


def test_quickstart_matches_reference(capsys):
    got = example("quickstart").main(["--device", "cpu"])
    assert "matches oracle ✓" in capsys.readouterr().out
    ref = load(ROOT / "examples" / "quickstart.py")
    app = ref.make_app()
    store = app.make_store()
    stream = app.gen_events(np.random.default_rng(0), 256)
    j_outs, j_values = jax_run(app, store, stream, 64, scheme="tstream")
    np.testing.assert_array_equal(got["values"].numpy(), j_values)
    assert len(got["outs"]) == len(j_outs) == 4
    for a, b in zip(got["outs"], j_outs):
        np.testing.assert_array_equal(a["count_after"],
                                      np.asarray(b["count_after"]))


def test_toll_processing_matches_reference(capsys):
    got = example("toll_processing").main(["--device", "cpu"])
    assert "agree with the sequential oracle ✓" in capsys.readouterr().out
    stream = J_TP.gen_events(np.random.default_rng(42), 2000)
    _, j_values = jax_run(J_TP, J_TP.make_store(), stream, 500,
                          scheme="tstream")
    values, tolls, _ = got["tstream"]
    np.testing.assert_allclose(values.numpy(), j_values, rtol=1e-5,
                               atol=1e-5)
    assert len(tolls) == 2000 and np.isfinite(tolls).all()


def test_ledger_serving_matches_reference(capsys):
    got = example("ledger_serving").main(["--device", "cpu"])
    assert "conservation holds" in capsys.readouterr().out
    stream = J_SL.gen_events(np.random.default_rng(7), 3000)
    j_outs, j_values = jax_run(J_SL, J_SL.make_store(), stream, 500,
                               scheme="tstream", abort_repass=True)
    np.testing.assert_array_equal(got["values"].numpy(), j_values)
    for a, b in zip(got["outs"], j_outs):
        np.testing.assert_array_equal(a["rejected"], np.asarray(b["rejected"]))


@pytest.mark.parametrize("flags,what", [
    (["--inject-restart", "--corrupt-latest"], "recovery bit-identity OK ✓"),
    (["--storm", "--devices", "4"], "streaming service demo OK ✓"),
    (["--perfetto-out", "{tmp}/trace.json"], "streaming service demo OK ✓"),
], ids=["restart_corrupt", "storm_sharded", "perfetto"])
def test_streaming_service(flags, what, tmp_path, capsys):
    flags = [f.format(tmp=tmp_path) for f in flags]
    got = example("streaming_service").main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert what in out
    ref = got["ref"]
    assert len(ref.outputs) > 0 and np.isfinite(ref.final_values).all()
    if "--corrupt-latest" in flags:
        assert "resume fell back past corrupted" in out
        assert np.array_equal(got["rec"].final_values, ref.final_values)
    if "--storm" in flags:
        assert any(d["knob"] == "slack" for d in ref.decisions)
    if "--perfetto-out" in flags:
        trace = tmp_path / "trace.json"
        assert trace.exists() and (tmp_path / "trace.json.telemetry.json"
                                   ).exists()
        with open(str(trace) + ".telemetry.json") as f:
            assert json.load(f)["schema"] == "repro.telemetry"


def test_train_100m_tiny(tmp_path, capsys):
    mod = example("train_100m")
    tiny = dataclasses.replace(mod.dense_100m(), name="dense-tiny",
                               n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=4, head_dim=16, d_ff=128, vocab=512)
    ckpt = tmp_path / "ckpt"
    got = mod.main(["--steps", "3", "--ckpt-dir", str(ckpt), "--device",
                    "cpu"], cfg=tiny)
    assert "dense-tiny" in capsys.readouterr().out
    assert len(got["losses"]) == 3 and np.isfinite(got["losses"]).all()
    assert os.listdir(ckpt) == ["step_00000003"]


def test_examples_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("the card is present: the defaults resolve to it")
    for name in ("quickstart", "toll_processing", "ledger_serving",
                 "streaming_service", "train_100m"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example(name).main([])
