"""The port's snapshots (``repro_torch/ckpt``) against the reference format.

A snapshot is ``step_<N>/manifest.json`` plus one ``.npy`` per leaf, the
leaf named by its key path, with byte sizes and CRC32s in the manifest.
Pinned here: the round trip; every corruption the fault plane makes is
detected; debris never shadows a valid snapshot; retention; and a snapshot
written by either package loads in the other, bitwise, down to a service
that resumes from the other package's snapshot.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.apps import ALL_APPS as J_APPS
from repro.core.intervals import ReplaySource as JReplaySource
from repro.core.intervals import WatermarkPolicy as JWatermarkPolicy
from repro.core.scheduler import DualModeEngine as JEngine
from repro.runtime.service import ServiceConfig as JServiceConfig
from repro.runtime.service import StreamService as JStreamService

from repro_torch import ckpt
from repro_torch.apps import ALL_APPS
from repro_torch.core.intervals import ReplaySource, WatermarkPolicy
from repro_torch.core.scheduler import DualModeEngine
from repro_torch.runtime.faults import corrupt_snapshot
from repro_torch.runtime.service import ServiceConfig, StreamService

from torch_parity import port_store


def _tree(rng):
    """A tree with every kind of node the service and its users write, in
    the dtypes JAX keeps without x64 (it loads int64 as int32)."""
    return dict(values=rng.standard_normal((5, 3)).astype(np.float32),
                ids=rng.integers(0, 100, 7).astype(np.int32),
                nested=dict(b=rng.standard_normal(4).astype(np.float32), a=[
                    rng.standard_normal((2, 2)).astype(np.float32),
                    np.arange(3, dtype=np.int32)]),
                half=rng.standard_normal(6).astype(ml_dtypes.bfloat16))


def _as_port(tree):
    """The same tree with tensors for leaves (bfloat16 included)."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_port(v) for v in tree]
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_tree_bits(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_bits(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_bits(g, w, f"{path}/{i}")
    else:
        g, w = _bits(got), _bits(want)
        assert g.shape == w.shape and g.dtype == w.dtype, path
        np.testing.assert_array_equal(g, w, err_msg=path)


def test_round_trip_and_layout(tmp_path):
    tree = _as_port(_tree(np.random.default_rng(0)))
    path = ckpt.save_checkpoint(str(tmp_path), 3, tree,
                                extra_meta=dict(intervals_done=3))
    assert os.path.basename(path) == "step_00000003"
    assert sorted(os.listdir(path)) == sorted(
        ["manifest.json", "values.npy", "ids.npy", "nested_b.npy",
         "nested_a_0.npy", "nested_a_1.npy", "half.npy"])
    assert ckpt.verify_checkpoint(str(tmp_path), 3) == (True, "ok")
    assert ckpt.read_manifest_meta(str(tmp_path), 3) == dict(intervals_done=3)
    back = ckpt.load_checkpoint(str(tmp_path), 3, tree, verify=True)
    _assert_tree_bits(back, tree)
    assert isinstance(back["values"], torch.Tensor)
    # numpy targets load as numpy
    back_np = ckpt.load_checkpoint(str(tmp_path), 3,
                                   dict(values=np.zeros((5, 3))))
    assert isinstance(back_np["values"], np.ndarray)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(str(tmp_path), 3, dict(values=np.zeros(4)))
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_checkpoint(str(tmp_path), 3, dict(other=np.zeros(4)))


@pytest.mark.parametrize("kind", ["torn_manifest", "corrupt_leaf",
                                  "truncate_leaf"])
def test_corruption_is_detected(tmp_path, kind):
    path = ckpt.save_checkpoint(str(tmp_path), 4,
                                dict(values=torch.arange(24.0).reshape(4, 6)))
    corrupt_snapshot(path, kind)
    if kind == "torn_manifest":
        assert ckpt.checkpoint_steps(str(tmp_path)) == []
    else:
        ok, why = ckpt.verify_checkpoint(str(tmp_path), 4)
        assert not ok and "leaf" in why
        with pytest.raises(ValueError, match="verification"):
            ckpt.load_checkpoint(str(tmp_path), 4,
                                 dict(values=torch.zeros(4, 6)), verify=True)


def test_debris_never_shadows_a_valid_snapshot(tmp_path):
    path = ckpt.save_checkpoint(str(tmp_path), 4, dict(values=np.ones(3)))
    corrupt_snapshot(path, "debris")
    assert os.path.isdir(str(tmp_path / "step_00000005"))
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert ckpt.latest_valid_step(str(tmp_path)) == 4
    p8 = ckpt.save_checkpoint(str(tmp_path), 8, dict(values=np.ones(3)))
    corrupt_snapshot(p8, "corrupt_leaf")
    assert ckpt.latest_step(str(tmp_path)) == 8
    assert ckpt.latest_valid_step(str(tmp_path)) == 4


def test_prune_keeps_the_newest(tmp_path):
    for s in (2, 4, 6, 8):
        ckpt.save_checkpoint(str(tmp_path), s, dict(values=np.ones(2)))
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert ckpt.prune_checkpoints(str(tmp_path), 2) == [2, 4]
    assert ckpt.checkpoint_steps(str(tmp_path)) == [8, 6]
    assert not os.path.exists(tmp_path / "step_00000003.tmp")


def test_jax_snapshot_loads_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    jtree = {k: v for k, v in tree.items()}
    jckpt.save_checkpoint(str(tmp_path), 7, jtree, extra_meta=dict(x=1))
    assert ckpt.verify_checkpoint(str(tmp_path), 7) == (True, "ok")
    assert ckpt.read_manifest_meta(str(tmp_path), 7) == dict(x=1)
    back = ckpt.load_checkpoint(str(tmp_path), 7, _as_port(tree),
                                verify=True)
    _assert_tree_bits(back, _as_port(tree))


def test_port_snapshot_loads_in_jax(tmp_path):
    tree = _tree(np.random.default_rng(2))
    ckpt.save_checkpoint(str(tmp_path), 9, _as_port(tree),
                         extra_meta=dict(y=[1, 2]))
    assert jckpt.verify_checkpoint(str(tmp_path), 9) == (True, "ok")
    assert jckpt.read_manifest_meta(str(tmp_path), 9) == dict(y=[1, 2])
    back = jckpt.load_checkpoint(str(tmp_path), 9, tree, verify=True)
    flat = lambda t: ([x for v in (t[k] for k in sorted(t))
                       for x in flat(v)] if isinstance(t, dict) else
                      [x for v in t for x in flat(v)]
                      if isinstance(t, list) else [t])
    for g, w in zip(flat(back), flat(tree)):
        np.testing.assert_array_equal(_bits(np.asarray(g)), _bits(w))
        assert np.asarray(g).dtype == w.dtype


def _service_pair(app_name, tmp_path):
    interval, n, jitter = 16, 160, 3
    japp, tapp = J_APPS[app_name], ALL_APPS[app_name]
    jstore = japp.make_store()
    jeng = JEngine(japp, jstore)
    teng = DualModeEngine(tapp, port_store(jstore), device="cpu")
    jcfg = JServiceConfig(punct_interval=interval, chunk_intervals=2,
                          snapshot_every=4, ckpt_dir=str(tmp_path),
                          watermark=JWatermarkPolicy(allowed_lateness=jitter))
    tcfg = ServiceConfig(punct_interval=interval, chunk_intervals=2,
                         snapshot_every=4, ckpt_dir=str(tmp_path),
                         watermark=WatermarkPolicy(allowed_lateness=jitter))
    jsrc = lambda: JReplaySource(japp.gen_events, n, seed=7,
                                 arrival_batch=11, jitter=jitter)
    tsrc = lambda: ReplaySource(tapp.gen_events, n, seed=7,
                                arrival_batch=11, jitter=jitter)
    return jeng, teng, jcfg, tcfg, jsrc, tsrc


def test_a_service_resumes_from_the_other_packages_snapshot(tmp_path):
    """A JAX service crashes after snapshots at 4 and 8; the port's service
    resumes from its snapshot and ends where the JAX uninterrupted run ends,
    bitwise (SL: outputs are selections, exact).  And the other way."""
    jeng, teng, jcfg, tcfg, jsrc, tsrc = _service_pair("sl", tmp_path / "a")
    jref = JStreamService(jeng, JServiceConfig(
        punct_interval=16, chunk_intervals=2,
        watermark=JWatermarkPolicy(allowed_lateness=3))).run(jsrc())
    with pytest.raises(RuntimeError, match="injected failure"):
        JStreamService(jeng, jcfg).run(jsrc(), crash_after_interval=9)
    rec = StreamService(teng, tcfg).resume(tsrc())
    assert rec.stats["replayed"] // 16 == 8
    np.testing.assert_array_equal(rec.final_values, jref.final_values)
    for a, b in zip(rec.outputs, jref.outputs[8:]):
        for k in b:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))

    jeng, teng, jcfg, tcfg, jsrc, tsrc = _service_pair("sl", tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected failure"):
        StreamService(teng, tcfg).run(tsrc(), crash_after_interval=5)
    jrec = JStreamService(jeng, jcfg).resume(jsrc())
    assert jrec.stats["replayed"] // 16 == 4
    np.testing.assert_array_equal(jrec.final_values, jref.final_values)
