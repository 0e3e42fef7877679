"""Helpers for the dry run's parity tests (``tests/test_torch_dryrun*.py``):
the reference's per-device argument bytes of a cell, counted from JAX's
``param_specs`` / ``batch_specs`` / ``cache_specs`` and ``jax.eval_shape``,
and the check of one ``run_cell`` result against the reference.  Not a test
module.
"""
import math

import jax

from repro.configs import get_arch as jax_arch
from repro.launch import sharding as jsh
from repro.launch import steps as jsteps
from repro.launch.mesh import dp_axes as jdp_axes
from repro.models import SHAPE_BY_NAME as J_SHAPES
from repro.models import cell_is_applicable as j_applicable
from repro.models import moe_ep as jmoe
from repro.models.serving import serving_padded as j_serving_padded
from jax.sharding import PartitionSpec as P

from repro_torch.launch.dryrun import run_cell
from repro_torch.models import moe_ep

ARCHS = ["minicpm-2b", "hubert-xlarge", "mamba2-2.7b", "zamba2-2.7b",
         "moonshot-v1-16b-a3b", "nemotron-4-15b", "granite-34b",
         "qwen2-vl-72b", "qwen1.5-110b", "deepseek-v3-671b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
CELLS = [(a, s) for a in ARCHS for s in SHAPES]

# The archs whose cells each dry-run file runs, so that no file holds more
# than about 300 s of case time (the driver keeps a file on one worker):
# "a" tests/test_torch_dryrun.py and test_torch_dryrun_multipod.py, "b"
# the *_b.py files, "c" the *_c.py files.
ARCH_SLICES = {
    "a": ("minicpm-2b", "hubert-xlarge", "moonshot-v1-16b-a3b",
          "nemotron-4-15b", "deepseek-v3-671b"),
    "b": ("granite-34b", "qwen2-vl-72b", "qwen1.5-110b"),
    "c": ("mamba2-2.7b", "zamba2-2.7b"),
}


def cells(part: str):
    """The cells of ``CELLS`` whose arch is in slice ``part``."""
    return [c for c in CELLS if c[0] in ARCH_SLICES[part]]


class FakeMesh:
    """A JAX-mesh stand-in with ``shape``, ``axis_names`` and ``size``
    (``tests/test_launch.py``)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())


def _mesh(multi_pod):
    return FakeMesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})


def _per_device(tree, specs, mesh):
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        n = 1
        for e in spec:
            if e is None:
                continue
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= mesh.shape[a]
        total += math.prod(x.shape) * x.dtype.itemsize / n
    return total


def reference_argument_bytes(arch, shape_name, multi_pod):
    """The step's inputs, per device, as the reference's specs shard them
    (params, AdamW m/v in bf16 and its step; batch; or cache, tokens and
    the position)."""
    cfg, shape, mesh = jax_arch(arch), J_SHAPES[shape_name], _mesh(multi_pod)
    gb = shape.global_batch
    step_cfg = jsteps.StepConfig()
    dp = math.prod(mesh.shape[a] for a in jdp_axes(mesh))
    tokens = max(gb // dp, 1) if shape.kind == "decode" else 1 << 30
    jsteps._configure_ep(cfg, mesh, step_cfg, tokens_per_device=tokens)
    try:
        if shape.kind == "decode":
            cfg = j_serving_padded(cfg, mesh.shape["model"])
        params = jsteps.abstract_params(cfg)
        total = _per_device(params, jsh.param_specs(params, mesh), mesh)
        batch = jsteps.batch_struct(cfg, shape)
        if shape.kind == "train":
            opt = jsteps.abstract_opt_state(cfg, step_cfg.optimizer)
            for k in ("m", "v"):
                total += _per_device(opt[k], jsh.param_specs(opt[k], mesh),
                                     mesh)
            total += 4                                   # the step count
        if shape.kind == "decode":
            cache = jsteps.abstract_cache(cfg, shape)
            total += _per_device(cache, jsh.cache_specs(cache, mesh, gb),
                                 mesh)
            tok = dict(tokens=batch["tokens"])
            total += _per_device(tok, jsh.batch_specs(tok, mesh, gb), mesh)
            total += 4                                   # the position
        else:
            total += _per_device(batch, jsh.batch_specs(batch, mesh, gb),
                                 mesh)
        return total
    finally:
        jmoe.set_ep_mesh(None, ("data",))


def check_cell(arch, shape_name, multi_pod):
    """run_cell against the reference: applicability and reason, param
    counts, per-device argument bytes (exact), the keys and what they
    hold."""
    try:
        res = run_cell(arch, shape_name, multi_pod, verbose=False)
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    jcfg, shape = jax_arch(arch), J_SHAPES[shape_name]
    ok, why = j_applicable(jcfg, shape)
    if not ok:
        assert res == dict(arch=arch, shape=shape_name, multi_pod=multi_pod,
                           skipped=True, reason=why)
        return res
    assert res["skipped"] is False
    assert res["n_devices"] == (512 if multi_pod else 256)
    assert res["model_params"] == jcfg.param_count()
    assert res["active_params"] == jcfg.active_param_count()
    assert res["mem"]["argument_bytes"] == reference_argument_bytes(
        arch, shape_name, multi_pod)
    assert res["mem"]["output_bytes"] > 0
    for k in ("temp_bytes", "peak_bytes"):
        assert res["mem"][k] is None
    assert res["xla_flops"] is None and res["xla_bytes_accessed"] is None
    assert res["hlo_flops"] > 0 and res["hlo_bytes_written"] > 0
    assert res["hlo_flops_per_device"] == res["hlo_flops"] / res["n_devices"]
    ep = jcfg.is_moe and shape.kind != "decode"
    assert (res["wire_bytes_per_device"] > 0) == ep
    assert set(res["collective_bytes"]) == ({"all-to-all"} if ep else set())
    return res
