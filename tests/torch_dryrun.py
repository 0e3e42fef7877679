"""Helpers for the dry run's parity tests (``tests/test_torch_dryrun*.py``):
the reference's per-device argument bytes of a cell, counted from JAX's
``param_specs`` / ``batch_specs`` / ``cache_specs`` and ``jax.eval_shape``,
the check of one ``run_cell`` result against the reference (the memory fields'
identities too), the step traced
as the dry run traces it (``traced``), and the reference's partitioned step
compiled on 8 forced host devices in a subprocess (``xla_partitioned_costs``,
beside the port's own ``port_partitioned_costs``; also read by
``scripts/dryrun_vs_xla.py``).  Not a test module.
"""
import json
import math
import os
import subprocess
import sys
from unittest import mock

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

from repro_torch.configs import get_arch
from repro_torch.launch.dryrun import place_inputs, run_cell
from repro_torch.launch.hlo_analysis import ProgramTrace, analyze
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.steps import StepConfig, build_step
from repro_torch.models import ShapeCfg, moe_ep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
    hold: one shard's program of the partitioned step, so FLOPs per device
    (at least the shard's share of the forward's matmuls, its tokens
    through the non-embedding params over ``model``), an all-gather (FSDP)
    and a reduce-scatter (their gradients) in every train cell, EP
    all-to-alls exactly in the MoE train and prefill cells; ``mem``'s
    temp and peak bytes ints with ``peak = argument + temp``, and the live
    bytes at the call (``ProgramTrace.hold``) the argument bytes."""
    held = []
    hold = ProgramTrace.hold

    def spy(trace, tree):
        held.append(hold(trace, tree))
        return held[-1]

    try:
        with mock.patch.object(ProgramTrace, "hold", spy):
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
    mem = res["mem"]
    assert all(type(mem[k]) is int for k in ("temp_bytes", "peak_bytes"))
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0
    # the live bytes at the call: the placed inputs, short of decode's
    # position (a host int in the port, an int32 argument in the reference)
    assert held == [mem["argument_bytes"] - (4 if shape.kind == "decode"
                                             else 0)]
    assert res["xla_flops"] is None and res["xla_bytes_accessed"] is None
    assert res["hlo_flops"] > 0 and res["hlo_bytes_written"] > 0
    assert not [k for k in res if k.startswith("hlo") and
                k.endswith("_per_device")]
    mesh = _mesh(multi_pod)
    dp = math.prod(mesh.shape[a] for a in jdp_axes(mesh))
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 \
        else shape.global_batch
    tokens = rows * (1 if shape.kind == "decode" else shape.seq_len)
    body = jcfg.active_param_count() - 2 * jcfg.vocab * jcfg.d_model
    assert res["hlo_flops"] >= 2 * tokens * body / mesh.shape["model"]
    coll = res["collective_bytes"]
    assert coll and all(b > 0 for b in coll.values())
    assert res["wire_bytes_per_device"] > 0
    if shape.kind == "train":
        assert coll.get("all-gather", 0) > 0
        assert coll.get("reduce-scatter", 0) > 0
    ep = jcfg.is_moe and shape.kind != "decode"
    assert ("all-to-all" in coll) == ep
    return res


def traced(cfg, shape, mesh, step_cfg=StepConfig()):
    """The step of ``shape`` built on ``mesh`` and traced once on its
    inputs placed on the plan's mesh, as ``run_cell`` traces it (decode at
    the cache's last slot): (trace, plan); ``trace.held``, the live bytes
    at the call."""
    try:
        fn, structs = build_step(cfg, shape, mesh, step_cfg)
        args = list(structs)
        if shape.kind == "decode":
            args[-1] = shape.seq_len - 1
        placed = place_inputs(shape.kind, fn.plan, mesh, shape.global_batch,
                              args)
        with ProgramTrace() as trace:
            trace.held = trace.hold(placed)
            fn(*placed)
        return trace, fn.plan
    finally:
        moe_ep.set_ep_mesh(None, ("data",))


# -- the reference's partitioned step, compiled ------------------------------
XLA_MESH = (2, 4)                 # ("data", "model") over 8 host devices
XLA_WORKER = r'''import os
import sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import json
import jax
from repro.configs import get_arch
from repro.launch import steps
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import ShapeCfg, moe_ep

out, b, s, cells = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:]
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
res = {}
for cell in cells:
    arch, kind = cell.split(":")
    try:
        with mesh:
            fn, specs = steps.build_step(get_arch(arch).smoke(),
                                         ShapeCfg("t", s, b, kind), mesh)
            compiled = fn.lower(*specs).compile()
            got = analyze_hlo(compiled.as_text(), 8)
            mem = compiled.memory_analysis()
        res[cell] = dict(dot_flops=got["dot_flops"],
                         coll_bytes=got["coll_bytes"],
                         wire_bytes_per_device=got["wire_bytes_per_device"],
                         argument_bytes=mem.argument_size_in_bytes,
                         temp_bytes=mem.temp_size_in_bytes,
                         peak_bytes=getattr(mem, "peak_memory_in_bytes",
                                            mem.argument_size_in_bytes
                                            + mem.temp_size_in_bytes))
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    print(cell, "REF_OK", flush=True)
with open(out, "w") as f:
    json.dump(res, f)
'''


def xla_partitioned_costs(cells, batch, seq, workdir) -> dict:
    """``analyze_hlo`` of the reference's ``build_step`` for each ``(arch,
    kind)`` of ``cells`` (smoke configs, batch x seq), jitted with its
    shardings on a (data 2, model 4) mesh of Auto axes over 8 forced host
    devices and compiled, in one subprocess: ``{(arch, kind): {dot_flops,
    coll_bytes, wire_bytes_per_device, argument_bytes, temp_bytes,
    peak_bytes}}``, per device (the memory from ``memory_analysis()``, as
    the reference's dry run reads it)."""
    script = os.path.join(workdir, "xla_worker.py")
    out = os.path.join(workdir, "xla_costs.json")
    with open(script, "w") as f:
        f.write(XLA_WORKER)
    proc = subprocess.run(
        [sys.executable, script, out, str(batch), str(seq)]
        + [f"{a}:{k}" for a, k in cells], cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=900)
    if proc.returncode or proc.stdout.count("REF_OK") != len(cells):
        raise RuntimeError(proc.stderr[-3000:])
    with open(out) as f:
        got = json.load(f)
    return {tuple(k.split(":")): v for k, v in got.items()}


def port_partitioned_costs(arch, kind, batch, seq) -> dict:
    """``analyze`` of the port's dry-run trace of the same step, one
    shard's program on the one-shard form of the (data 2, model 4) mesh,
    with its live-bytes count: ``argument_bytes`` (held at the call),
    ``temp_bytes`` (the peak above them) and ``peak_bytes``."""
    trace, _ = traced(get_arch(arch).smoke(), ShapeCfg("t", seq, batch, kind),
                      MeshSpec(dict(zip(("data", "model"), XLA_MESH))))
    return dict(analyze(trace), argument_bytes=trace.held,
                temp_bytes=trace.peak_bytes - trace.held,
                peak_bytes=trace.peak_bytes)


def port_extra_flops(cfg, kind, batch, seq) -> float:
    """The matmul FLOPs a device does in the port's partitioned step beyond
    the reference's compiled one, on the (data 2, model 4) mesh, for a dense
    config with attention over heads:

    * where ``model`` does not divide the kv heads (MQA), each shard
      projects the whole ``wk``/``wv`` for its data block's tokens
      (``Partitioned._kv_heads``), where XLA projects each shard's
      sequence block and gathers K and V: (m - 1) / m of those products,
      once in the forward and, in the train step, again in the recompute
      and in the two products of their gradient;
    * in the train step, ``torch.utils.checkpoint`` recomputes every layer
      whole, the FFN's down projection too, whose output no gradient reads
      (XLA drops that recompute): one shard's down projection a layer."""
    if cfg.is_moe or cfg.mla or cfg.family != "dense":
        raise ValueError(f"{cfg.name}: only dense attention configs")
    dp, m = XLA_MESH
    rows = batch // dp * seq             # a data block's tokens, whole S
    extra = 0.0
    if cfg.n_kv_heads % m:
        kv = 2 * rows * cfg.d_model * 2 * cfg.n_kv_heads * cfg.hd
        extra += cfg.n_layers * kv * (m - 1) / m * (
            4 if kind == "train" else 1)
    if kind == "train":
        extra += cfg.n_layers * 2 * rows * (cfg.d_ff // m) * cfg.d_model
    return extra
