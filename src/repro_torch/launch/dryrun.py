"""Dry run of one (arch x shape x mesh) cell at full size, with no device
(reference: ``repro/launch/dryrun.py``).

The reference AOT-compiles each cell on 256 or 512 forced host devices and
reads XLA's partitioned program, a per-device SPMD program.  The port has no
partitioner and no compiler: it builds the params, optimizer state, batch
and cache as shape-only ``meta`` tensors and traces **one shard's program
of the partitioned step** (``models/partitioned.Partitioned``) on the
production mesh, (data 16, model 16) or (pod 2, data 16, model 16), under
``launch/hlo_analysis.ProgramTrace``.  The step builders take the
production ``MeshSpec`` to its one-shard form (``core/mesh.ShardMesh.
one_shard``): the inputs are placed by the reference's specs as shard 0's
blocks (``launch/sharding.place_params`` / ``place_batch`` /
``place_cache``), the program runs shard 0's part, and each collective
returns shard 0's result and is recorded with its group.  Shard 0's
coordinates are all 0, so its blocks have every shard's shapes, and the
trace is the per-device program the reference reads:

* ``hlo_flops`` and ``hlo_bytes_written`` are per device (one shard's
  matmul FLOPs and bytes written), as in XLA's per-device HLO.  The train
  step's global norm counts each gradient block on its first replica
  (``Partitioned.global_norm``); shard 0 is the first replica of every
  block, so its norm terms are the most any shard writes;
* ``collective_bytes`` (by kind, shard 0's result bytes) and
  ``wire_bytes_per_device`` (the ring formulas over each group) cover every
  collective shard 0 runs: the FSDP gathers over the data axes and their
  reduce-scatters in the backward, the TP and vocab-parallel psums over
  ``model``, the sequence-parallel gathers and reduce-scatters along S
  (``seq_shard_acts``), the EP all-to-alls, the replicated leaves'
  gradient psums (``ShardMesh.psum_replicas``) and the loss's psums over
  the data axes; under remat "full" a layer's gathers count in its forward
  and again in the backward's recompute;
* ``mem.argument_bytes`` and ``mem.output_bytes`` are per device from the
  specs (each leaf's bytes over the product of the axis sizes its spec
  shards it on; the prefill and decode logits, shard 0's block of them);
* ``mem.peak_bytes`` is the most live bytes shard 0's traced program
  reaches, its inputs included (``ProgramTrace.peak_bytes``), and
  ``mem.temp_bytes`` is ``peak_bytes - argument_bytes``, the reference's
  relation; both ints, per device.  They are eager PyTorch's footprint of
  one shard's program, every op's output its own buffer, freed when the
  program drops its last reference to it: what a card running the port
  holds for the step, not XLA's fused buffer assignment.  A collective
  counts its result at one device's size (the one-shard form returns shard
  0's); an op's internal workspace (cuBLAS's) is not seen.  The live bytes
  at the call (the placed inputs, ``ProgramTrace.hold``) equal
  ``argument_bytes`` in every train and prefill cell; in a decode cell
  they are 4 bytes short, since the position is a host int in the port
  and an int32 argument in the reference.

The MoE path takes equal expert groups on meta tensors
(``layers.group_sizes``), since a shape-only program has no routing counts
to read.  What needs XLA's compiler has no counterpart and is None:
``xla_flops`` and ``xla_bytes_accessed`` (XLA's own cost analysis).
``trace_s`` (building, placing and tracing) takes the place of ``lower_s``
and ``compile_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-34b --shape train_4k
  python -m repro_torch.launch.dryrun --arch deepseek-v3-671b \
      --shape decode_32k --multi-pod --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..configs import get_arch
from ..models import SHAPE_BY_NAME, cell_is_applicable
from ..optim import AdamWConfig
from .hlo_analysis import ProgramTrace, analyze
from .mesh import make_production_mesh
from .sharding import (batch_specs, cache_specs, param_specs,
                       per_device_bytes, place_batch, place_cache,
                       place_params)
from .steps import StepConfig, build_step


_SCALAR = 4.0                           # the step counter / pos / loss


def argument_bytes(kind, shape, mesh, args) -> float:
    """The step's argument bytes per device from the specs on ``mesh``
    (the whole ``meta`` inputs ``args``)."""
    gb = shape.global_batch
    params = args[0]
    total = per_device_bytes(params, param_specs(params, mesh), mesh)
    if kind == "train":
        _, opt, batch = args
        return (total + _state_bytes(opt, mesh)
                + per_device_bytes(batch, batch_specs(batch, mesh, gb), mesh))
    if kind == "prefill":
        return total + per_device_bytes(args[1], batch_specs(
            args[1], mesh, gb), mesh)
    _, cache, tokens, _ = args
    tok = dict(tokens=tokens)
    return (total + per_device_bytes(cache, cache_specs(cache, mesh, gb),
                                     mesh)
            + per_device_bytes(tok, batch_specs(tok, mesh, gb), mesh)
            + _SCALAR)


def _state_bytes(opt, mesh) -> float:
    """AdamW's moments per device and its step counter."""
    return (per_device_bytes(opt["m"], param_specs(opt["m"], mesh), mesh)
            + per_device_bytes(opt["v"], param_specs(opt["v"], mesh), mesh)
            + _SCALAR)


def _block_bytes(groups) -> float:
    """Bytes of shard 0's block of a value in the one-shard form."""
    return float(groups[0][0].numel() * groups[0].element_size())


def output_bytes(kind, shape, mesh, args, out) -> float:
    """The step's output bytes per device: the new params and AdamW state
    and the loss (train), from the specs; the logits, shard 0's block of
    them (their spec's per-device bytes), and the decode cache."""
    if kind == "train":
        params, opt, _ = args
        return (per_device_bytes(params, param_specs(params, mesh), mesh)
                + _state_bytes(opt, mesh) + _SCALAR)
    if kind == "prefill":
        return _block_bytes(out)
    cache = args[1]
    return _block_bytes(out[0]) + per_device_bytes(
        cache, cache_specs(cache, mesh, shape.global_batch), mesh)


def place_inputs(kind, plan, mesh, global_batch: int, args) -> list:
    """The step's whole ``meta`` inputs at rest on the plan's mesh (the
    one-shard form of ``mesh``: shard 0's blocks), by the reference's specs
    read on ``mesh``."""
    pm = plan.mesh
    if kind == "train":
        params, opt, batch = args
        return [place_params(params, pm, plan.specs),
                place_params(opt, pm, param_specs(opt, mesh)),
                place_batch(batch, pm, global_batch)]
    if kind == "prefill":
        params, batch = args
        return [place_params(params, pm, plan.specs),
                place_batch(batch, pm, global_batch)]
    params, cache, tokens, pos = args
    return [place_params(params, pm, plan.specs),
            place_cache(cache, pm, global_batch),
            place_batch(dict(tokens=tokens), pm, global_batch)["tokens"],
            pos]


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, remat="full",
             seq_shard=True, opt_bf16=True, kv_chunk=1024,
             expert_parallel=True, serving_head_pad=True, verbose=True):
    cfg = get_arch(arch)
    shape = SHAPE_BY_NAME[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        return dict(arch=arch, shape=shape_name, multi_pod=multi_pod,
                    skipped=True, reason=why)

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    step_cfg = StepConfig(
        remat=remat, seq_shard_acts=seq_shard, kv_chunk=kv_chunk,
        expert_parallel=expert_parallel, serving_head_pad=serving_head_pad,
        optimizer=AdamWConfig(
            state_dtype=torch.bfloat16 if opt_bf16 else torch.float32))

    t0 = time.perf_counter()
    fn, specs = build_step(cfg, shape, mesh, step_cfg)
    args = list(specs)
    if shape.kind == "decode":
        args[-1] = shape.seq_len - 1     # the last slot of the cache
    placed = place_inputs(shape.kind, fn.plan, mesh, shape.global_batch,
                          args)
    with ProgramTrace() as trace:
        trace.hold(placed)
        out = fn(*placed)
    t_trace = time.perf_counter() - t0
    cost = analyze(trace)
    arg_b = argument_bytes(shape.kind, shape, mesh, args)
    out_b = output_bytes(shape.kind, shape, mesh, args, out)

    result = dict(
        arch=arch, shape=shape_name, multi_pod=multi_pod, skipped=False,
        n_devices=n_dev, trace_s=round(t_trace, 1),
        # XLA's own cost analysis: no counterpart without XLA
        xla_flops=None, xla_bytes_accessed=None,
        # one shard's traced program: per device (module docstring)
        hlo_flops=cost["dot_flops"],
        hlo_bytes_written=cost["bytes_written"],
        collective_bytes=cost["coll_bytes"],
        wire_bytes_per_device=cost["wire_bytes_per_device"],
        seq_shard_acts=seq_shard,
        mem=dict(argument_bytes=arg_b, output_bytes=out_b,
                 temp_bytes=int(trace.peak_bytes - arg_b),
                 peak_bytes=trace.peak_bytes),
        model_params=cfg.param_count(),
        active_params=cfg.active_param_count(),
    )
    if verbose:
        print(json.dumps(result, indent=2, default=float))
        print(f"[dryrun] {arch} × {shape_name} × "
              f"{'multi-pod(2,16,16)' if multi_pod else 'single-pod(16,16)'} "
              f"traced in {t_trace:.1f}s", file=sys.stderr)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--opt-fp32", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    result = run_cell(args.arch, args.shape, args.multi_pod,
                      remat=args.remat, seq_shard=not args.no_seq_shard,
                      opt_bf16=not args.opt_fp32)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        tag = f"{args.arch}__{args.shape}__{'mp' if args.multi_pod else 'sp'}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(result, f, indent=2, default=float)
    return result


if __name__ == "__main__":
    main()
