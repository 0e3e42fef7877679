"""Dry run of one (arch x shape x mesh) cell at full size, with no device
(reference: ``repro/launch/dryrun.py``).

The reference AOT-compiles each cell on 512 forced host devices and reads
XLA's partitioned program.  The port has no partitioner and no compiler: it
builds the params, optimizer state, batch and cache as shape-only ``meta``
tensors, runs the step once under ``launch/hlo_analysis.ProgramTrace`` on
the production ``MeshSpec``, and takes the per-device argument and output
bytes from the sharding specs (each leaf's bytes over the product of the
axis sizes its spec shards it on).  The MoE path takes equal expert groups
on meta tensors (``layers.group_sizes``), since a shape-only program has no
routing counts to read.

What needs XLA's partitioner or allocator has no counterpart and is None:
``xla_flops`` and ``xla_bytes_accessed`` (XLA's own cost analysis),
``mem.temp_bytes`` and ``mem.peak_bytes`` (its buffer assignment).  FLOPs
and bytes written are of the global program; the ``*_per_device`` keys
divide them by the device count.  The collectives counted are the
program's own (the EP all-to-alls, forward and backward); the partitioner's
implicit ones (FSDP gathers, gradient reductions) are not in an eager
program and are not counted.  ``trace_s`` takes the place of ``lower_s``
and ``compile_s``.  The traced program is the one-device one (a
``MeshSpec`` has no shards to run), which has a single layer carry:
``seq_shard_acts`` is reported, and changes nothing traced (the
partitioned program shards the carry, ``models/partitioned.py``).

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
                       per_device_bytes)
from .steps import StepConfig, build_step, logits_spec


def _arg_out_bytes(kind, cfg, shape, mesh, args, out):
    """(argument, output) bytes per device from the specs."""
    gb = shape.global_batch
    scalar = 4.0                           # the step counter / pos / loss
    if kind == "train":
        params, opt, batch = args
        state = (per_device_bytes(params, param_specs(params, mesh), mesh)
                 + per_device_bytes(opt["m"], param_specs(opt["m"], mesh),
                                    mesh)
                 + per_device_bytes(opt["v"], param_specs(opt["v"], mesh),
                                    mesh) + scalar)
        batch_b = per_device_bytes(batch, batch_specs(batch, mesh, gb), mesh)
        return state + batch_b, state + scalar
    if kind == "prefill":
        params, batch = args
        arg = (per_device_bytes(params, param_specs(params, mesh), mesh)
               + per_device_bytes(batch, batch_specs(batch, mesh, gb), mesh))
        return arg, per_device_bytes(dict(logits=out), dict(
            logits=logits_spec(cfg, shape, mesh)), mesh)
    params, cache, tokens, _ = args
    cache_b = per_device_bytes(cache, cache_specs(cache, mesh, gb), mesh)
    tok = dict(tokens=tokens)
    arg = (per_device_bytes(params, param_specs(params, mesh), mesh) + cache_b
           + per_device_bytes(tok, batch_specs(tok, mesh, gb), mesh) + scalar)
    logits = per_device_bytes(dict(logits=out[0]), dict(
        logits=logits_spec(cfg, shape, mesh, decode=True)), mesh)
    return arg, logits + cache_b


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
    with ProgramTrace() as trace:
        out = fn(*args)
    t_trace = time.perf_counter() - t0
    cost = analyze(trace, n_dev)
    arg_b, out_b = _arg_out_bytes(shape.kind, cfg, shape, mesh, args, out)

    result = dict(
        arch=arch, shape=shape_name, multi_pod=multi_pod, skipped=False,
        n_devices=n_dev, trace_s=round(t_trace, 1),
        # XLA's own cost analysis: no counterpart without XLA
        xla_flops=None, xla_bytes_accessed=None,
        # the traced program (global; see the module docstring)
        hlo_flops=cost["dot_flops"],
        hlo_bytes_written=cost["bytes_written"],
        hlo_flops_per_device=cost["dot_flops_per_device"],
        hlo_bytes_written_per_device=cost["bytes_written_per_device"],
        collective_bytes=cost["coll_bytes"],
        wire_bytes_per_device=cost["wire_bytes_per_device"],
        seq_shard_acts=seq_shard,
        mem=dict(argument_bytes=arg_b, output_bytes=out_b,
                 temp_bytes=None, peak_bytes=None),
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
