#!/usr/bin/env python3
"""The dry run's partitioned trace beside the reference's compiled
partitioned program, per device, on the host (no card).

Run from the repository root:

    JAX_PLATFORMS=cpu python3 scripts/dryrun_vs_xla.py [--batch 8] [--seq 32]

For the dense smoke archs minicpm-2b and granite-34b, train and prefill:
the JAX package's ``build_step`` compiled with its shardings on a (data 2,
model 4) mesh over 8 forced host devices and read by its ``analyze_hlo``,
beside the port's step traced on the one-shard form of the same mesh
(``tests/torch_dryrun.py``, the helpers ``tests/
test_torch_dryrun_partitioned_ref.py`` holds to).  Prints one line a cell:
dot FLOPs a device (both, their ratio, the port's extra work counted from
the config, ``port_extra_flops``), then the collective bytes by kind and
the ring wire bytes a device (both and their ratio), then the memory a
device, the reference's ``compiled.memory_analysis()`` (argument, temp and
peak bytes, as its dry run reads them) beside the port's live-bytes count
of the trace (eager buffers against XLA's fused buffer assignment: no
bar), and last a JSON line of the same numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

CELLS = [(a, k) for a in ("minicpm-2b", "granite-34b")
         for k in ("train", "prefill")]


def _ratio(a: float, b: float):
    return a / b if b else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_arch
    from torch_dryrun import (port_extra_flops, port_partitioned_costs,
                              xla_partitioned_costs)
    with tempfile.TemporaryDirectory() as work:
        xla = xla_partitioned_costs(CELLS, args.batch, args.seq, work)
    rows = {}
    for arch, kind in CELLS:
        port = port_partitioned_costs(arch, kind, args.batch, args.seq)
        ref = xla[(arch, kind)]
        extra = port_extra_flops(get_arch(arch).smoke(), kind, args.batch,
                                 args.seq)
        kinds = sorted(set(port["coll_bytes"]) | set(ref["coll_bytes"]))
        coll = {k: dict(port=port["coll_bytes"].get(k, 0.0),
                        xla=ref["coll_bytes"].get(k, 0.0),
                        ratio=_ratio(port["coll_bytes"].get(k, 0.0),
                                     ref["coll_bytes"].get(k, 0.0)))
                for k in kinds}
        row = dict(dot_flops=dict(
            port=port["dot_flops"], xla=ref["dot_flops"],
            ratio=_ratio(port["dot_flops"], ref["dot_flops"]),
            port_extra=extra,
            net_ratio=_ratio(port["dot_flops"] - extra, ref["dot_flops"])),
            coll_bytes=coll, wire_bytes_per_device=dict(
                port=port["wire_bytes_per_device"],
                xla=ref["wire_bytes_per_device"],
                ratio=_ratio(port["wire_bytes_per_device"],
                             ref["wire_bytes_per_device"])),
            mem={k: dict(port=port[k], xla=ref[k],
                         ratio=_ratio(port[k], ref[k]))
                 for k in ("argument_bytes", "temp_bytes", "peak_bytes")})
        rows[f"{arch}:{kind}"] = row
        f = row["dot_flops"]
        print(f"{arch} x {kind} (smoke, batch {args.batch} x seq "
              f"{args.seq}, (data 2, model 4)): dot_flops per device port "
              f"{f['port']} xla {f['xla']} ratio {f['ratio']} (port extra "
              f"{f['port_extra']}, net ratio {f['net_ratio']}) | "
              + " ".join(f"{k} port {v['port']} xla {v['xla']} ratio "
                         f"{v['ratio']}" for k, v in coll.items())
              + f" | wire_bytes_per_device port "
                f"{row['wire_bytes_per_device']['port']} xla "
                f"{row['wire_bytes_per_device']['xla']} | "
              + " ".join(f"{k} port {v['port']} xla {v['xla']} ratio "
                         f"{v['ratio']}" for k, v in row["mem"].items()))
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
