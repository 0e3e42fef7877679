"""Dry-run sweep driver: every (arch x shape x mesh) cell, resumable
(reference: ``repro/launch/sweep.py``).

Each cell runs in-process in turn; each result is written as one JSON file,
and a rerun skips the cells whose file exists.  Run:
``PYTHONPATH=src python -m repro_torch.launch.sweep [--out DIR]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

# cheapest-first so early failures surface fast
ARCH_ORDER = [
    "minicpm-2b", "hubert-xlarge", "mamba2-2.7b", "zamba2-2.7b",
    "moonshot-v1-16b-a3b", "nemotron-4-15b", "granite-34b",
    "qwen2-vl-72b", "qwen1.5-110b", "deepseek-v3-671b",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--only-multi-pod", action="store_true")
    ap.add_argument("--only-single-pod", action="store_true")
    ap.add_argument("--archs", default="")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from .dryrun import run_cell

    archs = args.archs.split(",") if args.archs else ARCH_ORDER
    meshes = [False, True]
    if args.only_multi_pod:
        meshes = [True]
    if args.only_single_pod:
        meshes = [False]

    for multi_pod in meshes:
        for arch in archs:
            for shape in SHAPE_ORDER:
                tag = f"{arch}__{shape}__{'mp' if multi_pod else 'sp'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[sweep] skip cached {tag}", file=sys.stderr)
                    continue
                print(f"[sweep] running {tag}", file=sys.stderr, flush=True)
                try:
                    res = run_cell(arch, shape, multi_pod, verbose=False)
                except Exception as e:  # record failures, keep sweeping
                    res = dict(arch=arch, shape=shape, multi_pod=multi_pod,
                               error=f"{type(e).__name__}: {e}",
                               traceback=traceback.format_exc()[-2000:])
                    print(f"[sweep] FAILED {tag}: {e}", file=sys.stderr,
                          flush=True)
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=float)
    print("[sweep] done", file=sys.stderr)


if __name__ == "__main__":
    main()
