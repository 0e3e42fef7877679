"""Run one benchmark cell once and print its result as the last line.

    python3 tsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a traced run.  The last lines of standard error, and
the result's ``checks``, give each number compared with the plain reference
beside its limit.  Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell asks for), and when the process has loaded
jax, jaxlib, flax or the JAX package ``repro``.  ``--rate`` overrides a
service cell's fixed rate (the sweep that fixes it); the benchmark's own
runs never pass it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "tsbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    args = ap.parse_args(argv)
    faulthandler.enable()       # a crash in native code prints its stacks

    # every cache of the program at a fixed path inside the checkout: the
    # kernels build into build/torch_kernels/, the dispatch search's
    # decisions persist here
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["REPRO_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    # the profiler's set-up session and the window's are two sessions; by
    # default CUPTI is torn down after the first and attached again at the
    # second, while the service's executor thread launches kernels: a
    # traced run then may hold the copies and none of the kernels, or
    # crash at the window's end.  Kept attached, the second session only
    # switches the recording on.
    os.environ["TEARDOWN_CUPTI"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    from tsbench import harness
    cell = harness.load(f"workloads/{args.workload}.json")
    import torch
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"tsbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    overrides = {} if args.rate is None else dict(rate_events_per_s=args.rate)
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T0, overrides)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"tsbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
