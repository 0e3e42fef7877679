"""The control of ``correct``: the plain reference in bfloat16, put in the
program's place, on a run's stream at the cell's own size.

    python3 tsbench/control.py --workload <cell> --events <n> --seeds 1,2,3

For each seed it makes the stream a run of the cell would make (the same
pool, the same blocks), runs the reference in float32 and in bfloat16, and
prints the numbers the check compares beside the configuration's limits.
The control has to come out not correct.  The benchmark's own runs do not
run it.
"""
import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def stream(run, n_events: int):
    """The blocks a run of ``n_events`` events hands to the reference."""
    cell = run.cell
    if cell["driver"] == "batch":
        n_call = int(cell["interval"]) * int(cell["intervals_per_call"])
        n_pool = int(cell["pool_calls"])
        pool = run.events(n_call * n_pool)
        return [{k: v[(c % n_pool) * n_call: (c % n_pool + 1) * n_call]
                 for k, v in pool.items()}
                for c in range(math.ceil(n_events / n_call))]
    pool = run.events(n_events)
    step = 1 << 20
    return [{k: v[lo: lo + step] for k, v in pool.items()}
            for lo in range(0, n_events, step)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--events", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from tsbench import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(args.workload, seed, 0, False, args.device, 0.0)
        run.initial_state_host = run.initial_state().cpu().numpy()
        run.blocks = stream(run, args.events)
        ref = harness.module("reference", run.config["app"])
        t = time.perf_counter()
        want, want_state = harness.reference_run(run)
        t_ref = time.perf_counter() - t
        got, got_state = harness.reference_run(run, dtype="bfloat16")
        nums = harness.compare(ref.OUTPUTS, got, want, got_state,
                               want_state, 0)
        lim = run.config["limits"]
        fails = sorted(k for k, v in nums.items() if v > lim[k])
        print(json.dumps(dict(workload=args.workload, seed=seed,
                              events=sum(len(next(iter(b.values())))
                                         for b in run.blocks),
                              reference_s=t_ref, control=nums,
                              limits=lim, control_fails=fails)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
