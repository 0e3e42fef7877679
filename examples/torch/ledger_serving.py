"""Streaming Ledger under load on the PyTorch port: concurrent transfers with
aborts (reference: ``examples/ledger_serving.py``).

Demonstrates §IV-C2 abort handling (rejected transfers leave no partial
effects) and conservation of money under the dual-mode engine on the CUDA
card.

    PYTHONPATH=src python examples/torch/ledger_serving.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.apps import SL
from repro_torch.core import DualModeEngine, EngineConfig
from repro_torch.kernels.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(7)
    stream = SL.gen_events(rng, 3000)
    store = SL.make_store(device=dev)
    before = float(store.values.cpu().numpy().sum())

    eng = DualModeEngine(SL, store, EngineConfig(scheme="tstream",
                                                 abort_repass=True),
                         device=dev)
    outs, values = eng.run_stream(store.values, stream, punct_interval=500)

    rejected = np.concatenate([np.asarray(o["rejected"]) for o in outs])
    after = float(values.cpu().numpy().sum())
    n_proc = (len(rejected) // 500) * 500
    dep_amt = stream["amount"][:n_proc][~stream["is_transfer"][:n_proc]]
    print(f"[sl] processed {n_proc} events, "
          f"{int(rejected.sum())} transfers rejected (insufficient funds)")
    print(f"[sl] ledger total {before:.1f} -> {after:.1f} "
          f"(deposited {2 * dep_amt.sum():.1f})")
    np.testing.assert_allclose(after - before, 2 * dep_amt.sum(), rtol=1e-3)
    print("[sl] conservation holds: committed transfers moved, "
          "rejected ones left no partial effects ✓")
    return dict(outs=outs, values=values.cpu(), before=before, after=after)


if __name__ == "__main__":
    main()
