"""Toll Processing end-to-end on the PyTorch port (the paper's motivating
application, Fig 2b; reference: ``examples/toll_processing.py``).

Streams Linear-Road position reports through the fused RS/VC/TN operator
with concurrent shared state on the CUDA card, comparing all
consistency-preserving engines.

    PYTHONPATH=src python examples/torch/toll_processing.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.apps import TP
from repro_torch.core import DualModeEngine, EngineConfig
from repro_torch.kernels.runtime import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(42)
    stream = TP.gen_events(rng, 2000)
    store = TP.make_store(device=dev)

    results = {}
    for scheme in ["tstream", "lock", "pat"]:
        eng = DualModeEngine(TP, store, EngineConfig(scheme=scheme),
                             device=dev)
        t0 = time.time()
        outs, values = eng.run_stream(store.values, stream,
                                      punct_interval=500)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        tolls = np.concatenate([np.asarray(o["toll"]) for o in outs])
        results[scheme] = (values.cpu(), tolls, dt)
        print(f"[tp] {scheme:8s}: {len(tolls)} tolls in {dt:.2f}s, "
              f"mean toll {tolls.mean():.3f}, "
              f"congested events {(tolls > 0).sum()}")

    v_t, tolls_t, _ = results["tstream"]
    v_l, tolls_l, _ = results["lock"]
    np.testing.assert_allclose(v_t.numpy(), v_l.numpy(), rtol=1e-4)
    np.testing.assert_allclose(tolls_t, tolls_l, rtol=1e-4)
    print("[tp] all schemes agree with the sequential oracle ✓")
    return results


if __name__ == "__main__":
    main()
