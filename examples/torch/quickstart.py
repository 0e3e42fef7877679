"""Quickstart on the PyTorch port: concurrent stateful stream processing in
40 lines (reference: ``examples/quickstart.py``).

Defines a tiny word-count-style application over shared state, runs it
through TStream's dual-mode engine on the CUDA card, and checks the result
against the sequential oracle (the ``lock`` scheme).

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import AppSpec, DualModeEngine, EngineConfig, make_store
from repro_torch.core.types import ASSOC_FUNS
from repro_torch.kernels.runtime import resolve_device

N_KEYS = 100


def make_app():
    def state_access(blt, eb):
        # one transaction: bump the key's counter, read it back
        blt.read_modify(0, eb["key"], eb["amount"], "add")
        blt.read(0, eb["key"])

    return AppSpec(
        name="counter", funs=ASSOC_FUNS, max_ops=2, width=1,
        make_store=lambda device=None, **_: make_store([N_KEYS], 1,
                                                       device=device),
        gen_events=lambda rng, n: dict(
            key=rng.integers(0, N_KEYS, n).astype(np.int32),
            amount=rng.uniform(0, 10, n).astype(np.float32)),
        pre_process=lambda ev: ev,
        state_access=state_access,
        # post_process is batched over events: [..., event, op, lane]
        post_process=lambda eb, res: dict(count_after=res.pre[..., 1, 0]),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' runs on the CPU; the CUDA card by default")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    app = make_app()
    store = app.make_store(device=dev)
    rng = np.random.default_rng(0)
    stream = app.gen_events(rng, 256)

    engine = DualModeEngine(app, store, EngineConfig(scheme="tstream"),
                            device=dev)
    outs, values = engine.run_stream(store.values, stream,
                                     punct_interval=64)

    oracle = DualModeEngine(app, store, EngineConfig(scheme="lock"),
                            device=dev)
    outs_o, values_o = oracle.run_stream(store.values, stream,
                                         punct_interval=64)
    np.testing.assert_allclose(values.cpu().numpy(), values_o.cpu().numpy(),
                               rtol=1e-5)
    total = float(values.cpu().numpy()[:N_KEYS].sum())
    print(f"quickstart OK — {len(outs)} punctuation intervals, "
          f"total count {total:.1f}, matches oracle ✓")
    return dict(outs=outs, values=values.cpu(), oracle_values=values_o.cpu())


if __name__ == "__main__":
    main()
