"""Kernels on a tensor's own card, and the sharded driver over device
groups, on the card.

Every test here needs NVIDIA cards: it is marked ``cuda``, decides in a
fixture whether enough cards are present and skips without them.  The file
imports no JAX.  On a machine with four cards:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_groups.py

* Each kernel wrapper, called on tensors on ``cuda:1`` while the current
  device is ``cuda:0``, launches on ``cuda:1`` (its outputs are there, the
  current device is left as it was) and gives the bits the same call gives
  on ``cuda:0``; each result is also held to its plain twin (bitwise, the
  affine scan to rtol = atol = 1e-5).
* The grouped sharded driver on two groups of one card (``["cuda:0",
  "cuda:0"]``) and on one group a card: GS on the megakernel rung and SL on
  the lockstep schedule bitwise with the one-group run on ``cuda:0``, TP
  ``shared_per_socket`` to rtol = atol = 1e-5 (the CUDA affine scan
  associates by where a chain lies among its tiles, and a group scans only
  its own rows); the megakernel launches once per group.
* Expert-parallel MoE over the same groupings of a (2, 4) mesh (moonshot's
  smoke config, bf16): the layer's output, kept mask and every gradient,
  the routed experts at rest in the groups by the EP rule, bitwise with
  one group on ``cuda:0``; and the partitioned train step (every leaf, the
  AdamW state and the batch placed, ``launch/sharding.place_params``):
  step 0's loss and gradients bitwise with one group, none of them NaN,
  and after a step every block still on its card.  ``compressed_psum``
  over ``data`` on those groups, bitwise with one group.
* The partitioned train step of a dense arch (minicpm-2b's smoke config,
  bf16; TP and FSDP) over the same groupings: step 0's loss and every
  gradient bitwise with one group, none NaN, and three steps' losses,
  params and state bitwise.
* The sequence-sharded carry (minicpm-2b's and zamba2-2.7b's smoke
  configs) against the whole carry over the same groupings: step 0's loss
  bitwise, every gradient within 2e-2 of its norm; sharded, every grouping
  bitwise with one group.
* The dry run's live-bytes count with a group a card on four cards: each
  of cards 1-3 peaks, in the partitioned train step, within 10% + 64 MiB
  of the one-shard meta trace's temp bytes.
"""
import numpy as np
import pytest
import torch

from repro_torch import LAUNCHES, reset_launches
from repro_torch.apps import ALL_APPS
from repro_torch.core import types as T
from repro_torch.core.engines import simple_affine_luts
from repro_torch.core.mesh import ShardMesh, card_groups
from repro_torch.core.restructure import restructure
from repro_torch.core.scheduler import DualModeEngine, EngineConfig
from repro_torch.kernels.hash_probe.ops import hash_probe
from repro_torch.kernels.hash_probe.ref import build_table, hash_probe_ref
from repro_torch.kernels.megakernel.ops import fused_chain_eval
from repro_torch.kernels.megakernel.ref import fused_chain_stream_ref
from repro_torch.kernels.radix_partition.ops import radix_partition_rank
from repro_torch.kernels.radix_partition.ref import radix_partition_rank_ref
from repro_torch.kernels.segscan.ops import segscan_affine, segscan_max
from repro_torch.kernels.segscan.ref import segscan_affine_ref, segscan_max_ref

pytestmark = pytest.mark.cuda

INTERVAL = 128


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def two_cards(card):
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA cards ({torch.cuda.device_count()} "
                    "present)")
    return card, torch.device("cuda", 1)


def _kernel_case(name):
    """(call, twin, inputs on the CPU, bitwise) of each kernel wrapper."""
    g = torch.Generator().manual_seed(3)
    if name == "radix_partition":
        keys = torch.randint(0, 1001, (40, 5000), generator=g,
                             dtype=torch.int32)
        return (lambda k: radix_partition_rank(k, 1001),
                lambda k: radix_partition_rank_ref(k, 1001), (keys,), True)
    if name in ("segscan_affine", "segscan_max"):
        a = torch.rand(300_000, 2, generator=g) * 1.5
        b = (torch.rand(300_000, 2, generator=g) - 0.5) * 4
        f = torch.rand(300_000, generator=g) < 0.2
        if name == "segscan_max":
            return segscan_max, lambda m, s: segscan_max_ref(s, m), (b, f), \
                True
        return segscan_affine, lambda x, y, s: segscan_affine_ref(s, x, y), \
            (a, b, f), False
    if name == "hash_probe":
        table = torch.from_numpy(build_table(np.arange(10_000,
                                                       dtype=np.int32), 2500))
        q = torch.randint(-5, 12_000, (100_000,), generator=g,
                          dtype=torch.int32)
        return hash_probe, hash_probe_ref, (q, table), True
    # the megakernel on a GS-shaped stream: 3 intervals of 5,000 rows
    rng = np.random.default_rng(7)
    s, n, k = 10_000, 5000, 3
    idx = torch.arange(n, dtype=torch.int32)
    ops = T.OpBatch(
        uid=torch.from_numpy(rng.integers(0, s, (k, n)).astype(np.int32)),
        ts=(idx // 4).expand(k, n), txn=(idx // 4).expand(k, n),
        slot=(idx % 4).expand(k, n),
        kind=torch.zeros((k, n), dtype=torch.int32),
        fun=torch.from_numpy(rng.integers(0, 4, (k, n)).astype(np.int32)),
        gate=torch.full((k, n), -1, dtype=torch.int32),
        operand=torch.from_numpy(rng.normal(size=(k, n, 2)).astype(
            np.float32)),
        valid=torch.from_numpy(rng.random((k, n)) > .01))
    sops, ch = restructure(ops, s, rowmajor_ts=True, light=True,
                           method="partition", geometry=False,
                           use_kernels=False)
    values = torch.from_numpy(rng.normal(size=(s + 1, 2)).astype(np.float32))
    values[s] = 0.0
    funs = (T.F_NOP, T.F_READ, T.F_PUT, T.F_ADD)
    a_lut, b_lut = simple_affine_luts(funs, "cpu")

    def mega(v, so, c, al, bl, fn=fused_chain_eval):
        res, out, _ = fn(v.clone(), so, c, s, a_lut=al, b_lut=bl)
        return res["pre"], res["post"], res["success"], out
    return (mega, lambda *x: mega(*x, fn=fused_chain_stream_ref),
            (values, sops, ch, a_lut, b_lut), True)


def _move(x, dev):
    if isinstance(x, (T.OpBatch,)) or hasattr(x, "seg_start"):
        return type(x)(**{k: None if v is None else v.to(dev)
                          for k, v in vars(x).items()})
    return x.to(dev)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("kernel", ["radix_partition", "segscan_affine",
                                    "segscan_max", "hash_probe",
                                    "megakernel"])
def test_wrapper_launches_on_its_tensors_card(two_cards, kernel):
    first, second = two_cards
    call, twin, args, bitwise = _kernel_case(kernel)
    torch.cuda.set_device(first)
    got = {}
    for dev in (second, first):
        inputs = [_move(a, dev) for a in args]
        reset_launches()
        out = _outs(call(*inputs))
        torch.cuda.synchronize(dev)
        assert torch.cuda.current_device() == first.index
        assert sum(LAUNCHES.values()) > 0, "no kernel launched"
        assert all(o.device == dev for o in out), kernel
        got[dev] = out
        want = _outs(twin(*inputs))
        for o, w in zip(out, want):
            if bitwise:
                assert torch.equal(o, w), f"{kernel} on {dev} vs twin"
            else:
                torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-5)
    for a, b in zip(got[second], got[first]):
        assert torch.equal(a.cpu(), b.cpu()), f"{kernel}: cuda:1 vs cuda:0"


@pytest.fixture(params=["one_card", "a_card_a_group"])
def group_devices(request, card):
    """The group devices of a case: two groups on one card, or one group
    on each of up to four cards (as many as divide the 4 shards)."""
    if request.param == "one_card":
        return [card, card]
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards ({n} present)")
    devs = card_groups(4, card)
    assert len(devs) == (4 if n >= 4 else 2) and len(set(devs)) == len(devs)
    return devs


@pytest.mark.parametrize("app_name,method,layout,shape,names", [
    ("gs", "megakernel", "shared_nothing", (4,), ("dev",)),
    ("sl", "partition", "shared_nothing", (4,), ("dev",)),
    ("tp", "partition", "shared_per_socket", (2, 2), ("socket", "core"))])
def test_grouped_driver_on_cards_matches_one_group(
        card, group_devices, app_name, method, layout, shape, names):
    devices = group_devices
    app = ALL_APPS[app_name]
    stream = app.gen_events(np.random.default_rng(11), 4 * INTERVAL)
    cfg = EngineConfig(restructure_method=method)
    runs = {}
    for devs in ([card], devices):
        mesh = ShardMesh(shape, names, devices=devs)
        eng = DualModeEngine(app, app.make_store(device=card), cfg,
                             device=card, mesh=mesh, layout=layout,
                             exchange_slack=8.0)
        reset_launches()
        outs, vals = eng.run_stream(eng.init_store.values, stream, INTERVAL)
        st = eng.last_exchange_stats
        assert int(np.sum(st["dropped"])) == 0
        assert eng.last_rung == method
        runs[len(devs)] = (outs, vals, dict(LAUNCHES))
    (o1, v1, l1), (og, vg, lg) = runs[1], runs[len(devices)]
    g = len(devices)
    assert lg["radix_partition"] == g * l1["radix_partition"]
    assert lg["megakernel"] == g * l1["megakernel"]
    if method == "megakernel":
        assert l1["megakernel"] == 3            # one stream call
    if app_name == "tp":
        torch.testing.assert_close(vg, v1, rtol=1e-5, atol=1e-5)
        for a, b in zip(og, o1):
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(vg, v1)
        for a, b in zip(og, o1):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(params=["one_card", "a_card_a_group"])
def ep_devices(request, card):
    """The groups of a (2, 4) EP mesh: two on one card, or one a card on
    up to four cards (as many as divide the 8 shards)."""
    if request.param == "one_card":
        return [card, card]
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two CUDA cards ({n} present)")
    return card_groups(8, card)


def _same_bits(a, b) -> bool:
    """Bitwise equal, and no NaN in either (C6 once gave NaN gradients)."""
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
        and not bool(torch.isnan(a).any()))


def _ep_setup(card, seed=0):
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    cfg = get_arch("moonshot-v1-16b-a3b").smoke()
    params = init_params(cfg, torch.Generator(device=card).manual_seed(seed),
                         device=card)
    params["stacks"]["moe"]["ffn"]["router"][..., :2] += 4.0      # skew
    return cfg, params


def _ep_mesh(devs):
    return ShardMesh((2, 4), ("data", "model"), devices=devs)


def test_grouped_ep_on_cards_matches_one_group(card, ep_devices):
    from repro_torch.launch.sharding import param_specs, place_params
    from repro_torch.models import moe_ep
    cfg, params = _ep_setup(card)
    layer = {k: v[0] for k, v in params["stacks"]["moe"]["ffn"].items()}
    x0 = torch.randn((8, 64, cfg.d_model), generator=torch.Generator(
        device=card).manual_seed(1), device=card).to(torch.bfloat16) + 0.5
    experts = ("wu", "wg", "wd")
    runs = []
    try:
        for devs in ([card], ep_devices):
            mesh = _ep_mesh(devs)
            moe_ep.set_ep_mesh(mesh, ("data",))
            specs = param_specs({"ffn": layer}, mesh)["ffn"]
            placed = place_params({"ffn": layer}, mesh)["ffn"]
            leaves = {k: tuple(t.clone().requires_grad_() for t in placed[k])
                      if k in experts else v.clone().requires_grad_()
                      for k, v in layer.items()}
            x = x0.clone().requires_grad_()
            y = moe_ep.moe_forward_ep(cfg, leaves, x)
            flat = [t for v in leaves.values()
                    for t in (v if isinstance(v, tuple) else (v,))]
            grads = torch.autograd.grad(y.float().square().sum(), [x] + flat)
            it = iter(grads[1:])
            whole = {k: mesh.assemble(tuple(next(it) for _ in v), specs[k])
                     if isinstance(v, tuple) else next(it)
                     for k, v in leaves.items()}
            with torch.no_grad():
                keep = torch.cat([r.keep.to(card) for r in
                                  moe_ep.route_groups(cfg, leaves, x0)])
            runs.append((y.detach(), keep, grads[0], whole))
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    (y1, k1, gx1, w1), (yg, kg, gxg, wg) = runs
    assert not k1.all()                         # choices were dropped
    assert torch.equal(yg, y1) and torch.equal(kg, k1)
    assert _same_bits(gxg, gx1)
    for k in w1:
        assert _same_bits(wg[k], w1[k]), k


def _partitioned_runs(card, devices, cfg, params, batch, steps,
                      step_cfg=None):
    """Step 0's loss and gradients of the partitioned train step on a
    (2, 4) mesh in one group on ``card`` and in ``devices``, then
    ``steps`` steps: (loss, whole grads, losses, whole params and state,
    the placed params, mesh) a grouping."""
    from repro_torch.launch.sharding import (gather_params, param_specs,
                                             place_batch, place_params)
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, moe_ep
    from repro_torch.optim import adamw_init
    runs = []
    try:
        for devs in ([card], devices):
            mesh = _ep_mesh(devs)
            step, structs = build_train_step(
                cfg, ShapeCfg("t", batch["tokens"].shape[1], 8, "train"),
                mesh, step_cfg or StepConfig())
            ps = param_specs(structs[0], mesh)
            ss = param_specs(structs[1], mesh)
            p = place_params(params, mesh, ps)
            loss, grads = step.plan.loss_and_grads(p, place_batch(batch,
                                                                  mesh))
            st = place_params(adamw_init(params, StepConfig().optimizer),
                              mesh, ss)
            losses = []
            for _ in range(steps):
                p, st, loss_s = step(p, st, batch)
                losses.append(loss_s)
            runs.append((loss, gather_params(grads, mesh, ps), losses,
                         gather_params(dict(p=p), mesh, dict(p=ps)),
                         gather_params(st, mesh, ss), p, mesh))
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    return runs


def test_grouped_ep_train_step_on_cards(card, ep_devices):
    from repro_torch.ckpt.checkpoint import _flatten
    cfg, params = _ep_setup(card, seed=2)
    toks = torch.randint(0, cfg.vocab, (8, 65), generator=torch.Generator(
        device=card).manual_seed(3), device=card, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    (l1, g1, ls1, *_), (lg, gg, lsg, _, _, p2, mesh) = _partitioned_runs(
        card, ep_devices, cfg, params, batch, 1)
    assert torch.equal(lg, l1) and torch.equal(lsg[0], ls1[0])
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert _same_bits(a, b), path
    wu = p2["stacks"]["moe"]["ffn"]["wu"]
    assert isinstance(wu, tuple) and [w.device for w in wu] == list(
        mesh.devices)


def test_partitioned_train_step_on_cards(card, ep_devices):
    """minicpm-2b's smoke config (MHA on TP, FSDP over data), bf16."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    cfg = get_arch("minicpm-2b").smoke()
    params = init_params(cfg, torch.Generator(device=card).manual_seed(5),
                         device=card)
    toks = torch.randint(0, cfg.vocab, (8, 33), generator=torch.Generator(
        device=card).manual_seed(5), device=card, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    (l1, g1, ls1, p1, s1, _, _), (lg, gg, lsg, pg, sg, placed, mesh) = \
        _partitioned_runs(card, ep_devices, cfg, params, batch, 3)
    assert torch.equal(lg, l1)
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert _same_bits(a, b), path
    assert torch.equal(torch.stack(lsg), torch.stack(ls1))
    for (path, a), (_, b) in zip(_flatten([pg, sg]), _flatten([p1, s1])):
        assert _same_bits(a.reshape(-1), b.reshape(-1)), path
    for path, x in _flatten(placed):
        assert x.device == mesh.devices[int(path[-1])], path


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-2.7b"])
def test_seq_sharded_carry_on_cards(card, ep_devices, arch):
    """The sequence-sharded carry (``seq_shard_acts``, the default) against
    the whole carry over the same groupings, bf16: step 0's loss bitwise,
    every gradient within the bf16 bar (2e-2 of its norm: the backward sums
    the shards' gradients at other points); with the carry sharded, the
    groups bitwise with one group (loss, gradients, two steps)."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models import init_params
    cfg = get_arch(arch).smoke()
    params = init_params(cfg, torch.Generator(device=card).manual_seed(7),
                         device=card)
    toks = torch.randint(0, cfg.vocab, (8, 33), generator=torch.Generator(
        device=card).manual_seed(7), device=card, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    on = _partitioned_runs(card, ep_devices, cfg, params, batch, 2)
    off = _partitioned_runs(card, ep_devices, cfg, params, batch, 0,
                            StepConfig(seq_shard_acts=False))
    (l1, g1, ls1, p1, s1, _, _), (lg, gg, lsg, pg, sg, _, _) = on
    assert torch.equal(lg, l1)
    assert torch.equal(torch.stack(lsg), torch.stack(ls1))
    for (path, a), (_, b) in zip(_flatten([gg, pg, sg]),
                                 _flatten([g1, p1, s1])):
        assert _same_bits(a.reshape(-1), b.reshape(-1)), path
    for run_on, run_off in zip(on, off):
        assert torch.equal(run_on[0], run_off[0])
        for (path, a), (_, b) in zip(_flatten(run_on[1]),
                                     _flatten(run_off[1])):
            a, b = a.double(), b.double()
            assert float((a - b).norm()) <= 2e-2 * float(b.norm()), path


def test_dryrun_memory_count_matches_each_card(card):
    """The dry run's one-shard count against the card's allocator with a
    group a card on four cards: minicpm-2b's smoke config, the partitioned
    train step on a (data 2, model 2) mesh, batch 8 x 2,048, after a
    warm-up step; each of cards 1-3 peaks above what it found within 10% +
    64 MiB of the one-shard meta trace's temp bytes (card 0 also holds the
    collectives' joins, ``core/mesh.ShardMesh.join``, and is not held)."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import place_inputs
    from repro_torch.launch.hlo_analysis import ProgramTrace
    from repro_torch.launch.mesh import MeshSpec, make_host_mesh
    from repro_torch.launch.sharding import (param_specs, place_batch,
                                             place_params)
    from repro_torch.launch.steps import StepConfig, build_train_step
    from repro_torch.models import ShapeCfg, init_params, moe_ep
    from repro_torch.optim import adamw_init
    n = torch.cuda.device_count()
    if n < 4:
        pytest.skip(f"needs four CUDA cards ({n} present)")
    devs = card_groups(4, card)
    cfg = get_arch("minicpm-2b").smoke()
    shape = ShapeCfg("t", 2048, 8, "train")
    params = init_params(cfg, torch.Generator(device=card).manual_seed(8),
                         device=card)
    toks = torch.randint(0, cfg.vocab, (8, 2049), generator=torch.Generator(
        device=card).manual_seed(8), device=card, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    try:
        mesh = make_host_mesh(model=2, data=2, devices=devs)
        fn, structs = build_train_step(cfg, shape, mesh)
        p = place_params(params, mesh, param_specs(structs[0], mesh))
        st = place_params(adamw_init(params, StepConfig().optimizer), mesh,
                          param_specs(structs[1], mesh))
        pb = place_batch(batch, mesh)
        del params
        fn(p, st, pb)
        gc.collect()
        for d in devs:
            torch.cuda.synchronize(d)
        base = [torch.cuda.memory_allocated(d) for d in devs]
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        fn(p, st, pb)
        for d in devs:
            torch.cuda.synchronize(d)
        measured = [torch.cuda.max_memory_allocated(d) - b
                    for d, b in zip(devs, base)]
        spec = MeshSpec({"data": 2, "model": 2})
        mfn, mstructs = build_train_step(cfg, shape, spec)
        placed = place_inputs("train", mfn.plan, spec, 8, list(mstructs))
        with ProgramTrace() as one:
            held = one.hold(placed)
            mfn(*placed)
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    predicted = one.peak_bytes - held
    for g in range(1, 4):
        m = measured[g]
        assert m > 0
        assert abs(predicted - m) <= 0.1 * m + (64 << 20), (g, predicted,
                                                             measured)


def test_grouped_compressed_psum_on_cards(card, ep_devices):
    from repro_torch.optim import compressed_psum
    gen = torch.Generator(device=card).manual_seed(4)
    grads = dict(a=torch.randn((8, 3000), generator=gen, device=card),
                 b=torch.randn((8, 40, 70), generator=gen, device=card))
    one = _ep_mesh([card])
    want = compressed_psum(grads, one, "data")
    mesh = _ep_mesh(ep_devices)
    got = compressed_psum(tuple(
        {k: v for k, v in zip(grads, parts)}
        for parts in zip(*(mesh.split(v) for v in grads.values()))),
        mesh, "data")
    for part, ref in zip(got, want):
        for k in ref:
            joined = mesh.join(tuple(t[k] for t in part))
            assert torch.equal(joined, ref[k]), k
            assert [t[k].device for t in part] == list(mesh.devices)


def test_partitioned_hybrid_train_and_decode_on_cards(card, ep_devices):
    """zamba2-2.7b's smoke config (mamba2 over its heads, the shared
    attention block, the vocab-parallel head), bf16: step 0's loss and
    every gradient bitwise with one group, none NaN, three steps' losses,
    params and state bitwise; one decode step's logits and new caches
    (the shared attention's cache at rest as the reference places it)
    bitwise with one group."""
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.configs import get_arch
    from repro_torch.launch.sharding import (cache_specs, gather_params,
                                             param_specs, place_params)
    from repro_torch.launch.steps import build_decode_step
    from repro_torch.models import ShapeCfg, init_cache, init_params, moe_ep
    cfg = get_arch("zamba2-2.7b").smoke()
    params = init_params(cfg, torch.Generator(device=card).manual_seed(6),
                         device=card)
    toks = torch.randint(0, cfg.vocab, (8, 33), generator=torch.Generator(
        device=card).manual_seed(6), device=card, dtype=torch.int32)
    batch = dict(tokens=toks[:, :-1].contiguous(),
                 labels=toks[:, 1:].contiguous())
    (l1, g1, ls1, p1, s1, _, _), (lg, gg, lsg, pg, sg, placed, mesh) = \
        _partitioned_runs(card, ep_devices, cfg, params, batch, 3)
    assert torch.equal(lg, l1) and bool(torch.isfinite(lg))
    for (path, a), (_, b) in zip(_flatten(gg), _flatten(g1)):
        assert _same_bits(a, b), path
        assert bool(torch.isfinite(a.float()).all()), path
    assert torch.equal(torch.stack(lsg), torch.stack(ls1))
    for (path, a), (_, b) in zip(_flatten([pg, sg]), _flatten([p1, s1])):
        assert _same_bits(a.reshape(-1), b.reshape(-1)), path
    dshape = ShapeCfg("d", 16, 8, "decode")
    cache = init_cache(cfg, 8, 16, device=card)
    runs = []
    try:
        for devs in ([card], ep_devices):
            m = _ep_mesh(devs)
            fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, m)
            c = cache
            outs = []
            for pos in range(3):
                dl, c = fn(place_params(params, m, param_specs(pst, m)), c,
                           toks[:, pos:pos + 1], pos)
                outs.append(m.assemble(dl, (("data",), None, "model")))
            runs.append((outs, gather_params(c, m, cache_specs(cst, m, 8))))
    finally:
        moe_ep.set_ep_mesh(None, ("data",))
    (o1, c1), (og, cg) = runs
    assert all(torch.equal(a, b) for a, b in zip(og, o1))
    for (path, a), (_, b) in zip(_flatten(cg), _flatten(c1)):
        assert _same_bits(a, b), path
