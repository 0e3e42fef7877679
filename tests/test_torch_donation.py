"""Buffer donation in the step builders (the reference's ``donate_argnums``
of ``repro/launch/steps.py`` and ``repro/launch/train.py``): the train
steps write the new params and AdamW state into the trees they are given,
and the decode step writes the new position into the cache it is given.

Smoke configs on the CPU, float32 params, inputs drawn with numpy from a
seed (``tests/torch_partitioned.py``).  Held here:

* ``build_train_step``'s step, on whole params (the one-device program) and
  on params placed on a (2, 4) mesh in two device groups, and
  ``launch/train.make_train_step``: every returned leaf, every group tensor
  of a placed tree, is the input's own storage, and the values are bitwise
  those of a plain AdamW here that builds new trees (the arithmetic the
  steps ran before they donated) on copies of the inputs;
* ``TrainLoop`` over the donating launcher step: a crash and a resume from
  the checkpoint end bitwise equal to the uninterrupted run;
* ``build_decode_step``'s one-device decode writes each cache leaf in place
  and is bitwise ``models.decode_step`` (which leaves its input cache as it
  was), for dense, MLA, mamba2, the hybrid stack and M-RoPE;
* the partitioned decode on a (2, 4) mesh in two groups writes its placed
  cache in place, zamba2's shared-attention cache too (it rests with the
  time axis on ``data``, so only the new position's rows are written back):
  every other row bitwise as it was, the new rows, the SSM states and the
  logits within 1e-4 of each leaf's largest magnitude of the one-device
  decode (as ``tests/test_torch_partitioned_b.py`` holds them).
"""
import numpy as np
import pytest
import torch

from repro_torch.ckpt.checkpoint import _flatten, _unflatten, clone_tree
from repro_torch.launch.sharding import (cache_specs, gather_params,
                                         param_specs, place_batch,
                                         place_cache, place_params)
from repro_torch.launch.steps import (StepConfig, build_decode_step,
                                      build_train_step, logits_spec)
from repro_torch.launch.train import make_train_step
from repro_torch.models import ShapeCfg, decode_step, loss_fn, moe_ep
from repro_torch.models.serving import pad_params_for_serving, serving_padded
from repro_torch.optim import wsd_schedule
from repro_torch.optim.adamw import _global_norm
from repro_torch.runtime import TrainLoop, TrainLoopConfig

import torch_partitioned as tp

torch.set_num_threads(1)

B, S, POS = tp.B, tp.S, tp.POS
TIME = ("k", "v", "ckv", "kr")       # cache leaves along the time axis


@pytest.fixture(autouse=True)
def _no_ep_mesh_left():
    yield
    moe_ep.set_ep_mesh(None, ("data",))


def _ptrs(tree):
    return [x.data_ptr() for _, x in _flatten(tree)]


def _plain_adamw(params, grads, st, lr_scale, gnorm=None):
    """AdamW building new trees, leaf by leaf (``tp.OPT``; every leaf on
    one device): global-norm clip, bias correction, decoupled weight decay,
    all in float32."""
    cfg = tp.OPT
    step = st["step"] + 1
    g_leaves = [g for _, g in _flatten(grads)]
    if gnorm is None:
        gnorm = _global_norm(g_leaves)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    bc1 = 1.0 - f32(cfg.b1) ** step.float()
    bc2 = 1.0 - f32(cfg.b2) ** step.float()
    lr = cfg.lr * lr_scale
    new_p, new_m, new_v = [], [], []
    for (_, p), g, (_, m), (_, v) in zip(_flatten(params), g_leaves,
                                         _flatten(st["m"]), _flatten(st["v"])):
        g = g.float() * clip
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * delta).to(p.dtype))
        new_m.append(m32.to(m.dtype))
        new_v.append(v32.to(v.dtype))
    return (_unflatten(params, iter(new_p)),
            dict(m=_unflatten(params, iter(new_m)),
                 v=_unflatten(params, iter(new_v)), step=step))


def _functional_step(cfg, params, st, bt, remat, schedule, plan=None):
    """The step's arithmetic without donation: (params, state, loss)."""
    lr = wsd_schedule(st["step"], **schedule)
    if plan is not None:
        loss, grads = plan.loss_and_grads(params, place_batch(bt, plan.mesh))
        with torch.no_grad():
            p, s = _plain_adamw(params, grads, st, lr,
                                gnorm=plan.global_norm(grads))
        return p, s, loss
    leaves = [x.detach().requires_grad_() for _, x in _flatten(params)]
    loss = loss_fn(cfg, _unflatten(params, iter(leaves)), bt, remat=remat)
    grads = _unflatten(params, iter(torch.autograd.grad(loss, leaves)))
    with torch.no_grad():
        p, s = _plain_adamw(params, grads, st, lr)
    return p, s, loss.detach()


STEPS = dict(warmup=2000, stable=50_000, decay=5_000)


@pytest.mark.parametrize("arch,placed", [
    ("minicpm-2b", False), ("moonshot-v1-16b-a3b", False),
    ("minicpm-2b", True), ("deepseek-v3-671b", True), ("zamba2-2.7b", True)])
def test_train_step_donates(arch, placed):
    cfg, params = tp.params(arch, seed=2)
    st, bt = tp.state(params, 2), tp.batch(cfg, 2)
    m = tp.mesh(2) if placed else tp.unpartitioned_mesh(cfg)
    fn, structs = build_train_step(cfg, ShapeCfg("t", S, B, "train"), m,
                                   StepConfig(optimizer=tp.OPT))
    if placed:
        ps, ss = param_specs(structs[0], m), param_specs(structs[1], m)
        p, s = place_params(params, m, ps), place_params(st, m, ss)
    else:
        p, s = clone_tree(params), clone_tree(st)
    want = _functional_step(cfg, clone_tree(p), clone_tree(s), bt, "full", STEPS,
                            fn.plan if placed else None)
    before = _ptrs([p, s])
    p2, s2, loss = fn(p, s, bt)
    assert p2 is p and s2 is s and _ptrs([p2, s2]) == before
    assert torch.equal(loss, want[2])
    tp.same_trees(p2, want[0])
    tp.same_trees(s2, want[1])
    assert int(s2["step"]) == 3001


def test_make_train_step_donates():
    cfg, params = tp.params("minicpm-2b", seed=4)
    st, bt = tp.state(params, 4), tp.batch(cfg, 4)
    step = make_train_step(cfg, tp.OPT, 10)
    want = _functional_step(cfg, clone_tree(params), clone_tree(st), bt, "dots",
                            dict(warmup=10, stable=7, decay=2))
    before = _ptrs([params, st])
    p2, s2, loss = step(params, st, bt)
    assert p2 is params and s2 is st and _ptrs([p2, s2]) == before
    assert torch.equal(loss, want[2])
    tp.same_trees(p2, want[0])
    tp.same_trees(s2, want[1])


def test_train_loop_crash_and_resume_with_donation(tmp_path):
    """Crash at step 5, resume from the checkpoint at 4: bitwise with the
    uninterrupted run (params, AdamW state, losses).  The step donates, so
    each loop starts from its own copy of the initial trees."""
    cfg, params = tp.params("minicpm-2b", seed=6)
    st = tp.state(params, 6)
    step = make_train_step(cfg, tp.OPT, 8)

    def make_batch(i, rng):
        toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        return dict(tokens=torch.from_numpy(toks[:, :-1].copy()),
                    labels=torch.from_numpy(toks[:, 1:].copy()))

    def loop(name):
        return TrainLoop(TrainLoopConfig(ckpt_dir=str(tmp_path / name),
                                         ckpt_every=2, max_steps=8),
                         step, make_batch, clone_tree(params), clone_tree(st))

    ref = loop("a")
    ref.run()
    crashed = loop("b")
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        crashed.run(crash_at=5)
    resumed = loop("b")
    assert resumed.try_resume() and resumed.start_step == 4
    resumed.run()
    tp.same_trees(resumed.params, ref.params)
    tp.same_trees(resumed.opt_state, ref.opt_state)
    assert crashed.losses[:4] + resumed.losses == ref.losses


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b",
                                  "zamba2-2.7b", "mamba2-2.7b",
                                  "qwen2-vl-72b"])
def test_decode_writes_cache_in_place(arch):
    cfg, params = tp.params(arch, seed=8)
    fn, (_, cst, _, _) = build_decode_step(
        cfg, ShapeCfg("d", S, B, "decode"), tp.mesh(1, (1, 1)),
        StepConfig(serving_head_pad=False))
    moe_ep.set_ep_mesh(None, ("data",))
    cache = tp.cache(cst, 8)
    ref = clone_tree(cache)
    ptrs = _ptrs(cache)
    for pos in (POS, POS + 1):
        tok = tp.batch(cfg, pos, kind="prefill")["tokens"][:, :1]
        before, kept = ref, clone_tree(ref)
        want, ref = decode_step(cfg, params, before, tok, pos)
        tp.same_trees(before, kept)      # decode_step stays functional
        got, out = fn(params, cache, tok, pos)
        assert out is cache and _ptrs(out) == ptrs
        assert torch.equal(got, want)
        tp.same_trees(out, ref)


def _rows(path, x, pos):
    """A cache leaf's rows at time ``pos`` (None for a leaf without a time
    axis; dim 2, after the stacked layer axis)."""
    return x.narrow(2, pos, 1) if path[-1] in TIME else None


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b",
                                  "zamba2-2.7b", "qwen1.5-110b"])
def test_partitioned_decode_writes_cache_in_place(arch):
    cfg, params = tp.params(arch, seed=9)
    m = tp.mesh(2)
    dshape = ShapeCfg("d", S, B, "decode")
    fn, (pst, cst, _, _) = build_decode_step(cfg, dshape, m)
    pc = serving_padded(cfg, 4)
    pp = pad_params_for_serving(cfg, pc, params)
    cache = tp.cache(cst, 9)
    cspecs = cache_specs(cst, m, B)
    placed = place_cache(cache, m, B)
    ptrs = _ptrs(placed)
    tok = tp.batch(cfg, 9, kind="prefill")["tokens"][:, :1]
    dl, out = fn(place_params(pp, m, param_specs(pst, m)), placed, tok, POS)
    assert out is placed and _ptrs(out) == ptrs
    got = gather_params(out, m, cspecs)
    moe_ep.set_ep_mesh(None, ("data",))
    one, _ = build_decode_step(pc, dshape, tp.mesh(1, (1, 1)),
                               StepConfig(serving_head_pad=False))
    wl, want = one(pp, clone_tree(cache), tok, POS)
    tp.close_trees(m.assemble(dl, logits_spec(pc, dshape, m, decode=True)),
                   wl)
    for (path, g), (_, w), (_, c) in zip(_flatten(got), _flatten(want),
                                         _flatten(cache)):
        new = _rows(path, g, POS)
        if new is None:
            tp.close_trees(g, w)
            continue
        tp.close_trees(new, _rows(path, w, POS))
        rest = torch.ones(g.shape[2], dtype=torch.bool)
        rest[POS] = False
        assert torch.equal(g[:, :, rest], c[:, :, rest]), path
