"""The port's training substrate against the JAX package and the reference's
own substrate tests (``tests/test_substrate.py:40-125``): AdamW, the LR
schedules, int8 gradient compression and its error-feedback all-reduce, the
fault-tolerant train loop's exact resume, and the TStream-managed data
pipeline.

Bars: the AdamW step within 1e-6 (relative and absolute, float32: XLA's CPU
may contract a multiply-add into an FMA and its pow may differ in the last
bit); the schedules within 1e-6 relative; ``compress_int8``'s ``q`` and
``scale`` equal; the train loop's crash and resume bitwise with the port's
uninterrupted run; the pipeline's ``stats_values``, outputs and batches
bitwise with the JAX pipeline's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.data import PipelineConfig as JaxPipelineConfig
from repro.data import StreamingPipeline as JaxPipeline
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.convert import params_to_numpy, params_to_torch
from repro_torch.core.mesh import ShardMesh
from repro_torch.data import PipelineConfig, StreamingPipeline
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               compress_int8, compressed_psum,
                               cosine_schedule, decompress_int8, wsd_schedule)
from repro_torch.runtime import TrainLoop, TrainLoopConfig

torch.set_num_threads(1)


def _assert_tree_close(got, want, tol, what):
    g, w = _flatten(params_to_numpy(got)), _flatten(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(np.asarray(a, np.float32), b, rtol=tol,
                                   atol=tol, err_msg=f"{what} {path}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_jax(state_dtype):
    """Three steps on a tree of f32 and bf16 leaves, the grads large enough
    that the global-norm clip engages, lr scaled by WSD."""
    rng = np.random.default_rng(0)
    params = dict(w=rng.normal(size=(16, 8)).astype(np.float32),
                  emb=dict(e=rng.normal(size=(32, 4)).astype(np.float32)),
                  b=rng.normal(size=(8,)).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp["emb"]["e"] = jp["emb"]["e"].astype(jnp.bfloat16)
    tp = params_to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jcfg = jax_optim.AdamWConfig(lr=1e-2, state_dtype=getattr(jnp,
                                                              state_dtype))
    tcfg = AdamWConfig(lr=1e-2, state_dtype=getattr(torch, state_dtype))
    js, ts = jax_optim.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for i in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), params)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        jg["emb"]["e"] = jg["emb"]["e"].astype(jnp.bfloat16)
        tg = params_to_torch(jax.tree_util.tree_map(np.asarray, jg), "cpu")
        jlr = jax_optim.wsd_schedule(js["step"], warmup=1, stable=1, decay=2)
        tlr = wsd_schedule(ts["step"], warmup=1, stable=1, decay=2)
        jp, js = jax_optim.adamw_update(jp, jg, js, jcfg, lr_scale=jlr)
        tp, ts = adamw_update(tp, tg, ts, tcfg, lr_scale=tlr)
    assert tp["emb"]["e"].dtype == torch.bfloat16
    assert ts["m"]["w"].dtype == getattr(torch, state_dtype)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    _assert_tree_close(tp, jp, 1e-6, "params")
    _assert_tree_close(ts["m"], js["m"], 1e-6, "m")
    _assert_tree_close(ts["v"], js["v"], 1e-6, "v")


def test_schedules_match_jax():
    steps = np.arange(0, 400, dtype=np.int32)
    for j, t, kw in (
            (jax_optim.wsd_schedule, wsd_schedule,
             dict(warmup=10, stable=100, decay=50)),
            (jax_optim.wsd_schedule, wsd_schedule,
             dict(warmup=0, stable=3, decay=1, floor=0.2)),
            (jax_optim.cosine_schedule, cosine_schedule,
             dict(warmup=10, total=300)),
            (jax_optim.cosine_schedule, cosine_schedule,
             dict(warmup=5, total=50, floor=0.0))):
        want = np.asarray(j(jnp.asarray(steps), **kw))
        got = t(torch.from_numpy(steps), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_schedules_monotone_segments():
    """The reference's own checks (``tests/test_substrate.py:90``)."""
    assert float(wsd_schedule(0, warmup=10, stable=100, decay=50)) == 0.0
    assert float(wsd_schedule(50, warmup=10, stable=100, decay=50)) == 1.0
    assert float(wsd_schedule(160, warmup=10, stable=100, decay=50)) <= 0.02
    assert 0.0 < float(cosine_schedule(500, warmup=10, total=1000)) < 1.0


@pytest.mark.parametrize("n,dtype", [(1000, "float32"), (256, "float32"),
                                     (3 * 257, "bfloat16")])
def test_compress_int8_matches_jax(n, dtype):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n,)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jax_optim.compress_int8(jx)
    tq, ts = compress_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    y = decompress_int8(tq, ts, tuple(x.shape))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jax_optim.decompress_int8(jq, js, x.shape)))
    # the reference's error bound (tests/test_substrate.py:103)
    xf = tx.float().numpy()
    assert np.abs(y.numpy() - xf).max() < np.abs(xf).max() / 100


@pytest.mark.parametrize("with_error", [False, True])
def test_compressed_psum_matches_jax(with_error):
    """Four shards' grads through ``ShardMesh.psum`` against the reference
    run as a ``vmap`` over a named axis (its ``psum`` then sums the
    shards): averages and error feedback equal."""
    rng = np.random.default_rng(7)
    grads = dict(a=rng.normal(size=(4, 300)).astype(np.float32),
                 b=dict(c=rng.normal(size=(4, 5, 7)).astype(np.float32)))
    error = (jax.tree_util.tree_map(
        lambda g: (rng.normal(size=g.shape) * 1e-3).astype(np.float32), grads)
        if with_error else None)
    ref = jax.vmap(lambda g, e: jax_optim.compressed_psum(g, "dev", e),
                   axis_name="dev")(
        jax.tree_util.tree_map(jnp.asarray, grads),
        None if error is None else jax.tree_util.tree_map(jnp.asarray, error))
    mesh = ShardMesh((4,), ("dev",), device="cpu")
    got = compressed_psum(
        params_to_torch(grads, "cpu"), mesh, "dev",
        None if error is None else params_to_torch(error, "cpu"))
    for g, r in zip(got, ref):
        for (path, a), (_, b) in zip(_flatten(params_to_numpy(g)),
                                     _flatten(jax.tree_util.tree_map(
                                         np.asarray, r))):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def _torch_loop_parts():
    """The reference's tiny regression (``tests/test_substrate.py:19``)."""
    cfg = AdamWConfig(lr=1e-2, state_dtype=torch.float32)
    params = dict(w=torch.ones((4, 4)), b=torch.zeros((4,)))

    def step_fn(params, opt_state, batch):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        y = batch["x"] @ leaves["w"] + leaves["b"]
        loss = torch.mean((y - batch["y"]) ** 2)
        gw, gb = torch.autograd.grad(loss, [leaves["w"], leaves["b"]])
        with torch.no_grad():
            p2, s2 = adamw_update(params, dict(w=gw, b=gb), opt_state, cfg)
        return p2, s2, loss.detach()

    def make_batch(step, rng):
        x = rng.normal(size=(8, 4)).astype(np.float32)
        return dict(x=torch.from_numpy(x),
                    y=torch.from_numpy(x @ np.ones((4, 4), np.float32)))
    return step_fn, make_batch, params, adamw_init(params, cfg)


def test_crash_restart_bitwise_exact(tmp_path):
    """Crash at step 25, resume from the checkpoint at 20: bitwise equal to
    the uninterrupted run (params, optimizer state and losses)."""
    step_fn, make_batch, params, opt = _torch_loop_parts()
    cfg = TrainLoopConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=10,
                          max_steps=40)
    loop = TrainLoop(cfg, step_fn, make_batch, params, opt)
    ref = loop.run()

    cfg2 = TrainLoopConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=10,
                           max_steps=40)
    loop2 = TrainLoop(cfg2, step_fn, make_batch, params, opt)
    with pytest.raises(RuntimeError, match="injected failure at step 25"):
        loop2.run(crash_at=25)
    loop3 = TrainLoop(cfg2, step_fn, make_batch, params, opt)
    assert loop3.try_resume() and loop3.start_step == 20
    out = loop3.run()
    for k in ref:
        assert torch.equal(ref[k], out[k]), k
    for k in ("m", "v", "step"):
        for (_, a), (_, b) in zip(_flatten(loop.opt_state[k]),
                                  _flatten(loop3.opt_state[k])):
            assert torch.equal(a, b), k
    assert loop3.losses == loop.losses[20:]


def test_pipeline_matches_jax():
    """Ten ingest intervals of 64 documents: the stats state after each,
    and the per-event outputs, bitwise with the JAX pipeline; then the
    mixture weights, and the doc-count lane summing to the documents."""
    jpipe = JaxPipeline(JaxPipelineConfig())
    tpipe = StreamingPipeline(PipelineConfig(), device="cpu")
    jrng, trng = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(10):
        jout = jpipe.ingest(jrng, 64)
        tout = tpipe.ingest(trng, 64)
        np.testing.assert_array_equal(tpipe.stats_values.numpy(),
                                      np.asarray(jpipe.stats_values))
        for k in jout:
            np.testing.assert_array_equal(tout[k], np.asarray(jout[k]),
                                          err_msg=k)
    assert tpipe.engine.last_rung == "packed"
    np.testing.assert_array_equal(tpipe.mixture_weights(),
                                  jpipe.mixture_weights())
    assert tpipe.stats_values[:16, 1].sum() == 640


def test_pipeline_batches_match_jax():
    """``batch_for_step`` is the reference's, bit for bit, and a pure
    function of (seed, step)."""
    for cfg in (dict(), dict(vocab=1000, seq_len=33, batch=3, seed=5)):
        jpipe = JaxPipeline(JaxPipelineConfig(**cfg))
        tpipe = StreamingPipeline(PipelineConfig(**cfg), device="cpu")
        for step in (0, 5, 123):
            jb, tb = jpipe.batch_for_step(step), tpipe.batch_for_step(step)
            for k in ("tokens", "labels"):
                assert tb[k].dtype == torch.int32
                np.testing.assert_array_equal(tb[k].numpy(),
                                              np.asarray(jb[k]))
            again = tpipe.batch_for_step(step)
            assert torch.equal(again["tokens"], tb["tokens"])


def test_pipeline_deterministic_and_stats():
    """The reference's pipeline test (``tests/test_substrate.py:113``)."""
    pipe = StreamingPipeline(PipelineConfig(), device="cpu")
    b1, b2 = pipe.batch_for_step(5), pipe.batch_for_step(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    pipe.ingest(np.random.default_rng(0), 64)
    w = pipe.mixture_weights()
    assert np.isclose(w.sum(), 1.0) and np.all(w > 0)
    assert pipe.stats_values[:16, 1].sum() == 64  # doc_count lane
