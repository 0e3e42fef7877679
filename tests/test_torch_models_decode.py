"""The port's model layer beyond the train step, against the JAX package:
``decode_step`` for the nine decoder architectures, decode against prefill
(dense and SSM), ``flash_attention`` over several KV chunks, ``moe_forward``
and ``ssd_chunked`` on the same inputs, ``init_params``'s tree, recompute
that changes no grad, the weight converter, and both launchers on the CPU.
Bars as in ``tests/torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_arch as jax_arch
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import layers as jax_layers
from repro.models import mamba2 as jax_mamba2
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.convert import params_to_numpy, params_to_torch
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import (decode_step, forward, init_cache, init_params,
                                layers, loss_fn, mamba2)
from torch_models import B, F32_TOL, max_rel, to_np

DECODERS = sorted(a for a in ARCHS if not jax_arch(a).encoder_only)
N_STEPS = 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_jax(arch):
    """Three decode steps from empty caches on the same float32 weights and
    tokens: logits and every cache leaf within F32_TOL of the leaf's
    largest magnitude."""
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    jparams = jax_init(jcfg, jax.random.key(0), dtype=jnp.float32)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, (N_STEPS, B, 1)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, i: jax_decode_step(jcfg, p, c, t, i))
    jc = jax_init_cache(jcfg, B, 8, dtype=jnp.float32)
    params = params_to_torch(_np_tree(jparams), "cpu")
    tc = init_cache(cfg, B, 8, dtype=torch.float32, device="cpu")
    assert [p for p, _ in _flatten(tc)] == [p for p, _ in _flatten(
        _np_tree(jc))]
    for i in range(N_STEPS):
        jl, jc = jstep(jparams, jc, jnp.asarray(toks[i]), jnp.int32(i))
        tl, tc = decode_step(cfg, params, tc, torch.from_numpy(toks[i]), i)
        assert tl.shape == (B, 1, cfg.vocab)
        assert max_rel(to_np(tl), to_np(jl)) <= F32_TOL, i
    for (path, got), (_, want) in zip(_flatten(tc), _flatten(_np_tree(jc))):
        assert max_rel(to_np(got), to_np(want)) <= F32_TOL, path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_cache_matches_jax_at_published_widths(arch):
    """The cache tree of every published configuration (depth cut to the
    fewest layers its plan takes): the reference's leaves, shapes and
    dtypes (``jax.eval_shape``, nothing allocated on the JAX side)."""
    import dataclasses
    ref = jax_arch(arch)
    n = max(2, ref.first_dense_layers + 1, ref.attn_every)
    jcfg, cfg = (dataclasses.replace(c, n_layers=n)
                 for c in (ref, get_arch(arch)))
    want = _flatten(jax.eval_shape(lambda: jax_init_cache(jcfg, 1, 4)))
    got = _flatten(init_cache(cfg, 1, 4, device="cpu"))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == w.shape, path
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path


@pytest.mark.parametrize("arch,tol", [("granite-34b", 2e-2),
                                      ("mamba2-2.7b", 5e-2),
                                      ("zamba2-2.7b", 5e-2)])
def test_decode_matches_prefill(arch, tol):
    """Greedy decode logits equal full-forward logits (KV cache and SSM
    recurrence), float32 params, at the reference's bars
    (``tests/test_models_smoke.py:77, :95``)."""
    cfg = get_arch(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    with torch.no_grad():
        full = forward(cfg, params, dict(tokens=toks), remat="none")
        caches = init_cache(cfg, B, 16, dtype=torch.float32, device="cpu")
        outs = []
        for i in range(8):
            lg, caches = decode_step(cfg, params, caches, toks[:, i:i + 1], i)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(to_np(torch.stack(outs, 1)), to_np(full),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("kv_chunk", [4, 7, 16, 64])
@pytest.mark.parametrize("case", ["causal", "full", "decode"])
def test_flash_attention_matches_jax(kv_chunk, case):
    """GQA (8 query heads over 2 KV heads), f32, within 1e-5."""
    rng = np.random.default_rng(kv_chunk)
    sq, sk = (1, 24) if case == "decode" else (19, 19)
    q = rng.normal(size=(2, sq, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, sk, 2, 16)).astype(np.float32)
    kw = dict(causal=case != "full", kv_chunk=kv_chunk)
    if case == "decode":
        kw.update(q_offset=11, kv_len=12)
    want = jax_layers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    got = layers.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), **kw)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                               atol=1e-5)


def _moe_inputs(dt):
    jcfg = jax_arch("moonshot-v1-16b-a3b").smoke()
    jp = jax_init(jcfg, jax.random.key(4), dtype=dt)
    p = jax.tree_util.tree_map(lambda x: x[0], jp["stacks"]["moe"])["ffn"]
    x = np.random.default_rng(4).normal(size=(2, 16, jcfg.d_model))
    return jcfg, p, x.astype(np.float32)


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_moe_forward_matches_jax(dt, tol):
    """Router top-k, the expert-sorted grouped matmul and the combine, on
    the same layer input (two shared experts, 8 experts, top-2)."""
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (
        jnp.bfloat16, torch.bfloat16)
    jcfg, p, x = _moe_inputs(jdt)
    want = jax_layers.moe_forward(jcfg, p, jnp.asarray(x).astype(jdt))
    got = layers.moe_forward(get_arch("moonshot-v1-16b-a3b").smoke(),
                             params_to_torch(_np_tree(p), "cpu"),
                             torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(to_np(got.float()), to_np(want), rtol=tol,
                               atol=tol)


def test_top_k_ties_take_the_lower_index():
    x = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    vals, idx = layers.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 3, 0]]
    assert vals.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("s,chunk", [(32, 8), (16, 16)])
def test_ssd_chunked_matches_jax(s, chunk):
    """Several chunks (the inter-chunk recurrence) and one, f32, 1e-5."""
    rng = np.random.default_rng(s)
    xh = rng.normal(size=(2, s, 4, 8)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(2, s, 4)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(4,)).astype(np.float32)
    bm = rng.normal(size=(2, s, 16)).astype(np.float32)
    cm = rng.normal(size=(2, s, 16)).astype(np.float32)
    want = jax_mamba2.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)),
                                  chunk)
    got = mamba2.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)),
                             chunk)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="multiple of chunk"):
        mamba2.ssd_chunked(*map(torch.from_numpy, (xh, dt, a, bm, cm)),
                           chunk + 1)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_params_tree_matches_jax(arch):
    """Same leaves, shapes and dtypes as the JAX init (bf16 default, f32
    router and A_log); constants equal; random leaves at the reference's
    scale (std within 15% on leaves of 1,024 or more values)."""
    jp = _np_tree(jax_init(jax_arch(arch).smoke(), jax.random.key(0)))
    tp = init_params(get_arch(arch).smoke(), torch.Generator().manual_seed(0),
                     device="cpu")
    jl, tl = _flatten(jp), _flatten(tp)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        t, j = to_np(t.float()), to_np(j)
        if np.all(j == j.flat[0]):
            assert np.all(t == j), path
        elif j.size >= 1024:
            assert 0.85 < t.std() / j.std() < 1.15, path


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b",
                                  "zamba2-2.7b"])
def test_remat_changes_no_grad(arch):
    """``remat`` none, full and dots: the same loss and grads, bit for bit."""
    cfg = get_arch(arch).smoke()
    params = init_params(cfg, torch.Generator().manual_seed(2),
                         dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, 16)).astype(
        np.int32)) for k in ("tokens", "labels")}
    runs = []
    for remat in ("none", "full", "dots"):
        leaves = [p.detach().requires_grad_() for _, p in _flatten(params)]
        loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch,
                       remat=remat)
        runs.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert torch.equal(a, b)


def test_params_convert_round_trip():
    """A JAX bf16 tree through ``params_to_torch`` keeps every bit; back
    through ``params_to_numpy`` it is float32 with the same values."""
    jp = _np_tree(jax_init(jax_arch("qwen2-vl-72b").smoke(),
                           jax.random.key(5)))
    tp = params_to_torch(jp, "cpu")
    for (path, t), (_, j) in zip(_flatten(tp), _flatten(jp)):
        if j.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, path
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  j.view(np.int16)), path
        else:
            assert np.array_equal(t.numpy(), j), path
    back = params_to_numpy(tp)
    for (path, b), (_, j) in zip(_flatten(back), _flatten(jp)):
        assert np.array_equal(b, j.astype(np.float32)), path


def test_train_launcher_on_cpu(tmp_path):
    losses = train_launch.main([
        "--arch", "minicpm-2b-smoke", "--steps", "4", "--batch", "2",
        "--seq-len", "16", "--ckpt-every", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(losses) == 4 and all(np.isfinite(losses))
    resumed = train_launch.main([
        "--arch", "minicpm-2b-smoke", "--steps", "6", "--batch", "2",
        "--seq-len", "16", "--ckpt-every", "2", "--device", "cpu",
        "--ckpt-dir", str(tmp_path / "ckpt"), "--resume"])
    assert len(resumed) == 2      # resumed at step 4


def test_serve_launcher_on_cpu():
    out = serve_launch.main(["--arch", "granite-34b-smoke", "--batch", "3",
                             "--prompt-len", "5", "--gen-len", "4",
                             "--device", "cpu"])
    assert out["admitted"].tolist() == [True] * 3
    assert out["generated"].shape == (3, 4)
