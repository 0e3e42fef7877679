"""The port's serving head padding (``repro_torch/models/serving.py``)
against the JAX package's (``repro/models/serving.py``).

Held here: ``serving_padded`` gives the reference's config (field for field,
and the config itself where nothing changes) for every arch at TP axes of
2, 8 and 16; ``pad_params_for_serving`` gives the reference's padded tree
bitwise, leaf by leaf, from the same (converted) params; and the
reference's ``test_head_padding_is_inert`` cases: the port's ``forward`` and
``decode_step`` on the padded params match JAX's unpadded run within
rtol = atol = 2e-4 (float32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_arch as jax_arch
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init
from repro.models import serving as jserving
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs import get_arch
from repro_torch.convert import params_to_torch
from repro_torch.models import decode_step, forward, init_cache
from repro_torch.models import serving

torch.set_num_threads(1)

MSIZES = (2, 8, 16)
TOL = 2e-4


@pytest.mark.parametrize("msize", MSIZES)
@pytest.mark.parametrize("arch", sorted(J_ARCHS))
def test_serving_padded_matches_reference(arch, msize):
    for suffix in ("", "-smoke"):
        jcfg, cfg = jax_arch(arch + suffix), get_arch(arch + suffix)
        jp, p = jserving.serving_padded(jcfg, msize), \
            serving.serving_padded(cfg, msize)
        assert (jp is jcfg) == (p is cfg)
        assert dataclasses.asdict(p) == dataclasses.asdict(jp)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str):
    cfg = jax_arch(arch).smoke()
    return jax.tree_util.tree_map(
        np.asarray, jax_init(cfg, jax.random.key(0), dtype=jnp.float32))


PADDED = [(a, m) for a in sorted(J_ARCHS) for m in MSIZES
          if jserving.serving_padded(jax_arch(a).smoke(), m)
          is not jax_arch(a).smoke()]


@pytest.mark.parametrize("arch,msize", PADDED)
def test_pad_params_bitwise(arch, msize):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    params = _jax_params(arch)
    want = jserving.pad_params_for_serving(
        jcfg, jserving.serving_padded(jcfg, msize),
        jax.tree_util.tree_map(jnp.asarray, params))
    got = serving.pad_params_for_serving(
        cfg, serving.serving_padded(cfg, msize),
        params_to_torch(params, "cpu"))
    want = _flatten(jax.tree_util.tree_map(np.asarray, want))
    got = _flatten(got)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == torch.float32, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))


def test_padding_leaves_callers_params():
    cfg = get_arch("minicpm-2b").smoke()
    params = params_to_torch(_jax_params("minicpm-2b"), "cpu")
    before = {p: x.clone() for p, x in _flatten(params)}
    padded = serving.pad_params_for_serving(
        cfg, serving.serving_padded(cfg, 8), params)
    assert padded["stacks"]["dense"]["attn"]["wq"].shape[-2] == 8
    for p, x in _flatten(params):
        assert torch.equal(x, before[p]), p


@pytest.mark.parametrize("arch,msize", [("minicpm-2b", 8),    # MHA pad
                                        ("granite-34b", 2),   # GQA replicate
                                        ("qwen1.5-110b", 8)])
def test_head_padding_is_inert(arch, msize):
    jcfg, cfg = jax_arch(arch).smoke(), get_arch(arch).smoke()
    padded = serving.serving_padded(cfg, msize)
    assert padded is not cfg
    jparams = _jax_params(arch)
    pparams = serving.pad_params_for_serving(
        cfg, padded, params_to_torch(jparams, "cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)

    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    ref = jax_forward(jcfg, jp, dict(tokens=jnp.asarray(toks)), remat="none")
    with torch.no_grad():
        out = forward(padded, pparams, dict(tokens=torch.from_numpy(toks)),
                      remat="none")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)

    c0 = jax_init_cache(jcfg, 2, 8, dtype=jnp.float32)
    l0, _ = jax_decode(jcfg, jp, c0, jnp.asarray(toks[:, :1]), jnp.int32(0))
    c1 = init_cache(padded, 2, 8, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        l1, _ = decode_step(padded, pparams, c1,
                            torch.from_numpy(toks[:, :1]), 0)
    np.testing.assert_allclose(l1.numpy(), np.asarray(l0, np.float32),
                               rtol=TOL, atol=TOL)
