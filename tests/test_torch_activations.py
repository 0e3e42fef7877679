"""The port's activations (``repro_torch/models/layers.py``: ``sigmoid``,
``silu``) against ``jax.nn.sigmoid`` / ``jax.nn.silu`` and their
``jax.grad``, on 20,001 points of x from -110 to 110.

The forward is the expansion XLA makes, 1 / (1 + exp(-x)), rounded to x's
dtype after each op; it is unchanged, and its bits are pinned here against
the expression itself.  It is not bitwise with JAX everywhere: torch's CPU
``exp`` and XLA's differ by one ulp at some inputs, and XLA flushes
subnormal results to zero (float32: 792 of the points for ``sigmoid``).

The gradient is ``lax.logistic``'s rule, g * (s * (1 - s)) from the saved
output s (autograd through the expansion gave NaN once ``exp(-x)``
overflowed).  Held here:

* no NaN and no inf anywhere, float32 and bfloat16;
* bitwise with that rule applied to the port's own s;
* float32, against ``jax.grad``: rtol = 1e-6 and atol = 1e-37 at every
  point where the forward agrees bitwise with JAX's; everywhere, rtol =
  3e-6 (one ulp of s carries into 1 - s: at x = 3.091, 2.7e-6) and atol =
  1.1e-36 (where XLA flushes a subnormal s to zero, ``silu``'s gradient is
  0 there against the port's x * s, at most 1.02e-36);
* bfloat16, against ``jax.grad`` in bfloat16: bitwise wherever JAX's
  gradient is at least 1e-30 in magnitude; below, within 1e-36 (the same
  flush).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import layers

X = np.linspace(-110, 110, 20001).astype(np.float32)
FNS = {"sigmoid": (layers.sigmoid, jax.nn.sigmoid),
       "silu": (layers.silu, jax.nn.silu)}


def _grad(fn, x: torch.Tensor) -> torch.Tensor:
    x = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(fn(x).sum(), x)
    return g


def _jax_grad(fn, x, dtype):
    return np.asarray(jax.vmap(jax.grad(fn))(jnp.asarray(x, dtype))
                      .astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_is_the_expansion(dtype):
    x = torch.from_numpy(X).to(dtype)
    s = 1 / (1 + torch.exp(-x))
    assert torch.equal(layers.sigmoid(x), s)
    assert torch.equal(layers.silu(x), x * s)
    assert layers.sigmoid(x).dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FNS))
def test_gradient_is_finite_and_the_logistic_rule(name, dtype):
    x = torch.from_numpy(X).to(dtype)
    g = _grad(FNS[name][0], x)
    assert torch.isfinite(g).all()
    s = 1 / (1 + torch.exp(-x))
    ds = s * (1 - s)
    want = ds if name == "sigmoid" else s + x * ds
    if name == "sigmoid":
        assert torch.equal(g, want)
    else:        # autograd adds the product rule's two terms in its order
        torch.testing.assert_close(g.float(), want.float(), rtol=1e-6,
                                   atol=1e-37)


@pytest.mark.parametrize("name", sorted(FNS))
def test_float32_gradient_matches_jax(name):
    tf, jf = FNS[name]
    x = torch.from_numpy(X)
    g = _grad(tf, x).numpy()
    jg = _jax_grad(jf, X, jnp.float32)
    same = tf(x).numpy() == np.asarray(jf(jnp.asarray(X)))
    assert same.sum() > 19_000
    err = np.abs(g - jg)
    assert (err <= 1e-6 * np.abs(jg) + 1e-37)[same].all()
    assert (err <= 3e-6 * np.abs(jg) + 1.1e-36).all()
    # the former NaN points
    for x0 in (-100.0, -89.0):
        assert float(_grad(tf, torch.tensor([x0]))[0]) == 0.0


@pytest.mark.parametrize("name", sorted(FNS))
def test_bfloat16_gradient_matches_jax(name):
    tf, jf = FNS[name]
    g = _grad(tf, torch.from_numpy(X).to(torch.bfloat16)).float().numpy()
    jg = _jax_grad(jf, X, jnp.bfloat16)
    big = np.abs(jg) >= 1e-30
    np.testing.assert_array_equal(g[big], jg[big])
    assert (np.abs(g - jg)[~big] <= 1e-36).all()
