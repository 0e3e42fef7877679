"""C7: the chunked SSD's gradient where a chunk's decay overflows
(``models/mamba2.ssd_chunked``).

The reference builds the intra-chunk decay as ``where(mask, exp(seg), 0)``
(``src/repro/models/mamba2.py:66-67``).  Above the diagonal ``seg`` is the
decay summed over the rest of the chunk, positive, and at a published
chunk of 256 with ``dt`` near 0.7 it passes 88, where float32's ``exp``
overflows: the value is masked, but the gradient is ``0 * inf = NaN``.
zamba2-2.7b trains at that chunk.  The port sends the masked entries to
-inf before the exp, which changes no value.  Held here, float32:

* where the reference's gradient is finite (a chunk of 16), the port's
  output and the gradients of every input equal the reference's within
  1e-5 of each one's largest magnitude;
* at a chunk of 256 over 256 steps the reference's gradient holds NaN
  (the record), the port's output equals the reference's within 1e-5, and
  its gradients are finite and equal the reference's at a chunk of 16 (the
  same function: the result does not depend on the chunk) within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as jax_ssd
from repro_torch.models.mamba2 import ssd_chunked

torch.set_num_threads(1)

S, H, P, N = 256, 2, 4, 4
NAMES = ("xh", "dt", "A", "Bm", "Cm")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return dict(xh=rng.normal(size=(1, S, H, P)).astype(np.float32),
                dt=rng.uniform(0.5, 1.0, (1, S, H)).astype(np.float32),
                A=np.array([-1.0, -0.5], np.float32),
                Bm=rng.normal(size=(1, S, N)).astype(np.float32),
                Cm=rng.normal(size=(1, S, N)).astype(np.float32),
                w=rng.normal(size=(1, S, H, P)).astype(np.float32))


def _jax(z, chunk):
    def f(*args):
        return jnp.sum(jax_ssd(*args, chunk) * z["w"])
    args = [jnp.asarray(z[k]) for k in NAMES]
    y = jax_ssd(*args, chunk)
    grads = jax.grad(f, argnums=tuple(range(5)))(*args)
    return np.asarray(y), [np.asarray(g) for g in grads]


def _port(z, chunk):
    args = [torch.from_numpy(z[k]).requires_grad_() for k in NAMES]
    y = ssd_chunked(*args, chunk)
    grads = torch.autograd.grad(torch.sum(y * torch.from_numpy(z["w"])),
                                args)
    return y.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_matches_reference_where_it_is_finite(seed):
    z = _inputs(seed)
    (yw, gw), (yg, gg) = _jax(z, 16), _port(z, 16)
    _close(yg, yw, 1e-5, "y")
    for name, a, b in zip(NAMES, gg, gw):
        assert np.isfinite(b).all()
        _close(a, b, 1e-5, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_long_chunk_gradient_is_finite(seed):
    z = _inputs(seed)
    y_ref, g_ref = _jax(z, S)
    assert any(np.isnan(g).any() for g in g_ref)       # the reference's NaN
    y, g = _port(z, S)
    _close(y, y_ref, 1e-5, "y")
    _, g16 = _jax(z, 16)
    for name, a, b in zip(NAMES, g, g16):
        assert np.isfinite(a).all(), name
        _close(a, b, 1e-4, name)
