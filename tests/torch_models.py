"""Helpers for the model layer's parity tests (``tests/test_torch_models*.py``).

Both packages get the same weights: the JAX ``init_params`` draws them, and
``repro_torch.convert.params_to_torch`` carries them over leaf by leaf (the
two inits use different generators, so their own draws cannot be compared).
Inputs are drawn with numpy from a seed.  Not a test module.

The bars, per field:

* float32 params: logits and every grad leaf within ``F32_TOL`` of the
  leaf's largest magnitude (max |port - ref| <= F32_TOL * max |ref|), the
  loss within ``F32_TOL`` relative.  XLA's CPU dots and reductions sum in
  another order than torch's, so the last bits differ.
* bfloat16 params: XLA keeps float32 across some fused bf16 ops (excess
  precision) where torch rounds after each op, so the two packages differ
  by bf16 rounding noise, and where a top-k router's inputs move by one
  bf16 step an expert choice can flip.  The bar is the reference's own: the
  port's norm-relative distance from the JAX bf16 run is at most
  ``max(BF16_TOL, 3 x`` the JAX bf16 run's distance from the JAX float32
  run of the same init``)``, for the logits and for each grad leaf; the
  loss within ``BF16_TOL`` relative.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_arch as jax_arch
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models import loss_fn as jax_loss
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_arch
from repro_torch.convert import params_to_torch
from repro_torch.models import forward, loss_fn

# small tensors in several worker processes: one intra-op thread each
torch.set_num_threads(1)

B, S = 2, 32
F32_TOL = 1e-4
BF16_TOL = 2e-2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def make_batch(cfg, rng):
    """The reference smoke test's batch (``tests/test_models_smoke.py``),
    as numpy; float fields are float32 and take the params' dtype later."""
    if cfg.frontend == "audio":
        return dict(
            frames=rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    batch = dict(tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 labels=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.normal(
            size=(B, 4, cfg.d_model)).astype(np.float32)
        batch["patch_pos"] = np.stack([rng.choice(S, 4, replace=False)
                                       for _ in range(B)]).astype(np.int32)
    if cfg.mrope:
        batch["pos3"] = np.broadcast_to(np.arange(S)[None, None],
                                        (B, 3, S)).astype(np.int32).copy()
    return batch


FLOAT_FIELDS = ("frames", "patch_embeds")


def jax_batch(batch, dtype):
    return {k: jnp.asarray(v).astype(dtype) if k in FLOAT_FIELDS
            else jnp.asarray(v) for k, v in batch.items()}


def port_batch(batch, dtype):
    return {k: torch.from_numpy(v).to(dtype) if k in FLOAT_FIELDS
            else torch.from_numpy(v) for k, v in batch.items()}


def to_np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def jax_run(arch: str, dt: str):
    """The JAX smoke model of ``arch`` in ``dt`` params (init key 0, batch
    seed 0): numpy params, batch, logits, loss and ``[(path, grad)]``."""
    cfg = jax_arch(arch).smoke()
    jdt = DTYPES[dt][0]
    params = jax_init(cfg, jax.random.key(0), dtype=jdt)
    batch = make_batch(cfg, np.random.default_rng(0))
    fn = jax.jit(lambda p, b: (
        jax_forward(cfg, p, b, remat="none"),
        jax.value_and_grad(lambda q: jax_loss(cfg, q, b, remat="none"))(p)))
    logits, (loss, grads) = fn(params, jax_batch(batch, jdt))
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                batch=batch, logits=to_np(logits), loss=float(loss),
                grads=[("/".join(p), to_np(g)) for p, g in _flatten(
                    jax.tree_util.tree_map(np.asarray, grads))])


def port_run(arch: str, dt: str, remat: str = "none"):
    """The port on the JAX run's params and batch: logits, loss, grads."""
    ref = jax_run(arch, dt)
    cfg = get_arch(arch).smoke()
    params = params_to_torch(ref["params"], "cpu")
    batch = port_batch(ref["batch"], DTYPES[dt][1])
    with torch.no_grad():
        logits = forward(cfg, params, batch, remat=remat)
    leaves = [p.requires_grad_() for _, p in _flatten(params)]
    loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return dict(logits=to_np(logits.float()), loss=loss.item(),
                grads=[("/".join(p), to_np(g.float()))
                       for (p, _), g in zip(_flatten(params), grads)])


def max_rel(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def norm_rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_f32(arch: str):
    ref, got = jax_run(arch, "f32"), port_run(arch, "f32")
    assert got["logits"].shape == ref["logits"].shape
    assert max_rel(got["logits"], ref["logits"]) <= F32_TOL
    assert abs(got["loss"] - ref["loss"]) <= F32_TOL * abs(ref["loss"])
    assert [p for p, _ in got["grads"]] == [p for p, _ in ref["grads"]]
    for (path, g), (_, r) in zip(got["grads"], ref["grads"]):
        assert g.shape == r.shape, path
        assert max_rel(g, r) <= F32_TOL, (path, max_rel(g, r))


def check_bf16(arch: str):
    ref, truth = jax_run(arch, "bf16"), jax_run(arch, "f32")
    got = port_run(arch, "bf16")
    bar = lambda r, t: max(BF16_TOL, 3 * norm_rel(r, t))
    assert norm_rel(got["logits"], ref["logits"]) <= bar(
        ref["logits"], truth["logits"])
    assert abs(got["loss"] - ref["loss"]) <= BF16_TOL * abs(ref["loss"])
    for (path, g), (_, r), (_, t) in zip(got["grads"], ref["grads"],
                                         truth["grads"]):
        assert g.shape == r.shape, path
        assert norm_rel(g, r) <= bar(r, t), (path, norm_rel(g, r),
                                             norm_rel(r, t))
