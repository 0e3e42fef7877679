"""Step builders and abstract inputs for every (arch x shape) cell
(reference: ``repro/launch/steps.py``).

``batch_struct``, ``abstract_params``, ``abstract_opt_state`` and
``abstract_cache`` give the inputs as shape-only ``meta`` tensors (the
reference's ``ShapeDtypeStruct``s): the dry run (``launch/dryrun.py``)
traces a step on them.  ``build_train_step``, ``build_prefill_step`` and
``build_decode_step`` return ``(fn, structs)``; ``fn`` runs eagerly where
its inputs lie.

Every field of ``StepConfig`` shapes the step.  The steps donate as the
reference's jits do (``donate_argnums``): the train step writes the new
params and AdamW state into the trees it is given and returns them, and the
decode step writes the new position into the cache it is given and returns
it.  A donated input belongs to the step: a caller that still needs it
clones it first.  The prefill step donates nothing.

On a ``ShardMesh`` of more than one shard the steps run the reference's
jit shardings: given params, AdamW state, batch and decode cache at rest
by their specs (``launch/sharding.place_params``, ``place_batch``,
``place_cache``; a whole batch or cache is placed on entry), they run the
partitioned program (``models/partitioned.py``: FSDP over the data axes,
TP over ``model``, EP for the routed experts, each group's share on its
group's device) and return params, state, caches and logits placed.  Given
whole params they run the one-device program, with EP over the mesh where
it is engaged.  On a mesh of one shard (``make_host_mesh(device=...)``'s
default) there is nothing to place and the program is that one-device
program.  On a device-free mesh (a ``MeshSpec``, the dry run's production
mesh) the plan is the partitioned program on the mesh's one-shard form
(``ShardMesh.one_shard``): given inputs placed on ``fn.plan.mesh`` (shard
0's blocks, ``launch/dryrun.place_inputs``) the step runs shard 0's part of
the partitioned program on ``meta`` tensors, which the dry run traces as
one device's program; given whole inputs, the one-device program.
``seq_shard_acts`` (the reference's Megatron sequence sharding of the layer
carry) applies to the partitioned train and prefill steps, the dry run's
too: between blocks each shard keeps its ``[B/dp, S/m, D]`` block of the
carry (``Partitioned``), where the reference's rule admits it (``model``
divides S and S >= m).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..ckpt.checkpoint import _flatten, _unflatten
from ..core.mesh import ShardMesh, axis_sizes
from ..models import (ArchConfig, ShapeCfg, decode_step_, forward, loss_fn,
                      meta_cache, meta_params)
from ..models import layers, moe_ep
from ..models.partitioned import Partitioned
from ..models.serving import serving_padded
from ..optim import AdamWConfig, adamw_init, adamw_update_, wsd_schedule
from .mesh import dp_axes
from .sharding import (batch_specs, cache_specs, is_placed, param_specs,
                       place_batch, place_cache, sanitize_spec)

N_PATCHES = 256  # vision stub: patches per sample in vlm cells


@dataclasses.dataclass(frozen=True)
class StepConfig:
    remat: str = "full"
    seq_shard_acts: bool = True       # Megatron-style sequence sharding of
                                      # the layer carry (train/prefill only)
    expert_parallel: bool = True      # EP MoE (vs the dropless path)
    serving_head_pad: bool = True     # decode: pad/replicate kv heads so
                                      # the cache shards on the model axis
    kv_chunk: int = 1024              # flash-attention KV streaming chunk
    optimizer: AdamWConfig = AdamWConfig(state_dtype=torch.bfloat16)


def _configure_ep(cfg: ArchConfig, mesh, step_cfg: StepConfig,
                  tokens_per_device: int = 1 << 30):
    """EP pays off only when each device has enough tokens to fill its
    all-to-all capacity buckets; decode (a handful of tokens a device)
    stays on the dropless path."""
    layers.set_kv_chunk(step_cfg.kv_chunk)
    msize = axis_sizes(mesh)["model"]
    if step_cfg.expert_parallel and cfg.is_moe \
            and cfg.n_experts % msize == 0 and tokens_per_device >= msize:
        moe_ep.set_ep_mesh(mesh, dp_axes(mesh))
    else:
        moe_ep.set_ep_mesh(None, dp_axes(mesh))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "decode":
        return dict(tokens=_meta((b, 1), i32))
    if cfg.frontend == "audio":
        batch = dict(frames=_meta((b, s, cfg.d_model), bf16))
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), i32)
        return batch
    batch = dict(tokens=_meta((b, s), i32))
    if shape.kind == "train":
        batch["labels"] = _meta((b, s), i32)
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _meta((b, N_PATCHES, cfg.d_model), bf16)
        batch["patch_pos"] = _meta((b, N_PATCHES), i32)
    if cfg.mrope:
        batch["pos3"] = _meta((b, 3, s), i32)
    return batch


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16):
    return meta_params(cfg, dtype)


def abstract_opt_state(cfg: ArchConfig, opt: AdamWConfig):
    return adamw_init(abstract_params(cfg), opt)


def abstract_cache(cfg: ArchConfig, shape: ShapeCfg):
    return meta_cache(cfg, shape.global_batch, shape.seq_len)


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def logits_spec(cfg: ArchConfig, shape: ShapeCfg, mesh,
                decode: bool = False):
    """Spec of the logits [B, S, V], sanitized for odd batch/vocab sizes
    (the reference's ``_logits_spec``)."""
    s = 1 if decode else shape.seq_len
    return sanitize_spec((dp_axes(mesh), None, "model"),
                         (shape.global_batch, s, cfg.vocab), mesh)


def _plan(cfg: ArchConfig, mesh, params_s, step_cfg: StepConfig):
    """The partitioned program on a mesh of more than one shard (its specs
    read the EP mesh ``_configure_ep`` just set): on a ``ShardMesh`` itself;
    on a device-free mesh (``MeshSpec``, the dry run's) on its one-shard
    form (``ShardMesh.one_shard``).  None on a mesh of one shard."""
    if mesh.size == 1:
        return None
    if not isinstance(mesh, ShardMesh):
        sizes = axis_sizes(mesh)
        mesh = ShardMesh.one_shard([sizes[a] for a in mesh.axis_names],
                                   mesh.axis_names)
    return Partitioned(cfg, mesh, param_specs(params_s, mesh),
                       remat=step_cfg.remat,
                       seq_shard=step_cfg.seq_shard_acts)


def _placed(plan, params) -> bool:
    return plan is not None and is_placed(params)


def _batch_in(plan, batch, global_batch: int):
    return batch if is_placed(batch) else place_batch(batch, plan.mesh,
                                                      global_batch)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def build_train_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
                     step_cfg: StepConfig = StepConfig()):
    """Returns ``(step, (params_struct, opt_struct, batch_struct))``;
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``.  The
    params and AdamW state are donated: the step writes the new values into
    them, leaf by leaf after the gradients are taken, and returns the same
    trees (placed params give placed results, the loss on
    ``mesh.device``)."""
    _configure_ep(cfg, mesh, step_cfg)
    opt = step_cfg.optimizer
    params_s = abstract_params(cfg)
    plan = _plan(cfg, mesh, params_s, step_cfg)

    def train_step(params, opt_state, batch):
        lr = wsd_schedule(opt_state["step"], warmup=2000, stable=50_000,
                          decay=5_000)
        if _placed(plan, params):
            loss, grads = plan.loss_and_grads(
                params, _batch_in(plan, batch, shape.global_batch))
            with torch.no_grad():
                params, opt_state = adamw_update_(
                    params, grads, opt_state, opt, lr_scale=lr,
                    gnorm=plan.global_norm(grads))
            return params, opt_state, loss
        leaves = [p.detach().requires_grad_() for _, p in _flatten(params)]
        loss = loss_fn(cfg, _unflatten(params, iter(leaves)), batch,
                       remat=step_cfg.remat)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            params, opt_state = adamw_update_(
                params, _unflatten(params, iter(grads)), opt_state, opt,
                lr_scale=lr)
        return params, opt_state, loss.detach()

    train_step.plan = plan
    return train_step, (params_s, abstract_opt_state(cfg, opt),
                        batch_struct(cfg, shape))


def build_prefill_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
                       step_cfg: StepConfig = StepConfig()):
    """Returns ``(prefill, (params_struct, batch_struct))``;
    ``prefill(params, batch) -> logits`` (placed by ``logits_spec`` where
    the params are placed)."""
    _configure_ep(cfg, mesh, step_cfg)
    params_s = abstract_params(cfg)
    plan = _plan(cfg, mesh, params_s, step_cfg)

    def prefill(params, batch):
        with torch.no_grad():
            if _placed(plan, params):
                return plan.prefill(params, _batch_in(
                    plan, batch, shape.global_batch),
                    logits_spec(cfg, shape, mesh))
            return forward(cfg, params, batch, remat="none")

    prefill.plan = plan
    return prefill, (params_s, batch_struct(cfg, shape))


def build_decode_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
                      step_cfg: StepConfig = StepConfig()):
    """serve_step: one new token against a seq_len-deep KV cache.  With
    ``serving_head_pad`` the config is padded for the model axis
    (``models.serving``) and ``serve`` takes the padded params
    (``pad_params_for_serving``).  Returns ``(serve, (params_struct,
    cache_struct, tokens_struct, pos_struct))``; ``serve(params, caches,
    tokens, pos) -> (logits, caches)`` with ``pos`` an int (placed params
    give placed logits and caches; a whole cache or whole tokens are placed
    on entry).  The cache is donated: the new position is written into it
    in place and it comes back (a whole cache given with placed params is
    placed, and the placed copy comes back)."""
    _configure_ep(cfg, mesh, step_cfg,
                  tokens_per_device=max(shape.global_batch
                                        // _dp_size(mesh), 1))
    if step_cfg.serving_head_pad:
        cfg = serving_padded(cfg, axis_sizes(mesh)["model"])

    params_s, cache_s = abstract_params(cfg), abstract_cache(cfg, shape)
    tokens_s = batch_struct(cfg, shape)["tokens"]
    plan = _plan(cfg, mesh, params_s, step_cfg)
    if plan is not None:
        cspecs = cache_specs(cache_s, mesh, shape.global_batch)
        tspec = batch_specs(dict(tokens=tokens_s), mesh,
                            shape.global_batch)["tokens"]

    def serve(params, caches, tokens, pos):
        with torch.no_grad():
            if _placed(plan, params):
                if not is_placed(caches):
                    caches = place_cache(caches, plan.mesh,
                                         shape.global_batch)
                tokens = _batch_in(plan, dict(tokens=tokens),
                                   shape.global_batch)["tokens"]
                return plan.decode(params, caches, cspecs, tokens, int(pos),
                                   logits_spec(cfg, shape, mesh,
                                               decode=True), tspec[0])
            return decode_step_(cfg, params, caches, tokens, int(pos))

    serve.plan = plan
    return serve, (params_s, cache_s, tokens_s, _meta((), torch.int32))


def build_step(cfg: ArchConfig, shape: ShapeCfg, mesh,
               step_cfg: StepConfig = StepConfig()):
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, step_cfg)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, step_cfg)
    return build_decode_step(cfg, shape, mesh, step_cfg)
