"""Model assembly: init / forward / decode for all assigned families
(reference: ``repro/models/model.py``).

Parameters are the reference's nested dict of layer-stacked leaves (a stack
of ``count`` blocks is one tensor ``[count, ...]``; Zamba2's hybrid groups
are ``[groups, per, ...]``), so a converted JAX tree runs here unchanged
and a checkpoint is leaf-compatible.  Each stack runs as a Python loop over
its layers; ``remat`` picks per-block recompute: ``"none"``, ``"full"``
(``torch.utils.checkpoint``) or ``"dots"`` (a selective checkpoint that
keeps the outputs of matmuls without batch dims, as JAX's
``dots_with_no_batch_dims_saveable``).  Recompute changes no value.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ckpt.checkpoint import clone_tree
from ..kernels.runtime import resolve_device
from .config import ArchConfig
from .layers import (attn_forward, ffn_forward, mla_forward, moe_forward,
                     rms_norm, weak)
from .mamba2 import CONV_W, mamba_forward, mamba_param_shapes
from .moe_ep import get_ep_mesh, moe_forward_ep

Tree = Any


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
class _Init:
    """Draws every leaf from one generator, on the generator's device, and
    puts it on ``device`` in ``dtype``; ``lead`` is the stack's leading
    axes (``(count,)``, or ``(groups, per)`` for the hybrid stack)."""

    def __init__(self, generator: torch.Generator, dtype, device, lead=()):
        self.gen, self.dtype, self.device = generator, dtype, device
        self.lead = tuple(lead)

    def dense(self, shape, dtype=None, scale=None):
        """``_dense_init``: N(0, 1) * scale, scale 1/sqrt(fan_in) by
        default, drawn in float32."""
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(self.lead + tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.gen.device) * scale
        return x.to(self.device, dtype or self.dtype)

    def const(self, shape, value, dtype=None):
        return torch.full(self.lead + tuple(shape), value,
                          dtype=dtype or self.dtype, device=self.device)


class _MetaInit(_Init):
    """Shape-only leaves on the ``meta`` device (``meta_params``)."""

    def __init__(self, dtype, lead=()):
        self.gen, self.dtype, self.device = None, dtype, torch.device("meta")
        self.lead = tuple(lead)

    def dense(self, shape, dtype=None, scale=None):
        return torch.empty(self.lead + tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)

    def const(self, shape, value, dtype=None):
        return self.dense(shape, dtype)


def _attn_params(cfg: ArchConfig, ini: _Init):
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return dict(
            wdq=ini.dense((d, cfg.q_lora_rank)),
            q_norm=ini.const((cfg.q_lora_rank,), 1.0),
            wuq=ini.dense((cfg.q_lora_rank, h, dn + dr)),
            wdkv=ini.dense((d, cfg.kv_lora_rank)),
            kv_norm=ini.const((cfg.kv_lora_rank,), 1.0),
            wkr=ini.dense((d, dr)),
            wuk=ini.dense((cfg.kv_lora_rank, h, dn)),
            wuv=ini.dense((cfg.kv_lora_rank, h, dv)),
            wo=ini.dense((h, dv, d)),
        )
    p = dict(wq=ini.dense((d, h, hd)), wk=ini.dense((d, hkv, hd)),
             wv=ini.dense((d, hkv, hd)), wo=ini.dense((h, hd, d)))
    if cfg.qkv_bias:
        p.update(bq=ini.const((h, hd), 0.0), bk=ini.const((hkv, hd), 0.0),
                 bv=ini.const((hkv, hd), 0.0))
    return p


def _ffn_params(cfg: ArchConfig, ini: _Init, d_ff: int):
    d = cfg.d_model
    p = dict(wu=ini.dense((d, d_ff)), wd=ini.dense((d_ff, d)))
    if cfg.gated_ffn:
        p["wg"] = ini.dense((d, d_ff))
    return p


def _moe_params(cfg: ArchConfig, ini: _Init):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = dict(router=ini.dense((d, e), dtype=torch.float32),
             wu=ini.dense((e, d, f)), wd=ini.dense((e, f, d)))
    if cfg.gated_ffn:
        p["wg"] = ini.dense((e, d, f))
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p.update(shared_wu=ini.dense((d, fs)), shared_wd=ini.dense((fs, d)))
        if cfg.gated_ffn:
            p["shared_wg"] = ini.dense((d, fs))
    return p


def _block_params(cfg: ArchConfig, ini: _Init, kind: str):
    """One transformer block: kind in {dense, moe, ssm, shared_attn}."""
    d = cfg.d_model
    if kind == "ssm":
        mp = {}
        for name, shp in sorted(mamba_param_shapes(cfg).items()):
            if name in ("conv_b", "dt_bias"):
                mp[name] = ini.const(shp, 0.0)
            elif name == "A_log":
                mp[name] = ini.const(shp, 0.0, torch.float32)
            elif name in ("D", "out_norm"):
                mp[name] = ini.const(shp, 1.0)
            else:
                mp[name] = ini.dense(shp)
        return dict(ln=ini.const((d,), 1.0), mamba=mp)
    if kind == "dense":
        ffn = _ffn_params(cfg, ini, cfg.d_ff)
    elif kind == "moe":
        ffn = _moe_params(cfg, ini)
    elif kind == "shared_attn":
        ffn = _ffn_params(cfg, ini, cfg.shared_attn_d_ff)
    else:
        raise ValueError(kind)
    return dict(ln1=ini.const((d,), 1.0), attn=_attn_params(cfg, ini),
                ln2=ini.const((d,), 1.0), ffn=ffn)


def layer_plan(cfg: ArchConfig):
    """The sequence of (kind, count) stacks composing the model body."""
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        g = cfg.attn_every
        return [("hybrid_group", cfg.n_layers // g)]
    if cfg.is_moe:
        nd = cfg.first_dense_layers
        return [("dense", nd), ("moe", cfg.n_layers - nd)]
    return [("dense", cfg.n_layers)]


def init_params(cfg: ArchConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Tree:
    """The reference's parameter tree (leaves, shapes, dtypes and init
    scales), drawn from ``generator`` on its device and placed on
    ``device`` (None: the CUDA card).  Its values are not the JAX init's:
    give both packages the same weights with ``convert.params_to_torch``."""
    dev = resolve_device(device)
    return _build_params(cfg, lambda lead=(): _Init(generator, dtype, dev,
                                                     lead))


def meta_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Tree:
    """The parameter tree as shape-only ``meta`` tensors (the reference's
    ``jax.eval_shape`` of ``init_params``): no memory, no device."""
    return _build_params(cfg, lambda lead=(): _MetaInit(dtype, lead))


def _build_params(cfg: ArchConfig, make_init) -> Tree:
    """The tree, each leaf from ``make_init(lead)``'s initializer in the
    order ``init_params`` draws them."""
    ini = make_init()
    params: Dict[str, Tree] = {}
    if cfg.frontend != "audio":
        params["embed"] = ini.dense((cfg.vocab, cfg.d_model), scale=0.02)
    params["final_norm"] = ini.const((cfg.d_model,), 1.0)
    params["lm_head"] = ini.dense((cfg.d_model, cfg.vocab))

    stacks = {}
    for kind, count in layer_plan(cfg):
        if count == 0:
            continue
        if kind == "hybrid_group":
            stacks[kind] = _block_params(
                cfg, make_init((count, cfg.attn_every)), "ssm")
        else:
            stacks[kind] = _block_params(cfg, make_init((count,)), kind)
    params["stacks"] = stacks
    if cfg.family == "hybrid":
        params["shared_attn"] = _block_params(cfg, ini, "shared_attn")
    if cfg.mtp:
        params["mtp"] = dict(
            proj=ini.dense((2 * cfg.d_model, cfg.d_model)),
            norm1=ini.const((cfg.d_model,), 1.0),
            norm2=ini.const((cfg.d_model,), 1.0),
            block=_block_params(cfg, ini, "moe" if cfg.is_moe else "dense"),
        )
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
REMAT_POLICIES = ("none", "dots", "full")

_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of matmuls with no batch dims (``torch.einsum``
    lowers those to a bmm over one batch); recompute the rest."""
    if op in _MATMULS or (op is torch.ops.aten.bmm.default
                          and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, policy: str):
    if policy == "none":
        return fn
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=ctx)
    if policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat={policy!r}; choose from {REMAT_POLICIES}")


def _block_forward(cfg: ArchConfig, p, x, pos, kind, cache=None,
                   cache_pos=None, pos3=None):
    if kind == "ssm":
        h, new_cache = mamba_forward(cfg, p["mamba"],
                                     rms_norm(x, p["ln"], cfg.norm_eps),
                                     cache)
        return x + weak(cfg.residual_scale, h.dtype) * h, new_cache
    attn_fn = mla_forward if cfg.mla else attn_forward
    kw = dict(cache=cache, cache_pos=cache_pos)
    if not cfg.mla:
        kw["pos3"] = pos3
    a, new_cache = attn_fn(cfg, p["attn"],
                           rms_norm(x, p["ln1"], cfg.norm_eps), pos, **kw)
    x = x + weak(cfg.residual_scale, a.dtype) * a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        if get_ep_mesh() is not None:
            f = moe_forward_ep(cfg, p["ffn"], h)   # expert-parallel path
        else:
            f = moe_forward(cfg, p["ffn"], h)      # one-device path
    else:
        f = ffn_forward(cfg, p["ffn"], h)
    return x + weak(cfg.residual_scale, f.dtype) * f, new_cache


def _unstack(tree, n: int):
    """A tree of stacked leaves ``[n, ...]`` as n trees of ``[...]`` (one
    ``unbind`` per leaf, whose backward stacks the grads)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: cols[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def write_into(dst, src) -> None:
    """Each leaf of the cache tree ``src`` copied into the same leaf of
    ``dst``, but where it already is that leaf's storage (written in place
    by ``layers._write_cache``)."""
    if isinstance(dst, dict):
        for k in dst:
            write_into(dst[k], src[k])
    elif not _aliases(dst, src):
        dst.copy_(src)


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same elements (never on ``meta``,
    which has no storage to compare)."""
    if a is b:
        return True
    return (a.device == b.device and a.device.type != "meta"
            and a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _run_stacks(cfg: ArchConfig, params, x, pos, *, caches=None,
                cache_pos=None, pos3=None, remat="full"):
    """Run the layer stacks in order; returns (x, caches): each layer's new
    cache is written into ``caches`` (attention writes its new position
    there itself)."""
    for kind, count in layer_plan(cfg):
        if count == 0:
            continue
        layers = _unstack(params["stacks"][kind], count)
        lcs = _unstack(caches[kind] if caches is not None else None, count)
        if kind == "hybrid_group":
            per = cfg.attn_every

            def group_body(h, gp, gc):
                for lp, lc in zip(_unstack(gp, per),
                                  _unstack(gc["ssm"] if gc is not None
                                           else None, per)):
                    h, nc = _block_forward(cfg, lp, h, pos, "ssm", cache=lc,
                                           cache_pos=cache_pos)
                    if lc is not None:
                        write_into(lc, nc)
                # shared attention block (same weights every group)
                h, _ = _block_forward(
                    cfg, params["shared_attn"], h, pos, "dense",
                    cache=gc["attn"] if gc is not None else None,
                    cache_pos=cache_pos, pos3=pos3)
                return h, gc

            body = _maybe_remat(group_body, remat)
        else:
            def body_fn(h, lp, lc, kind=kind):
                return _block_forward(cfg, lp, h, pos, kind, cache=lc,
                                      cache_pos=cache_pos, pos3=pos3)

            body = _maybe_remat(body_fn, remat)
        for lp, lc in zip(layers, lcs):
            x, nc = body(x, lp, lc)
            if lc is not None:
                write_into(lc, nc)
    return x, caches


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(embed, tokens, axis=0)`` through ``F.embedding``, whose
    CUDA backward is deterministic."""
    return F.embedding(tokens.long(), params["embed"])


def embed_inputs(cfg: ArchConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Returns (hidden, pos, pos3)."""
    if cfg.frontend == "audio":
        x = batch["frames"]
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        return x, pos, None
    return finish_inputs(cfg, embed_tokens(params, batch["tokens"]), batch)


def finish_inputs(cfg: ArchConfig, x: torch.Tensor, batch
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             Optional[torch.Tensor]]:
    """``embed_inputs`` after the token lookup ``x``: the vision patches
    scattered over their placeholders, and the positions (a partitioned
    step looks the tokens up vocab-parallel, then scatters)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        # scatter precomputed patch embeddings over placeholder positions
        pe, pp = batch["patch_embeds"], batch["patch_pos"]
        rows = torch.arange(b, device=x.device)[:, None].expand(pp.shape)
        x = x.index_put((rows, pp.long()), pe.to(x.dtype))
    pos = torch.arange(s, device=tokens.device)[None, :]
    pos3 = batch.get("pos3") if cfg.mrope else None
    return x, pos, pos3


def forward(cfg: ArchConfig, params, batch, *, remat="full") -> torch.Tensor:
    """Train/prefill forward -> logits [B, S, V]."""
    x, pos, pos3 = embed_inputs(cfg, params, batch)
    x, _ = _run_stacks(cfg, params, x, pos, pos3=pos3, remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,dv->bsv", x, params["lm_head"])


def masked_ce_sums(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The masked cross-entropy's sum and the mask's count (a partitioned
    step sums both over the data axes before it divides)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(labels, min=0).long()[..., None])[..., 0]
    return torch.sum((lse - gold) * mask), mask.sum()


def vocab_parallel_ce_sums(logits, labels, masks, starts, psum, pmax):
    """``masked_ce_sums`` with the vocab split over shards (a partitioned
    step's ``model`` axis), one list entry a shard: each shard's logits
    block [..., V / m], its labels and mask, and ``starts``, its block's
    first vocab id.  ``psum`` / ``pmax`` take such a list and reduce it
    over the shards that split one row's vocab.  The row max is detached
    and maxed over them, the sum of exponentials and the gold logit (from
    the shard that owns the label) summed; differentiation through the
    ``psum`` is exact.  Returns each shard's (sum, count), equal on the
    shards of one row."""
    lf = [x.float() for x in logits]
    mx = pmax([x.detach().amax(-1) for x in lf])
    se = psum([torch.sum(torch.exp(x - m[..., None]), -1)
               for x, m in zip(lf, mx)])
    gold = []
    for x, lab, lo in zip(lf, labels, starts):
        ids = torch.clamp(lab, min=0).long() - lo
        own = (ids >= 0) & (ids < x.shape[-1])
        g = torch.gather(x, -1, torch.where(own, ids, 0)[..., None])[..., 0]
        gold.append(torch.where(own, g, 0.0))
    gold = psum(gold)
    return [(torch.sum((torch.log(e) + m - g) * mask), mask.sum())
            for e, m, g, mask in zip(se, mx, gold, masks)]


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    total, count = masked_ce_sums(logits, labels, mask)
    return total / torch.clamp(count, min=1)


def loss_fn(cfg: ArchConfig, params, batch, *, remat="full") -> torch.Tensor:
    """Next-token CE (causal LMs) or masked-prediction CE (encoder)."""
    x, pos, pos3 = embed_inputs(cfg, params, batch)
    h, _ = _run_stacks(cfg, params, x, pos, pos3=pos3, remat=remat)
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", hn, params["lm_head"])
    labels = batch["labels"]
    mask = labels >= 0
    ce = _masked_ce(logits, labels, mask)

    if cfg.mtp:
        # DeepSeek-V3 MTP depth 1: predict t+2 through one extra block.
        emb_next = torch.roll(embed_tokens(params, batch["tokens"]), -1, 1)
        mp = params["mtp"]
        hcat = torch.cat([rms_norm(h, mp["norm1"], cfg.norm_eps),
                          rms_norm(emb_next, mp["norm2"], cfg.norm_eps)],
                         dim=-1)
        hm = torch.einsum("bsd,dk->bsk", hcat, mp["proj"])
        hm, _ = _block_forward(cfg, mp["block"], hm, pos,
                               "moe" if cfg.is_moe else "dense")
        lm = torch.einsum("bsd,dv->bsv",
                          rms_norm(hm, params["final_norm"], cfg.norm_eps),
                          params["lm_head"])
        lbl2 = torch.roll(labels, -1, 1)
        mask2 = mask & torch.roll(mask, -1, 1)
        mask2[:, -1] = False
        ce = ce + 0.1 * _masked_ce(lm, lbl2, mask2)
    return ce


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Tree:
    """Layer-stacked cache tree matching layer_plan, on ``device`` (None:
    the CUDA card)."""
    return _cache_tree(cfg, batch, max_seq, dtype, resolve_device(device))


def meta_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16) -> Tree:
    """``init_cache``'s tree as shape-only ``meta`` tensors."""
    return _cache_tree(cfg, batch, max_seq, dtype, torch.device("meta"))


def _cache_tree(cfg: ArchConfig, batch: int, max_seq: int, dtype,
                dev: torch.device) -> Tree:
    z = functools.partial(torch.zeros, device=dev)
    f32 = torch.float32
    # each shape is built only for the kinds the plan holds: an SSM-only
    # config has no attention heads
    conv = lambda lead: z(lead + (batch, CONV_W - 1,
                                  cfg.d_inner + 2 * cfg.ssm_state),
                          dtype=dtype)
    ssm = lambda lead: z(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state), dtype=f32)
    kv = lambda lead: z(lead + (batch, max_seq, cfg.n_kv_heads, cfg.hd),
                        dtype=dtype)
    caches = {}
    for kind, count in layer_plan(cfg):
        if count == 0:
            continue
        if kind == "hybrid_group":
            per = cfg.attn_every
            caches[kind] = dict(
                ssm=dict(conv=conv((count, per)), ssm=ssm((count, per))),
                attn=dict(k=kv((count,)), v=kv((count,))))
        elif kind == "ssm":
            caches[kind] = dict(conv=conv((count,)), ssm=ssm((count,)))
        elif cfg.mla:
            caches[kind] = dict(
                ckv=z((count, batch, max_seq, cfg.kv_lora_rank), dtype=dtype),
                kr=z((count, batch, max_seq, cfg.qk_rope_dim), dtype=dtype))
        else:
            caches[kind] = dict(k=kv((count,)), v=kv((count,)))
    return caches


def decode_step(cfg: ArchConfig, params, caches, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Tree]:
    """One token step.  tokens: [B, 1]; pos: the cache fill (an int).
    Returns (logits [B, 1, V], new caches); the caller's caches are left as
    they were (``decode_step_`` on a copy of them)."""
    return decode_step_(cfg, params, clone_tree(caches), tokens, pos)


def decode_step_(cfg: ArchConfig, params, caches, tokens: torch.Tensor,
                 pos: int) -> Tuple[torch.Tensor, Tree]:
    """``decode_step`` with the caches donated (the reference's
    ``donate_argnums=(1,)``): the new position is written into ``caches``
    in place, and ``(logits, caches)`` comes back."""
    x = embed_tokens(params, tokens)
    posv = torch.full((1, 1), int(pos), dtype=torch.int32, device=x.device)
    pos3 = posv[:, None, :].expand(x.shape[0], 3, 1) if cfg.mrope else None
    x, new_caches = _run_stacks(cfg, params, x, posv, caches=caches,
                                cache_pos=int(pos), pos3=pos3, remat="none")
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    return logits, new_caches
