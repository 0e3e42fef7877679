"""Transformer building blocks: norms, RoPE/M-RoPE, flash-style attention
(GQA + MLA), FFN variants, dropless MoE (reference: ``repro/models/layers.py``).

Plain PyTorch over the reference's parameter dicts, in its dtypes:

* attention streams over KV chunks with an online softmax, so no S x S
  score matrix is built for a long sequence (DESIGN.md §6);
* MoE sorts the (token, expert) pairs by expert and runs one matmul per
  expert over its contiguous rows (the reference's ``lax.ragged_dot``);
* every op whose backward could add into one place from many threads is
  written so that it does not: token gathers go through ``F.embedding``
  (its CUDA backward is deterministic), the MoE's row gathers are
  permutations and broadcasts, and its combine sums each token's k expert
  outputs in a fixed order instead of scattering them.  A training step on
  the card is then bitwise repeatable.

JAX promotes a Python scalar to the array's dtype before it multiplies
(``q * scale`` on bf16 rounds ``scale`` to bf16 first); torch keeps the
scalar in float32.  ``weak`` gives the scalar JAX would use, so bf16 runs
round as the reference's do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig

# flash-attention KV streaming chunk (larger chunks rewrite the f32
# online-softmax accumulators fewer times; temporaries grow with the chunk)
DEFAULT_KV_CHUNK = 1024


def set_kv_chunk(n: int) -> None:
    global DEFAULT_KV_CHUNK
    DEFAULT_KV_CHUNK = int(n)


def weak(s: float, dtype: torch.dtype) -> float:
    """The Python scalar ``s`` as JAX's weak typing applies it to an array
    of ``dtype``: rounded to that dtype."""
    return float(torch.tensor(s, dtype=dtype))


# ---------------------------------------------------------------------------
# norms & misc
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


class _Sigmoid(torch.autograd.Function):
    """The logistic with JAX's own derivative rule for ``lax.logistic``,
    g * (s * (1 - s)) from the saved output s.  Autograd through the
    expansion would give 0 * inf = NaN once ``exp(-x)`` overflows."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA expands it, 1 / (1 + exp(-x)), rounded to
    x's dtype after each op (``torch.sigmoid`` rounds bf16 once); its
    gradient is ``lax.logistic``'s (``_Sigmoid``)."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x), each op in x's dtype."""
    return x * sigmoid(x)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


_SQRT_2_OVER_PI = math.sqrt(2 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (``F.gelu``
    defaults to erf), op for op in x's dtype."""
    c, k = weak(_SQRT_2_OVER_PI, x.dtype), weak(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * x ** 3))))


def act_fn(name: str):
    if name == "silu":
        return silu
    if name == "relu2":
        return _relu2
    if name == "gelu":
        return gelu
    raise ValueError(name)


# ---------------------------------------------------------------------------
# RoPE (+ sectioned M-RoPE for Qwen2-VL)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
            ) -> torch.Tensor:
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., S, H, D]; pos: broadcastable to [..., S]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = pos[..., None].float() * inv                       # [..., S, D/2]
    ang = ang[..., None, :]                                  # head axis
    return _rotate(x, torch.cos(ang), torch.sin(ang))


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL M-RoPE: rotary pairs split into (t, h, w) sections.

    x: [B, S, H, D]; pos3: [B, 3, S] position ids per section.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # [D/2]
    sec = torch.cat([torch.full((s,), i, dtype=torch.int64, device=x.device)
                     for i, s in enumerate(sections)])[: d // 2]
    # pick, per rotary pair, the section's position id
    pos = torch.gather(pos3.float(), 1,
                       sec[None, :, None].expand(x.shape[0], d // 2,
                                                 x.shape[1]))  # [B, D/2, S]
    ang = pos.permute(0, 2, 1)[..., None, :] * inv
    return _rotate(x, torch.cos(ang), torch.sin(ang))


# ---------------------------------------------------------------------------
# flash-style attention (no S x S materialization)
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset: int = 0,
                    kv_len: Optional[int] = None,
                    kv_chunk: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention streaming over KV chunks.

    q: [B, Sq, H, D]; k/v: [B, Sk, Hkv, D] (GQA: H % Hkv == 0).
    ``q_offset``: absolute position of q[0] (decode / chunked prefill).
    ``kv_len``: effective kv length (decode with preallocated cache).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = h // hkv
    scale = 1.0 / math.sqrt(d)
    kv_chunk = DEFAULT_KV_CHUNK if kv_chunk is None else kv_chunk
    nchunks = max(1, -(-sk // kv_chunk))
    ck = min(kv_chunk, sk)
    pad = nchunks * ck - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device

    # GQA grouping: q [B, Sq, G, R, D] so shared KV heads are never repeated
    qg = (q * weak(scale, q.dtype)).float().reshape(b, sq, hkv, rep, d)
    qpos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, rep, sq), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, rep, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, sq, dv), dtype=torch.float32, device=dev)
    for j in range(nchunks):
        kj = k[:, j * ck:(j + 1) * ck].float()
        vj = v[:, j * ck:(j + 1) * ck].float()
        kpos = j * ck + torch.arange(ck, device=dev)
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kj)
        mask = (kpos < sk)[None, :].expand(sq, ck)
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        if kv_len is not None:
            mask = mask & (kpos < kv_len)[None, :]
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)      # [B,G,R,Sq,dv]
    out = out.reshape(b, h, sq, dv).permute(0, 2, 1, 3)
    return out.to(q.dtype)                                 # [B, Sq, H, dv]


def _write_cache(buf: torch.Tensor, new: torch.Tensor, pos: int
                 ) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim(buf, new, pos, axis=1)`` into
    ``buf`` itself, which comes back: the cache belongs to the decode step
    (the reference's ``donate_argnums``), and the rest of it is not
    copied."""
    buf.narrow(1, pos, new.shape[1]).copy_(new)
    return buf


# ---------------------------------------------------------------------------
# GQA attention layer (optionally with KV cache)
# ---------------------------------------------------------------------------
def attn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
                 cache: Optional[dict] = None, cache_pos: Optional[int] = None,
                 pos3: Optional[torch.Tensor] = None,
                 kv_heads: Optional[Tuple[int, int]] = None,
                 partial: bool = False
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: [B, S, D].  With ``cache``, writes new kv at ``cache_pos`` (into
    ``cache`` itself) and attends over the cache (decode / incremental
    prefill).  The head counts are the weights' own, so a tensor-parallel
    shard runs this on its heads' columns of ``wq``/``wk``/``wv`` and rows
    of ``wo`` (its output is then a partial sum, float32 with ``partial``:
    see ``out_proj``).  ``kv_heads`` ``(lo, hi)``: the kv heads its q heads
    attend to, where ``wk``/``wv`` (and the cache) hold more."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.mrope and pos3 is not None:
        q = apply_mrope(q, pos3, cfg.rope_theta)
        k = apply_mrope(k, pos3, cfg.rope_theta)
    elif not cfg.encoder_only:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)

    if cache is not None:
        ck = _write_cache(cache["k"], k, cache_pos)
        cv = _write_cache(cache["v"], v, cache_pos)
        cache = dict(k=ck, v=cv)
        if kv_heads is not None:
            ck, cv = (c[:, :, kv_heads[0]:kv_heads[1]] for c in (ck, cv))
        o = flash_attention(q, ck, cv, causal=True, q_offset=cache_pos,
                            kv_len=cache_pos + s)
    else:
        if kv_heads is not None:
            k, v = (t[:, :, kv_heads[0]:kv_heads[1]] for t in (k, v))
        o = flash_attention(q, k, v, causal=not cfg.encoder_only)
    return out_proj("bshk,hkd->bsd", o, p["wo"], partial), cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3): low-rank q/kv with compressed KV cache
# ---------------------------------------------------------------------------
def mla_forward(cfg: ArchConfig, p: dict, x: torch.Tensor, pos: torch.Tensor,
                cache: Optional[dict] = None, cache_pos: Optional[int] = None,
                partial: bool = False
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    """With ``cache``, the new latent is written into ``cache`` itself.  The
    head count is ``wuq``'s own, so a tensor-parallel shard runs
    this on its heads of ``wuq``/``wuk``/``wuv`` and rows of ``wo`` (its
    output is then a partial sum, float32 with ``partial``); the latent is
    whole on every shard."""
    b, s, _ = x.shape
    h = p["wuq"].shape[-2]
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    # --- queries through the q-LoRA path
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdq"]), p["q_norm"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wuq"])          # [B,S,H,dn+dr]
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    # --- compressed kv latent + shared rope key
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wdkv"]), p["kv_norm"],
                   cfg.norm_eps)                             # [B,S,r]
    k_rope = apply_rope(torch.einsum("bsd,dk->bsk", x, p["wkr"])[:, :, None, :],
                        pos, cfg.rope_theta)[:, :, 0]        # [B,S,dr]

    if cache is not None:
        ckv_c = _write_cache(cache["ckv"], ckv, cache_pos)
        kr_c = _write_cache(cache["kr"], k_rope, cache_pos)
        # absorbed decode: score = q_nope·W_uk^T·ckv + q_rope·k_rope,
        # attention output stays in latent space, expanded once via W_uv.
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wuk"])
        q_eff = torch.cat([q_lat, q_rope], dim=-1)           # [B,S,H,r+dr]
        k_eff = torch.cat([ckv_c[:, :, None, :], kr_c[:, :, None, :]],
                          dim=-1)                            # [B,S,1,r+dr]
        o_lat = flash_attention(q_eff, k_eff, ckv_c[:, :, None, :],
                                causal=True, q_offset=cache_pos,
                                kv_len=cache_pos + s)        # [B,S,H,r]
        o = torch.einsum("bshr,rhk->bshk", o_lat, p["wuv"])   # [B,S,H,dv]
        cache = dict(ckv=ckv_c, kr=kr_c)
    else:
        k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wuk"])
        v = torch.einsum("bsr,rhk->bshk", ckv, p["wuv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                      dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(q_full, k, v, causal=True)
    return out_proj("bshk,hkd->bsd", o, p["wo"], partial), cache


# ---------------------------------------------------------------------------
# FFN + MoE
# ---------------------------------------------------------------------------
def out_proj(eq: str, x: torch.Tensor, w: torch.Tensor,
             partial: bool = False) -> torch.Tensor:
    """A layer's last projection.  ``partial``: a tensor-parallel shard's
    share of a sum over its rows of ``w``, kept in float32, so the psum
    that adds the shards' shares rounds once, as the one-device product
    does (bf16 shares each rounded put mamba2's outputs several percent
    off over a few layers)."""
    if partial:
        return torch.einsum(eq, x.float(), w.float())
    return torch.einsum(eq, x, w)


def ffn_forward(cfg: ArchConfig, p: dict, x: torch.Tensor,
                partial: bool = False) -> torch.Tensor:
    f = act_fn(cfg.act)
    if cfg.gated_ffn:
        h = f(torch.einsum("bsd,df->bsf", x, p["wg"])) \
            * torch.einsum("bsd,df->bsf", x, p["wu"])
    else:
        h = f(torch.einsum("bsd,df->bsf", x, p["wu"]))
    return out_proj("bsf,fd->bsd", h, p["wd"], partial)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties keep the lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def group_sizes(ids: torch.Tensor, n: int):
    """Rows of each group ``0..n-1`` in ``ids`` as host ints (a read that
    waits for the device); ``None`` for ``meta`` tensors, whose shape-only
    program (the dry run) has no counts to read: ``grouped_matmul`` then
    counts every row through one expert, and a block of experts takes its
    equal share of the rows."""
    if ids.is_meta:
        return None
    return torch.bincount(ids.reshape(-1), minlength=n)[:n].tolist()


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, sizes) -> torch.Tensor:
    """``lax.ragged_dot``: rows ``xs`` [T, K] in contiguous groups of
    ``sizes`` (one per expert), each times its expert's ``w[e]`` [K, N];
    rows past the groups' sum give zeros.  ``sizes=None`` (meta tensors
    only, see ``group_sizes``): every row through one expert's weight, as
    one matmul, the work of T rows each through its own expert."""
    if sizes is None:
        ys = xs @ w[0]
    else:
        outs, start = [], 0
        for i, n in enumerate(sizes):
            outs.append(xs[start:start + n] @ w[i])
            start += n
        ys = torch.cat(outs, dim=0)
    tail = xs.shape[0] - ys.shape[0]
    if tail:
        ys = torch.cat([ys, ys.new_zeros((tail, ys.shape[1]))], dim=0)
    return ys


def moe_forward(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dropless MoE: router top-k -> sort tokens by expert -> grouped matmul,
    plus the shared experts.

    x: [B, S, D].  Expert weights: [E, D, F] / [E, F, D] (+gate for swiglu).
    """
    b, s, d = x.shape
    out = moe_routed(cfg, p, x)
    if cfg.n_shared_experts:
        sh = dict(wg=p["shared_wg"], wu=p["shared_wu"], wd=p["shared_wd"]) \
            if cfg.gated_ffn else dict(wu=p["shared_wu"], wd=p["shared_wd"])
        out = out + ffn_forward(cfg, sh, x).reshape(b * s, d)
    return out.reshape(b, s, d).to(x.dtype)


def moe_routed(cfg: ArchConfig, p: dict, x: torch.Tensor,
               experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The routed experts of ``moe_forward``: [B * S, D] in the experts'
    dtype.  ``experts`` ``(lo, hi)``: ``wu``/``wg``/``wd`` hold only those
    experts (a tensor-parallel shard's block); routing is over all of them,
    the rows routed elsewhere give zeros, and the output is this block's
    partial sum."""
    if isinstance(p["wu"], tuple):
        raise ValueError("routed experts placed in device groups take the "
                         "expert-parallel path (launch/sharding."
                         "gather_params assembles them)")
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    n_tok = b * s
    xt = x.reshape(n_tok, d)
    logits = xt.float() @ p["router"].float()
    gates, choice = top_k(sigmoid(logits), k)            # DSv3-style
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    t = n_tok * k
    flat_exp = choice.reshape(t)
    order = torch.argsort(flat_exp, stable=True)
    # row r of the expert-sorted layout is token order[r] // k; a broadcast
    # and a permutation, so no backward adds into one row from many
    xs = xt[:, None, :].expand(n_tok, k, d).reshape(t, d)[order]   # [T, D]
    sizes = group_sizes(flat_exp, e)
    if experts is not None:
        # the block's experts hold one contiguous run of the sorted rows
        lo, hi = experts
        if sizes is None:                    # meta: equal groups
            start, rows = t * lo // e, t * (hi - lo) // e
        else:
            start, rows = sum(sizes[:lo]), sum(sizes[lo:hi])
            sizes = sizes[lo:hi]
        xs = xs[start:start + rows]

    f = act_fn(cfg.act)
    if cfg.gated_ffn:
        hidden = f(grouped_matmul(xs, p["wg"], sizes)) \
            * grouped_matmul(xs, p["wu"], sizes)
    else:
        hidden = f(grouped_matmul(xs, p["wu"], sizes))
    ys = grouped_matmul(hidden, p["wd"], sizes)                 # [T, D]
    if experts is not None:
        ys = torch.cat([ys.new_zeros((start, d)), ys,
                        ys.new_zeros((t - start - rows, d))])
    gate_flat = gates.reshape(t)[order]
    ys = ys * gate_flat[:, None].to(ys.dtype)

    # the reference's ``zeros.at[sort_tok].add(ys)`` adds a token's k rows
    # in sorted order, i.e. by ascending expert: sum them in that order
    inv = torch.argsort(order)
    per_tok = ys[inv].reshape(n_tok, k, d)
    by_exp = torch.argsort(choice, dim=-1, stable=True)
    per_tok = torch.gather(per_tok, 1, by_exp[..., None].expand(n_tok, k, d))
    out = torch.zeros((n_tok, d), dtype=ys.dtype, device=x.device)
    for j in range(k):
        out = out + per_tok[:, j]
    return out
