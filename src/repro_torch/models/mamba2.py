"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060 (reference:
``repro/models/mamba2.py``).

Chunked SSD algorithm: the sequence is split into chunks of length Q;
intra-chunk interactions use the quadratic (attention-like) form,
inter-chunk state is carried by a linear recurrence — the paper's
decomposition.  Decode runs the O(1)-per-token recurrence with a
(conv window, SSM state) cache.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads,
state N = ssm_state, single B/C group (n_groups = 1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import rms_norm, silu

CONV_W = 4


def _dw_conv(x: torch.Tensor, w: torch.Tensor,
             state: Optional[torch.Tensor] = None):
    """Causal depthwise conv, window CONV_W.  x: [B, S, C], w: [CONV_W, C].

    With ``state`` [B, CONV_W-1, C] (decode), returns (y, new_state).
    """
    if state is not None:
        xin = torch.cat([state, x], dim=1)
    else:
        xin = F.pad(x, (0, 0, CONV_W - 1, 0))
    new_state = xin[:, -(CONV_W - 1):]
    y = sum(xin[:, i:i + x.shape[1]] * w[i] for i in range(CONV_W))
    return y, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> torch.Tensor:
    """Chunked SSD scan.

    xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (negative);
    Bm/Cm: [B, S, N] (single group, broadcast over heads).
    Returns y: [B, S, H, P].
    """
    b, s, h, p = xh.shape
    n = Bm.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    xq = xh.reshape(b, nc, chunk, h, p)
    dtq = dt.reshape(b, nc, chunk, h)
    Bq = Bm.reshape(b, nc, chunk, n).float()
    Cq = Cm.reshape(b, nc, chunk, n).float()

    dA = dtq * A[None, None, None, :]               # [B,C,Q,H] (negative)
    cum = torch.cumsum(dA, dim=2)                   # within-chunk cumsum
    scores = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)       # [B,C,Q,Q]
    xdt = xq.float() * dtq[..., None]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xh.device))

    # per-head [B,C,Q,Q] decay matrix, one head at a time: the H axis of
    # the decay is never materialized.  The masked (k > q) entries go to
    # -inf before the exp: their exp(seg) overflows in a long chunk, and
    # where(mask, exp(seg), 0)'s gradient is then 0 * inf = NaN (the
    # reference's formulation; ROADMAP C7).  The values are the same.
    y_intra = []
    for hh in range(h):
        cum_h = cum[..., hh]                        # [B,C,Q]
        seg = cum_h[:, :, :, None] - cum_h[:, :, None, :]
        L = torch.exp(torch.where(mask, seg, -torch.inf))
        y_intra.append(torch.einsum("bcqk,bckp->bcqp", scores * L,
                                    xdt[..., hh, :]))
    y_intra = torch.stack(y_intra, dim=-2)                  # [B,C,Q,H,P]

    # chunk-final states: S_c = sum_k exp(cum_end - cum_k) * B_k x_k dt_k
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,C,Q,H]
    states = torch.einsum("bckn,bckh,bckhp->bcnhp", Bq, decay_end, xdt)

    # inter-chunk recurrence over chunk states (emit the state *before*)
    chunk_decay = torch.exp(cum[:, :, -1, :])               # [B,C,H]
    carry = torch.zeros((b, n, h, p), dtype=torch.float32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, None, :, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # [B,C,N,H,P]

    # contribution of carried state to each position
    decay_in = torch.exp(cum)                               # [B,C,Q,H]
    y_inter = torch.einsum("bcqn,bcqh,bcnhp->bcqhp", Cq, decay_in,
                           prev_states)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(xh.dtype)


def mamba_forward(cfg: ArchConfig, p: dict, x: torch.Tensor,
                  cache: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One Mamba2 block.  x: [B, S, D].  Decode when ``cache`` is given
    (S == 1): conv window + SSM state recurrence."""
    proj = torch.einsum("bsd,dc->bsc", x, p["in_proj"])
    y, new_conv, new_ssm = mamba_mix(cfg, p, proj, cache)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = torch.einsum("bsc,cd->bsd", y, p["out_proj"])
    new_cache = None
    if cache is not None:
        new_cache = dict(conv=new_conv.to(cache["conv"].dtype),
                         ssm=new_ssm.to(cache["ssm"].dtype))
    return out, new_cache


def mamba_mix(cfg: ArchConfig, p: dict, proj: torch.Tensor,
              cache: Optional[dict] = None,
              heads: Optional[Tuple[int, int]] = None):
    """The block from its input projection ``proj`` [B, S, C] (whole: the
    columns ``[z | x | B | C | dt]``) to the gated SSD output, before the
    norm: ``(y [B, S, h * P], new conv state, new SSM state)``, the states
    None without ``cache``.  ``heads`` ``(h0, h1)``: run only those SSM
    heads (a tensor-parallel shard's block): ``A_log``, ``D``, ``dt_bias``
    and the cache's ``ssm`` hold only them, ``conv_w``, ``conv_b`` and the
    cache's ``conv`` are whole, and the conv state returned holds the
    heads' ``x`` columns and the whole ``B``/``C``."""
    b, s, _ = proj.shape
    di, n, hdim = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    z, xc, Bm, Cm, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    conv_w, conv_b = p["conv_w"], p["conv_b"]
    conv_state = cache["conv"] if cache is not None else None
    if heads is not None:
        h0, h1 = heads
        c0, c1 = h0 * hdim, h1 * hdim
        own = lambda t: torch.cat([t[..., c0:c1], t[..., di:]], dim=-1)
        z, xc, dt = z[..., c0:c1], xc[..., c0:c1], dt[..., h0:h1]
        conv_w, conv_b = own(conv_w), own(conv_b)
        if conv_state is not None:
            conv_state = own(conv_state)
        h, di = h1 - h0, c1 - c0
    conv_in = torch.cat([xc, Bm, Cm], dim=-1)
    conv_out, new_conv = _dw_conv(conv_in, conv_w, conv_state)
    conv_out = silu(conv_out + conv_b)
    xc, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)

    A = -torch.exp(p["A_log"].float())                       # [H]
    dt = _softplus(dt.float() + p["dt_bias"])                # [B,S,H]
    xh = xc.reshape(b, s, h, hdim)

    if cache is None:
        pad = (-s) % cfg.ssm_chunk
        if pad:
            xh2 = F.pad(xh, (0, 0, 0, 0, 0, pad))
            dt2 = F.pad(dt, (0, 0, 0, pad))
            B2 = F.pad(Bm, (0, 0, 0, pad))
            C2 = F.pad(Cm, (0, 0, 0, pad))
        else:
            xh2, dt2, B2, C2 = xh, dt, Bm, Cm
        y = ssd_chunked(xh2, dt2, A, B2, C2, cfg.ssm_chunk)[:, :s]
        new_ssm = new_conv = None
    else:
        # O(1) recurrence: state [B,H,P,N]
        st = cache["ssm"].float()
        dA = torch.exp(dt[:, 0, :, None, None] * A[None, :, None, None])
        upd = torch.einsum("bhp,bn,bh->bhpn", xh[:, 0].float(),
                           Bm[:, 0].float(), dt[:, 0])
        st = st * dA + upd
        y = torch.einsum("bhpn,bn->bhp", st, Cm[:, 0].float())
        y = y[:, None].to(xh.dtype)                          # [B,1,H,P]
        new_ssm = st

    y = y + xh * p["D"][None, None, :, None]
    return y.reshape(b, s, di) * silu(z), new_conv, new_ssm


def mamba_param_shapes(cfg: ArchConfig):
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    return dict(
        in_proj=(d, 2 * di + 2 * n + h),
        conv_w=(CONV_W, conv_ch),
        conv_b=(conv_ch,),
        A_log=(h,),
        D=(h,),
        dt_bias=(h,),
        out_norm=(di,),
        out_proj=(di, d),
    )
