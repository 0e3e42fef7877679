"""Serving-plan head padding: make KV caches shardable on the model axis
(reference: ``repro/models/serving.py``).

Decode cells whose kv-head count does not divide the TP axis (minicpm's 36
MHA heads; GQA kv=8 on a 16-way axis) replicate the whole cache on every
device.  Two weight transforms that change no output fix this at serving
time:

* MHA: pad q and kv heads together to the next multiple of the axis.  The
  padded heads have zero W_q/W_k/W_v columns and zero W_o rows, so they add
  nothing.
* GQA (hkv < axis): replicate kv heads up to the axis size and regroup.
  Replicated kv heads are identical, so each q head attends as before.

The per-device cache then drops by (new local kv heads / old replicated kv
heads): minicpm 36 -> 3 (12x).  MQA (kv=1) gains nothing.  The transforms
work on a layer stack as on one block: every head axis is counted from the
end of a leaf's shape.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import ArchConfig


def serving_padded(cfg: ArchConfig, msize: int) -> ArchConfig:
    """Config transform for decode on an ``msize``-way TP axis (``cfg``
    itself where nothing changes)."""
    if not cfg.n_heads or cfg.mla or cfg.encoder_only:
        return cfg
    hkv, nh = cfg.n_kv_heads, cfg.n_heads
    if hkv % msize == 0:
        return cfg
    if hkv == nh:                       # MHA: pad q and kv together
        nh2 = -(-nh // msize) * msize
        return dataclasses.replace(cfg, n_heads=nh2, n_kv_heads=nh2,
                                   head_dim=cfg.hd)
    if hkv < msize and nh % msize == 0 and (nh // hkv) % (nh // msize) == 0:
        return dataclasses.replace(cfg, n_kv_heads=msize, head_dim=cfg.hd)
    return cfg


def _pad_heads(w: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    """Zero-pad head axis ``axis`` (negative) of ``w`` to ``target``."""
    shape = list(w.shape)
    shape[axis] = target - shape[axis]
    return torch.cat([w, w.new_zeros(shape)], dim=axis)


def pad_attn_params(cfg: ArchConfig, padded: ArchConfig, p: dict) -> dict:
    """One attention block's weights (or a stack of them), training layout
    -> serving layout: zero-pad q/o heads; replicate kv heads with
    regrouping."""
    if padded is cfg:
        return p
    nh0, nh1 = cfg.n_heads, padded.n_heads
    kv0, kv1 = cfg.n_kv_heads, padded.n_kv_heads
    out = dict(p)
    if nh1 > nh0:
        out["wq"] = _pad_heads(p["wq"], -2, nh1)          # [..., D, H, hd]
        out["wo"] = _pad_heads(p["wo"], -3, nh1)          # [..., H, hd, D]
        if "bq" in p:
            out["bq"] = _pad_heads(p["bq"], -2, nh1)      # [..., H, hd]
    if kv1 != kv0:
        if kv0 == nh0:                 # MHA path: zero-pad kv too
            out["wk"] = _pad_heads(p["wk"], -2, kv1)
            out["wv"] = _pad_heads(p["wv"], -2, kv1)
            if "bk" in p:
                out["bk"] = _pad_heads(p["bk"], -2, kv1)
                out["bv"] = _pad_heads(p["bv"], -2, kv1)
        else:                          # GQA: replicate + regroup
            r0, r1 = nh0 // kv0, padded.n_heads // kv1
            src = (torch.arange(kv1, device=p["wk"].device) * r1) // r0
            for name in ("wk", "wv", "bk", "bv"):
                if name in p:
                    out[name] = torch.index_select(p[name], p[name].dim() - 2,
                                                   src)
    return out


def pad_params_for_serving(cfg: ArchConfig, padded: ArchConfig,
                           params: dict) -> dict:
    """Whole-model weight transform (training -> serving head layout); the
    caller's tree is left as it was."""
    if padded is cfg:
        return params
    out = dict(params)
    if "stacks" in params:
        out["stacks"] = dict(params["stacks"])
    for kind, stack in params.get("stacks", {}).items():
        if kind in ("ssm", "hybrid_group") or "attn" not in stack:
            continue
        out["stacks"][kind] = dict(stack)
        out["stacks"][kind]["attn"] = pad_attn_params(cfg, padded,
                                                      stack["attn"])
    if "shared_attn" in params:
        out["shared_attn"] = dict(params["shared_attn"])
        out["shared_attn"]["attn"] = pad_attn_params(
            cfg, padded, params["shared_attn"]["attn"])
    return out
