"""AdamW over a parameter tree (reference: ``repro/optim/adamw.py``).

The optimizer state mirrors the parameter tree (``m``, ``v`` leaf for leaf,
and an int32 ``step``), so it checkpoints like the params.  ``state_dtype``
sets the moments' dtype (float32 by default; bfloat16 halves their memory).
The update is the reference's: global-norm clip, bias correction, decoupled
weight decay, all in float32, the new params cast back to their dtype.
Leaves are visited in the reference's order (dict keys sorted), so the
global norm sums them in the same order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from ..ckpt.checkpoint import _flatten, _unflatten, clone_tree

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32


def _leaves(tree: Tree):
    return [leaf for _, leaf in _flatten(tree)]


def adamw_init(params: Tree, cfg: AdamWConfig) -> Tree:
    leaves = _leaves(params)

    def zeros():
        return _unflatten(params, iter(
            torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
            for p in leaves))
    dev = leaves[0].device if leaves else None
    return dict(m=zeros(), v=zeros(),
                step=torch.zeros((), dtype=torch.int32, device=dev))


def _global_norm(leaves) -> torch.Tensor:
    """The norm of every leaf together, on the first leaf's device.  Leaves
    on one device sum in leaf order; leaves across devices (routed-expert
    slices placed in device groups) sum per device in leaf order, and the
    per-device sums, gathered on the first device, in the order the
    devices first appear."""
    parts = {}
    for x in leaves:
        term = torch.sum(torch.square(x.float()))
        parts[x.device] = parts[x.device] + term if x.device in parts \
            else term
    if len(parts) <= 1:
        return torch.sqrt(sum(parts.values()))
    first = next(iter(parts))
    return torch.sqrt(sum(v.to(first) for v in parts.values()))


def adamw_update(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig,
                 lr_scale=1.0, gnorm=None) -> Tuple[Tree, Tree]:
    """One step.  Returns ``(new_params, new_state)``; neither input is
    written (``adamw_update_`` on copies of them)."""
    return adamw_update_(clone_tree(params), grads, clone_tree(state), cfg,
                         lr_scale=lr_scale, gnorm=gnorm)


def adamw_update_(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig,
                  lr_scale=1.0, gnorm=None) -> Tuple[Tree, Tree]:
    """One step with ``params`` and ``state`` donated (the reference's
    ``donate_argnums=(0, 1)``): each leaf (each group tensor of a placed
    tree) and its moments are written in place, one leaf at a time, so at
    most one leaf's temporaries exist at once.  Returns ``(params,
    state)``, the same trees.  ``gnorm``: the gradients' global norm where
    the caller counts it (a partitioned step counts each placed block once,
    ``models/partitioned.Partitioned.global_norm``); else ``_global_norm``
    of the gradient leaves."""
    step = state["step"] + 1
    g_leaves = _leaves(grads)
    if gnorm is None:
        gnorm = _global_norm(g_leaves)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = step.to(torch.float32)
    b1 = torch.tensor(cfg.b1, dtype=torch.float32, device=step.device)
    b2 = torch.tensor(cfg.b2, dtype=torch.float32, device=step.device)
    bc1 = 1.0 - b1 ** step_f
    bc2 = 1.0 - b2 ** step_f
    lr = cfg.lr * lr_scale

    scalars = {step.device: (clip, bc1, bc2, lr)}
    for p, g, m, v in zip(_leaves(params), g_leaves, _leaves(state["m"]),
                          _leaves(state["v"])):
        if p.device not in scalars:      # a leaf of another device group
            scalars[p.device] = tuple(
                x.to(p.device) if isinstance(x, torch.Tensor) else x
                for x in scalars[step.device])
        clip, bc1, bc2, lr = scalars[p.device]
        g = g.float() * clip
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        del g                   # fewer of the leaf's temporaries live at once
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        del delta
        m.copy_(m32)
        v.copy_(v32)
    state["step"].copy_(step)
    return params, state
