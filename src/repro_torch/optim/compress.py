"""Gradient compression for the data-parallel all-reduce (reference:
``repro/optim/compress.py``).

int8 block-quantized gradients with error feedback: the DP all-reduce moves
~4x fewer bytes.  ``compressed_psum`` is the reference's shard_map body on
the port's mesh (``core/mesh.ShardMesh``), whose shards lie in device
groups: each group's gradient leaves carry its shards first, on its card;
every group quantizes its own rows there, the int32 block sums and the
float32 scale sums run through the grouped ``ShardMesh.psum`` (which sums
as the one-group stack does, so any grouping gives the bits of one group),
and the error feedback stays on each group's card.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from ..ckpt.checkpoint import _flatten, _unflatten

Tree = Any
BLOCK = 256


def _compress_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization of each row of ``rows`` [R, n]:
    ``q`` [R, nb, BLOCK] int8, ``scale`` [R, nb, 1] float32."""
    flat = rows.float()
    flat = F.pad(flat, (0, (-flat.shape[1]) % BLOCK))
    blocks = flat.reshape(flat.shape[0], -1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8 quantization.  x: any shape (f32/bf16).
    Returns ``q`` [n_blocks, BLOCK] int8 and ``scale`` [n_blocks, 1]."""
    q, scale = _compress_rows(x.reshape(1, -1))
    return q[0], scale[0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compressed_psum(grads: Tree, mesh, axis_name, error: Tree | None = None
                    ) -> Tuple[Tree, Tree]:
    """Error-feedback compressed gradient all-reduce over ``axis_name`` of
    ``mesh``.  With one device group ``grads`` is a tree whose every leaf
    holds one shard's gradient per index of its first axis (``mesh.size``
    entries); with G groups it is a tuple of G such trees, group g's on
    ``mesh.devices[g]`` with its ``mesh.per_group`` shards.  Returns
    (averaged grads, new error feedback), both in the layout given."""
    group = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    nd = math.prod(mesh.shape[mesh.axis_names.index(a)] for a in group)
    grouped = mesh.n_groups > 1
    trees = tuple(grads) if grouped else (grads,)
    if len(trees) != mesh.n_groups:
        raise ValueError(f"a mesh of {mesh.n_groups} device groups takes a "
                         f"tuple of {mesh.n_groups} gradient trees")
    errors = (tuple(error) if grouped else (error,)) if error is not None \
        else (None,) * mesh.n_groups
    pg = mesh.per_group

    def one(gs, es):
        g32 = [g.float() + (e if e is not None else 0.0)
               for g, e in zip(gs, es)]
        rows = [x.reshape(pg, -1) for x in g32]
        qs = [_compress_rows(r) for r in rows]
        # the collective moves the quantized values and their scales
        qsum = mesh.psum(tuple(q.to(torch.int32) for q, _ in qs), group,
                         dim=0)
        ssum = mesh.psum(tuple(s for _, s in qs), group, dim=0)
        n = rows[0].shape[1]
        out = []
        for g, r, (q, s), qt, st in zip(gs, rows, qs, qsum, ssum):
            avg = (qt.float() * (st / nd)).reshape(pg, -1)[:, :n] / nd
            deq = (q.float() * s).reshape(pg, -1)[:, :n]
            out.append((avg.reshape(g.shape).to(g.dtype),
                        (r - deq).reshape(g.shape)))
        return out

    flat_g = [[leaf for _, leaf in _flatten(t)] for t in trees]
    flat_e = [[None] * len(flat_g[0]) if e is None
              else [leaf for _, leaf in _flatten(e)] for e in errors]
    outs = [one(gs, es) for gs, es in zip(zip(*flat_g), zip(*flat_e))]
    avg = tuple(_unflatten(t, iter(o[j][0] for o in outs))
                for j, t in enumerate(trees))
    err = tuple(_unflatten(t, iter(o[j][1] for o in outs))
                for j, t in enumerate(trees))
    return (avg, err) if grouped else (avg[0], err[0])
