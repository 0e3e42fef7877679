"""Gradient compression for the data-parallel all-reduce (reference:
``repro/optim/compress.py``).

int8 block-quantized gradients with error feedback: the DP all-reduce moves
~4x fewer bytes.  ``compressed_psum`` is the reference's shard_map body on
the port's mesh (``core/mesh.ShardMesh``): each gradient leaf carries the
shard axis first, every shard quantizes its own slice, and the sums run
through ``ShardMesh.psum``.
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
    ``mesh``.  Every leaf holds one shard's gradient per index of its first
    axis (``mesh.size`` entries).  Returns (averaged grads, new error
    feedback), both in that layout."""
    group = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    nd = math.prod(mesh.shape[mesh.axis_names.index(a)] for a in group)

    def one(g, e):
        g32 = g.float() + (e if e is not None else 0.0)
        rows = g32.reshape(mesh.size, -1)
        q, s = _compress_rows(rows)
        # the collective moves the quantized values and their scales
        (qsum,) = mesh.psum((q.to(torch.int32),), group, dim=0)
        (ssum,) = mesh.psum((s,), group, dim=0)
        n = rows.shape[1]
        avg = (qsum.float() * (ssum / nd)).reshape(mesh.size, -1)[:, :n] / nd
        deq = (q.float() * s).reshape(mesh.size, -1)[:, :n]
        return (avg.reshape(g.shape).to(g.dtype),
                (rows - deq).reshape(g.shape))

    flat_g = [leaf for _, leaf in _flatten(grads)]
    flat_e = ([None] * len(flat_g) if error is None
              else [leaf for _, leaf in _flatten(error)])
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (_unflatten(grads, iter(o[0] for o in outs)),
            _unflatten(grads, iter(o[1] for o in outs)))
