"""Sharding rules: parameter, batch and cache partition specs (reference:
``repro/launch/sharding.py``).

Scheme (DESIGN.md §6): TP on the ``model`` axis (attention heads, ffn
hidden, the MoE expert dim), FSDP (ZeRO) on the data axes for the other big
dim.  Norms and small vectors replicate; stacked layer axes are never
sharded.

A spec is JAX's ``PartitionSpec`` as data: a tuple with one entry per dim,
each ``None`` (replicated), an axis name, or a tuple of axis names.  The
port has no ``NamedSharding``: ``param_shardings`` pairs each spec with the
mesh, and the dry run reads per-device sizes from them (``spec_bytes``).

On a ``ShardMesh`` of more than one shard, ``place_params``,
``place_batch`` and ``place_cache`` put every leaf where its spec puts it,
in the mesh's per-shard form: a tuple of G tensors, group g's on
``mesh.devices[g]`` stacking the block of each of its shards
(``ShardMesh.place``); ``gather_params`` assembles the whole leaves again.
The partitioned step (``models/partitioned.py``) runs on such trees.
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from ..core.mesh import ShardMesh, axis_sizes, spec_entry_axes
from ..models.moe_ep import ep_axes, get_ep_mesh
from ..models.partitioned import map_specs
from .mesh import dp_axes

PyTree = Any
Spec = Tuple[Any, ...]


def _lead(path: Tuple[str, ...]) -> int:
    """Stacked layer axes before a leaf's own: hybrid groups have two,
    plain stacks one."""
    if "stacks" not in path:
        return 0
    return 2 if "hybrid_group" in path else 1


def _rule(path: Tuple[str, ...], ndim: int, dp, ep=None) -> Spec:
    """Spec for one parameter leaf.

    ``ep``: mesh axes for the expert dimension of routed-expert weights
    (``moe_ep.ep_axes``): expert weights live fully sharded by expert, so
    the EP region needs no weight collectives."""
    name = path[-1]
    lead = _lead(path)
    core = ndim - lead

    def spec(*dims):
        assert len(dims) == core, (path, ndim, dims)
        return (None,) * lead + dims

    # --- embeddings / head -----------------------------------------------
    if name == "embed":
        return ("model", dp)
    if name == "lm_head":
        return (dp, "model")
    # --- norms / scalars / biases-on-heads ---------------------------------
    if name in ("final_norm", "ln", "ln1", "ln2", "q_norm", "kv_norm",
                "out_norm", "norm1", "norm2"):
        return spec(*([None] * core))
    if name in ("A_log", "D", "dt_bias", "conv_b"):
        return spec(*([None] * (core - 1)), "model")
    if name in ("bq", "bk", "bv"):
        return spec("model", None)
    # --- attention ---------------------------------------------------------
    if name in ("wq", "wk", "wv"):            # [D, H, hd]
        return spec(dp, "model", None)
    if name == "wo":                           # [H, hd, D]
        return spec("model", None, dp)
    if name == "wdq":                          # [D, q_lora]
        return spec(dp, "model")
    if name == "wuq":                          # [q_lora, H, dims]
        return spec(None, "model", None)
    if name == "wdkv":                         # [D, kv_lora]
        return spec(dp, None)
    if name == "wkr":                          # [D, rope]
        return spec(dp, None)
    if name in ("wuk", "wuv"):                 # [kv_lora, H, dim]
        return spec(None, "model", None)
    # --- ffn / moe ----------------------------------------------------------
    if name == "router":                       # [D, E]
        return spec(dp, None)
    if name in ("wu", "wg"):
        if core == 3:                          # [E, D, F]
            # EP active: fully sharded by expert; else the expert dim on
            # model + FSDP over dp
            return spec(ep, None, None) if ep else spec("model", dp, None)
        return spec(dp, "model")               # [D, F]
    if name == "wd":
        if core == 3:                          # [E, F, D]
            return spec(ep, None, None) if ep else spec("model", None, dp)
        return spec("model", dp)               # [F, D]
    if name in ("shared_wu", "shared_wg"):
        return spec(dp, "model")
    if name == "shared_wd":
        return spec("model", dp)
    # --- mamba ---------------------------------------------------------------
    if name == "in_proj":                      # [D, C]
        return spec(dp, "model")
    if name == "conv_w":                       # [4, C]
        return spec(None, "model")
    if name == "out_proj":                     # [di, D]
        return spec("model", dp)
    if name == "proj":                         # mtp [2D, D]
        return spec(dp, "model")
    # fallback: replicate
    return spec(*([None] * core))


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def sanitize_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop mesh axes from dims they do not divide (a sharded argument
    must divide exactly).  A trailing dim with no entry gets ``None``."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, dims):
        if entry is not None and size % _axis_size(mesh, entry) != 0:
            # try shrinking a tuple entry to its largest dividing prefix
            if isinstance(entry, (tuple, list)):
                pref = list(entry)
                while pref and size % _axis_size(mesh, tuple(pref)) != 0:
                    pref.pop()
                entry = tuple(pref) if pref else None
            else:
                entry = None
        out.append(entry)
    return tuple(out)


def _walk(tree: PyTree, prefix: Tuple[str, ...] = ()):
    """``[(key path, leaf)]`` of a nested dict, keys in sorted order (the
    order of ``jax.tree_util``); anything else is a leaf, a spec too."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _walk(tree[k], prefix + (str(k),))]
    return [(prefix, tree)]


def _map_with_path(fn, tree: PyTree) -> PyTree:
    """``fn(key path, leaf)`` over a nested dict, the dict kept."""
    if isinstance(tree, dict):
        return {k: _map_with_path(lambda p, x, k=k: fn((k,) + p, x), v)
                for k, v in tree.items()}
    return fn((), tree)


def param_specs(params: PyTree, mesh) -> PyTree:
    dp = dp_axes(mesh)

    def one(names, leaf):
        ep = None
        if names[-1] in ("wu", "wg", "wd") and leaf.dim() >= 3 \
                and get_ep_mesh() is not None:
            ep = ep_axes(mesh, leaf.shape[-3])
        return sanitize_spec(_rule(names, leaf.dim(), dp, ep),
                             tuple(leaf.shape), mesh)

    return _map_with_path(one, params)


def _partitioned(mesh) -> bool:
    return isinstance(mesh, ShardMesh) and mesh.size > 1


def is_placed(tree: PyTree) -> bool:
    """Whether a tree holds leaves in the mesh's per-shard form (tuples of
    group tensors): ``place_params`` / ``place_batch`` / ``place_cache``'s
    output."""
    return any(isinstance(x, tuple) for _, x in _walk(tree))


def _place(tree: PyTree, mesh, specs: PyTree) -> PyTree:
    return map_specs(lambda x, spec: x.to(mesh.device) if x.dim() == 0
                     else mesh.place(x, spec), tree, specs)


def place_params(params: PyTree, mesh, specs: PyTree = None) -> PyTree:
    """``params`` (or an AdamW state mirroring them) at rest by the
    reference's specs (``param_specs``, which read the EP mesh of
    ``moe_ep.get_ep_mesh``: set it first, as the step builders do).  On a
    ``ShardMesh`` of more than one shard every leaf becomes the mesh's
    per-shard form, a tuple of G tensors ``[per_group, *block]``, group g's
    on ``mesh.devices[g]`` holding the block of each of its shards (a dim
    whose axis ``sanitize_spec`` dropped is whole in every block; the
    routed experts fall under the EP rule ``spec(ep, None, None)``).  A 0-d
    leaf (AdamW's ``step``) stays one tensor on ``mesh.device``.  With G =
    ``mesh.size`` each group's bytes are ``per_device_bytes``; on the
    one-shard form (``ShardMesh.one_shard``) the one group holds shard 0's
    block, whose bytes are ``per_device_bytes``.  On a mesh of one shard, or a
    ``MeshSpec``, the tree as given."""
    if not _partitioned(mesh):
        return params
    return _place(params, mesh, param_specs(params, mesh)
                  if specs is None else specs)


def gather_params(params: PyTree, mesh, specs: PyTree) -> PyTree:
    """``place_params``'s inverse, bitwise: each placed leaf whole on
    ``mesh.device``, each block from the first shard that holds it.
    ``specs`` are the whole tree's (``param_specs`` of the step builders'
    structs, taken under the same EP mesh)."""
    def one(x, spec):
        return mesh.assemble(x, spec) if isinstance(x, tuple) else x
    return map_specs(one, params, specs)


def place_batch(batch: PyTree, mesh, global_batch: int = None) -> PyTree:
    """A batch at rest by ``batch_specs``: the rows over the data axes
    where they divide the global batch, else whole in every shard.  On a
    mesh of one shard the batch as given."""
    if not _partitioned(mesh):
        return batch
    if global_batch is None:
        global_batch = next(x for _, x in _walk(batch)).shape[0]
    return _place(batch, mesh, batch_specs(batch, mesh, global_batch))


def place_cache(caches: PyTree, mesh, global_batch: int) -> PyTree:
    """A decode cache at rest by ``cache_specs``: the batch over the data
    axes, kv heads (or a latent, the conv channels, the SSM heads) over
    ``model`` where they divide.  On a mesh of one shard the cache as
    given."""
    if not _partitioned(mesh):
        return caches
    return _place(caches, mesh, cache_specs(caches, mesh, global_batch))


def param_shardings(params: PyTree, mesh) -> PyTree:
    """Each leaf's spec paired with the mesh: ``(mesh, spec)``."""
    return _map_with_path(lambda _, s: (mesh, s), param_specs(params, mesh))


def _dp_lead(mesh, global_batch: int):
    dp = dp_axes(mesh)
    dp_size = math.prod(axis_sizes(mesh)[a] for a in dp)
    return dp if global_batch % dp_size == 0 else None


def batch_specs(batch: PyTree, mesh, global_batch: int) -> PyTree:
    """Shard the batch axis over the data axes when divisible, else
    replicate (long_500k decode has batch 1)."""
    lead = _dp_lead(mesh, global_batch)
    return _map_with_path(lambda _, leaf: sanitize_spec(
        (lead,) + (None,) * (leaf.dim() - 1), tuple(leaf.shape), mesh), batch)


def cache_specs(caches: PyTree, mesh, global_batch: int) -> PyTree:
    """KV/SSM cache sharding: batch over data axes, kv heads / latent over
    model when divisible; stacked layer axes unsharded."""
    bshard = _dp_lead(mesh, global_batch)
    msize = axis_sizes(mesh)["model"]

    def one(names, leaf):
        lead = (None,) * (2 if "hybrid_group" in names else 1)
        last = leaf.shape[-1]
        if names[-1] in ("k", "v"):            # [B, S, hkv, hd]
            hspec = "model" if leaf.shape[-2] % msize == 0 else None
            return lead + (bshard, None, hspec, None)
        if names[-1] in ("ckv", "conv"):       # [B, S, r] / [B, w, C]
            return lead + (bshard, None,
                           "model" if last % msize == 0 else None)
        if names[-1] == "kr":                  # [B, S, rope]
            return lead + (bshard, None, None)
        if names[-1] == "ssm":                 # [B, H, P, N]
            h = leaf.shape[len(lead) + 1]
            return lead + (bshard, "model" if h % msize == 0 else None,
                           None, None)
        return (None,) * leaf.dim()

    return _map_with_path(lambda names, leaf: sanitize_spec(
        one(names, leaf), tuple(leaf.shape), mesh), caches)


def spec_bytes(leaf: torch.Tensor, spec: Spec, mesh) -> float:
    """Bytes of one device's shard of ``leaf`` under ``spec``."""
    n = math.prod(_axis_size(mesh, e) for e in spec)
    return leaf.numel() * leaf.element_size() / n


def per_device_bytes(tree: PyTree, specs: PyTree, mesh) -> float:
    """Summed ``spec_bytes`` of a tree's leaves under its specs."""
    leaves, spec_leaves = _walk(tree), _walk(specs)
    if [p for p, _ in leaves] != [p for p, _ in spec_leaves]:
        raise ValueError("the specs do not mirror the tree")
    return float(sum(spec_bytes(x, s, mesh)
                     for (_, x), (_, s) in zip(leaves, spec_leaves)))
