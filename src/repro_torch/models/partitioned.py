"""The partitioned train, prefill and decode programs over a ``ShardMesh``
(reference: the jit ``in_shardings`` of ``repro/launch/steps.py``, with
``param_shardings``, ``batch_specs`` and ``cache_specs``).

Every leaf, the AdamW moments, the batch and the decode cache rest in the
mesh's per-shard form (``launch/sharding.place_params`` / ``place_batch`` /
``place_cache``: a tuple of G tensors ``[per_group, *block]``, group g's on
``mesh.devices[g]``).  The program runs every shard's part as one call per
shard, on its group's device, so a shard's arithmetic is the same for any
grouping; values that cross shards go through the mesh's collectives
(``core/mesh.py``), which join on the first device and associate as one
group does.  On the CPU any grouping is then bitwise with one group.

Per layer, the reference's scheme (DESIGN.md §6):

* **FSDP**: each leaf is all-gathered over the data axes before use; the
  gather's gradient is a reduce-scatter back to the blocks' owners;
* **TP (Megatron)** over ``model``: a shard computes with its own
  ``model`` block of every leaf the specs split there, and one ``psum``
  over ``model`` sums the partial outputs, kept in float32 and rounded
  once (``layers.out_proj``):
  - attention (MHA, GQA, MQA): the shard's heads of ``wq``/``wk``/``wv``
    (and ``bq``/``bk``/``bv``) and rows of ``wo``.  A shard whose q heads
    share kv heads it does not hold whole (MQA, or kv heads ``model`` does
    not divide) takes the whole ``wk``/``wv`` and attends with its own kv
    heads (``layers.attn_forward``'s ``kv_heads``);
  - MLA: the shard's heads of ``wuq``/``wuk``/``wuv`` and rows of ``wo``;
    the absorbed decode contracts every head over the whole latent, so
    the ``ckv`` cache is gathered in and each shard keeps its block;
  - the dense FFN and the shared experts: column-parallel ``wu``/``wg``,
    row-parallel ``wd``;
  - the routed experts without EP (the spec's ``("model", dp, None)``):
    each shard runs the dropless layer over its own experts for every
    token, routing replicated (``layers.moe_routed``);
  - mamba2 over its SSM heads: ``in_proj`` column-parallel on its block,
    then its output gathered over ``model`` (the columns ``[z | x | B | C
    | dt]`` do not split on head boundaries; with fewer tokens a shard
    than d_model this moves fewer bytes than gathering the weight); each
    shard's heads of ``z``/``x``/``dt``, the whole ``B``/``C``, its
    blocks of ``A_log``/``D``/``dt_bias``, the ``ssm`` cache and the rows
    of ``out_proj``; ``out_norm``'s sum of squares is psum'd over
    ``model``;
  - ``embed`` and ``lm_head`` where ``model`` divides the vocab: the
    lookup of each shard's vocab block, zero elsewhere, psum'd (one term
    is nonzero, so it is the whole lookup bit for bit); the head gives
    each shard its logits block and the cross-entropy is vocab-parallel
    (``model.vocab_parallel_ce_sums``); MTP's ``proj`` is column-parallel,
    its output gathered over ``model``;
* **still gathered whole over ``model``**: MLA's ``wdq`` (its ``q_lora``
  columns feed an RMS norm over the whole ``q_lora``), mamba2's ``conv_w``
  and ``conv_b`` (a shard needs its heads' ``x`` channels and the whole
  ``B``/``C``, not one contiguous block; 4 x C and C values), and any leaf
  whose spec ``sanitize_spec`` left without ``model`` (a vocab, head count
  or hidden width ``model`` does not divide: minicpm-2b's 122,753-entry
  vocab), whose compute is then replicated over ``model``;
* **the routed experts** under EP: each shard routes its token block
  (``moe_ep.TokenLayout``), the buffers cross ``ShardMesh.all_to_all`` and
  each shard's experts are its own block of the EP rule
  (``moe_ep.ep_groups``);
* **the loss** is the reference's global mean: the masked CE sum and the
  mask count are psum'd over the data axes before they divide.

**Sequence parallelism** (``seq_shard``, ``StepConfig.seq_shard_acts``;
the reference constrains the layer carry to ``P(dp, "model", None)``): in
the train and prefill steps, where ``model`` divides the sequence, each
shard keeps only its ``[B/dp, S/m, D]`` block of the carry between blocks.
The norms and residual adds run on the block; each layer's normed input is
all-gathered along S over ``model`` (attention, MLA, mamba2's projection,
conv and SSD, the FFN, the dropless and shared experts; the EP experts
route the block as it is, ``moe_ep.TokenLayout``'s own), and the TP
partials are reduce-scattered along S instead of psum'd.  Both sum the
same stack over the mesh dims, so the forward is bitwise the program with
the carry whole; the backward sums the shards' gradients at other points
(float32 roundings apart, ROADMAP C).  The vocab-parallel lookup ends as
a reduce-scatter onto the block (a whole table looks up the block's tokens;
vision patches are scattered into the whole sequence first); the head, the
cross-entropy and MTP take the carry gathered back.

Decode caches rest by ``cache_specs`` and are donated: each layer reshards
its leaves to the form its compute takes (the batch over the data axes,
the heads over ``model`` where TP), reading from each spec which dim the
data axes shard, and writes the new position back into the placed cache
(``cache_out``).  Where a leaf rests as it computes, the layer writes into
a view of it; else only the new position's rows go back (the hybrid
stack's shared-attention cache rests with the sequence on the data axes
and ``hd`` on ``model``, as the reference places it: its spec counts two
stacked axes where there is one).

The gradient is exact differentiation of the loss as shard 0 holds it
(every shard holds the same value).  A leaf that the spec replicates has
a copy per shard, and its gradient is the sum over its copies
(``ShardMesh.psum_replicas``), which every replica then holds, so the
replicas stay bitwise equal after every step.  The global norm counts each
block once (its first replica), a per-block sum of squares summed on the
first device in shard order.

On the one-shard form of a mesh (``ShardMesh.one_shard``, the dry run's:
``mesh.held`` is 1) every per-shard list holds shard 0 alone and each
collective returns shard 0's result, so the program run is shard 0's part
of the partitioned step on the production mesh, traced as one device's
program (``launch/dryrun.py``).  Shard 0's coordinates are all 0: its
blocks have every shard's shapes, its ``model`` slices are the first, and it
is the first replica of every block.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.mesh import ShardMesh, axis_sizes, spec_entry_axes
from .config import ArchConfig
from .layers import (attn_forward, ffn_forward, mla_forward, moe_routed,
                     out_proj, rms_norm, weak)
from .mamba2 import mamba_forward, mamba_mix
from .model import (_maybe_remat, embed_inputs, finish_inputs, layer_plan,
                    masked_ce_sums, vocab_parallel_ce_sums, write_into)
from . import moe_ep

Tree = Any
PerShard = List[Any]

def _pairs(tree: Tree, specs: Tree, prefix=()):
    """``[(key path, placed leaf, spec)]`` of a dict tree and its mirrored
    spec tree, keys sorted (``ckpt._flatten``'s order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _pairs(tree[k], specs[k], prefix + (k,))]
    return [(prefix, tree, specs)]


def map_specs(fn, tree: Tree, specs: Tree) -> Tree:
    """``fn(placed leaf, spec)`` over a dict tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _unstack(tree: Tree, specs: Tree, n: int):
    """A placed tree of stacked leaves (``[per_group, n, ...]`` a group) as
    n ``(tree, specs)`` of the layers (one ``unbind`` per group tensor)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, specs[k], n) for k, v in tree.items()}
        return [({k: cols[k][i][0] for k in tree},
                 {k: cols[k][i][1] for k in tree}) for i in range(n)]
    cols = [t.unbind(1) for t in tree]
    return [(tuple(c[i] for c in cols), tuple(specs)[1:]) for i in range(n)]


class _RecomputeHere(torch.autograd.Function):
    """The identity on a block's per-shard outputs, its last op.  Every
    gradient of the block passes through its backward first, and that
    backward reads the tensor it saved: under remat this is the block's
    first unpack, so the block is recomputed there, once, on one thread.
    Without it, the backward threads of two devices can each reach an
    unpack of the block first and both start the recompute
    (``torch.utils.checkpoint`` takes no lock), which fails."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(xs[0])
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.saved_tensors
        return grads


class Partitioned:
    """The partitioned program of one config on a ``ShardMesh`` with a
    ``model`` axis.  ``specs``: the whole parameter tree's specs
    (``launch/sharding.param_specs``, under the EP mesh the step set)."""

    def __init__(self, cfg: ArchConfig, mesh: ShardMesh, specs: Tree,
                 remat: str = "full", seq_shard: bool = True):
        if "model" not in mesh.axis_names:
            raise ValueError(f"the partitioned step needs a 'model' axis, "
                             f"got {mesh.axis_names}")
        self.cfg, self.mesh, self.specs, self.remat = cfg, mesh, specs, remat
        self.seq_shard = seq_shard
        self.dp = (("pod", "data") if "pod" in mesh.axis_names
                   else ("data",))
        self.msize = axis_sizes(mesh)["model"]
        mi = mesh.axis_names.index("model")
        self.model_idx = [mesh.coords(s)[mi] for s in range(mesh.held)]
        self.vocab_tp = self._split(specs["lm_head"], 1)
        # the spec entry of the batch the decode caches serve (the data
        # axes, or None where they do not divide it): ``decode`` sets it
        self.batch_entry = None

    def _split(self, spec, d: int) -> bool:
        """Whether ``model`` (of more than one shard) splits dim ``d``."""
        return self.msize > 1 and "model" in spec_entry_axes(spec[d])

    def seq_sharded(self, s: int) -> bool:
        """Whether the layer carry of an ``s``-long sequence rests as each
        shard's sequence block over ``model`` between blocks: with
        ``seq_shard`` (``StepConfig.seq_shard_acts``), by the reference's
        rule (``_constrain_maker``: ``model`` divides ``s``, ``s`` >= m)."""
        m = self.msize
        return self.seq_shard and m > 1 and s % m == 0 and s >= m

    # -- per-shard values ----------------------------------------------------
    def groups(self, vals: PerShard):
        """A value per shard (a list) -> the mesh's per-group stacks."""
        pg = self.mesh.per_group
        return tuple(torch.stack(vals[g * pg:(g + 1) * pg])
                     for g in range(self.mesh.n_groups))

    @staticmethod
    def shards(groups) -> PerShard:
        """The mesh's per-group stacks -> a value per shard."""
        return [t for grp in groups for t in grp.unbind(0)]

    def use(self, groups, spec, keep: Tuple[str, ...] = ()) -> PerShard:
        """Each shard's value of a placed leaf for its compute: all-gathered
        (tiled) over every axis of ``spec`` but those in ``keep``."""
        xs = groups
        for d, entry in enumerate(spec):
            axes = spec_entry_axes(entry)
            if axes and not set(axes) & set(keep):
                xs = self.mesh.all_gather(xs, axes, d, dim=0, tiled=True)
        return self.shards(xs)

    def use_tree(self, tree: Tree, specs: Tree, keep=(),
                 whole=()) -> PerShard:
        """``use`` over a dict of placed leaves: one dict a shard; the
        leaves named in ``whole`` are gathered over every axis."""
        if tree is None:
            return [None] * self.mesh.held
        out = [dict() for _ in range(self.mesh.held)]
        for k, v in tree.items():
            kk = () if k in whole else keep
            vals = (self.use_tree(v, specs[k], kk, whole)
                    if isinstance(v, dict) else self.use(v, specs[k], kk))
            for o, x in zip(out, vals):
                o[k] = x
        return out

    def psum(self, vals: PerShard, axes) -> PerShard:
        return self.shards(self.mesh.psum(self.groups(vals), axes, dim=0))

    def pmax(self, vals: PerShard, axes) -> PerShard:
        return self.shards(self.mesh.pmax(self.groups(vals), axes, dim=0))

    def gather(self, vals: PerShard, d: int, axes=("model",)) -> PerShard:
        """Each shard's value concatenated along its dim ``d`` over
        ``axes`` (a tiled ``all_gather``; its gradient a reduce-scatter)."""
        return self.shards(self.mesh.all_gather(self.groups(vals), axes, d,
                                                dim=0, tiled=True))

    def whole_seq(self, vals: PerShard, sp: bool) -> PerShard:
        """A carry's sequence blocks gathered along S over ``model`` where
        ``sp``, else the values as they are."""
        return self.gather(vals, 1) if sp else vals

    def seq_block(self, vals: PerShard, sp: bool) -> PerShard:
        """Each shard's own sequence block of a value it holds whole, where
        ``sp`` (a copy, so the whole value need not live on), else the
        values as they are."""
        if not sp:
            return vals
        out = []
        for i, x in enumerate(vals):
            n = x.shape[1] // self.msize
            out.append(x.narrow(1, self.model_idx[i] * n, n).clone())
        return out

    def _own(self, x: torch.Tensor, spec, s: int, keep) -> torch.Tensor:
        """Shard ``s``'s block of a value ``use`` gathered (the dims whose
        axes are not in ``keep``)."""
        own = tuple(None if set(spec_entry_axes(e)) & set(keep) else e
                    for e in spec)
        return self.mesh.block_of(x, own, s)

    def reshard(self, groups, src, dst):
        """A placed value from spec ``src`` to spec ``dst``: gathered over
        ``src``'s axes on each dim where the two differ, then each shard's
        block of ``dst`` on those dims."""
        same = [spec_entry_axes(a) == spec_entry_axes(b)
                for a, b in zip(src, dst)]
        for d, (a, eq) in enumerate(zip(src, same)):
            if spec_entry_axes(a) and not eq:
                groups = self.mesh.all_gather(groups, spec_entry_axes(a), d,
                                              dim=0, tiled=True)
        own = tuple(None if eq else b for b, eq in zip(dst, same))
        if not any(spec_entry_axes(e) for e in own):
            return groups
        return self.groups([self.mesh.block_of(x, own, s)
                            for s, x in enumerate(self.shards(groups))])

    # -- caches ---------------------------------------------------------------
    def _compute_spec(self, name: str, spec, heads):
        """The spec of a cache leaf as a layer computes with it: the batch
        (dim 0) on the batch's data entry, the heads of ``k``/``v`` (dim 2)
        and ``ssm`` (dim 1) on ``heads``, every other dim whole."""
        out = [self.batch_entry] + [None] * (len(spec) - 1)
        if name in ("k", "v"):
            out[2] = heads
        elif name == "ssm":
            out[1] = heads
        return tuple(out)

    def cache_in(self, cache, heads=None) -> PerShard:
        """A layer's placed cache ``(tree, specs)`` in its compute form
        (``_compute_spec``): one dict a shard."""
        if cache is None:
            return [None] * self.mesh.held
        tree, specs = cache
        out = [dict() for _ in range(self.mesh.held)]
        for k in tree:
            vals = self.shards(self.reshard(
                tree[k], specs[k], self._compute_spec(k, specs[k], heads)))
            for o, x in zip(out, vals):
                o[k] = x
        return out

    def cache_out(self, cache, new: PerShard, heads=None, pos=None,
                  rows=1):
        """The new per-shard caches, in compute form, written into the
        placed cache at rest, which comes back (the decode step donates its
        cache).  Where a leaf's compute form is its form at rest,
        ``cache_in`` gave views of it and the layer wrote its new position
        there itself (``layers._write_cache``); a leaf along the time axis
        (``k``, ``v``, ``ckv``, ``kr``) resharded on the way in writes back
        only its ``rows`` new rows at ``pos``, any other leaf its whole new
        value."""
        if cache is None:
            return None
        tree, specs = cache
        for k in specs:
            comp = self._compute_spec(k, specs[k], heads)
            rest, vals = self.shards(tree[k]), [n[k] for n in new]
            if any(spec_entry_axes(a) != spec_entry_axes(b)
                   for a, b in zip(comp, specs[k])):
                if k in ("k", "v", "ckv", "kr"):
                    self._write_rows(vals, comp, specs[k], rest, pos, rows)
                    continue
                vals = self.shards(self.reshard(self.groups(vals), comp,
                                                specs[k]))
            for r, v in zip(rest, vals):
                write_into(r, v)
        return tree

    def _write_rows(self, vals: PerShard, comp, spec, rest: PerShard,
                    pos: int, n: int) -> None:
        """The ``n`` rows at ``pos`` of the time axis (dim 1) of a cache
        leaf in compute form (spec ``comp``), resharded on every other dim
        to its spec at rest, written into each shard's block at rest where
        that block's stretch of the time axis holds them (the hybrid
        stack's shared-attention cache rests with the time axis on the
        data axes)."""
        whole_t = lambda sp: (sp[0], None) + tuple(sp[2:])
        rows = self.shards(self.reshard(
            self.groups([v.narrow(1, pos, n) for v in vals]), whole_t(comp),
            whole_t(spec)))
        for s, (r, x) in enumerate(zip(rest, rows)):
            lo = self.mesh._block(spec[1], s)[0] * r.shape[1]
            a, b = max(pos, lo), min(pos + n, lo + r.shape[1])
            if a < b:
                r.narrow(1, a - lo, b - a).copy_(x.narrow(1, a - pos, b - a))

    # -- layers ---------------------------------------------------------------
    def _kv_heads(self, spec_wk) -> Optional[List[Tuple[int, int]]]:
        """Each shard's kv heads where it runs its q heads tensor-parallel:
        None where ``wk``'s block already holds exactly them (``model``
        shards the kv heads), else a range a shard into the whole kv
        heads; raises ``ValueError`` where a shard's q heads cannot attend
        through a contiguous run of kv heads in order."""
        cfg, m = self.cfg, self.msize
        hm, rep = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
        ranges = [((i * hm) // rep, ((i + 1) * hm - 1) // rep + 1)
                  for i in range(m)]
        for i, (lo, hi) in enumerate(ranges):
            n = hi - lo
            if hm % n or any(lo + j // (hm // n) != (i * hm + j) // rep
                             for j in range(hm)):
                raise ValueError("q heads straddle kv heads")
        if "model" in spec_entry_axes(spec_wk[1]):
            return None
        return [ranges[i] for i in self.model_idx]

    def _attn_tp(self, specs) -> Tuple[bool, Optional[list]]:
        """Whether attention runs tensor-parallel on this layer (``model``
        shards the q heads of ``wq`` (MLA: ``wuq``, ``wuk``, ``wuv``) and
        ``wo``) and each shard's kv heads (``_kv_heads``; None for MLA)."""
        if self.cfg.mla:
            return (all(self._split(specs[k], 1) for k in ("wuq", "wuk",
                                                            "wuv"))
                    and self._split(specs["wo"], 0)), None
        if not (self._split(specs["wq"], 1) and self._split(specs["wo"], 0)):
            return False, None
        try:
            return True, self._kv_heads(specs["wk"])
        except ValueError:
            return False, None

    def block(self, kind: str, lp: Tree, ls: Tree, xs: PerShard, pos,
              cache=None, cache_pos=None, pos3=None, sp=False):
        """One block on every shard (``model._block_forward``'s program):
        returns the new per-shard hidden state and the new placed cache.
        ``sp``: the carry ``xs`` is each shard's sequence block
        (``seq_sharded``); the norms and residual adds run on the block,
        every layer on the normed input gathered whole along S, and its
        output comes back as the block (a reduce-scatter of the TP
        partials)."""
        if kind == "ssm":
            return self.ssm(lp, ls, xs, cache, sp)
        cfg = self.cfg
        res = lambda a: weak(cfg.residual_scale, a.dtype)
        ln1, ln2 = self.use(lp["ln1"], ls["ln1"]), self.use(lp["ln2"],
                                                            ls["ln2"])
        attn, nc = self.attention(
            lp["attn"], ls["attn"], self.whole_seq(
                [rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, ln1)], sp),
            pos, cache, cache_pos, pos3, sp)
        xs = [x + res(a) * a for x, a in zip(xs, attn)]
        hs = [rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, ln2)]
        f = (self.moe(lp["ffn"], ls["ffn"], hs, sp) if kind == "moe"
             else self.ffn(lp["ffn"], ls["ffn"], hs, sp))
        return [x + res(y) * y for x, y in zip(xs, f)], nc

    def attention(self, lp: Tree, ls: Tree, hs: PerShard, pos, cache=None,
                  cache_pos=None, pos3=None, sp=False):
        """The attention layer (GQA or MLA) on every shard's normed hidden
        state (whole along S): (per-shard output, its sequence block where
        ``sp``; the placed cache, written in place)."""
        cfg, n = self.cfg, self.mesh.held
        tp, kv = self._attn_tp(ls)
        pa = self.use_tree(lp, ls, ("model",) if tp else (), whole=("wdq",))
        heads = "model" if tp and kv is None and not cfg.mla else None
        cs = self.cache_in(cache, heads)
        out, ncs = [], []
        for i in range(n):
            if cfg.mla:
                a, nc = mla_forward(cfg, pa[i], hs[i], pos[i], cache=cs[i],
                                    cache_pos=cache_pos, partial=tp)
            else:
                a, nc = attn_forward(cfg, pa[i], hs[i], pos[i], cache=cs[i],
                                     cache_pos=cache_pos,
                                     pos3=None if pos3 is None else pos3[i],
                                     kv_heads=None if kv is None else kv[i],
                                     partial=tp)
            out.append(a)
            ncs.append(nc)
        out = (self._sum_partials(out, hs, sp) if tp
               else self.seq_block(out, sp))
        return out, self.cache_out(cache, ncs, heads, cache_pos,
                                   hs[0].shape[1])

    def _sum_partials(self, parts: PerShard, like: PerShard,
                      sp: bool = False) -> PerShard:
        """The shards' partial outputs (float32, ``layers.out_proj``)
        summed over ``model`` and rounded once to the hidden dtype: a psum,
        or with ``sp`` a reduce-scatter along S that leaves each shard its
        sequence block (both sum the same stack over the mesh dims, so the
        block is bitwise the psum's)."""
        if sp:
            summed = self.shards(self.mesh.reduce_scatter(
                self.groups(parts), ("model",), 1, dim=0))
        else:
            summed = self.psum(parts, ("model",))
        return [y.to(h.dtype) for y, h in zip(summed, like)]

    def _mamba_tp(self, ms) -> bool:
        """Whether mamba2 runs over its SSM heads: ``model`` splits them
        (``A_log``, ``D``, ``dt_bias``) and ``out_proj``'s rows."""
        return (all(self._split(ms[k], -1) for k in ("A_log", "D",
                                                      "dt_bias"))
                and self._split(ms["out_proj"], 0))

    def ssm(self, lp: Tree, ls: Tree, xs: PerShard, cache, sp=False):
        """A mamba2 block on every shard: over the shard's SSM heads where
        ``model`` splits them, else replicated; its conv and SSD on the
        normed input gathered whole along S where ``sp``."""
        cfg, n = self.cfg, self.mesh.held
        res = lambda a: weak(cfg.residual_scale, a.dtype)
        mp, ms = lp["mamba"], ls["mamba"]
        hs = self.whole_seq([rms_norm(x, w, cfg.norm_eps) for x, w in zip(
            xs, self.use(lp["ln"], ls["ln"]))], sp)
        if not self._mamba_tp(ms):
            ps = self.use_tree(mp, ms)
            cs = self.cache_in(cache)
            out, ncs = [], []
            for i in range(n):
                h, nc = mamba_forward(cfg, ps[i], hs[i], cs[i])
                out.append(h)
                ncs.append(nc)
            out = self.seq_block(out, sp)
            return ([x + res(h) * h for x, h in zip(xs, out)],
                    self.cache_out(cache, ncs))
        col = self._split(ms["in_proj"], 1)
        w_in = self.use(mp["in_proj"], ms["in_proj"],
                        ("model",) if col else ())
        proj = [torch.einsum("bsd,dc->bsc", h, w) for h, w in zip(hs, w_in)]
        if col:
            proj = self.gather(proj, 2)
        own_k, rest_k = ("A_log", "D", "dt_bias", "out_proj"), (
            "conv_w", "conv_b", "out_norm")
        own = self.use_tree({k: mp[k] for k in own_k},
                            {k: ms[k] for k in own_k}, ("model",))
        rest = self.use_tree({k: mp[k] for k in rest_k},
                             {k: ms[k] for k in rest_k})
        cs = self.cache_in(cache, "model")
        hl, hdim = cfg.ssm_heads // self.msize, cfg.ssm_head_dim
        ys, convs, ssms, sq = [], [], [], []
        for i in range(n):
            h0 = self.model_idx[i] * hl
            y, cv, st = mamba_mix(cfg, {**own[i], **rest[i]}, proj[i], cs[i],
                                  heads=(h0, h0 + hl))
            ys.append(y)
            convs.append(cv)
            ssms.append(st)
            sq.append(torch.sum(torch.square(y.float()), -1, keepdim=True))
        # out_norm: an RMS norm over the whole d_inner
        sq = self.psum(sq, ("model",))
        out = []
        for i in range(n):
            c0 = self.model_idx[i] * hl * hdim
            w = rest[i]["out_norm"][c0:c0 + hl * hdim]
            y = (ys[i].float() * torch.rsqrt(sq[i] / cfg.d_inner
                                             + cfg.norm_eps)
                 * w.float()).to(ys[i].dtype)
            out.append(out_proj("bsc,cd->bsd", y, own[i]["out_proj"], True))
        out = self._sum_partials(out, xs, sp)
        xs = [x + res(h) * h for x, h in zip(xs, out)]
        if cache is None:
            return xs, None
        # the conv state whole again: the heads' x columns gathered over
        # model, beside the B/C columns every shard holds
        xcols = self.gather([c[..., :hl * hdim] for c in convs], 2)
        new = [dict(conv=torch.cat([x, c[..., hl * hdim:]], -1).to(
                    cs[i]["conv"].dtype),
                    ssm=st.to(cs[i]["ssm"].dtype))
               for i, (x, c, st) in enumerate(zip(xcols, convs, ssms))]
        return xs, self.cache_out(cache, new, "model")

    def ffn(self, lp: Tree, ls: Tree, hs: PerShard, sp=False) -> PerShard:
        """The dense FFN: column-parallel ``wu``/``wg``, row-parallel
        ``wd`` and a psum over ``model`` where ``model`` shards the hidden
        width, else replicated.  ``sp``: ``hs`` are the sequence blocks,
        gathered whole first, and the output is the block."""
        tp = self._split(ls["wu"], -1)
        ps = self.use_tree(lp, ls, ("model",) if tp else ())
        out = [ffn_forward(self.cfg, p, h, tp)
               for p, h in zip(ps, self.whole_seq(hs, sp))]
        return (self._sum_partials(out, hs, sp) if tp
                else self.seq_block(out, sp))

    def moe(self, lp: Tree, ls: Tree, hs: PerShard, sp=False) -> PerShard:
        """The MoE block: the routed experts under EP where the step
        engaged it (``moe_ep.get_ep_mesh``), else the dropless layer over
        each shard's own experts where ``model`` splits them (else whole);
        the shared experts tensor-parallel where ``model`` splits their
        hidden width.  The partial outputs take one psum over ``model``.
        ``sp``: ``hs`` are the sequence blocks; EP routes them as they are,
        the dropless and shared experts take them gathered whole, and the
        output is the block."""
        cfg = self.cfg
        names = [k for k in ("wu", "wg", "wd") if k in lp]
        router = self.use(lp["router"], ls["router"])
        parts, wholes = [], []
        ep = moe_ep.get_ep_mesh() is not None
        if ep:
            wholes.append(self._ep({k: lp[k] for k in names}, hs, router,
                                   sp))
        hw = self.whole_seq(hs, sp) if cfg.n_shared_experts or not ep else hs
        if not ep:
            tp = self._split(ls["wu"], 0)
            pe = self.use_tree({k: lp[k] for k in names},
                               {k: ls[k] for k in names},
                               ("model",) if tp else ())
            eb = cfg.n_experts // self.msize
            out = []
            for i, (p, h, r) in enumerate(zip(pe, hw, router)):
                blk = ((self.model_idx[i] * eb, (self.model_idx[i] + 1) * eb)
                       if tp else None)
                out.append(moe_routed(cfg, dict(p, router=r), h, blk)
                           .reshape(h.shape))
            (parts if tp else wholes).append(
                out if tp else self.seq_block(out, sp))
        if cfg.n_shared_experts:
            sk = [k for k in lp if k.startswith("shared_")]
            tp = self._split(ls["shared_wu"], 1)
            ps = self.use_tree({k[len("shared_"):]: lp[k] for k in sk},
                               {k[len("shared_"):]: ls[k] for k in sk},
                               ("model",) if tp else ())
            out = [ffn_forward(cfg, p, h, tp) for p, h in zip(ps, hw)]
            (parts if tp else wholes).append(
                out if tp else self.seq_block(out, sp))
        ys = (self._sum_partials([sum(t[1:], t[0]) for t in zip(*parts)],
                                 hs, sp) if parts else None)
        for w in wholes:
            ys = w if ys is None else [a + b for a, b in zip(ys, w)]
        return [y.to(h.dtype) for y, h in zip(ys, hs)]

    def _ep(self, experts: Tree, hs: PerShard, router: PerShard,
            sp=False) -> PerShard:
        """The routed experts under EP: each shard routes its block of the
        sequence (``moe_ep.TokenLayout``'s; all of it where ``model`` does
        not divide it), the outputs gathered back over ``model``.  ``sp``:
        ``hs`` already are those blocks, and the output stays the block."""
        cfg, mesh = self.cfg, self.mesh
        b, s, d = hs[0].shape
        cut = (not sp and s % self.msize == 0 and s >= self.msize
               and self.msize > 1)
        sl = s // self.msize if cut else s
        xl = [(h.narrow(1, self.model_idx[i] * sl, sl) if cut else h)
              .reshape(b * sl, d) for i, h in enumerate(hs)]
        logits = [torch.einsum("td,de->te", x.float(), r.float())
                  for x, r in zip(xl, router)]
        outs = moe_ep.ep_groups(cfg, mesh, self.groups(xl),
                                self.groups(logits), experts)
        ys = [o.reshape(b, sl, d).to(hs[0].dtype)
              for o in self.shards(outs)]
        return self.gather(ys, 1) if cut else ys

    def run_stacks(self, params, specs, xs, pos, pos3, caches=None,
                   cache_pos=None, remat="none", sp=False):
        """The layer stacks in order (``model._run_stacks``); returns the
        per-shard hidden state.  ``caches`` (``{kind: (placed tree,
        specs)}``): each layer writes its new position into them (the
        decode step donates them).  ``sp``: the carry ``xs`` is each
        shard's sequence block, and so is what comes back."""
        cfg = self.cfg
        for kind, count in layer_plan(cfg):
            if count == 0:
                continue
            layers = _unstack(params["stacks"][kind], specs["stacks"][kind],
                              count)
            lcs = (_unstack(caches[kind][0], caches[kind][1], count)
                   if caches is not None else [None] * count)
            if kind == "hybrid_group":
                per = cfg.attn_every

                def body(h, lp, lc):
                    scs = (_unstack(lc[0]["ssm"], lc[1]["ssm"], per)
                           if lc is not None else [None] * per)
                    for sl, sc in zip(_unstack(lp[0], lp[1], per), scs):
                        h, _ = self.block("ssm", sl[0], sl[1], h, pos, sc,
                                          sp=sp)
                    h, _ = self.block(
                        "dense", params["shared_attn"], specs["shared_attn"],
                        h, pos, None if lc is None else (lc[0]["attn"],
                                                         lc[1]["attn"]),
                        cache_pos, pos3, sp)
                    return list(_RecomputeHere.apply(*h))
            else:
                def body(h, lp, lc, kind=kind):
                    h, _ = self.block(kind, lp[0], lp[1], h, pos, lc,
                                      cache_pos, pos3, sp)
                    return list(_RecomputeHere.apply(*h))
            body = _maybe_remat(body, remat)
            for lp, lc in zip(layers, lcs):
                xs = body(xs, lp, lc)
        return xs

    # -- inputs and outputs ---------------------------------------------------
    def _batch(self, batch) -> PerShard:
        """A placed batch as one dict a shard."""
        out = [dict() for _ in range(self.mesh.held)]
        for k, v in batch.items():
            for o, x in zip(out, self.shards(v)):
                o[k] = x
        return out

    def lookup(self, params, tokens: PerShard, sp: bool = False
               ) -> PerShard:
        """Each shard's token embeddings: vocab-parallel where ``model``
        splits ``embed``'s rows (each shard looks up the tokens of its
        block, zero elsewhere, one psum over ``model``: bitwise the whole
        lookup), else the whole table's.  ``sp``: each shard's sequence
        block of them (the psum a reduce-scatter along S; the whole table
        looks up the block's tokens alone)."""
        spec = self.specs["embed"]
        if not self._split(spec, 0):
            return [F.embedding(t.long(), e) for t, e in zip(
                self.seq_block(tokens, sp),
                self.use(params["embed"], spec))]
        out = []
        for i, (t, e) in enumerate(zip(tokens, self.use(
                params["embed"], spec, ("model",)))):
            ids = t.long() - self.model_idx[i] * e.shape[0]
            own = (ids >= 0) & (ids < e.shape[0])
            x = F.embedding(torch.where(own, ids, 0), e)
            out.append(torch.where(own[..., None], x, 0.0))
        return self._sum_partials(out, out, sp)

    def embed(self, params, batch: PerShard, sp: bool = False):
        """Each shard's ``model.embed_inputs``: (hidden, pos, pos3); with
        ``sp`` the hidden state is the shard's sequence block (the
        positions stay whole: attention runs on the whole sequence)."""
        cfg = self.cfg
        if cfg.frontend == "audio":              # frames in: no lookup
            got = [embed_inputs(cfg, {}, b) for b in batch]
            xs = self.seq_block([g[0] for g in got], sp)
        else:
            # the patch scatter takes the whole sequence's embeddings
            early = sp and cfg.frontend != "vision"
            got = [finish_inputs(cfg, x, b) for x, b in zip(
                self.lookup(params, [b["tokens"] for b in batch], early),
                batch)]
            xs = [g[0] for g in got]
            if not early:
                xs = self.seq_block(xs, sp)
        return xs, [g[1] for g in got], [g[2] for g in got]

    def _head(self, params, hs: PerShard) -> PerShard:
        """The logits: each shard's vocab block where ``vocab_tp``."""
        cfg = self.cfg
        fn = self.use(params["final_norm"], self.specs["final_norm"])
        lm = self.use(params["lm_head"], self.specs["lm_head"],
                      ("model",) if self.vocab_tp else ())
        return [torch.einsum("bsd,dv->bsv", rms_norm(h, f, cfg.norm_eps), w)
                for h, f, w in zip(hs, fn, lm)]

    def _own_logits(self, logits: PerShard, spec):
        """The per-shard logits placed by the logits' spec: each shard's
        own block where ``vocab_tp``, else its vocab block of the whole
        logits (replicated over ``model``)."""
        if self.vocab_tp:
            return self.groups(logits)
        return self.groups([self._own(x, spec, s, self.dp)
                            for s, x in enumerate(logits)])

    def _ce(self, logits: PerShard, labels: PerShard, masks: PerShard):
        """The masked CE's global mean, on every shard."""
        if self.vocab_tp:
            starts = [self.model_idx[s] * x.shape[-1]
                      for s, x in enumerate(logits)]
            got = vocab_parallel_ce_sums(
                logits, labels, masks, starts,
                lambda v: self.psum(v, ("model",)),
                lambda v: self.pmax(v, ("model",)))
        else:
            got = [masked_ce_sums(x, lab, m)
                   for x, lab, m in zip(logits, labels, masks)]
        tot = self.psum([t for t, _ in got], self.dp)
        cnt = self.psum([c for _, c in got], self.dp)
        return [t / torch.clamp(c, min=1) for t, c in zip(tot, cnt)]

    def loss(self, params, batch) -> torch.Tensor:
        """``model.loss_fn`` partitioned: the loss as shard 0 holds it (on
        ``mesh.device``)."""
        cfg = self.cfg
        bs = self._batch(batch)
        sp = self.seq_sharded(bs[0]["labels"].shape[1])
        xs, pos, pos3 = self.embed(params, bs, sp)
        hs = self.run_stacks(params, self.specs, xs, pos, pos3,
                             remat=self.remat, sp=sp)
        hs = self.whole_seq(hs, sp)     # the head, the CE and MTP: whole
        labels = [b["labels"] for b in bs]
        masks = [lab >= 0 for lab in labels]
        ce = self._ce(self._head(params, hs), labels, masks)
        if cfg.mtp:
            mp, ms = params["mtp"], self.specs["mtp"]
            norms = self.use_tree({k: mp[k] for k in ("norm1", "norm2")}, ms)
            emb = self.lookup(params, [b["tokens"] for b in bs])
            hcat = [torch.cat([rms_norm(h, p["norm1"], cfg.norm_eps),
                               rms_norm(torch.roll(e, -1, 1), p["norm2"],
                                        cfg.norm_eps)], dim=-1)
                    for h, e, p in zip(hs, emb, norms)]
            col = self._split(ms["proj"], 1)
            hm = [torch.einsum("bsd,dk->bsk", h, w) for h, w in zip(
                hcat, self.use(mp["proj"], ms["proj"],
                               ("model",) if col else ()))]
            if col:
                hm = self.gather(hm, 2)
            hm, _ = self.block("moe" if cfg.is_moe else "dense", mp["block"],
                               ms["block"], hm, pos)
            lbl2 = [torch.roll(lab, -1, 1) for lab in labels]
            mask2 = []
            for mask in masks:
                m2 = mask & torch.roll(mask, -1, 1)
                m2[:, -1] = False
                mask2.append(m2)
            ce = [a + 0.1 * b for a, b in zip(
                ce, self._ce(self._head(params, hm), lbl2, mask2))]
        return ce[0]

    def prefill(self, params, batch, logits_spec):
        """``model.forward`` partitioned: the logits placed by their spec."""
        bs = self._batch(batch)
        key = "frames" if self.cfg.frontend == "audio" else "tokens"
        sp = self.seq_sharded(bs[0][key].shape[1])
        xs, pos, pos3 = self.embed(params, bs, sp)
        hs = self.run_stacks(params, self.specs, xs, pos, pos3, sp=sp)
        return self._own_logits(self._head(params, self.whole_seq(hs, sp)),
                                logits_spec)

    def decode(self, params, caches, cache_specs, tokens, pos: int,
               logits_spec, batch_entry):
        """``model.decode_step`` partitioned: (placed logits, the placed
        ``caches``, the new position written into them in place: the step
        donates them).  ``batch_entry``: the tokens' batch spec entry (the
        data axes, or None where they do not divide the batch)."""
        cfg = self.cfg
        self.batch_entry = batch_entry
        xs = self.lookup(params, self.shards(tokens))
        posv = [torch.full((1, 1), int(pos), dtype=torch.int32,
                           device=x.device) for x in xs]
        pos3 = [p[:, None, :].expand(x.shape[0], 3, 1) if cfg.mrope else None
                for p, x in zip(posv, xs)]
        paired = {k: (caches[k], cache_specs[k]) for k in caches}
        hs = self.run_stacks(params, self.specs, xs, posv, pos3,
                             caches=paired, cache_pos=int(pos))
        return self._own_logits(self._head(params, hs), logits_spec), caches

    # -- the train step -------------------------------------------------------
    def loss_and_grads(self, params, batch):
        """(loss, gradients in placed form): each leaf's gradient summed
        over its replicas, so every replica holds the leaf's gradient."""
        from ..ckpt.checkpoint import _flatten, _unflatten
        leaves = [t.detach().requires_grad_() for _, t in _flatten(params)]
        loss = self.loss(_unflatten(params, iter(leaves)), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _unflatten(params, iter(
            torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves)))
        with torch.no_grad():
            grads = map_specs(self.mesh.psum_replicas, grads, self.specs)
        return loss.detach(), grads

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the logical gradient tree, on ``mesh.device``: each
        block counted once (its first replica), a sum of squares per block
        on its shard's device, summed on the first device in (shard, leaf)
        order."""
        mesh = self.mesh
        terms = [[] for _ in range(mesh.held)]
        for _, groups, spec in _pairs(grads, self.specs):
            for g, grp in enumerate(groups):
                for j, s in enumerate(mesh.shards(g)):
                    if mesh.first_replica(spec, s):
                        terms[s].append(torch.sum(torch.square(
                            grp[j].float())))
        parts = [torch.stack([t for s in mesh.shards(g) for t in terms[s]])
                 .to(mesh.device) for g in range(mesh.n_groups)
                 if any(terms[s] for s in mesh.shards(g))]
        return torch.sqrt(torch.sum(torch.cat(parts)))


