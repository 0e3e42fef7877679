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
* **TP (Megatron)**: attention (MHA, GQA, MQA) and the dense FFN run on the
  shard's heads / hidden columns of ``wq``/``wk``/``wv``/``wu``/``wg``
  (gathered over data only) and rows of ``wo``/``wd``; one ``psum`` over
  ``model`` a block sums the partial outputs.  A shard whose q heads share
  kv heads it does not hold whole (MQA, or kv heads ``model`` does not
  divide) takes the whole ``wk``/``wv`` and attends with its own kv heads
  (``layers.attn_forward``'s ``kv_heads``);
* **every other leaf** (``embed``, ``lm_head``, the norms, MLA, mamba2, the
  router, the shared experts, the MTP block) is gathered over every axis
  of its spec, and its compute is replicated over ``model``;
* **the routed experts** keep EP: each shard routes its token block
  (``moe_ep.TokenLayout``), the buffers cross ``ShardMesh.all_to_all`` and
  each shard's experts are its own block of the EP rule
  (``moe_ep.ep_groups``);
* **the loss** is the reference's global mean: the masked CE sum and the
  mask count are psum'd over the data axes before they divide.

The gradient is exact differentiation of the loss as shard 0 holds it
(every shard holds the same value).  A leaf that the spec replicates has
a copy per shard, and its gradient is the sum over its copies
(``ShardMesh.psum_replicas``), which every replica then holds, so the
replicas stay bitwise equal after every step.  The global norm counts each
block once (its first replica), a per-block sum of squares summed on the
first device in shard order.
"""
from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch

from ..core.mesh import ShardMesh, axis_sizes, spec_entry_axes
from .config import ArchConfig
from .layers import (attn_forward, ffn_forward, mla_forward, moe_forward,
                     rms_norm, weak)
from .mamba2 import mamba_forward
from .model import _maybe_remat, embed_inputs, layer_plan, masked_ce_sums
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
                 remat: str = "full"):
        if "model" not in mesh.axis_names:
            raise ValueError(f"the partitioned step needs a 'model' axis, "
                             f"got {mesh.axis_names}")
        self.cfg, self.mesh, self.specs, self.remat = cfg, mesh, specs, remat
        self.dp = (("pod", "data") if "pod" in mesh.axis_names
                   else ("data",))
        self.msize = axis_sizes(mesh)["model"]
        mi = mesh.axis_names.index("model")
        self.model_idx = [mesh.coords(s)[mi] for s in range(mesh.size)]

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

    def use_tree(self, tree: Tree, specs: Tree, keep=()) -> PerShard:
        """``use`` over a dict of placed leaves: one dict a shard."""
        if tree is None:
            return [None] * self.mesh.size
        out = [dict() for _ in range(self.mesh.size)]
        for k, v in tree.items():
            vals = (self.use_tree(v, specs[k], keep) if isinstance(v, dict)
                    else self.use(v, specs[k], keep))
            for o, x in zip(out, vals):
                o[k] = x
        return out

    def psum(self, vals: PerShard, axes) -> PerShard:
        return self.shards(self.mesh.psum(self.groups(vals), axes, dim=0))

    def _own(self, x: torch.Tensor, spec, s: int, keep) -> torch.Tensor:
        """Shard ``s``'s block of a value ``use`` gathered (the dims whose
        axes are not in ``keep``)."""
        own = tuple(None if set(spec_entry_axes(e)) & set(keep) else e
                    for e in spec)
        return self.mesh.block_of(x, own, s)

    # -- caches ---------------------------------------------------------------
    def cache_in(self, cache, keep) -> PerShard:
        """A layer's placed cache ``(tree, specs)`` for its compute: each
        shard's dict, gathered over every axis but the batch's data axes
        and ``keep``."""
        if cache is None:
            return [None] * self.mesh.size
        tree, specs = cache
        return self.use_tree(tree, specs, keep + self.dp)

    def cache_out(self, cache, new: PerShard, keep):
        """The new per-shard caches back in placed form: each shard's own
        block of what ``cache_in`` gathered."""
        if cache is None:
            return None
        _, specs = cache
        keep = keep + self.dp

        def one(k, spec):
            return self.groups([self._own(n[k], spec, s, keep)
                                for s, n in enumerate(new)])
        return {k: one(k, specs[k]) for k in specs}

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
        shards the q heads of ``wq`` and ``wo``) and each shard's kv
        heads (``_kv_heads``)."""
        cfg = self.cfg
        if cfg.mla or self.msize == 1:
            return False, None
        if not ("model" in spec_entry_axes(specs["wq"][1])
                and "model" in spec_entry_axes(specs["wo"][0])):
            return False, None
        try:
            return True, self._kv_heads(specs["wk"])
        except ValueError:
            return False, None

    def block(self, kind: str, lp: Tree, ls: Tree, xs: PerShard, pos,
              cache=None, cache_pos=None, pos3=None):
        """One block on every shard (``model._block_forward``'s program):
        returns the new per-shard hidden state and the new placed cache."""
        cfg, n = self.cfg, self.mesh.size
        res = lambda a: weak(cfg.residual_scale, a.dtype)
        if kind == "ssm":
            ps = self.use_tree(lp, ls)
            cs = self.cache_in(cache, ())
            out, ncs = [], []
            for i in range(n):
                h, nc = mamba_forward(cfg, ps[i]["mamba"], rms_norm(
                    xs[i], ps[i]["ln"], cfg.norm_eps), cs[i])
                out.append(xs[i] + res(h) * h)
                ncs.append(nc)
            return out, self.cache_out(cache, ncs, ())
        tp, kv = self._attn_tp(ls["attn"])
        keep = ("model",) if tp else ()
        pa = self.use_tree(lp["attn"], ls["attn"], keep)
        ln1, ln2 = self.use(lp["ln1"], ls["ln1"]), self.use(lp["ln2"],
                                                            ls["ln2"])
        cs = self.cache_in(cache, keep)
        attn, ncs = [], []
        for i in range(n):
            h = rms_norm(xs[i], ln1[i], cfg.norm_eps)
            if cfg.mla:
                a, nc = mla_forward(cfg, pa[i], h, pos[i], cache=cs[i],
                                    cache_pos=cache_pos)
            else:
                a, nc = attn_forward(cfg, pa[i], h, pos[i], cache=cs[i],
                                     cache_pos=cache_pos, pos3=pos3[i],
                                     kv_heads=None if kv is None else kv[i])
            attn.append(a)
            ncs.append(nc)
        if tp:
            attn = self.psum(attn, ("model",))
        xs = [x + res(a) * a for x, a in zip(xs, attn)]
        hs = [rms_norm(x, w, cfg.norm_eps) for x, w in zip(xs, ln2)]
        f = (self.moe(lp["ffn"], ls["ffn"], hs) if kind == "moe"
             else self.ffn(lp["ffn"], ls["ffn"], hs))
        xs = [x + res(y) * y for x, y in zip(xs, f)]
        return xs, self.cache_out(cache, ncs, keep)

    def ffn(self, lp: Tree, ls: Tree, hs: PerShard) -> PerShard:
        """The dense FFN: column-parallel ``wu``/``wg``, row-parallel
        ``wd`` and a psum over ``model`` where ``model`` shards the hidden
        width, else replicated."""
        tp = self.msize > 1 and "model" in spec_entry_axes(ls["wu"][-1])
        ps = self.use_tree(lp, ls, ("model",) if tp else ())
        out = [ffn_forward(self.cfg, p, h) for p, h in zip(ps, hs)]
        return self.psum(out, ("model",)) if tp else out

    def moe(self, lp: Tree, ls: Tree, hs: PerShard) -> PerShard:
        """The MoE block: EP over the routed experts where the step engaged
        it (``moe_ep.get_ep_mesh``), the router and the shared experts
        replicated; else the dropless layer, replicated."""
        cfg, mesh = self.cfg, self.mesh
        if moe_ep.get_ep_mesh() is None:
            return [moe_forward(cfg, p, h)
                    for p, h in zip(self.use_tree(lp, ls), hs)]
        experts = {k: v for k, v in lp.items() if k in ("wu", "wg", "wd")}
        rest = {k: v for k, v in lp.items() if k not in experts}
        ps = self.use_tree(rest, {k: ls[k] for k in rest})
        b, s, d = hs[0].shape
        ns = self.msize if s % self.msize == 0 and s >= self.msize else 1
        sl = s // ns
        xl = [(h.narrow(1, self.model_idx[i] * sl, sl) if ns > 1 else h)
              .reshape(b * sl, d) for i, h in enumerate(hs)]
        logits = [torch.einsum("td,de->te", x.float(), p["router"].float())
                  for x, p in zip(xl, ps)]
        outs = moe_ep.ep_groups(cfg, mesh, self.groups(xl),
                                self.groups(logits), experts)
        ys = [o.reshape(b, sl, d).to(hs[0].dtype)
              for o in self.shards(outs)]
        if ns > 1:
            ys = self.shards(mesh.all_gather(self.groups(ys), ("model",), 1,
                                             dim=0, tiled=True))
        if cfg.n_shared_experts:
            ys = [y + ffn_forward(cfg, {k[len("shared_"):]: p[k] for k in p
                                        if k.startswith("shared_")}, h)
                  for y, p, h in zip(ys, ps, hs)]
        return ys

    def run_stacks(self, params, specs, xs, pos, pos3, caches=None,
                   cache_pos=None, remat="none"):
        """The layer stacks in order (``model._run_stacks``); returns the
        per-shard hidden state and the new placed caches."""
        cfg = self.cfg
        new = {} if caches is not None else None
        for kind, count in layer_plan(cfg):
            if count == 0:
                continue
            layers = _unstack(params["stacks"][kind], specs["stacks"][kind],
                              count)
            if caches is not None and kind == "hybrid_group":
                raise NotImplementedError(
                    "the partitioned decode of a hybrid stack (its shared "
                    "attention cache's spec shards the sequence)")
            lcs = (_unstack(caches[kind][0], caches[kind][1], count)
                   if caches is not None else [None] * count)
            if kind == "hybrid_group":
                per = cfg.attn_every

                def body(h, lp, _lc):
                    for sp in _unstack(lp[0], lp[1], per):
                        h, _ = self.block("ssm", sp[0], sp[1], h, pos)
                    h, _ = self.block("dense", params["shared_attn"],
                                      specs["shared_attn"], h, pos,
                                      pos3=pos3)
                    return list(_RecomputeHere.apply(*h)), None
            else:
                def body(h, lp, lc, kind=kind):
                    h, nc = self.block(kind, lp[0], lp[1], h, pos, lc,
                                       cache_pos, pos3)
                    return list(_RecomputeHere.apply(*h)), nc
            body = _maybe_remat(body, remat)
            outs = []
            for lp, lc in zip(layers, lcs):
                xs, nc = body(xs, lp, lc)
                outs.append(nc)
            if caches is not None:
                new[kind] = {k: tuple(torch.stack([o[k][g] for o in outs], 1)
                                      for g in range(self.mesh.n_groups))
                             for k in outs[0]}
        return xs, new

    # -- inputs and outputs ---------------------------------------------------
    def _batch(self, batch) -> PerShard:
        """A placed batch as one dict a shard."""
        out = [dict() for _ in range(self.mesh.size)]
        for k, v in batch.items():
            for o, x in zip(out, self.shards(v)):
                o[k] = x
        return out

    def embed(self, params, batch: PerShard):
        """Each shard's ``model.embed_inputs``: (hidden, pos, pos3)."""
        emb = (self.use(params["embed"], self.specs["embed"])
               if "embed" in params else [None] * self.mesh.size)
        got = [embed_inputs(self.cfg, {"embed": e}, b)
               for e, b in zip(emb, batch)]
        return [g[0] for g in got], [g[1] for g in got], [g[2] for g in got]

    def _head(self, params, hs: PerShard) -> PerShard:
        cfg = self.cfg
        fn = self.use(params["final_norm"], self.specs["final_norm"])
        lm = self.use(params["lm_head"], self.specs["lm_head"])
        return [torch.einsum("bsd,dv->bsv", rms_norm(h, f, cfg.norm_eps), w)
                for h, f, w in zip(hs, fn, lm)]

    def _own_logits(self, logits: PerShard, spec):
        """The per-shard logits (replicated over ``model``) placed by the
        logits' spec: each shard's vocab block where ``model`` shards it."""
        return self.groups([self._own(x, spec, s, self.dp)
                            for s, x in enumerate(logits)])

    def _global_mean(self, sums: PerShard, counts: PerShard):
        tot = self.psum(sums, self.dp)
        cnt = self.psum(counts, self.dp)
        return [t / torch.clamp(c, min=1) for t, c in zip(tot, cnt)]

    def loss(self, params, batch) -> torch.Tensor:
        """``model.loss_fn`` partitioned: the loss as shard 0 holds it (on
        ``mesh.device``)."""
        cfg, n = self.cfg, self.mesh.size
        bs = self._batch(batch)
        xs, pos, pos3 = self.embed(params, bs)
        hs, _ = self.run_stacks(params, self.specs, xs, pos, pos3,
                                remat=self.remat)
        logits = self._head(params, hs)
        sums, counts, masks = [], [], []
        for lg, b in zip(logits, bs):
            mask = b["labels"] >= 0
            t, c = masked_ce_sums(lg, b["labels"], mask)
            sums.append(t)
            counts.append(c)
            masks.append(mask)
        ce = self._global_mean(sums, counts)
        if cfg.mtp:
            mp = self.use_tree({k: v for k, v in params["mtp"].items()
                                if k != "block"}, self.specs["mtp"])
            emb = self.use(params["embed"], self.specs["embed"])
            hm = []
            for i in range(n):
                emb_next = torch.roll(torch.nn.functional.embedding(
                    bs[i]["tokens"].long(), emb[i]), -1, 1)
                hcat = torch.cat([rms_norm(hs[i], mp[i]["norm1"],
                                           cfg.norm_eps),
                                  rms_norm(emb_next, mp[i]["norm2"],
                                           cfg.norm_eps)], dim=-1)
                hm.append(torch.einsum("bsd,dk->bsk", hcat, mp[i]["proj"]))
            hm, _ = self.block("moe" if cfg.is_moe else "dense",
                               params["mtp"]["block"],
                               self.specs["mtp"]["block"], hm, pos)
            lm = self._head(params, hm)
            s2, c2 = [], []
            for lg, b, mask in zip(lm, bs, masks):
                lbl2 = torch.roll(b["labels"], -1, 1)
                mask2 = mask & torch.roll(mask, -1, 1)
                mask2[:, -1] = False
                t, c = masked_ce_sums(lg, lbl2, mask2)
                s2.append(t)
                c2.append(c)
            ce = [a + 0.1 * b for a, b in zip(ce, self._global_mean(s2, c2))]
        return ce[0]

    def prefill(self, params, batch, logits_spec):
        """``model.forward`` partitioned: the logits placed by their spec."""
        bs = self._batch(batch)
        xs, pos, pos3 = self.embed(params, bs)
        hs, _ = self.run_stacks(params, self.specs, xs, pos, pos3)
        return self._own_logits(self._head(params, hs), logits_spec)

    def decode(self, params, caches, cache_specs, tokens, pos: int,
               logits_spec):
        """``model.decode_step`` partitioned: (placed logits, new placed
        caches)."""
        cfg = self.cfg
        toks = self.shards(tokens)
        emb = self.use(params["embed"], self.specs["embed"])
        xs = [torch.nn.functional.embedding(t.long(), e)
              for t, e in zip(toks, emb)]
        posv = [torch.full((1, 1), int(pos), dtype=torch.int32,
                           device=x.device) for x in xs]
        pos3 = [p[:, None, :].expand(x.shape[0], 3, 1) if cfg.mrope else None
                for p, x in zip(posv, xs)]
        paired = {k: (caches[k], cache_specs[k]) for k in caches}
        hs, new = self.run_stacks(params, self.specs, xs, posv, pos3,
                                  caches=paired, cache_pos=int(pos))
        return self._own_logits(self._head(params, hs), logits_spec), new

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
        terms = [[] for _ in range(mesh.size)]
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


