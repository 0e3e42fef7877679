"""Punctuation-aligned snapshots: the reference's checkpoint format, for
trees of tensors.

Reference: ``repro/ckpt/checkpoint.py``.  The layout is the same, so a
snapshot written by either package loads in the other::

    <dir>/step_<N>/manifest.json + one .npy per leaf

A leaf is addressed by its key path (``"values"``, ``"a/b"``, ``"a/0"``),
the string the reference builds from ``jax.tree_util``'s key paths.  The
trees here are dicts, lists and tuples of tensors and numpy arrays, walked
as ``jax.tree_util.tree_flatten_with_path`` walks them: dict keys sorted,
sequences in order, ``None`` an empty subtree.

Durability and validity are the reference's (DESIGN.md §2.7): every leaf
file and the manifest are fsync'd before the atomic rename, and the
manifest records each leaf's byte size and CRC32, so

* a crashed writer leaves only a ``.tmp`` directory (or a manifest-less
  ``step_*`` debris dir), both invisible to :func:`latest_step`;
* a torn or bit-rotted *published* snapshot is detected by
  :func:`verify_checkpoint` and skipped by :func:`latest_valid_step`,
  which lets a service resume fall back to the newest snapshot that
  verifies.

``reshard`` loads a snapshot for another mesh.  The reference's
``spec_fn(target, mesh)`` gives each leaf a JAX sharding; the port's mesh
(``core/mesh.ShardMesh``) keeps its shards in device groups, one device a
group, so here it gives each leaf the device to load onto, which may differ
from leaf to leaf.  The service's snapshots hold canonical uid-order
values, so a snapshot cut on any mesh restores onto any other through
``DualModeEngine.carry_in``, which cuts them into the groups' blocks.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import zlib
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix=()):
    """``[(key path, leaf), ...]`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in ``_flatten``'s
    order, from the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return next(leaves)


def clone_tree(tree):
    """A copy of every leaf of ``tree`` (every group tensor of a placed
    tree): what a caller keeps of an input that a step donates."""
    return _unflatten(tree, iter(x.clone() for _, x in _flatten(tree)))


def _path_str(path) -> str:
    return "/".join(path)


def _to_numpy(leaf):
    """A leaf as numpy and the dtype name the manifest records (bfloat16,
    which numpy lacks, is stored as its uint16 bits, as the reference
    does)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                return crc
            crc = zlib.crc32(block, crc)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:                      # platform without dir fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _span(tracer, name: str, **args):
    """Telemetry span when a tracer is attached (DESIGN.md §2.11), a
    no-op context otherwise — ckpt/ stays importable without the
    runtime telemetry module."""
    if tracer is None:
        return contextlib.nullcontext()
    return tracer.span(name, cat="ckpt", **args)


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    extra_meta: Optional[dict] = None,
                    tracer=None) -> str:
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    leaves = _flatten(tree)
    manifest = dict(step=step, leaves={}, meta=extra_meta or {})
    with _span(tracer, "snapshot.write", step=step, leaves=len(leaves)):
        for path, leaf in leaves:
            key = _path_str(path)
            arr, dtype = _to_numpy(leaf)
            fname = re.sub(r"[^\w\-]", "_", key) + ".npy"
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = dict(
                file=fname, dtype=dtype, shape=list(arr.shape),
                bytes=os.path.getsize(fpath), crc32=_crc32_file(fpath))
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
    # atomic publish: a crashed writer never yields a half checkpoint —
    # every byte is durable before the rename makes the step visible
    with _span(tracer, "snapshot.rename", step=step):
        if os.path.exists(out):
            shutil.rmtree(out)
        os.rename(tmp, out)
        _fsync_dir(ckpt_dir)
    return out


def _read_manifest(ckpt_dir: str, step: int) -> Optional[dict]:
    """The step's manifest, or None if missing/unparseable (torn write)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_manifest_meta(ckpt_dir: str, step: int) -> Optional[dict]:
    """The ``extra_meta`` dict a snapshot was published with (or None for
    a missing/torn manifest).  This is the service's replay record: for
    adaptive runs it carries the controller decision trace + record
    window alongside ``intervals_done`` (DESIGN.md §2.9), so ``resume``
    can rebuild the plan without loading any leaf.

    Elastic runs additionally record ``ownership`` (owner count + the
    override list live at publish time, DESIGN.md §2.10).  It is
    informational: snapshot *values* are always written in canonical
    single-device layout, so restore re-derives the placement by
    replaying the decision trace and rebinds the engine to it — a
    snapshot taken under any placement restores onto any other."""
    manifest = _read_manifest(ckpt_dir, step)
    if manifest is None:
        return None
    return dict(manifest.get("meta") or {})


def checkpoint_steps(ckpt_dir: str) -> List[int]:
    """Published steps with a *readable* manifest, descending.

    A ``step_*`` directory without a parseable ``manifest.json`` is a
    crashed writer's debris and never shadows a good snapshot.
    """
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and _read_manifest(ckpt_dir, int(m.group(1))) is not None:
            steps.append(int(m.group(1)))
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = checkpoint_steps(ckpt_dir)
    return steps[0] if steps else None


def verify_checkpoint(ckpt_dir: str, step: int) -> Tuple[bool, str]:
    """Cheap integrity check: manifest readable, every leaf present with
    the recorded byte size and CRC32.  Returns ``(ok, why)``; manifests
    written before checksums existed verify on presence alone."""
    manifest = _read_manifest(ckpt_dir, step)
    if manifest is None:
        return False, "manifest missing or unreadable"
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    for key, ent in manifest.get("leaves", {}).items():
        path = os.path.join(src, ent["file"])
        if not os.path.isfile(path):
            return False, f"leaf {key!r} missing"
        if "bytes" in ent and os.path.getsize(path) != ent["bytes"]:
            return False, (f"leaf {key!r} truncated: "
                           f"{os.path.getsize(path)} != {ent['bytes']}B")
        if "crc32" in ent and _crc32_file(path) != ent["crc32"]:
            return False, f"leaf {key!r} checksum mismatch"
    return True, "ok"


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
    """Newest step that passes :func:`verify_checkpoint` — the recovery
    fallback order: a torn/corrupted latest never masks an older good
    snapshot."""
    for step in checkpoint_steps(ckpt_dir):
        if verify_checkpoint(ckpt_dir, step)[0]:
            return step
    return None


def prune_checkpoints(ckpt_dir: str, keep_last: int) -> List[int]:
    """Retention after atomic publish: keep the newest ``keep_last``
    ``step_*`` directories (by step number, readable or not — corrupt
    dirs age out too) and sweep stale ``.tmp`` writer debris.  Returns
    the removed steps."""
    if keep_last <= 0 or not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m:
            steps.append(int(m.group(1)))
    steps.sort()
    removed = []
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
        removed.append(s)
    newest = steps[-1] if steps else None
    for d in os.listdir(ckpt_dir):
        m = re.match(r"^step_(\d+)\.tmp$", d)
        if m and newest is not None and int(m.group(1)) < newest:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    return removed


def load_checkpoint(ckpt_dir: str, step: int, target: Tree,
                    verify: bool = False) -> Tree:
    """Restore into the structure of ``target``, a tree of tensors or numpy
    arrays (only their shapes are read).  A tensor leaf comes back as a
    tensor on its device, any other leaf as a numpy array.  With
    ``verify``, integrity-check the snapshot first and raise
    ``ValueError`` instead of loading damaged bytes."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    if verify:
        ok, why = verify_checkpoint(ckpt_dir, step)
        if not ok:
            raise ValueError(f"checkpoint step {step} fails verification: "
                             f"{why}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)

    out = []
    for path, leaf in _flatten(target):
        key = _path_str(path)
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(src, ent["file"]))
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(f"{key}: ckpt shape {arr.shape} != {expect}")
        if isinstance(leaf, torch.Tensor):
            t = torch.from_numpy(arr.view(np.int16) if ent["dtype"] ==
                                 "bfloat16" else arr)
            if ent["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            out.append(t.to(leaf.device))
        else:
            out.append(arr)
    return _unflatten(target, iter(out))


def reshard(ckpt_dir: str, step: int, target: Tree, mesh, spec_fn) -> Tree:
    """Load a checkpoint for another mesh: ``spec_fn(target, mesh)``
    returns a tree like ``target`` holding the device of each leaf, and
    leaves may go to different devices (on a ``ShardMesh``, any of
    ``mesh.devices``: a shard's leaves on its group's device, the
    canonical values on ``mesh.device``).  Every leaf comes back as a
    tensor on its device."""
    flat = _flatten(target)
    places = [d for _, d in _flatten(spec_fn(target, mesh))]
    if len(places) != len(flat):
        raise ValueError(f"spec_fn gave {len(places)} leaves, target has "
                         f"{len(flat)}")
    # load_checkpoint puts a tensor leaf on that leaf's device: stand each
    # leaf in as one element on its device, expanded to the leaf's shape
    placed = [torch.empty((), device=dev).expand(tuple(np.shape(leaf)))
              for (_, leaf), dev in zip(flat, places)]
    return load_checkpoint(ckpt_dir, step,
                           _unflatten(target, iter(placed)))
