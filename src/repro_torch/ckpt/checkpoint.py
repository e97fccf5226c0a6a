"""Sharded checkpointing with atomic commit (fault tolerance, DESIGN.md 8),
the port of `repro/ckpt/checkpoint.py`.

Layout:  <dir>/step_<n>/shard_<host>.npz + manifest.json
  * each host dumps the leaves it owns (here: single-host, all leaves);
  * manifest records step, pytree structure, leaf shapes/dtypes, the
    leaves' key paths and the caller's meta;
  * writes go to step_<n>.tmp and are renamed into place -> a crash never
    leaves a half checkpoint visible;
  * `restore` returns (tree, manifest) for ANY grid: re-sharding is the
    loader's job (`repro_torch.ckpt.elastic`), because the arrays are
    saved in GLOBAL layout;
  * async-writer failures are RECORDED, not swallowed: the next `save()` /
    `wait()` / `join()` re-raises the writer thread's exception, so a
    checkpoint that silently failed to land cannot masquerade as durable.

The on-disk layout is the JAX package's, leaf for leaf: `shard_0.npz`
holds `leaf_<i>` in the order of the sorted-key walk of a nested dict
(the order `jax.tree.flatten` emits), and `manifest.json` holds `step`,
`treedef`, `n_leaves`, `shapes`, `dtypes`, `paths` and `meta`.  So each
package restores the other's directories.  `treedef` is the only field
written differently: the JAX package stores `str(treedef)` of its pytree,
this module a string of its own of the same shape
(`PyTreeDef({'a': *, ...})` for nested dicts).  Neither package's
`restore_tree` nor `restore` reads it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch


def _tree_paths(tree, prefix=""):
    """`/`-joined key paths for a pure nested-dict tree, in the order
    `_flatten` emits the leaves (sorted dict keys); None when the tree has
    non-dict interior nodes (path-keyed restore unavailable)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree.keys()):
            sub = _tree_paths(tree[k], f"{prefix}{k}/")
            if sub is None:
                return None
            out.extend(sub)
        return out
    if isinstance(tree, (list, tuple)):
        return None
    return [prefix[:-1]]


def _host(leaf) -> np.ndarray:
    """A leaf as a host array: a tensor (a parameter, on any device) is
    detached and copied off its device."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree) -> list:
    """Leaves of a tree of dicts, lists and tuples: dict keys sorted,
    sequences in order; None is an empty node (no leaf), as in JAX."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _flatten(x)]
    if tree is None:
        return []
    return [tree]


def _unflatten(example, leaves):
    """A tree shaped like `example` whose leaves are taken from the
    iterator `leaves` in `_flatten`'s order."""
    if isinstance(example, dict):
        return {k: _unflatten(example[k], leaves) for k in sorted(example)}
    if isinstance(example, (list, tuple)):
        return type(example)(_unflatten(x, leaves) for x in example)
    if example is None:
        return None
    return next(leaves)


def _treedef_str(tree) -> str:
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(x) for x in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread = None
        self._error = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra_meta: dict | None = None):
        self._raise_pending()
        host_leaves = [_host(leaf) for leaf in _flatten(tree)]
        treedef = _treedef_str(tree)
        paths = _tree_paths(tree)
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            self._raise_pending()

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            manifest = {
                "step": step,
                "treedef": treedef,
                "n_leaves": len(host_leaves),
                "shapes": [list(a.shape) for a in host_leaves],
                "dtypes": [str(a.dtype) for a in host_leaves],
                "paths": paths,
                "meta": extra_meta or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def guarded():
            try:
                write()
            except BaseException as e:     # noqa: BLE001 -- re-raised later
                self._error = e

        if self.async_write:
            self._thread = threading.Thread(target=guarded)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    # `join` is the spelling recovery drivers use at end-of-query
    join = wait

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest(self):
        s = self.steps()
        return s[-1] if s else None

    def restore(self, treedef_example, step: int | None = None):
        """treedef_example: a tree of nested dicts / lists / tuples with the
        target structure (values are ignored).  Returns (tree, manifest)
        or (None, None)."""
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "shard_0.npz"))
        leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        return _unflatten(treedef_example, iter(leaves)), manifest

    def restore_tree(self, step: int | None = None):
        """Restore WITHOUT a structure example: rebuilds the nested dict
        from the manifest's leaf paths (recorded for pure-dict trees, which
        is what traversal snapshots are).  Returns (tree, manifest) or
        (None, None)."""
        step = step if step is not None else self.latest()
        if step is None:
            return None, None
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        paths = manifest.get("paths")
        if paths is None:
            raise ValueError(
                f"checkpoint step_{step} was not saved from a nested dict; "
                "use restore(treedef_example)")
        data = np.load(os.path.join(path, "shard_0.npz"))
        tree = {}
        for i, p in enumerate(paths):
            node, parts = tree, p.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[f"leaf_{i}"]
        return tree, manifest
