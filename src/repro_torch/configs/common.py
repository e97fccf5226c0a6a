"""Shared config plumbing, the port of `repro/configs/common.py`: the
mesh-axis descriptor, the dry-run spec and the architecture record.

Where the JAX package lowers a step for a device mesh from
`ShapeDtypeStruct`s and `NamedSharding`s, the port traces it on the meta
device (tensors with shapes and dtypes and no storage) from the same
shapes, and carries each leaf's sharding as a `Split`, a plain tuple of
one entry a dim: None (not split), a mesh-axis name or a tuple of names
(split over their product, the first major) -- a `PartitionSpec`'s
entries, a shorter one padded with None.  A parameter tree is the JAX package's: nested
dicts (lists where the JAX tree has lists) keyed by the path of each
module parameter (`attn.wq` -> {"attn": {"wq": ...}}).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: tuple            # data-parallel axes, e.g. ("pod", "data")
    tp: str = "model"    # tensor/expert-parallel axis

    @property
    def all(self):
        return (*self.dp, self.tp)


@dataclasses.dataclass
class DryrunSpec:
    """What `launch/dryrun.py` traces: fn(*args) on the meta device.

    args: a tree (dicts, lists, tuples) of meta tensors with the JAX
    spec's shapes and dtypes.  in_splits / out_splits: the trees of the
    JAX spec's in_shardings / out_shardings, each leaf's split tuple
    (None for a leaf or a whole subtree: replicated, as an unspecified
    JAX sharding of a placeholder is).  JAX's donate_argnums has no field:
    it feeds XLA's buffer aliasing, and the dry run records no alias
    bytes."""
    fn: Callable
    args: tuple
    in_splits: Any
    out_splits: Any
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str
    shapes: tuple
    build_dryrun: Callable        # (shape, mesh, axes: MeshAxes) -> DryrunSpec
    smoke: Callable               # (device=None) -> None, raises on failure
    skip_shapes: dict = dataclasses.field(default_factory=dict)
    source: str = ""


class Split(tuple):
    """One leaf's split, `PartitionSpec(*entries)` as a tuple:
    `Split((None, "model"))`.  Its own type, so a tree of splits tells a
    leaf's split from a tuple of subtrees."""


def S(*entries) -> Split:
    """`Split` of the given entries, as `P(*entries)` is spelt."""
    return Split(entries)


def _is_tree(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, Split)


def tree_paths(tree, prefix=()) -> list:
    """[(path, leaf)] in JAX's leaf order (dict keys sorted, sequences in
    turn); a path is the tuple of dict keys and sequence indices.  None
    is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k],
                                                              prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def leaf_splits(tree, splits) -> list:
    """[(path, leaf, Split or None)] of `tree`, with `splits` a prefix
    of it: a None or a `Split` where `tree` has a subtree applies to every
    leaf below, as JAX broadcasts a sharding prefix."""
    def walk(t, s, prefix):
        if t is None:
            return []
        if _is_tree(t) and (s is None or isinstance(s, Split)):
            return [(p, leaf, s) for p, leaf in tree_paths(t, prefix)]
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k], s[k],
                                                       prefix + (k,))]
        if isinstance(t, (list, tuple)):
            return [x for i, v in enumerate(t) for x in walk(v, s[i],
                                                             prefix + (i,))]
        return [(prefix, t, s)]
    return walk(tree, splits, ())


def map_splits(fn, splits, tree):
    """fn(split, leaf) over a tree of `Split`s and the same tree of
    tensors: the tree of the results."""
    if isinstance(splits, Split):
        return fn(splits, tree)
    if isinstance(splits, dict):
        return {k: map_splits(fn, splits[k], tree[k]) for k in splits}
    return type(splits)(map_splits(fn, s, t) for s, t in zip(splits, tree))


def split_axes(entry) -> tuple:
    """A split entry -> the mesh axes it names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape, split, axis_sizes: dict) -> tuple:
    """A leaf's per-device shape under `split` (None = replicated) on a
    mesh of `axis_sizes`: each dim divided (rounded up, as JAX pads an
    uneven shard) by the product of the sizes of the axes it is split
    over."""
    parts = tuple(split or ()) + (None,) * (len(shape) - len(split or ()))
    return tuple(-(-int(s) // math.prod(axis_sizes[a] for a in split_axes(e)))
                 for s, e in zip(shape, parts))


def shard_bytes(tree, splits, axis_sizes: dict) -> int:
    """Per-device bytes of a tree of tensors under its splits."""
    return sum(math.prod(shard_shape(leaf.shape, s, axis_sizes))
               * leaf.element_size()
               for _, leaf, s in leaf_splits(tree, splits)
               if isinstance(leaf, torch.Tensor))


def abstract(tree):
    """A tree of tensors -> the same tree of meta tensors (shape and dtype,
    no storage): JAX's tree of `ShapeDtypeStruct`s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstract(v) for v in tree)
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def param_tree(model) -> dict:
    """A module's parameters as the JAX parameter tree: `layers.0.w_self`
    -> {"layers": [{"w_self": ...}]} (a level whose keys are all digits
    is a list)."""
    root: dict = {}
    for name, p in model.named_parameters():
        node = root
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = p
    return _lists(root)


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def flat_params(tree, prefix: str = "") -> dict:
    """The JAX parameter tree -> {module parameter name: tensor}, the
    mapping `torch.func.functional_call` takes."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}.{k}" if prefix else k))
    return out


class _Bound(torch.nn.Module):
    """One method of a module as a module's forward (what
    `torch.func.functional_call` calls)."""

    def __init__(self, model, method: str):
        super().__init__()
        self.model, self.method = model, method

    def forward(self, *args, **kw):
        return getattr(self.model, self.method)(*args, **kw)


def apply_params(model, params, method: str = "forward"):
    """model's `method` with its parameters taken from `params` (the JAX
    parameter tree): JAX's `fn(cfg, params, ...)` over the port's
    module."""
    bound = _Bound(model, method)
    flat = {f"model.{k}": v for k, v in flat_params(params).items()}

    def fn(*args, **kw):
        return torch.func.functional_call(bound, flat, args, kw)
    return fn


def value_and_grad(loss_fn):
    """JAX's `jax.value_and_grad(loss_fn)`: fn(params, *args) -> (loss,
    the gradient tree of `params`, its first argument)."""
    def fn(params, *args):
        leaves = [leaf for _, leaf in tree_paths(params)]
        for leaf in leaves:
            if not leaf.requires_grad:
                leaf.requires_grad_()
        loss = loss_fn(params, *args)
        # a parameter the loss does not read gets a zero gradient, as in JAX
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
        return loss.detach(), tree_map(lambda _: next(grads), params)
    return fn
