"""Data pipeline, the port of `repro/data/pipeline.py`: a deterministic
synthetic LM token stream (zipfian unigrams + short-range induction
structure so a real LM can actually fit it), batch placement on a mesh
(a process group's rank receives its rows), and a double-buffered host
prefetcher.  The generator is numpy, the JAX
module's to the letter: the same arguments give the same arrays bit for
bit."""
from __future__ import annotations

import math
import queue
import threading

import numpy as np
import torch

from repro_torch.dist.compat import StackedMesh
from repro_torch.optim.adamw import tree_map


def synthetic_lm_batches(vocab: int, batch: int, seq: int, *, seed: int = 0,
                         n_batches: int | None = None):
    """Yields (tokens, labels) int32 (batch, seq).  Zipf unigram marginals
    with injected copy patterns (position t repeats t - period)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks**1.1
    probs /= probs.sum()
    i = 0
    while n_batches is None or i < n_batches:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
        period = 1 + (i % 7)
        mask = rng.random((batch, seq + 1)) < 0.5
        idx = np.arange(seq + 1)
        src = np.clip(idx - period, 0, None)
        toks = np.where(mask, toks[:, src], toks)
        yield toks[:, :-1], toks[:, 1:]
        i += 1


def _kept(spec, names) -> list:
    """JAX's spec with the axes the mesh lacks dropped: per dim the mesh
    axes it splits over (first major), () for none."""
    parts = []
    for e in (spec or ()):
        axes = tuple(e) if isinstance(e, (tuple, list)) else \
            (() if e is None else (e,))
        parts.append(tuple(a for a in axes if a in names))
    return parts


def _rank_block(shape, mesh, spec) -> tuple:
    """The slices of an array of `shape` that the processors of this
    rank's block of a `ProcessMesh` hold under `spec`, as one block: the
    union of their shards, which must tile a box."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    coords = [dict(zip(mesh.axis_names, (i, j)))
              for i in range(mesh.i0, mesh.i0 + mesh.Rl)
              for j in range(mesh.j0, mesh.j0 + mesh.Cl)]
    out = []
    for dim, axes in enumerate(_kept(spec, mesh.axis_names)):
        n = math.prod(sizes[a] for a in axes)
        if n == 1:
            out.append(slice(None))
            continue
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of size {shape[dim]} does not "
                             f"split over {axes} ({n} shards)")
        idx = set()
        for c in coords:
            k = 0
            for a in axes:
                k = k * sizes[a] + c[a]
            idx.add(k)
        lo, hi = min(idx), max(idx) + 1
        if len(idx) != hi - lo:
            raise ValueError(
                f"rank {mesh.rank}'s processors hold shards {sorted(idx)} "
                f"of dim {dim}: not one block")
        per = shape[dim] // n
        out.append(slice(lo * per, hi * per))
    return tuple(out)


def shard_batch(batch, mesh, spec=(("pod", "data"),)):
    """Place host arrays (a tree of numpy arrays or tensors) on the mesh
    as `NamedSharding(mesh, P(*spec))` places them (axes the mesh lacks
    are dropped; a dim split over several axes takes the first as major).
    A `StackedMesh` holds every shard on its one device, so the arrays go
    there whole; on a `ProcessMesh` each rank receives the rows (the
    block, for a spec over several dims) its processors hold."""
    if isinstance(mesh, StackedMesh):
        return tree_map(lambda a: torch.as_tensor(a, device=mesh.device),
                        batch)

    def place(a):
        a = torch.as_tensor(a)
        return a[_rank_block(a.shape, mesh, spec)].to(mesh.device)
    return tree_map(place, batch)


class Prefetcher:
    """Host-side double buffering (the CPUs-as-coprocessors role)."""

    def __init__(self, it, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.it = it
        self._done = object()
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        for x in self.it:
            self.q.put(x)
        self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self.q.get()
        if x is self._done:
            raise StopIteration
        return x
