"""Data pipeline, the port of `repro/data/pipeline.py`: a deterministic
synthetic LM token stream (zipfian unigrams + short-range induction
structure so a real LM can actually fit it), batch placement on a mesh,
and a double-buffered host prefetcher.  The generator is numpy, the JAX
module's to the letter: the same arguments give the same arrays bit for
bit."""
from __future__ import annotations

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


def shard_batch(batch, mesh):
    """Place host arrays (a tree of numpy arrays or tensors) on the mesh.
    A `StackedMesh` holds every shard of the batch on its one device, so
    the arrays go there whole: JAX's `spec` (which mesh axes shard the
    batch dim) has nothing to choose."""
    if not isinstance(mesh, StackedMesh):
        raise NotImplementedError(
            "shard_batch over a process group (ProcessMesh) is not ported "
            "yet (ROADMAP A21); use a StackedMesh")
    return tree_map(lambda a: torch.as_tensor(a, device=mesh.device), batch)


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
