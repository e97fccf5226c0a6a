"""The port's single-device BFS (`core.bfs_single`) and its ground truth
(`core.bfs_reference_py`, the port's own copy) against the JAX package's,
on the CPU: level and pred equal, bit for bit,

  * on SCALE 8 and 10 R-MAT CSCs from many roots, an isolated root among
    them;
  * on the ring and the two-component graphs of tests/test_bfs_core.py;
  * on a CSC with -1 rows inside its columns and a row_idx padded with -1
    past col_off[n];
  * with edge passes (the module's CHUNK) that split columns.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(k), SCALE, 8)` as numpy,
its JAX `build_csc`, roots from `np.random.default_rng`.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs_reference_py as jax_bfs_reference_py
from repro.core import bfs_single as jax_bfs_single
from repro.graphgen import build_csc as jax_build_csc
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.core import bfs_reference_py, bfs_single

# the module (the package exports its function under the same name)
BS = importlib.import_module("repro_torch.core.bfs_single")


def _csc(edges, n):
    co, ri = jax_build_csc(jnp.asarray(edges), n)
    return np.array(co), np.array(ri)


def _check(co, ri, root):
    n = co.shape[0] - 1
    jl, jp = jax_bfs_single(jnp.asarray(co), jnp.asarray(ri), root)
    tl, tp = bfs_single(torch.from_numpy(co), torch.from_numpy(ri), root)
    assert tl.dtype == torch.int32 and tp.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    if (ri >= 0).all():
        rl, rp = bfs_reference_py(co, ri, root, n)
        jrl, jrp = jax_bfs_reference_py(co, ri, root, n)
        np.testing.assert_array_equal(rl, jrl)
        np.testing.assert_array_equal(rp, jrp)
        np.testing.assert_array_equal(rl, tl.numpy())


@pytest.mark.parametrize("scale", [8, 10])
def test_rmat_many_roots(scale):
    n = 1 << scale
    edges = np.asarray(jax_rmat_edges(jax.random.key(scale), scale, 8))
    co, ri = _csc(edges, n)
    deg = np.diff(co)
    roots = list(np.random.default_rng(scale).choice(
        np.flatnonzero(deg > 0), 12, replace=False))
    isolated = np.flatnonzero(deg == 0)
    assert isolated.size, "the draw has no isolated vertex"
    for root in roots + [int(isolated[0])]:
        _check(co, ri, int(root))


@pytest.mark.parametrize("chunk", [1, 7, 100, 5000])
def test_chunks_split_columns(chunk, monkeypatch):
    """Edge passes of `chunk` slots (the module's CHUNK) split columns."""
    monkeypatch.setattr(BS, "CHUNK", chunk)
    n = 1 << 8
    edges = np.asarray(jax_rmat_edges(jax.random.key(3), 8, 8))
    co, ri = _csc(edges, n)
    for root in (int(np.argmax(np.diff(co))), 17):
        _check(co, ri, root)


def test_ring():
    n = 16
    src = np.arange(n)
    edges = np.stack([np.concatenate([src, (src + 1) % n]),
                      np.concatenate([(src + 1) % n, src])]).astype(np.int32)
    co, ri = _csc(edges, n)
    _check(co, ri, 0)
    lvl, _ = bfs_single(torch.from_numpy(co), torch.from_numpy(ri), 0)
    np.testing.assert_array_equal(lvl.numpy(),
                                  np.minimum(np.arange(n), n - np.arange(n)))


def test_disconnected():
    edges = np.array([[0, 1, 2, 3], [1, 0, 3, 2]], np.int32)
    co, ri = _csc(edges, 4)
    for root in range(4):
        _check(co, ri, root)
    lvl, _ = bfs_single(torch.from_numpy(co), torch.from_numpy(ri), 0)
    assert lvl.tolist() == [0, 1, -1, -1]


def test_padded_rows_are_inactive(monkeypatch):
    """-1 rows inside columns (extra edges u -> -1) and a row_idx padded
    with -1 past col_off[n] scan nothing, in JAX as in the port."""
    n = 1 << 8
    edges = np.asarray(jax_rmat_edges(jax.random.key(5), 8, 8))
    rng = np.random.default_rng(5)
    holes = np.stack([rng.integers(0, n, 300),
                      np.full(300, -1)]).astype(np.int32)
    co, ri = _csc(np.concatenate([edges, holes], axis=1), n)
    ri = np.concatenate([ri, np.full(77, -1, np.int32)])
    monkeypatch.setattr(BS, "CHUNK", 333)
    for root in rng.choice(np.flatnonzero(np.diff(co) > 1), 6,
                           replace=False):
        _check(co, ri, int(root))
