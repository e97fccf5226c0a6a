"""The port's main path as a whole: `DistGraph.from_edges(edges,
BFSConfig(grid=...)).session().bfs(root | roots)` on the CPU equals the JAX
package's, scalar and batched -- levels, preds, n_levels, edges_scanned --
exactly.

  * 1x1 against the JAX session in this process;
  * 2x2 and 1x4 against a JAX run in a subprocess with four forced host
    devices (tests/dist/torch_parity_ref.py; this process keeps one JAX
    device), also through `DistGraph.from_partition` fed the JAX partition,
    at edge_chunk 64 and 8192, and with dedup="sort";
  * the port's `validate_bfs` passes on good output and raises on a
    corrupted pred.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(42), 9, 16)` as numpy;
roots from `np.random.default_rng(0)` among degree > 0 vertices.
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.core.partition import partition_2d as jax_partition_2d
from repro.core.types import Grid2D as JGrid2D
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.convert import graph_from_partition
from repro_torch.core.types import Grid2D
from repro_torch.core.validate import (EdgeIndex, count_component_edges,
                                       harmonic_mean, validate_bfs)

SCALE, EF = 9, 16
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny; on a busy machine (a parallel
    test run) torch's intra-op thread pool only waits for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graph_data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, EF))
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, roots


@pytest.fixture(scope="module")
def jax_multi(graph_data, tmp_path_factory):
    """JAX outputs at 2x2 and 1x4, from one subprocess."""
    edges, roots = graph_data
    d = tmp_path_factory.mktemp("jax_ref")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _assert_equal(out, ref, tag, kind):
    np.testing.assert_array_equal(out.level.numpy(), ref[f"{tag}_{kind}_level"])
    np.testing.assert_array_equal(out.pred.numpy(), ref[f"{tag}_{kind}_pred"])
    np.testing.assert_array_equal(out.n_levels.numpy(),
                                  ref[f"{tag}_{kind}_n_levels"])
    want = ref[f"{tag}_{kind}_edges"]
    got = out.edges_scanned
    assert (list(got) if kind == "batch" else got) == want.tolist()


def test_1x1_equals_jax_in_process(graph_data):
    edges, roots = graph_data
    jsess = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)),
                                    n=N).session()
    sess = DistGraph.from_edges(edges, BFSConfig(grid=(1, 1)), device="cpu",
                                n=N).session()
    one = sess.bfs(int(roots[0]))
    jone = jsess.bfs(int(roots[0]))
    jmany = jsess.bfs(roots)
    ref = {"1x1_scalar_level": np.asarray(jone.level),
           "1x1_scalar_pred": np.asarray(jone.pred),
           "1x1_scalar_n_levels": np.asarray(jone.n_levels),
           "1x1_scalar_edges": np.asarray(jone.edges_scanned),
           "1x1_batch_level": np.asarray(jmany.level),
           "1x1_batch_pred": np.asarray(jmany.pred),
           "1x1_batch_n_levels": np.asarray(jmany.n_levels),
           "1x1_batch_edges": np.asarray(jmany.edges_scanned)}
    _assert_equal(one, ref, "1x1", "scalar")
    assert isinstance(one.edges_scanned, int) and one.edges_scanned > 0
    _assert_equal(sess.bfs(roots), ref, "1x1", "batch")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
@pytest.mark.parametrize("edge_chunk", [64, 8192])
def test_grid_equals_jax(graph_data, jax_multi, grid, edge_chunk):
    edges, roots = graph_data
    tag = f"{grid[0]}x{grid[1]}"
    sess = DistGraph.from_edges(
        edges, BFSConfig(grid=grid, edge_chunk=edge_chunk), device="cpu",
        n=N).session()
    _assert_equal(sess.bfs(int(roots[0]), validate=True), jax_multi, tag,
                  "scalar")
    _assert_equal(sess.bfs(roots, validate=True), jax_multi, tag, "batch")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_from_jax_partition_equals_jax(graph_data, jax_multi, grid):
    """Both packages search the very same partition."""
    edges, roots = graph_data
    R, C = grid
    lg = jax_partition_2d(edges, JGrid2D(R, C, N))
    tgrid = Grid2D(R, C, N)
    csc = graph_from_partition(tgrid, lg.col_off, lg.row_idx, lg.nnz, "cpu")
    sess = DistGraph.from_partition(tgrid, csc, BFSConfig(dedup="sort"),
                                    n=N).session()
    tag = f"{R}x{C}"
    _assert_equal(sess.bfs(int(roots[0])), jax_multi, tag, "scalar")
    _assert_equal(sess.bfs(roots), jax_multi, tag, "batch")


def test_reference_paths_equal_auto(graph_data, jax_multi):
    edges, roots = graph_data
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)), device="cpu",
                                 n=N)
    sess = graph.session(BFSConfig(grid=(2, 2), expand="reference",
                                   fold="reference"))
    _assert_equal(sess.bfs(roots), jax_multi, "2x2", "batch")


def test_validate_bfs_and_teps(graph_data):
    edges, roots = graph_data
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)), device="cpu",
                                 n=N)
    out = graph.session().bfs(int(roots[0]))
    te = torch.from_numpy(edges.copy())
    index = EdgeIndex(te, N)
    validate_bfs(te, out.level, out.pred, int(roots[0]), index=index)
    validate_bfs(te, out.level, out.pred, int(roots[0]))
    from repro.core.validate import count_component_edges as jax_count
    assert count_component_edges(te, out.level) == jax_count(
        edges, out.level.numpy())
    assert harmonic_mean([1.0, 3.0]) == pytest.approx(1.5)

    visited = torch.nonzero(out.level > 0).flatten()
    v = int(visited[len(visited) // 2])
    for bad_pred, msg in ((v, "tree edge not level+1"),
                          (-1, "pred/level visited sets differ")):
        pred = out.pred.clone()
        pred[v] = bad_pred
        with pytest.raises(AssertionError, match=re.escape(msg)):
            validate_bfs(te, out.level, pred, int(roots[0]), index=index)
    # a parent one level up that is not a neighbour of v
    lv = int(out.level[v])
    nbrs = set(edges[0][edges[1] == v].tolist())
    fake = next(int(w) for w in torch.nonzero(out.level == lv - 1).flatten()
                if int(w) not in nbrs)
    pred = out.pred.clone()
    pred[v] = fake
    with pytest.raises(AssertionError, match="tree edge not in graph"):
        validate_bfs(te, out.level, pred, int(roots[0]), index=index)


def _without_tree_edge(edges, level, root):
    """The edge list with every copy of one tree edge (both directions)
    removed: root to a vertex at level 1, whose parent is the root on every
    grid."""
    v = int(np.flatnonzero(level == 1)[0])
    p = root
    drop = ((edges[0] == p) & (edges[1] == v)) | \
        ((edges[0] == v) & (edges[1] == p))
    return np.ascontiguousarray(edges[:, ~drop])


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_validate_takes_an_edge_array(graph_data, grid):
    """bfs(validate=) takes False, True or a (2, E) edge array, numpy or
    tensor, scalar root and batch alike, as the JAX session does
    (tests/test_algos.py::test_validate_flag_runs_graph500_rules); an array
    with a tree edge removed raises AssertionError, in both packages; an
    array's EdgeIndex is not cached on the graph."""
    edges, roots = graph_data
    graph = DistGraph.from_edges(edges, BFSConfig(grid=grid), device="cpu",
                                 n=N)
    sess = graph.session()
    one = sess.bfs(int(roots[0]), validate=edges)
    sess.bfs(roots, validate=torch.from_numpy(edges.copy()))
    sess.bfs(roots, validate=False)
    assert graph._edge_index is None
    sess.bfs(int(roots[0]), validate=True)
    assert graph._edge_index is not None
    bad = _without_tree_edge(edges, one.level.numpy(), int(roots[0]))
    for arg in (bad, torch.from_numpy(bad)):
        with pytest.raises(AssertionError, match="tree edge not in graph"):
            sess.bfs(int(roots[0]), validate=arg)
        with pytest.raises(AssertionError, match="tree edge not in graph"):
            sess.bfs(roots, validate=arg)
    # the witness: the JAX session on the same edges and roots
    jsess = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)),
                                    n=N).session()
    jone = jsess.bfs(int(roots[0]), validate=edges)
    np.testing.assert_array_equal(np.asarray(jone.level), one.level.numpy())
    jsess.bfs(roots, validate=edges)
    with pytest.raises(AssertionError, match="tree edge not in graph"):
        jsess.bfs(int(roots[0]), validate=bad)
    with pytest.raises(AssertionError, match="tree edge not in graph"):
        jsess.bfs(roots, validate=bad)
