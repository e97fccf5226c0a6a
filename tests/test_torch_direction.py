"""The direction-optimised path as a whole: `DistGraph.from_edges(edges,
BFSConfig(direction=..., fold_codec=...)).session().bfs(root | roots)` on
the CPU equals the JAX package's -- levels, preds, n_levels, edges_scanned
and the `directions` trace -- exactly.

  * 1x1 against the JAX session in this process;
  * 2x2 and 1x4 against one JAX run in a subprocess with four forced host
    devices (tests/dist/torch_parity_ref.py --direction), which computes
    every configuration in one call;
  * the same searches with the kernel wrappers wired in (on CPU tensors
    they run their plain twins), and from the JAX package's own CSC + CSR
    partition through `repro_torch.convert`.

A scalar port search is held to the JAX batch row of its root (the JAX
package's batched search equals its scalar one, its own contract).
Inputs: `repro.graphgen.rmat_edges(jax.random.key(42), 9, 16)` as numpy;
roots from `np.random.default_rng(0)` among degree > 0 vertices.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.core.partition import partition_2d as jax_partition_2d
from repro.core.partition import partition_2d_csr as jax_partition_2d_csr
from repro.core.types import Grid2D as JGrid2D
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.convert import csr_from_partition, graph_from_partition
from repro_torch.core.types import Grid2D
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as KE
from repro_torch.kernels import fold as KF

SCALE, EF = 9, 16
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
CONFIGS = [(d, c) for d in (True, "bottomup") for c in ("list", "bitmap")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny; on a busy machine (a parallel
    test run) torch's intra-op thread pool only waits for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dtag(direction):
    return {False: "td", True: "adaptive"}.get(direction, direction)


@pytest.fixture(scope="module")
def graph_data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, EF))
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, roots


@pytest.fixture(scope="module")
def jax_1x1(graph_data):
    """JAX batched outputs at 1x1, in process, for every configuration."""
    edges, roots = graph_data
    graph = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=N)
    ref = {}
    for direction, codec in CONFIGS + [(False, "bitmap")]:
        out = graph.session(JaxBFSConfig(grid=(1, 1), direction=direction,
                                         fold_codec=codec)).bfs(roots)
        p = f"1x1_{dtag(direction)}_{codec}_batch"
        ref[f"{p}_level"] = np.asarray(out.level)
        ref[f"{p}_pred"] = np.asarray(out.pred)
        ref[f"{p}_n_levels"] = np.asarray(out.n_levels)
        ref[f"{p}_edges"] = np.asarray(out.edges_scanned, np.int64)
        if out.directions is not None:
            ref[f"{p}_directions"] = np.asarray(out.directions)
    return ref


@pytest.fixture(scope="module")
def jax_multi(graph_data, tmp_path_factory):
    """JAX outputs at 2x2 and 1x4 for every configuration, one
    subprocess."""
    edges, roots = graph_data
    d = tmp_path_factory.mktemp("jax_dir_ref")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4", "--direction"], capture_output=True, text=True,
        timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _ref(grid, jax_1x1, jax_multi):
    return jax_1x1 if grid == (1, 1) else jax_multi


def _assert_equal(sess, roots, ref, prefix):
    """Scalar search of each root against its batch row, then the batch."""
    want_dirs = ref.get(f"{prefix}_directions")
    for b, root in enumerate(roots[:2]):
        one = sess.bfs(int(root))
        np.testing.assert_array_equal(one.level.numpy(),
                                      ref[f"{prefix}_level"][b])
        np.testing.assert_array_equal(one.pred.numpy(),
                                      ref[f"{prefix}_pred"][b])
        assert int(one.n_levels) == int(ref[f"{prefix}_n_levels"][b])
        assert one.edges_scanned == int(ref[f"{prefix}_edges"][b])
        if want_dirs is None:
            assert one.directions is None
        else:
            np.testing.assert_array_equal(one.directions.numpy(),
                                          want_dirs[b])
    many = sess.bfs(roots)
    np.testing.assert_array_equal(many.level.numpy(), ref[f"{prefix}_level"])
    np.testing.assert_array_equal(many.pred.numpy(), ref[f"{prefix}_pred"])
    np.testing.assert_array_equal(many.n_levels.numpy(),
                                  ref[f"{prefix}_n_levels"])
    assert list(many.edges_scanned) == ref[f"{prefix}_edges"].tolist()
    if want_dirs is not None:
        np.testing.assert_array_equal(many.directions.numpy(), want_dirs)
    return many


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("direction,codec", CONFIGS)
def test_direction_search_equals_jax(graph_data, jax_1x1, jax_multi, grid,
                                     direction, codec):
    edges, roots = graph_data
    tag = f"{grid[0]}x{grid[1]}"
    graph = DistGraph.from_edges(edges, BFSConfig(grid=grid), device="cpu",
                                 n=N)
    assert graph.csr is None                 # planned lazily
    sess = graph.session(BFSConfig(grid=grid, direction=direction,
                                   fold_codec=codec))
    assert graph.csr is not None and graph.edges is not None
    many = _assert_equal(sess, roots, _ref(grid, jax_1x1, jax_multi),
                         f"{tag}_{dtag(direction)}_{codec}_batch")
    dirs = many.directions.numpy()
    if direction == "bottomup":
        assert set(dirs[dirs >= 0].tolist()) == {1}
    else:                                     # R-MAT: both directions run
        assert set(dirs[dirs >= 0].tolist()) == {0, 1}


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4)])
def test_bitmap_topdown_equals_jax(graph_data, jax_1x1, jax_multi, grid):
    edges, roots = graph_data
    sess = DistGraph.from_edges(
        edges, BFSConfig(grid=grid, fold_codec="bitmap"), device="cpu",
        n=N).session()
    assert sess.graph.csr is None            # top-down plans no CSR
    _assert_equal(sess, roots, _ref(grid, jax_1x1, jax_multi),
                  f"{grid[0]}x{grid[1]}_td_bitmap_batch")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
@pytest.mark.parametrize("direction", [True, "bottomup"])
def test_kernel_wrappers_equal_jax(graph_data, jax_multi, grid, direction):
    """The kernel path's wiring -- `fold_ops` through pack_blocks and the
    bitmap codec, the chunk hooks -- with the wrappers on CPU tensors,
    where they run their plain twins."""
    edges, roots = graph_data
    sess = DistGraph.from_edges(
        edges, BFSConfig(grid=grid, direction=direction,
                         fold_codec="bitmap"), device="cpu", n=N).session()
    eng = sess.engine
    eng.expand_fn, eng.bottomup_fn = KE.expand_chunk, KB.bottomup_chunk
    eng.fold_ops = eng.codec.ops = KF
    _assert_equal(sess, roots, jax_multi,
                  f"{grid[0]}x{grid[1]}_{dtag(direction)}_bitmap_batch")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_from_jax_csr_partition_equals_jax(graph_data, jax_multi, grid):
    """Both packages search the very same CSC and CSR."""
    edges, roots = graph_data
    R, C = grid
    jgrid, tgrid = JGrid2D(R, C, N), Grid2D(R, C, N)
    lg = jax_partition_2d(edges, jgrid)
    csr = jax_partition_2d_csr(edges, jgrid)
    sess = DistGraph.from_partition(
        tgrid, graph_from_partition(tgrid, lg.col_off, lg.row_idx, lg.nnz,
                                    "cpu"),
        BFSConfig(direction=True, fold_codec="bitmap"), n=N,
        csr=csr_from_partition(tgrid, csr["row_off"], csr["col_idx"],
                               csr["nnz"], "cpu")).session()
    _assert_equal(sess, roots, jax_multi, f"{R}x{C}_adaptive_bitmap_batch")


def test_csr_from_partition_checks_shapes():
    grid = Grid2D(2, 2, 16)
    with pytest.raises(ValueError, match="do not fit grid 2x2"):
        csr_from_partition(grid, np.zeros((2, 2, 5), np.int32),
                           np.zeros((2, 2, 3), np.int32),
                           np.zeros((2, 2), np.int32), "cpu")


def test_direction_needs_edges_or_csr(graph_data):
    edges, _ = graph_data
    grid = Grid2D(1, 1, N)
    lg = jax_partition_2d(edges, JGrid2D(1, 1, N))
    graph = DistGraph.from_partition(
        grid, graph_from_partition(grid, lg.col_off, lg.row_idx, lg.nnz,
                                   "cpu"), n=N)
    with pytest.raises(ValueError, match="needs the CSR twin"):
        graph.session(BFSConfig(direction=True))
