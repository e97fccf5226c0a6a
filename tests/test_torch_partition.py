"""The port's `partition_2d` and `partition_2d_csr` (built block by block
in torch) equal the JAX package's (one global lexsort in numpy) at grids
1x1, 2x2, 1x4 and 2x4: col_off / row_off, row_idx / col_idx in the same
order, nnz.  The index maps agree too.  Exact equality.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import partition as JP
from repro.core.types import Grid2D as JGrid2D
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.core import partition as P
from repro_torch.core.types import Grid2D

SCALE, EF = 9, 16
N = 1 << SCALE


@pytest.fixture(scope="module")
def edges():
    return np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, EF))


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_partition_2d_equals_jax(edges, R, C):
    want = JP.partition_2d(edges, JGrid2D(R, C, N))
    got = P.partition_2d(torch.from_numpy(edges.copy()), Grid2D(R, C, N))
    np.testing.assert_array_equal(got.col_off.numpy(), want.col_off)
    np.testing.assert_array_equal(got.row_idx.numpy(), want.row_idx)
    np.testing.assert_array_equal(got.nnz.numpy(), want.nnz)


def test_partition_2d_in_pieces(edges, monkeypatch):
    """Pieces and sort ranges smaller than the edge list give the same
    partition."""
    monkeypatch.setattr(P, "EDGE_PIECE", 1000)
    monkeypatch.setattr(P, "SORT_PIECE", 700)
    want = JP.partition_2d(edges, JGrid2D(2, 4, N), pad_to=9000)
    got = P.partition_2d(torch.from_numpy(edges.copy()), Grid2D(2, 4, N),
                         pad_to=9000)
    np.testing.assert_array_equal(got.row_idx.numpy(), want.row_idx)
    np.testing.assert_array_equal(got.col_off.numpy(), want.col_off)
    with pytest.raises(ValueError, match="pad_to=10"):
        P.partition_2d(torch.from_numpy(edges.copy()), Grid2D(2, 4, N),
                       pad_to=10)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_partition_2d_csr_equals_jax(edges, R, C):
    want = JP.partition_2d_csr(edges, JGrid2D(R, C, N))
    got = P.partition_2d_csr(torch.from_numpy(edges.copy()), Grid2D(R, C, N))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_partition_2d_csr_in_pieces(edges, monkeypatch):
    """Pieces and sort ranges smaller than the edge list give the same CSR
    twin."""
    monkeypatch.setattr(P, "EDGE_PIECE", 1000)
    monkeypatch.setattr(P, "SORT_PIECE", 700)
    want = JP.partition_2d_csr(edges, JGrid2D(2, 4, N), pad_to=9000)
    got = P.partition_2d_csr(torch.from_numpy(edges.copy()), Grid2D(2, 4, N),
                             pad_to=9000)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="pad_to=10"):
        P.partition_2d_csr(torch.from_numpy(edges.copy()), Grid2D(2, 4, N),
                           pad_to=10)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_index_maps_equal_jax(R, C):
    g = np.arange(N, dtype=np.int64)
    grid, jgrid = Grid2D(R, C, N), JGrid2D(R, C, N)
    tg = torch.from_numpy(g)
    for name in ("owner_of", "local_row", "local_col"):
        got = getattr(P, name)(tg, grid)
        want = getattr(JP, name)(g, jgrid)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(a.numpy(), b)
    lr = torch.arange(grid.n_rows_local)
    lc = torch.arange(grid.n_cols_local)
    for i in range(R):
        np.testing.assert_array_equal(
            P.global_from_row(lr, i, grid).numpy(),
            JP.global_from_row(lr.numpy(), i, jgrid))
        for j in range(C):
            np.testing.assert_array_equal(
                P.row2col(lr, i, j, grid).numpy(),
                JP.row2col(lr.numpy(), i, j, jgrid))
    for j in range(C):
        np.testing.assert_array_equal(
            P.global_from_col(lc, j, grid).numpy(),
            JP.global_from_col(lc.numpy(), j, jgrid))
