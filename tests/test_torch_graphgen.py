"""The port's graph generation and CSR / CSC construction against the JAX
package's (`repro.graphgen`), on the CPU, exactly:

  * `degrees`, `build_csc`, `build_csr` and `build_csc_np` array for array
    and dtype for dtype on R-MAT edges, with duplicate edges, empty
    columns and n_cols above the largest id, and with placement pieces
    smaller than the edge list;
  * the int32-offset limit: a ValueError past 2^31 - 1 edges (through the
    check itself, nothing allocated), where JAX's cumsum wraps;
  * `make_undirected` equal to JAX's; `permute_labels` equal to perm[edges]
    for its generator's permutation, a bijection keeping the sorted degree
    sequence;
  * `REALWORLD_SPECS` equal to JAX's, and `realworld_analog`'s meta, n and
    edge shape equal to JAX's for all four graphs at reductions 14 and 20;
  * `rmat_edges`'s shape, range, symmetry and skew as tests/test_graphgen.py
    checks the JAX generator's.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(k), SCALE <= 10, EF)` as
numpy, and `np.random.default_rng` draws.
"""
import jax
import numpy as np
import pytest
import torch

from repro import graphgen as JG
from repro.graphgen.build import build_csc_np as jax_build_csc_np
from repro_torch import graphgen as G
from repro_torch.graphgen import build as B


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _equal(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _cases():
    rng = np.random.default_rng(0)
    rmat = np.asarray(JG.rmat_edges(jax.random.key(1), 10, 8))
    dup = rng.integers(0, 20, (2, 300)).astype(np.int32)
    dup = np.concatenate([dup, dup[:, :50], dup[:, :7]], axis=1)
    sparse = np.stack([rng.choice([3, 9, 41], 200),
                       rng.integers(0, 64, 200)]).astype(np.int32)
    return {"rmat": (rmat, 1 << 10), "duplicates": (dup, 20),
            "empty_columns": (sparse, 64), "n_above_max": (dup, 37),
            "no_edges": (np.zeros((2, 0), np.int32), 5)}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_degrees_and_csc_equal_jax(case):
    edges, n = CASES[case]
    _equal(G.degrees(_t(edges[0]), n), JG.degrees(edges[0], n))
    co, ri = G.build_csc(_t(edges), n)
    jco, jri = JG.build_csc(edges, n)
    _equal(co, jco)
    _equal(ri, jri)
    ro, ci = G.build_csr(_t(edges), n)
    jro, jci = JG.build_csr(edges, n)
    _equal(ro, jro)
    _equal(ci, jci)
    for got, want in zip(B.build_csc_np(edges, n),
                         jax_build_csc_np(edges, n)):
        _equal(got, want)


def test_build_csc_in_pieces(monkeypatch):
    """Placement pieces smaller than the edge list (columns straddling
    them) give the same CSC."""
    edges, n = CASES["rmat"]
    monkeypatch.setattr(B, "EDGE_PIECE", 777)
    co, ri = G.build_csc(_t(edges), n)
    jco, jri = JG.build_csc(edges, n)
    _equal(co, jco)
    _equal(ri, jri)


def test_int32_offset_limit():
    """2^31 - 1 edges fit int32 offsets; 2^31 (R-MAT SCALE 26, edgefactor
    16, symmetrised) raise the ValueError naming the limit, where JAX's
    int32 cumsum wraps to INT32_MIN."""
    B.check_int32_offsets(2**31 - 1)
    with pytest.raises(ValueError, match="int32 offsets"):
        B.check_int32_offsets(2**31)
    wrapped = np.cumsum(np.array([2**30, 2**30], np.int64)).astype(np.int32)
    assert wrapped[-1] == np.iinfo(np.int32).min

    class Row:                       # a row of 2^31 ids, never built
        shape = (2**31,)
        device = torch.device("cpu")

    class Huge:                      # the (2, 2^31) edge list
        shape = (2, 2**31)

        def __getitem__(self, k):
            return Row()

    with pytest.raises(ValueError, match="2\\^31 - 1"):
        G.build_csc(Huge(), 1 << 26)


def test_source_ids_past_n_cols_raise():
    """`degrees` drops ids past n as JAX's scatter does; `build_csc` then
    raises (JAX's offsets would no longer cover the edges)."""
    edges, _ = CASES["duplicates"]
    _equal(G.degrees(_t(edges[0]), 10), JG.degrees(edges[0], 10))
    with pytest.raises(ValueError, match="lie in"):
        G.build_csc(_t(edges), 10)


def test_make_undirected_equals_jax():
    edges = np.asarray(JG.rmat_edges(jax.random.key(2), 8, 4,
                                     undirected=False))
    _equal(G.make_undirected(_t(edges)),
           JG.make_undirected(jax.numpy.asarray(edges)))


def test_permute_labels_is_its_generators_permutation():
    edges, n = CASES["rmat"]
    got = G.permute_labels(_t(edges), n,
                           torch.Generator().manual_seed(5))
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(5))
    _equal(got, perm.to(torch.int32)[_t(edges).long()].numpy())
    # a bijection: distinct labels stay distinct, degrees move with them
    ids = np.unique(edges)
    assert np.unique(got.numpy()).size == ids.size
    np.testing.assert_array_equal(
        np.sort(np.bincount(got.numpy()[0], minlength=n)),
        np.sort(np.bincount(edges[0], minlength=n)))
    # the default generator is seeded, so the relabelling is reproducible
    assert torch.equal(G.permute_labels(_t(edges), n),
                       G.permute_labels(_t(edges), n))


def test_realworld_specs_equal_jax():
    assert G.REALWORLD_SPECS == JG.REALWORLD_SPECS


@pytest.mark.parametrize("reduction", [14, 20])
@pytest.mark.parametrize("name", sorted(JG.REALWORLD_SPECS))
def test_realworld_analog_matches_jax(name, reduction):
    edges, n, meta = G.realworld_analog(
        name, torch.Generator().manual_seed(0), scale_reduction=reduction,
        device="cpu")
    jedges, jn, jmeta = JG.realworld_analog(name, jax.random.key(0),
                                            scale_reduction=reduction)
    assert (meta, n) == (jmeta, jn)
    assert tuple(edges.shape) == tuple(jedges.shape)
    assert edges.dtype == torch.int32
    assert int(edges.min()) >= 0 and int(edges.max()) < n


def test_rmat_shape_range_symmetry_skew():
    n = 1 << 10
    e = G.rmat_edges(10, 16, torch.Generator().manual_seed(0), "cpu")
    assert tuple(e.shape) == (2, 2 * 16 * n) and e.dtype == torch.int32
    assert int(e.min()) >= 0 and int(e.max()) < n
    half = e.shape[1] // 2
    assert torch.equal(e[0, :half], e[1, half:])
    assert torch.equal(e[1, :half], e[0, half:])
    deg = G.degrees(e[0], n).double()
    assert float(deg.max()) > 8 * float(deg.mean())
    again = G.rmat_edges(10, 16, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(e, again)
