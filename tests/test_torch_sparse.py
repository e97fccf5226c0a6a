"""The port's sparse substrate (`repro_torch.sparse`) against the JAX
package's (`repro.sparse`), on the CPU:

  * `segment_sum`, `segment_mean`, `segment_max`, `degree_norm` and
    `gather_scatter` (every `reduce`, with and without weights and a valid
    mask), on ids with empty segments, out-of-range and negative ids;
  * int32 features (C6): `gather_scatter` (sum, weighted, masked, max
    with INT32_MIN empty rows, mean) and fixed-bag `embedding_bag` keep
    JAX's dtypes and values exactly;
  * `embedding_bag` in both layouts (fixed bags padded with -1, flat ids
    with CSR offsets, an empty bag), with and without per-sample weights,
    "sum" and "mean";
  * `NeighborSampler` against JAX's class on a SCALE 8 CSR with isolated
    vertices: the same seed draws the same blocks bit for bit; both raise
    IndexError when they sample a trailing isolated vertex (its row offset
    is past col_idx, ROADMAP C);
  * the JAX index rules the port copies: `at_add` (negative ids wrap, the
    rest out of range drop) and `take_rows` (wrap, NaN past either end).

Inputs: numpy from `np.random.default_rng` seeds.  Tolerances: exact on
integer-valued floats (sums far below 2^24) and on integer outputs;
rtol 1e-5, atol 1e-6 on random floats.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import (NeighborSampler as JaxSampler, degree_norm as
                          jax_degree_norm, embedding_bag as jax_embedding_bag,
                          gather_scatter as jax_gather_scatter,
                          segment_max as jax_segment_max,
                          segment_mean as jax_segment_mean,
                          segment_sum as jax_segment_sum)
from repro_torch.sparse import (NeighborSampler, degree_norm, embedding_bag,
                                gather_scatter, segment_max, segment_mean,
                                segment_sum)
from repro_torch.sparse.segment import at_add, take_rows

N_SEG, E, D = 13, 96, 5
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, exact):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _values(rng, integer, shape):
    if integer:
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(params=["int", "float"])
def seg_data(request):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, N_SEG - 3, E).astype(np.int32)  # top 3 empty
    ids[:4] = [-1, N_SEG, N_SEG + 5, -N_SEG]             # all dropped
    return request.param == "int", ids, _values(rng, request.param == "int",
                                                (E, D))


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("ndim", [1, 2])
def test_segment_ops_equal_jax(seg_data, op, ndim):
    exact, ids, vals = seg_data
    vals = vals if ndim == 2 else vals[:, 0].copy()
    port = {"sum": segment_sum, "mean": segment_mean, "max": segment_max}
    jax_ = {"sum": jax_segment_sum, "mean": jax_segment_mean,
            "max": jax_segment_max}
    got = port[op](_t(vals), _t(ids), N_SEG)
    want = jax_[op](jnp.asarray(vals), jnp.asarray(ids), N_SEG)
    # an empty segment's max is -inf in both
    _close(got, want, exact or op == "max")


def test_segment_ops_on_int_values():
    rng = np.random.default_rng(3)
    ids = rng.integers(-2, N_SEG + 2, E).astype(np.int32)
    vals = rng.integers(-50, 50, (E, D)).astype(np.int32)
    for port, jax_ in ((segment_sum, jax_segment_sum),
                       (segment_max, jax_segment_max),
                       (segment_mean, jax_segment_mean)):
        _close(port(_t(vals), _t(ids), N_SEG),
               jax_(jnp.asarray(vals), jnp.asarray(ids), N_SEG), True)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_gather_scatter_equals_jax(seg_data, reduce, weighted, masked):
    exact, _, h = seg_data
    rng = np.random.default_rng(5)
    n = h.shape[0] // 4
    h = h[:n]
    src = rng.integers(-3, n + 3, E).astype(np.int32)    # clipped gathers
    dst = rng.integers(0, n - 2, E).astype(np.int32)     # two rows empty
    dst[:3] = [-1, -n, n]                                # wrap, wrap, drop
    w = rng.integers(1, 4, E).astype(np.float32) if weighted else None
    valid = rng.random(E) < 0.7 if masked else None
    got = gather_scatter(_t(h), _t(src), _t(dst), n, reduce=reduce,
                         edge_weight=None if w is None else _t(w),
                         valid=None if valid is None else _t(valid))
    want = jax_gather_scatter(jnp.asarray(h), jnp.asarray(src),
                              jnp.asarray(dst), n, reduce=reduce,
                              edge_weight=None if w is None
                              else jnp.asarray(w),
                              valid=None if valid is None
                              else jnp.asarray(valid))
    _close(got, want, exact and reduce != "mean")


# C6: an int32 `h` keeps its dtype through gather_scatter as in JAX
C6_H = np.arange(12, dtype=np.int32).reshape(4, 3)
C6_SRC = np.array([0, 1, 2, 3], np.int32)
C6_DST = np.array([0, 0, 1, 1], np.int32)        # rows 2 and 3 empty
C6_MASK = np.array([True, False, True, True])
C6_W = np.array([0.5, 1.5, 2.5, 0.25], np.float32)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_gather_scatter_int32_keeps_jax_dtype(reduce, weighted, masked):
    """Sums and maxima stay int32 (weighted messages add in float32 and
    the sum truncates once: row 1's 17.5 + 2.5 is 20), an empty row of
    "max" is INT32_MIN, "mean" is float32: dtype and value equal to
    JAX's, exactly."""
    kw = dict(edge_weight=C6_W if weighted else None,
              valid=C6_MASK if masked else None)
    got = gather_scatter(_t(C6_H), _t(C6_SRC), _t(C6_DST), 4, reduce=reduce,
                         **{k: None if v is None else _t(v)
                            for k, v in kw.items()})
    want = jax_gather_scatter(jnp.asarray(C6_H), jnp.asarray(C6_SRC),
                              jnp.asarray(C6_DST), 4, reduce=reduce,
                              **{k: None if v is None else jnp.asarray(v)
                                 for k, v in kw.items()})
    _close(got, want, True)
    assert str(want.dtype) == ("float32" if reduce == "mean" else "int32")
    if reduce == "max":
        assert (got[2:] == np.iinfo(np.int32).min).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_int32_table_keeps_jax_dtype(mode, weighted):
    """A fixed-bag sum of an int32 table is int32 (padding and an empty
    bag add 0 of that dtype); weights or "mean" give float32, as in JAX."""
    table = np.arange(15, dtype=np.int32).reshape(5, 3)
    idx = np.array([[0, 1, -1], [2, 4, 3], [-1, -1, -1]], np.int32)
    w = np.full((3, 3), 0.5, np.float32) if weighted else None
    got = embedding_bag(_t(table), _t(idx), mode=mode,
                        weights=None if w is None else _t(w))
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             mode=mode,
                             weights=None if w is None else jnp.asarray(w))
    _close(got, want, True)


def test_gather_scatter_unknown_reduce_raises():
    with pytest.raises(ValueError, match="median"):
        gather_scatter(torch.ones(4, 2), torch.zeros(3, dtype=torch.int32),
                       torch.zeros(3, dtype=torch.int32), 4, reduce="median")


@pytest.mark.parametrize("masked", [False, True])
def test_degree_norm_equals_jax(masked):
    rng = np.random.default_rng(7)
    n = 20
    dst = rng.integers(-2, n + 2, E).astype(np.int32)
    src = rng.integers(-2, n + 2, E).astype(np.int32)
    valid = rng.random(E) < 0.6 if masked else None
    got = degree_norm(_t(dst), _t(src), n,
                      None if valid is None else _t(valid))
    want = jax_degree_norm(jnp.asarray(dst), jnp.asarray(src), n,
                           None if valid is None else jnp.asarray(valid))
    _close(got, want, False)


def test_jax_index_rules():
    idx = np.array([-1, 4, -5, 2, -4, 3], np.int32)
    vals = np.arange(1, 7, dtype=np.float32)
    _close(at_add(4, _t(idx), _t(vals)),
           jnp.zeros(4).at[jnp.asarray(idx)].add(jnp.asarray(vals),
                                                 mode="drop"), True)
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    _close(take_rows(_t(table), _t(idx)),
           jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0), True)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_embedding_bag_fixed_bags(mode, weighted, integer):
    rng = np.random.default_rng(13)
    V, B, L = 30, 9, 6
    table = _values(rng, integer, (V, D))
    idx = rng.integers(0, V + 4, (B, L)).astype(np.int32)  # some clipped
    idx[rng.random((B, L)) < 0.3] = -1                      # padding
    idx[0] = -1                                             # an empty bag
    w = rng.integers(1, 4, (B, L)).astype(np.float32) if weighted else None
    got = embedding_bag(_t(table), _t(idx), weights=None if w is None
                        else _t(w), mode=mode)
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             weights=None if w is None else jnp.asarray(w),
                             mode=mode)
    _close(got, want, integer and mode == "sum")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_embedding_bag_csr_bags(mode, weighted, integer):
    rng = np.random.default_rng(17)
    V, B = 30, 8
    table = _values(rng, integer, (V, D))
    sizes = rng.integers(0, 6, B)
    sizes[2] = 0                                            # an empty bag
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    nnz = int(offsets[-1]) + 3               # three ids past the last bag
    idx = rng.integers(-2, V + 2, nnz).astype(np.int32)     # clipped
    w = rng.integers(1, 4, nnz).astype(np.float32) if weighted else None
    got = embedding_bag(_t(table), _t(idx), _t(offsets),
                        weights=None if w is None else _t(w), mode=mode)
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(offsets),
                             weights=None if w is None else jnp.asarray(w),
                             mode=mode)
    _close(got, want, integer and mode == "sum")


def test_embedding_bag_segment_ids_equal_jax():
    """The CSR layout's `searchsorted` segment ids, bit for bit (read
    through a one-hot table: bag b's sum counts its ids)."""
    offsets = np.array([0, 0, 3, 3, 7, 8, 8], np.int32)
    nnz = 10
    table = np.eye(nnz, dtype=np.float32)
    idx = np.arange(nnz, dtype=np.int32)
    got = embedding_bag(_t(table), _t(idx), _t(offsets))
    want = jax_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                             jnp.asarray(offsets))
    _close(got, want, True)


def _csr_with_isolated(scale=8, seed=19):
    rng = np.random.default_rng(seed)
    n = 1 << scale
    deg = rng.integers(0, 6, n)
    deg[rng.random(n) < 0.2] = 0                            # isolated
    # a trailing isolated vertex makes both samplers index one past
    # col_idx (test_neighbor_sampler_trailing_isolated_vertex)
    deg[-1] = max(deg[-1], 1)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    col_idx = rng.integers(0, n, int(row_off[-1])).astype(np.int32)
    return n, row_off, col_idx


def test_neighbor_sampler_equals_jax_bit_for_bit():
    n, row_off, col_idx = _csr_with_isolated()
    seeds = np.random.default_rng(23).choice(n, 32, replace=False)
    port, ref = NeighborSampler(row_off, col_idx, seed=5), \
        JaxSampler(row_off, col_idx, seed=5)
    for fanouts in ([15, 10], [3], [4, 2, 2]):
        got, want = port.sample_block(seeds, fanouts), \
            ref.sample_block(seeds, fanouts)
        assert got["fanouts"] == want["fanouts"]
        for a, b in zip(got["nodes"], want["nodes"]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for (s1, d1), (s2, d2) in zip(got["edges"], want["edges"]):
            np.testing.assert_array_equal(s1, s2)
            np.testing.assert_array_equal(d1, d2)
    isolated = np.flatnonzero(np.diff(row_off) == 0)[:5]
    np.testing.assert_array_equal(port.sample_hop(isolated, 3),
                                  np.repeat(isolated[:, None], 3, 1))


def test_neighbor_sampler_trailing_isolated_vertex():
    """Both samplers gather col_idx[row_off[v]] before masking an isolated
    v, which is past the array for a trailing isolated vertex: JAX's class
    raises IndexError there, and so does the port's copy."""
    row_off = np.array([0, 2, 3, 3], np.int64)
    col_idx = np.array([1, 2, 0], np.int32)
    nodes = np.array([0, 2])
    for cls in (NeighborSampler, JaxSampler):
        with pytest.raises(IndexError):
            cls(row_off, col_idx, seed=1).sample_hop(nodes, 2)
