"""The port's kernels against the JAX package's Pallas kernels.

  * the plain `expand_chunk` equals `repro.kernels.expand.expand_chunk(...,
    interpret=True)` on (v, won, u), every lane, masked lanes included --
    on random CSC blocks and on real chunks of an R-MAT search, at chunk
    lengths that are and are not multiples of 512;
  * the plain `compact_rows` equals `repro.kernels.fold.compact_rows(...,
    interpret=True)`;
  * the plain `bottomup_chunk` equals `repro.kernels.bottomup.
    bottomup_chunk(..., interpret=True)` on (r, c, hit), every lane, and
    the JAX reference scan on its hit lanes; the plain `pack_bits` /
    `unpack_bits` equal `repro.kernels.fold.pack_bits` / `unpack_bits`
    (interpret mode), S % 32 != 0 included;
  * CPU tensors take the plain version and launch nothing; "kernel" on the
    CPU raises.

The kernels themselves run only on a card: tests/test_torch_gpu.py.

Everything is integer, so every comparison is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.kernels.bottomup import bottomup_chunk as jax_bottomup_chunk
from repro.kernels.expand import expand_chunk as jax_expand_chunk
from repro.kernels.fold import compact_rows as jax_compact_rows
from repro.kernels.fold import pack_bits as jax_pack_bits
from repro.kernels.fold import unpack_bits as jax_unpack_bits
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.core import frontier as F
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as K
from repro_torch.kernels import fold as KF
from repro_torch.kernels.select import resolve_path

SCALE = 8


def _random_block(rng, ncl, n_rows, front_total, max_deg=9):
    deg = rng.integers(0, max_deg, size=ncl).astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = max(int(col_off[-1]), 1)
    row_idx = rng.integers(0, n_rows, size=nnz + 5).astype(np.int32)
    row_idx[nnz:] = -1                                   # padding
    front = np.full(ncl, -1, np.int32)
    front[:front_total] = rng.permutation(ncl)[:front_total]
    visited = rng.random(n_rows) < 0.3
    return col_off, row_idx, front, visited


def _both_expand(col_off, row_idx, front, front_total, visited, start, E):
    """(jax (v, won, u), port (v, won, u)) as numpy for one chunk."""
    ncl = front.shape[0]
    fr = np.clip(front, 0, ncl - 1)
    deg = np.where(np.arange(ncl) < front_total,
                   col_off[fr + 1] - col_off[fr], 0)
    cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    words = np.asarray(F.pack_bitmap(torch.from_numpy(visited)))
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    jv, jwon, ju = jax_expand_chunk(
        gids, jnp.asarray(cumul), jnp.asarray(front), jnp.int32(front_total),
        jnp.asarray(col_off), jnp.asarray(row_idx), jnp.asarray(visited),
        jnp.asarray(words.view(np.uint32)), interpret=True)
    tv, twon, tu = K.expand_chunk(
        start, E, torch.from_numpy(cumul), torch.from_numpy(front),
        torch.tensor(front_total, dtype=torch.int32),
        torch.from_numpy(col_off), torch.from_numpy(row_idx),
        torch.from_numpy(words))
    return ((np.asarray(jv), np.asarray(jwon), np.asarray(ju)),
            (tv.numpy(), twon.numpy(), tu.numpy()))


@pytest.mark.parametrize("ncl,front_total,E,start", [
    (64, 64, 512, 0),        # full frontier, one tile
    (64, 0, 256, 0),         # empty frontier: every lane masked
    (100, 37, 1000, 0),      # chunk not a multiple of 512 (tile 500)
    (50, 20, 96, 64),        # small tile, chunk starting mid-frontier
    (200, 150, 1536, 512),   # three tiles, masked tail
])
def test_plain_expand_chunk_equals_pallas(ncl, front_total, E, start, rng):
    col_off, row_idx, front, visited = _random_block(rng, ncl, 300,
                                                     front_total)
    (jv, jwon, ju), (tv, twon, tu) = _both_expand(
        col_off, row_idx, front, front_total, visited, start, E)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(twon, jwon)
    np.testing.assert_array_equal(tu, ju)


def test_plain_expand_chunk_real_chunks():
    """Real chunks: each level of an R-MAT search at 1x1, frontier and
    visited set taken from the finished search's levels."""
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, 16))
    n = 1 << SCALE
    graph = DistGraph.from_edges(edges, BFSConfig(), device="cpu", n=n)
    deg = np.bincount(edges[0], minlength=n)
    root = int(np.random.default_rng(0).choice(np.flatnonzero(deg > 0)))
    level = graph.session().bfs(root).level.numpy()
    col_off = graph.csc.col_off[0, 0].numpy()
    row_idx = graph.csc.row_idx[0, 0].numpy()
    for lvl in range(int(level.max()) + 1):
        members = np.flatnonzero(level == lvl).astype(np.int32)
        front = np.full(n, -1, np.int32)
        front[:members.size] = members
        visited = (level >= 0) & (level <= lvl)
        total = int((col_off[members + 1] - col_off[members]).sum())
        for start, E in ((0, 1000), (0, 2048), (max(total - 700, 0), 1024)):
            (jv, jwon, ju), (tv, twon, tu) = _both_expand(
                col_off, row_idx, front, members.size, visited, start, E)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(twon, jwon)
            np.testing.assert_array_equal(tu, ju)


def _random_rows(rng, N, S, p):
    mask = rng.random((N, S)) < p
    a = rng.integers(-5, 1000, size=(N, S)).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, size=(N, S)).astype(np.int32)
    return mask, a, b


@pytest.mark.parametrize("N,S,p", [(1, 1000, 0.5), (3, 77, 0.0),
                                   (2, 64, 1.0), (4, 513, 0.1)])
def test_plain_compact_rows_equals_pallas(N, S, p, rng):
    mask, a, b = _random_rows(rng, N, S, p)
    (ja, jb), jc = jax_compact_rows(jnp.asarray(mask),
                                    (jnp.asarray(a), jnp.asarray(b)),
                                    (-1, 7), interpret=True)
    (ta, tb), tc = KF.compact_rows(torch.from_numpy(mask),
                                   (torch.from_numpy(a), torch.from_numpy(b)),
                                   (-1, 7))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_plain_compact_rows_real_exchange_row():
    """The main path's shape: one row of R padded frontier blocks, as
    `compact_blocks` hands it to the kernel."""
    rng = np.random.default_rng(3)
    R, S = 4, 256
    vals = rng.integers(0, 1024, size=(R, S)).astype(np.int32)
    cnts = np.array([0, 256, 17, 100], np.int32)
    mask = np.arange(S)[None, :] < cnts[:, None]
    (jo,), _ = jax_compact_rows(jnp.asarray(mask.reshape(1, -1)),
                                (jnp.asarray(vals.reshape(1, -1)),), (-1,),
                                interpret=True)
    out, total = F.compact_blocks(torch.from_numpy(vals),
                                  torch.from_numpy(cnts), ops=KF)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jo)[0])
    assert int(total) == int(cnts.sum())


def _bottomup_inputs(rng, nrl, ncl, block, frontier_frac, e_max=None):
    """Random CSR, a blocked frontier bitmap and a MASKED-degree workload
    (some rows visited, their degree zeroed), as in tests/test_direction.py;
    words as int32 bit patterns."""
    deg = rng.integers(0, 6, size=nrl)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    e_max = e_max or 6 * nrl
    col_idx = rng.integers(0, ncl, size=max(e_max, 1)).astype(np.int32)
    mask = rng.random(ncl) < frontier_frac
    W = (block + 31) // 32
    words = np.zeros(((ncl + block - 1) // block) * W, np.uint32)
    for c in np.flatnonzero(mask):
        blk, off = c // block, c % block
        words[blk * W + (off >> 5)] |= np.uint32(1) << np.uint32(off & 31)
    visited = rng.random(nrl) < 0.3
    cumul = np.concatenate(
        [[0], np.cumsum(np.where(visited, 0, deg))]).astype(np.int32)
    return row_off, col_idx, words.view(np.int32), cumul


def _both_bottomup(row_off, col_idx, words, cumul, total, start, E, block):
    """(jax kernel (r, c, hit), jax reference, port plain) as numpy."""
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    jargs = (jnp.asarray(cumul), jnp.int32(total), jnp.asarray(row_off),
             jnp.asarray(col_idx), jnp.asarray(words.view(np.uint32)))
    kern = jax_bottomup_chunk(gids, *jargs, block=block, interpret=True)
    ref = JF.reference_bottomup_chunk(gids, *jargs, block=block)
    got = KB.bottomup_chunk(
        start, E, torch.from_numpy(cumul),
        torch.tensor(total, dtype=torch.int32), torch.from_numpy(row_off),
        torch.from_numpy(col_idx), torch.from_numpy(words), block=block)
    return ([np.asarray(x) for x in kern], [np.asarray(x) for x in ref],
            [x.numpy() for x in got])


@pytest.mark.parametrize("block", [37, 64])
@pytest.mark.parametrize("frontier_frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("chunk", ["one_tile", "ragged", "straddle",
                                   "zero_total"])
def test_plain_bottomup_chunk_equals_pallas(block, frontier_frac, chunk):
    """Chunks: one 512-lane tile; 1000 lanes (tile 500); 384 lanes
    straddling the live total; total = 0 (every lane masked)."""
    rng = np.random.default_rng(block * 10 + int(frontier_frac * 10))
    nrl = ncl = 2 * block
    row_off, col_idx, words, cumul = _bottomup_inputs(rng, nrl, ncl, block,
                                                      frontier_frac)
    if chunk == "zero_total":
        cumul = np.zeros_like(cumul)
    total = int(cumul[-1])
    start, E = {"one_tile": (0, 512), "ragged": (0, 1000),
                "straddle": (max(total - 100, 0), 384),
                "zero_total": (0, 256)}[chunk]
    kern, ref, got = _both_bottomup(row_off, col_idx, words, cumul, total,
                                    start, E, block)
    for k, g in zip(kern, got):              # every lane, masked included
        np.testing.assert_array_equal(g, k)
    hit = got[2]
    np.testing.assert_array_equal(hit, ref[2])
    for x, y in zip(ref[:2], got[:2]):       # the reference on hit lanes
        np.testing.assert_array_equal(np.where(hit, y, 0),
                                      np.where(hit, x, 0))
    live = start + np.arange(E) < total
    assert live.any() == (chunk != "zero_total") and not live.all()


@pytest.mark.parametrize("S", [1, 31, 32, 33, 65])
@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_plain_pack_unpack_bits_equal_pallas(S, p, rng):
    mask = rng.random((3, S)) < p
    jw = np.asarray(jax_pack_bits(jnp.asarray(mask), interpret=True))
    tw = KF.pack_bits(torch.from_numpy(mask))
    assert tw.dtype == torch.int32 and tw.shape == (3, (S + 31) // 32)
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), jw)
    jb = np.asarray(jax_unpack_bits(jnp.asarray(jw), S, interpret=True))
    tb = KF.unpack_bits(tw, S)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(tb.numpy(), mask)


def test_cpu_tensors_launch_nothing(rng):
    counters = (K.expand_chunk, KF.compact_rows, KF.pack_bits,
                KF.unpack_bits, KB.bottomup_chunk)
    before = [f.launches for f in counters]
    col_off, row_idx, front, visited = _random_block(rng, 32, 100, 10)
    _both_expand(col_off, row_idx, front, 10, visited, 0, 512)
    mask, a, _ = _random_rows(rng, 2, 50, 0.5)
    KF.compact_rows(torch.from_numpy(mask), (torch.from_numpy(a),), (-1,))
    KF.unpack_bits(KF.pack_bits(torch.from_numpy(mask)), 50)
    row_off, col_idx, words, cumul = _bottomup_inputs(rng, 64, 64, 37, 0.5)
    _both_bottomup(row_off, col_idx, words, cumul, int(cumul[-1]), 0, 128,
                   37)
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), 6, 4))
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)), device="cpu")
    graph.session().bfs(int(edges[0, 0]))
    graph.session(BFSConfig(grid=(2, 2), direction="bottomup",
                            fold_codec="bitmap")).bfs(int(edges[0, 0]))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("knob", ["expand", "fold", "bottomup"])
def test_kernel_path_on_cpu_raises(knob):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_path("kernel", "cpu", knob=knob)
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), 6, 4))
    graph = DistGraph.from_edges(edges, BFSConfig(), device="cpu")
    with pytest.raises(ValueError, match=f"{knob}='kernel' needs a CUDA"):
        graph.session(BFSConfig(**{knob: "kernel"}))
    assert resolve_path("auto", "cpu", knob=knob) == "reference"
    assert resolve_path("reference", "cpu", knob=knob) == "reference"


@pytest.mark.parametrize("N,S,p", [(1, 70, 0.5), (4, 33, 0.0), (3, 64, 1.0),
                                   (5, 1000, 0.3)])
def test_row_prefix_is_the_row_cumsum(N, S, p, rng):
    """The compaction's flat-scan row prefix equals a per-row cumsum."""
    mask = torch.from_numpy(rng.random((N, S)) < p)
    assert torch.equal(KF.row_prefix(mask),
                       torch.cumsum(mask, dim=1, dtype=torch.int32))
