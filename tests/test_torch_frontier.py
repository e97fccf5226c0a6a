"""The port's frontier ops and stacked-grid exchanges, op by op against the
JAX package's jnp functions (`repro.core.frontier`, `repro.dist`), in
process, on random inputs: empty and full frontiers, S % 32 != 0, bit 31
set in the bitmaps.  The port keeps bitmaps as int32 bit patterns, compared
here as uint32 through numpy views.  Exact equality throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as JF
from repro.core.types import Grid2D as JGrid2D
from repro.dist.strategy import emulate_exchange
from repro.kernels.expand import make_expand_fn
from repro_torch.core import frontier as F
from repro_torch.core.types import Grid2D
from repro_torch.dist import exchange as X
from repro_torch.dist.topology import StackedTopology
from repro_torch.kernels import expand as K
from repro_torch.kernels import fold as KF


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def sink(x):
    """Per-vertex state with the port's trailing sink slot."""
    t = T(x)
    return torch.cat([t, torch.zeros(1, dtype=t.dtype)])


@pytest.mark.parametrize("n", [0, 1, 100])
def test_exclusive_cumsum(n, rng):
    x = rng.integers(0, 50, size=n).astype(np.int32)
    eq(F.exclusive_cumsum(T(x)), JF.exclusive_cumsum(jnp.asarray(x)))


@pytest.mark.parametrize("cnts", [[0, 0, 0], [40, 40, 40], [3, 0, 40],
                                  [1, 39, 17]])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_compact_blocks(cnts, kernel_ops, rng):
    vals = rng.integers(0, 999, size=(3, 40)).astype(np.int32)
    cnts = np.asarray(cnts, np.int32)
    out, total = F.compact_blocks(T(vals), T(cnts),
                                  ops=KF if kernel_ops else None)
    jout, jtotal = JF.compact_blocks(jnp.asarray(vals), jnp.asarray(cnts))
    eq(out, jout)
    assert int(total) == int(jtotal)


@pytest.mark.parametrize("method", ["scatter", "sort"])
@pytest.mark.parametrize("p_elig", [0.0, 0.5, 1.0])
def test_winner_dedup(method, p_elig, rng):
    v = rng.integers(0, 30, size=500).astype(np.int32)
    elig = rng.random(500) < p_elig
    eq(F.winner_dedup(T(v), T(elig), 30, method),
       JF.winner_dedup(jnp.asarray(v), jnp.asarray(elig), 30, method))


@pytest.mark.parametrize("cap,fill", [(64, 0), (64, 50), (8, 3)])
def test_bucket_append(cap, fill, rng):
    C = 4
    dst = np.full((C, cap), -1, np.int32)
    cnt = np.minimum(rng.integers(0, fill + 1, size=C), cap).astype(np.int32)
    for c in range(C):
        dst[c, :cnt[c]] = rng.integers(0, 100, size=cnt[c])
    v = rng.integers(0, 100, size=200).astype(np.int32)
    tgt = rng.integers(0, C, size=200).astype(np.int32)
    take = rng.random(200) < 0.4
    d, c = F.bucket_append(T(dst), T(cnt), T(v), T(tgt), T(take), C)
    jd, jc = JF.bucket_append(jnp.asarray(dst), jnp.asarray(cnt),
                              jnp.asarray(v), jnp.asarray(tgt),
                              jnp.asarray(take), C)
    eq(d, jd)
    eq(c, jc)
    buf = np.full(50, -1, np.int32)
    b, c = F.append_padded(T(buf), torch.tensor(3, dtype=torch.int32),
                           T(v[:60]), T(take[:60]))
    jb, jc = JF.append_padded(jnp.asarray(buf), jnp.int32(3),
                              jnp.asarray(v[:60]), jnp.asarray(take[:60]))
    eq(b, jb)
    assert int(c) == int(jc)


@pytest.mark.parametrize("S", [1, 31, 32, 33, 100])
def test_pack_unpack_bitmap(S, rng):
    mask = rng.random((3, S)) < 0.5
    mask[:, -1] = True                          # the last bit of a word
    if S >= 32:
        mask[:, 31] = True                      # bit 31 of word 0
    words = F.pack_bitmap(T(mask))
    jwords = JF.pack_bitmap(jnp.asarray(mask))
    eq(words.numpy().view(np.uint32), jwords)
    eq(F.unpack_bitmap(words, S), JF.unpack_bitmap(jwords, S))


def test_set_bits_bit31(rng):
    n = 200
    visited = rng.random(n) < 0.3
    words = F.pack_bitmap(T(visited))
    jwords = JF.pack_bitmap(jnp.asarray(visited))
    v = np.array([31, 63, 0, 5, 191, 95], np.int32)      # bits 31 included
    v = v[~visited[v]]
    take = np.ones(v.shape, bool)
    take[-1] = False
    got = F.set_bits(words, T(v), T(take))
    want = JF.set_bits(jwords, jnp.asarray(v), jnp.asarray(take))
    eq(got.numpy().view(np.uint32), want)
    assert (got.numpy().view(np.uint32) >> 31).any()


def _csc(rng, ncl, n_rows, max_deg=6):
    deg = rng.integers(0, max_deg, size=ncl).astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    row_idx = np.full(int(col_off[-1]) + 3, -1, np.int32)
    row_idx[:col_off[-1]] = rng.integers(0, n_rows, size=col_off[-1])
    return col_off, row_idx


@pytest.mark.parametrize("front_total", [0, 13, 64])
def test_reference_expand_chunk(front_total, rng):
    col_off, row_idx = _csc(rng, 64, 128)
    front = np.full(64, -1, np.int32)
    front[:front_total] = rng.permutation(64)[:front_total]
    fr = np.clip(front, 0, 63)
    deg = np.where(np.arange(64) < front_total, col_off[fr + 1] - col_off[fr],
                   0)
    cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    gids = np.arange(300, dtype=np.int32)
    got = F.reference_expand_chunk(T(gids), T(cumul), T(front),
                                   torch.tensor(front_total,
                                                dtype=torch.int32),
                                   T(col_off), T(row_idx))
    want = JF.reference_expand_chunk(jnp.asarray(gids), jnp.asarray(cumul),
                                     jnp.asarray(front),
                                     jnp.int32(front_total),
                                     jnp.asarray(col_off),
                                     jnp.asarray(row_idx))
    for g, w in zip(got, want):
        eq(g, w)


@pytest.mark.parametrize("front_total", [0, 20, 64])
@pytest.mark.parametrize("through_kernel", [False, True])
def test_expand_frontier(front_total, through_kernel, rng):
    """The chunk loop, plain scan or through the kernel wrapper (its plain
    version on CPU tensors, with the incrementally kept bitmap), against
    the JAX loop with the Pallas kernel in interpret mode."""
    grid = Grid2D(2, 2, 128)            # S = 32, n_rows 64, ncl 64
    i, j = 1, 0
    col_off, row_idx = _csc(rng, 64, 64)
    front = np.full(64, -1, np.int32)
    front[:front_total] = rng.permutation(64)[:front_total]
    visited = rng.random(64) < 0.2
    level = np.where(visited, 0, -1).astype(np.int32)
    pred = np.where(visited, 7, -1).astype(np.int32)
    ex = F.expand_frontier(
        T(col_off), T(row_idx), sink(visited), sink(level), sink(pred),
        T(front), torch.tensor(front_total, dtype=torch.int32), 3,
        grid=grid, i=i, j=j, edge_chunk=40,
        expand_fn=K.expand_chunk if through_kernel else None)
    jex = JF.expand_frontier(
        jnp.asarray(col_off), jnp.asarray(row_idx), jnp.asarray(visited),
        jnp.asarray(level), jnp.asarray(pred), jnp.asarray(front),
        jnp.int32(front_total), jnp.int32(3),
        grid=JGrid2D(2, 2, 128), i=i, j=j, edge_chunk=40,
        expand_fn=make_expand_fn(path="pallas-interpret")
        if through_kernel else None)
    for got, want in zip(ex[:3], jex[:3]):
        eq(got[:-1], want)
    eq(ex.dst, jex.dst)
    eq(ex.dst_cnt, jex.dst_cnt)
    assert ex.edges_scanned == int(jex.edges_scanned)


@pytest.mark.parametrize("p_cnt", [0.0, 0.5, 1.0])
def test_update_frontier(p_cnt, rng):
    grid = Grid2D(2, 2, 128)
    C, S, i, j = 2, 32, 0, 1
    int_cnt = (rng.random(C) * p_cnt * S).astype(np.int32)
    int_verts = np.full((C, S), -1, np.int32)
    for m in range(C):
        int_verts[m, :int_cnt[m]] = j * S + rng.permutation(S)[:int_cnt[m]]
    visited = rng.random(64) < 0.3
    level = np.where(visited, 1, -1).astype(np.int32)
    pred = np.where(visited, 3, -1).astype(np.int32)
    up = F.update_frontier(T(int_verts), T(int_cnt), sink(visited),
                           sink(level), sink(pred), 2, grid=grid, i=i, j=j)
    jup = JF.update_frontier(jnp.asarray(int_verts), jnp.asarray(int_cnt),
                             jnp.asarray(visited), jnp.asarray(level),
                             jnp.asarray(pred), jnp.int32(2),
                             grid=JGrid2D(2, 2, 128), i=i, j=j)
    for got, want in zip(up[:3], jup[:3]):
        eq(got[:-1], want)
    eq(up.new_front, jup.new_front)
    assert int(up.new_cnt) == int(jup.new_cnt)


# ----------------------------------------------------------------------------
# The stacked-grid exchanges
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_col_all_to_all_is_flat_exchange(R, C, rng):
    topo = StackedTopology(Grid2D(R, C, R * C * 8), torch.device("cpu"))
    x = rng.integers(0, 2**31 - 1, size=(R, C, C, 5)).astype(np.int32)
    recv = topo.col_all_to_all(T(x)).numpy()
    for i in range(R):
        eq(recv[i], emulate_exchange(x[i], "flat"))
    counts = x[..., 0, 0] % 1000
    assert int(topo.psum_all(T(counts))) == int(counts.sum())


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_expand_exchange(R, C, kernel_ops, rng):
    S = 8
    topo = StackedTopology(Grid2D(R, C, R * C * S), torch.device("cpu"))
    cnt = rng.integers(0, S + 1, size=(R, C)).astype(np.int32)
    cnt[0, 0] = 0
    front = np.full((R, C, S), -1, np.int32)
    for i in range(R):
        for j in range(C):
            front[i, j, :cnt[i, j]] = rng.integers(0, R * S, size=cnt[i, j])
    af, tot = X.expand_exchange(T(front), T(cnt), topo=topo,
                                ops=KF if kernel_ops else None)
    for i in range(R):
        for j in range(C):
            # JAX: row all_gather of the column, then compact_blocks
            jf, jt = JF.compact_blocks(jnp.asarray(front[:, j]),
                                       jnp.asarray(cnt[:, j]))
            eq(af[i, j], jf)
            assert int(tot[i, j]) == int(jt)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_list_fold_and_resolve_preds(R, C, rng):
    S = 6
    grid = Grid2D(R, C, R * C * S)
    topo = StackedTopology(grid, torch.device("cpu"))
    dst = rng.integers(-1, 50, size=(R, C, C, S)).astype(np.int32)
    dst_cnt = rng.integers(0, S + 1, size=(R, C, C)).astype(np.int32)
    iv, ic = X.ListFold().fold(T(dst), T(dst_cnt), topo=topo)
    for i in range(R):
        msg = np.concatenate([dst_cnt[i][..., None], dst[i]], axis=-1)
        recv = emulate_exchange(msg, "flat")
        eq(iv[i], recv[..., 1:])
        eq(ic[i], recv[..., 0])
    assert X.ListFold().wire_bytes(grid) == C * (4 * S + 4)

    # preds with deferred markers -(c+2) on owned blocks
    nrl = grid.n_rows_local
    pred = rng.integers(0, 100, size=(R, C, nrl)).astype(np.int32)
    marks = rng.random((R, C, nrl)) < 0.4
    pred = np.where(marks, -(rng.integers(0, C, size=(R, C, nrl)) + 2), pred)
    got = X.resolve_preds(T(pred), topo=topo).numpy()
    for i in range(R):
        recv = emulate_exchange(pred[i].reshape(C, C, S), "flat")
        for j in range(C):
            # JAX resolve_preds, evaluated on the emulated all_to_all
            pb = jnp.asarray(pred[i, j].reshape(C, S))
            own = pb[j]
            sender = jnp.clip(-own - 2, 0, C - 1)
            from_sender = jnp.take_along_axis(jnp.asarray(recv[j]),
                                              sender[None, :], axis=0)[0]
            eq(got[i, j], jnp.where(own < -1, from_sender, own))


# ----------------------------------------------------------------------------
# Direction optimisation and the value folds
# ----------------------------------------------------------------------------

def _blocked_words(rng, block, n_blocks, frac):
    """A blocked frontier bitmap as uint32 (JAX) and its set cols."""
    W = (block + 31) // 32
    mask = rng.random(block * n_blocks) < frac
    words = np.zeros(n_blocks * W, np.uint32)
    for c in np.flatnonzero(mask):
        blk, off = c // block, c % block
        words[blk * W + (off >> 5)] |= np.uint32(1) << np.uint32(off & 31)
    return words, mask


@pytest.mark.parametrize("block", [37, 64])
@pytest.mark.parametrize("frontier_frac", [0.0, 0.4, 1.0])
def test_bit_blocks_and_reference_bottomup_chunk(block, frontier_frac, rng):
    nrl = ncl = 2 * block
    words, mask = _blocked_words(rng, block, 2, frontier_frac)
    c = np.arange(ncl, dtype=np.int32)
    got = F.test_bit_blocks(T(words.view(np.int32)), T(c), block)
    eq(got, JF.test_bit_blocks(jnp.asarray(words), jnp.asarray(c), block))
    eq(got, mask)

    deg = rng.integers(0, 6, size=nrl)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, ncl, size=6 * nrl).astype(np.int32)
    visited = rng.random(nrl) < 0.3
    cumul = np.concatenate([[0], np.cumsum(np.where(visited, 0, deg))]) \
        .astype(np.int32)
    total = int(cumul[-1])
    gids = np.arange(total + 40, dtype=np.int32)   # masked tail included
    out = F.reference_bottomup_chunk(
        T(gids), T(cumul), torch.tensor(total, dtype=torch.int32),
        T(row_off), T(col_idx), T(words.view(np.int32)), block=block)
    want = JF.reference_bottomup_chunk(
        jnp.asarray(gids), jnp.asarray(cumul), jnp.int32(total),
        jnp.asarray(row_off), jnp.asarray(col_idx), jnp.asarray(words),
        block=block)
    for a, b in zip(out, want):
        eq(a, b)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_pack_blocks(R, C, kernel_ops, rng):
    from repro.algos.program import pack_blocks as jax_pack_blocks
    from repro_torch.algos.program import pack_blocks
    S = 13
    grid = Grid2D(R, C, R * C * S)
    nrl = grid.n_rows_local
    imp = rng.random((R, C, nrl)) < 0.4
    vals = rng.integers(0, 10**6, size=(R, C, nrl)).astype(np.int32)
    ids, cnt, vs = pack_blocks(T(imp), T(vals), grid,
                               ops=KF if kernel_ops else None)
    assert ids.shape == (R, C, C, S) and cnt.shape == (R, C, C)
    jgrid = JGrid2D(R, C, R * C * S)
    for i in range(R):
        for j in range(C):
            for a, b in zip((ids[i, j], cnt[i, j], vs[i, j]),
                            jax_pack_blocks(jnp.asarray(imp[i, j]),
                                            jnp.asarray(vals[i, j]), jgrid)):
                eq(a, b)


def _canonical_buckets(rng, R, C, S, p):
    """(R, C, C, S) canonical value-fold buckets: bucket m holds ascending
    distinct local rows m*S + t, front-packed, padded -1."""
    ids = np.full((R, C, C, S), -1, np.int32)
    vals = np.full((R, C, C, S), 2**31 - 1, np.int32)
    cnt = np.zeros((R, C, C), np.int32)
    for i in range(R):
        for j in range(C):
            for m in range(C):
                t = np.flatnonzero(rng.random(S) < p)
                ids[i, j, m, :t.size] = m * S + t
                vals[i, j, m, :t.size] = rng.integers(0, 10**6, t.size)
                cnt[i, j, m] = t.size
    return ids, cnt, vals


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("S", [1, 33])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_bitmap_and_list_folds(R, C, S, p, kernel_ops, rng):
    """BitmapFold.fold / fold_values and ListFold.fold_values equal the JAX
    codecs' encode / decode over `emulate_exchange`, processor by
    processor; both codecs deliver the same received set."""
    from repro.dist import exchange as JX
    grid = Grid2D(R, C, R * C * S)
    topo = StackedTopology(grid, torch.device("cpu"))
    ops = KF if kernel_ops else None
    ids, cnt, vals = _canonical_buckets(rng, R, C, S, p)
    bm = X.get_fold_codec("bitmap", grid, ops=ops)
    lf = X.get_fold_codec("list", grid, ops=ops)
    iv, ic = bm.fold(T(ids), T(cnt), topo=topo)
    bi, bc, bv = bm.fold_values(T(ids), T(cnt), T(vals), topo=topo)
    li, lc, lv = lf.fold_values(T(ids), T(cnt), T(vals), topo=topo)
    for i in range(R):
        words = np.stack([np.asarray(JX.BitmapFold.encode(
            jnp.asarray(ids[i, j]), jnp.asarray(cnt[i, j]), S))
            for j in range(C)])                              # (C, C, W)
        recv = emulate_exchange(words, "flat")
        rvals = emulate_exchange(vals[i], "flat")
        lmsg = emulate_exchange(np.concatenate(
            [cnt[i][..., None], ids[i], vals[i]], axis=-1), "flat")
        for j in range(C):
            jv, jc = JX.BitmapFold.decode(jnp.asarray(recv[j]), jnp.int32(j),
                                          S)
            for got in ((iv, ic), (bi, bc)):
                eq(got[0][i, j], jv)
                eq(got[1][i, j], jc)
            eq(bv[i, j], rvals[j])
            eq(li[i, j], lmsg[j, :, 1:1 + S])
            eq(lc[i, j], lmsg[j, :, 0])
            eq(lv[i, j], lmsg[j, :, 1 + S:])
            eq(li[i, j], jv)               # same canonical set either way
    for codec, jcodec in ((bm, JX.BitmapFold()), (lf, JX.ListFold())):
        assert codec.wire_bytes(grid) == jcodec.wire_bytes(grid)
        assert codec.wire_bytes_values(grid) == \
            jcodec.wire_bytes_values(grid)
        assert codec.wire_bytes_values_sent(grid, int(cnt.sum())) == \
            jcodec.wire_bytes_values_sent(grid, int(cnt.sum()))
    assert bm.wire_bytes(grid) == C * 4 * ((S + 31) // 32)


def test_bitmap_fold_values_in_process_1x1(rng):
    """JAX's own `BitmapFold.fold_values` under shard_map at 1x1 against
    the port's stacked fold."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.dist import exchange as JX
    from repro.dist.compat import make_mesh, shard_map
    from repro.dist.topology import Topology
    S = 45
    ids, cnt, vals = _canonical_buckets(rng, 1, 1, S, 0.5)
    mesh = make_mesh((1, 1), ("r", "c"), devices=jax.devices()[:1])
    jtopo = Topology.for_grid(JGrid2D(1, 1, S), mesh)
    spec = P("r", "c")

    def fold(a, b, c):
        out = JX.BitmapFold().fold_values(a[0, 0], b[0, 0], c[0, 0],
                                          topo=jtopo, j=jnp.int32(0))
        return tuple(x[None, None] for x in out)

    want = shard_map(fold, mesh=mesh, in_specs=(spec,) * 3,
                     out_specs=(spec,) * 3)(jnp.asarray(ids),
                                            jnp.asarray(cnt),
                                            jnp.asarray(vals))
    grid = Grid2D(1, 1, S)
    got = X.BitmapFold().fold_values(
        T(ids), T(cnt), T(vals), topo=StackedTopology(grid,
                                                      torch.device("cpu")))
    for a, b in zip(got, want):
        eq(a, b)


def test_delta_codec_names_its_roadmap_item():
    """The delta codec is ported (ROADMAP A8): it builds where S <= 65536
    and otherwise refuses, naming the codecs that work."""
    assert X.get_fold_codec("delta", Grid2D(1, 1, 1 << 16)).name == "delta"
    with pytest.raises(ValueError, match=r"S <= 65536.*codecs that do work "
                                         r"at this block size: \['bitmap', "
                                         r"'list'\]"):
        X.get_fold_codec("delta", Grid2D(1, 1, (1 << 16) + 1))
    with pytest.raises(ValueError, match="unknown fold codec"):
        X.get_fold_codec("zip", Grid2D(1, 1, 8))


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_frontier_words(R, C, rng):
    """The port's stacked `frontier_words` equals the JAX formula: each
    processor's own frontier packed to S bits, row-gathered."""
    from repro_torch.algos.direction import frontier_words
    S = 37
    grid = Grid2D(R, C, R * C * S)
    topo = StackedTopology(grid, torch.device("cpu"))
    front = np.full((R, C, S), -1, np.int32)
    for i in range(R):
        for j in range(C):
            k = rng.integers(0, S + 1)
            front[i, j, :k] = np.sort(i * S + rng.choice(S, k, replace=False))
    got = frontier_words(topo, T(front)).numpy()
    for j in range(C):
        own = [JF.pack_bitmap(jnp.asarray(np.isin(
            np.arange(S), front[i, j][front[i, j] >= 0] - i * S)))
            for i in range(R)]
        eq(got[j].view(np.uint32), np.concatenate(own))
