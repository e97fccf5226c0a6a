"""The value programs' ops and kernels, and the delta codec, against the
JAX package in process, on random inputs.

  * the plain `expand_chunk_values` / `bottomup_chunk_values` equal the
    Pallas kernels (`interpret=True`) on every lane, masked lanes included,
    and the JAX reference formulas on valid / hit lanes; the plain
    `expand_chunk_values` also on the stage-1 stress cases of
    `scripts/torch_stage_cases.py` (EXPAND_CASES), the plain
    `bottomup_chunk_values` on its BOTTOMUP_CASES (the kernels are held to
    them on the card);
  * the plain `delta_gaps` / `delta_positions` equal the Pallas kernels
    (interpret mode): all-invalid rows, full rows of S = 65536 (count = S,
    the header's two words), S % 32 != 0;
  * `expand_exchange_values`, `scan_relax`, `scatter_min_received` and
    `owned_to_front` equal the jnp functions, processor by processor;
  * `DeltaFold` encode / decode / fold / fold_values and the wire message
    equal the JAX codec over `emulate_exchange`, bit for bit (uint16
    compared through numpy views of the port's int16 words);
  * `partition_edge_vals(_csr)` equal the JAX layouts at 1x1, 2x2, 1x4 and
    2x4.

Integer outputs: exact equality throughout.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algos import program as JPR
from repro.core import frontier as JF
from repro.core import partition as JP
from repro.core.types import Grid2D as JGrid2D
from repro.dist import exchange as JX
from repro.dist.strategy import emulate_exchange
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.kernels.bottomup import bottomup_chunk_values as \
    jax_bottomup_chunk_values
from repro.kernels.expand import expand_chunk_values as \
    jax_expand_chunk_values
from repro.kernels.fold import delta_gaps as jax_delta_gaps
from repro.kernels.fold import delta_positions as jax_delta_positions
from repro_torch.algos import program as PR
from repro_torch.core import frontier as F
from repro_torch.core import partition as P
from repro_torch.core.types import Grid2D
from repro_torch.dist import exchange as X
from repro_torch.dist.topology import StackedTopology
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as KE
from repro_torch.kernels import fold as KF

I32_MAX = 2**31 - 1
CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SC = _load_script("torch_stage_cases")


def T(x):
    return torch.from_numpy(np.array(x))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def u16(t):
    """The port's int16 wire words as the JAX uint16 bit pattern."""
    return t.numpy().view(np.uint16)


# ----------------------------------------------------------------------------
# B8 expand_chunk_values
# ----------------------------------------------------------------------------

def _random_block(rng, ncl, n_rows, front_total, max_deg=9):
    deg = rng.integers(0, max_deg, size=ncl).astype(np.int32)
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = max(int(col_off[-1]), 1)
    row_idx = rng.integers(0, n_rows, size=nnz + 5).astype(np.int32)
    row_idx[nnz:] = -1
    front = np.full(ncl, -1, np.int32)
    front[:front_total] = rng.permutation(ncl)[:front_total]
    payload = rng.integers(-5, 2**31 - 1, size=ncl).astype(np.int32)
    fr = np.clip(front, 0, ncl - 1)
    deg_f = np.where(np.arange(ncl) < front_total,
                     col_off[fr + 1] - col_off[fr], 0)
    cumul = np.concatenate([[0], np.cumsum(deg_f)]).astype(np.int32)
    return col_off, row_idx, front, payload, cumul


@pytest.mark.parametrize("ncl,front_total,E,start", [
    (64, 64, 512, 0),        # full frontier, one tile
    (64, 0, 256, 0),         # empty frontier: every lane masked
    (100, 37, 1000, 0),      # chunk not a multiple of 512
    (50, 20, 96, 64),        # chunk starting mid-frontier
    (200, 150, 1536, 512),   # masked tail
])
def test_plain_expand_chunk_values_equals_pallas(ncl, front_total, E, start,
                                                 rng):
    col_off, row_idx, front, payload, cumul = _random_block(
        rng, ncl, 300, front_total)
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    jargs = (jnp.asarray(cumul), jnp.asarray(front), jnp.asarray(payload),
             jnp.int32(front_total), jnp.asarray(col_off),
             jnp.asarray(row_idx))
    kern = jax_expand_chunk_values(gids, *jargs, interpret=True)
    got = KE.expand_chunk_values(
        start, E, T(cumul), T(front), T(payload),
        torch.tensor(front_total, dtype=torch.int32), T(col_off),
        T(row_idx))
    for g, k in zip(got, kern):              # every lane
        eq(g, k)
    v, _, k, addr, valid = JF.reference_expand_chunk(
        gids, jnp.asarray(cumul), jnp.asarray(front), jnp.int32(front_total),
        jnp.asarray(col_off), jnp.asarray(row_idx))
    valid = np.asarray(valid)
    eq(got[3], valid)
    for g, r in zip(got[:3], (v, jnp.asarray(payload)[k], addr)):
        eq(np.where(valid, g.numpy(), 0), np.where(valid, np.asarray(r), 0))


@pytest.mark.parametrize("name", SC.EXPAND_CASES)
def test_plain_expand_chunk_values_stage_cases_equal_pallas(name):
    """The stage-1 stress cases (a zero-degree run longer than a block, one
    slot spanning many blocks, chunks straddling and wholly past the live
    total, an empty frontier, n_lanes % 256 != 0, and the rest): every
    lane against the Pallas kernel."""
    c = SC.expand_case(name)
    start, E, ft = c["start"], c["E"], c["front_total"]
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    kern = jax_expand_chunk_values(
        gids, jnp.asarray(c["cumul"]), jnp.asarray(c["front"]),
        jnp.asarray(c["payload"]), jnp.int32(ft), jnp.asarray(c["col_off"]),
        jnp.asarray(c["row_idx"]), interpret=True)
    got = KE.expand_chunk_values(start, E, *SC.value_args(c, CPU))
    for g, k in zip(got, kern):
        eq(g, k)
    if name == "ragged":
        assert E % 256 != 0


# ----------------------------------------------------------------------------
# B9 bottomup_chunk_values
# ----------------------------------------------------------------------------

def _bottomup_inputs(rng, nrl, ncl, block, frontier_frac):
    deg = rng.integers(0, 6, size=nrl)
    row_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col_idx = rng.integers(0, ncl, size=6 * nrl).astype(np.int32)
    mask = rng.random(ncl) < frontier_frac
    W = (block + 31) // 32
    words = np.zeros(((ncl + block - 1) // block) * W, np.uint32)
    for c in np.flatnonzero(mask):
        blk, off = c // block, c % block
        words[blk * W + (off >> 5)] |= np.uint32(1) << np.uint32(off & 31)
    visited = rng.random(nrl) < 0.3
    cumul = np.concatenate(
        [[0], np.cumsum(np.where(visited, 0, deg))]).astype(np.int32)
    dense_pay = rng.integers(0, 2**31 - 1, size=ncl).astype(np.int32)
    return row_off, col_idx, words, cumul, dense_pay


@pytest.mark.parametrize("block", [37, 64])
@pytest.mark.parametrize("frontier_frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("chunk", ["one_tile", "ragged", "straddle",
                                   "zero_total"])
def test_plain_bottomup_chunk_values_equals_pallas(block, frontier_frac,
                                                   chunk):
    rng = np.random.default_rng(block * 10 + int(frontier_frac * 10))
    nrl = ncl = 2 * block
    row_off, col_idx, words, cumul, dense_pay = _bottomup_inputs(
        rng, nrl, ncl, block, frontier_frac)
    if chunk == "zero_total":
        cumul = np.zeros_like(cumul)
    total = int(cumul[-1])
    start, E = {"one_tile": (0, 512), "ragged": (0, 1000),
                "straddle": (max(total - 100, 0), 384),
                "zero_total": (0, 256)}[chunk]
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    jargs = (jnp.asarray(cumul), jnp.int32(total), jnp.asarray(row_off),
             jnp.asarray(col_idx), jnp.asarray(words),
             jnp.asarray(dense_pay))
    kern = jax_bottomup_chunk_values(gids, *jargs, block=block,
                                     interpret=True)
    ref = JF.reference_bottomup_values_chunk(gids, *jargs, block=block)
    got = KB.bottomup_chunk_values(
        start, E, T(cumul), torch.tensor(total, dtype=torch.int32),
        T(row_off), T(col_idx), T(words.view(np.int32)), T(dense_pay),
        block=block)
    for g, k in zip(got, kern):              # every lane, masked included
        eq(g, k)
    hit = got[3].numpy()
    eq(hit, ref[3])
    for g, r in zip(got[:3], ref[:3]):       # the reference on hit lanes
        eq(np.where(hit, g.numpy(), 0), np.where(hit, np.asarray(r), 0))
    live = start + np.arange(E) < total
    assert live.any() == (chunk != "zero_total") and not live.all()
    # the torch reference formulas equal the JAX ones on every lane
    tref = F.reference_bottomup_values_chunk(
        T(np.asarray(gids)), T(cumul), torch.tensor(total,
                                                    dtype=torch.int32),
        T(row_off), T(col_idx), T(words.view(np.int32)), T(dense_pay),
        block=block)
    for a, b in zip(tref, ref):
        eq(a, b)


@pytest.mark.parametrize("name", SC.BOTTOMUP_CASES)
def test_plain_bottomup_chunk_values_stage_cases_equal_pallas(name):
    """The bottom-up stage-1 stress cases of `scripts/torch_stage_cases.py`
    (zero-width runs, the flat tail past the live total, a row spanning many
    blocks, 99 % and 99.8 % of rows visited, straddling / past / zero
    totals, ragged
    chunks, block % 32 != 0, empty and full frontiers): every lane of
    (r, pay, addr, hit) against the Pallas kernel, masked lanes (pay =
    dense_pay[0]) included."""
    c = SC.bottomup_case(name)
    start, E, block = c["start"], c["E"], c["block"]
    gids = jnp.asarray(start + np.arange(E, dtype=np.int32))
    kern = jax_bottomup_chunk_values(
        gids, jnp.asarray(c["cumul"]), jnp.int32(c["total"]),
        jnp.asarray(c["row_off"]), jnp.asarray(c["col_idx"]),
        jnp.asarray(c["words"].view(np.uint32)), jnp.asarray(c["dense_pay"]),
        block=block, interpret=True)
    got = KB.bottomup_chunk_values(start, E, *SC.bottomup_args(c, CPU, True),
                                   block=block)
    for g, k in zip(got, kern):
        eq(g, k)
    masked = start + np.arange(E) >= c["total"]
    assert (got[1].numpy()[masked] == c["dense_pay"][0]).all()


# ----------------------------------------------------------------------------
# B5 delta_gaps, B6 delta_positions
# ----------------------------------------------------------------------------

def _sorted_rows(rng, N, S, counts):
    """(N, S) int32 rows: `counts[r]` distinct sorted offsets < S, then
    I32_MAX (the encode's padding), and the valid mask."""
    ts = np.full((N, S), I32_MAX, np.int32)
    for r, c in enumerate(counts):
        ts[r, :c] = np.sort(rng.choice(S, c, replace=False))
    valid = np.arange(S)[None, :] < np.asarray(counts)[:, None]
    return ts, valid


@pytest.mark.parametrize("S,counts", [
    (33, [0, 33, 7]),                  # S % 32 != 0, an empty and a full row
    (100, [0, 0]),                     # all-invalid rows
    (1 << 16, [1 << 16, 40000, 1]),    # count = S = 65536, large gaps
])
def test_plain_delta_kernels_equal_pallas(S, counts):
    rng = np.random.default_rng(S)
    ts, valid = _sorted_rows(rng, len(counts), S, counts)
    jg = np.asarray(jax_delta_gaps(jnp.asarray(ts), jnp.asarray(valid),
                                   interpret=True))
    tg = KF.delta_gaps(T(ts), T(valid))
    assert tg.dtype == torch.int16 and tg.shape == ts.shape
    eq(u16(tg), jg)
    jp = np.asarray(jax_delta_positions(jnp.asarray(jg), interpret=True))
    tp = KF.delta_positions(tg)
    eq(tp, jp)
    eq(np.where(valid, tp.numpy(), 0), np.where(valid, ts, 0))


def test_plain_delta_positions_wraps_as_int32():
    """Gaps of 65535 over a long row: the sum passes 2^31 and wraps as
    JAX's int32 cumsum does."""
    gaps = np.full((2, 40000), 65535, np.uint16)
    want = np.asarray(jax_delta_positions(jnp.asarray(gaps),
                                          interpret=True))
    eq(KF.delta_positions(T(gaps.view(np.int16))), want)


def test_u16_helpers_round_trip(rng):
    x = rng.integers(0, 1 << 16, size=1000).astype(np.int32)
    bits = F.u16_bits(T(x))
    assert bits.dtype == torch.int16
    eq(bits.numpy().view(np.uint16), x.astype(np.uint16))
    eq(F.u16_values(bits), x)
    v = rng.integers(-2**31, 2**31 - 1, size=(3, 50)).astype(np.int32)
    pairs = X._i32_to_u16(T(v))
    eq(u16(pairs), np.asarray(JX._i32_to_u16(jnp.asarray(v))))
    eq(X._u16_to_i32(pairs), v)


# ----------------------------------------------------------------------------
# The value-program blocks
# ----------------------------------------------------------------------------

class _Gathered:
    """A JAX topology stand-in whose row gather is the identity: the caller
    passes processor (i, j)'s gathered column directly."""

    def __init__(self, grid):
        self.grid = grid

    @staticmethod
    def row_gather(x):
        return x


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_expand_exchange_values(R, C, kernel_ops, rng):
    S = 8
    grid = Grid2D(R, C, R * C * S)
    topo = StackedTopology(grid, CPU)
    cnt = rng.integers(0, S + 1, size=(R, C)).astype(np.int32)
    cnt[0, 0] = 0
    front = np.full((R, C, S), -1, np.int32)
    pay = rng.integers(0, 10**6, size=(R, C, S)).astype(np.int32)
    for i in range(R):
        for j in range(C):
            front[i, j, :cnt[i, j]] = rng.integers(0, R * S, size=cnt[i, j])
    af, ap, tot = X.expand_exchange_values(
        T(front), T(cnt), T(pay), topo=topo, fill=-7,
        ops=KF if kernel_ops else None)
    jtopo = _Gathered(JGrid2D(R, C, R * C * S))
    for i in range(R):
        for j in range(C):
            jf, jp, jt = JX.expand_exchange_values(
                jnp.asarray(front[:, j]), jnp.asarray(cnt[:, j]),
                jnp.asarray(pay[:, j]), topo=jtopo, fill=-7)
            eq(af[i, j], jf)
            eq(ap[i, j], jp)
            assert int(tot[i, j]) == int(jt)


@pytest.mark.parametrize("front_total", [0, 1, 40, 64])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("through_kernel", [False, True])
def test_scan_relax(front_total, weighted, through_kernel, rng):
    """The chunked scan, with the identity relax or SSSP's min-plus over
    uint8 edge values, at a chunk that cuts frontier columns."""
    ncl, n_rows = 64, 120
    col_off, row_idx, front, payload, _ = _random_block(rng, ncl, n_rows,
                                                        front_total)
    payload = rng.integers(0, 1000, size=ncl).astype(np.int32)
    w = rng.integers(1, 256, size=row_idx.shape[0]).astype(np.uint8)
    jgrid = JGrid2D(1, 1, ncl)

    def jrelax(p, ww):
        return p + ww.astype(jnp.int32) if weighted else p

    def trelax(p, ww):
        return p + ww.to(torch.int32) if weighted else p

    want, wtot = JPR.scan_relax(
        jnp.asarray(col_off), jnp.asarray(row_idx),
        jnp.asarray(w) if weighted else None, jnp.asarray(front),
        jnp.asarray(payload), jnp.int32(front_total), jrelax,
        n_rows=n_rows, grid=jgrid, edge_chunk=37)
    got, tot = PR.scan_relax(
        T(col_off), T(row_idx), T(w) if weighted else None, T(front),
        T(payload), torch.tensor(front_total, dtype=torch.int32), trelax,
        n_rows=n_rows, edge_chunk=37,
        expand_fn=KE.expand_chunk_values if through_kernel else None)
    eq(got, want)
    assert tot == int(wtot)


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
def test_scatter_min_received(R, C, p, rng):
    S = 11
    grid = Grid2D(R, C, R * C * S)
    ids = np.full((R, C, C, S), -1, np.int32)
    vals = rng.integers(0, 10**6, size=(R, C, C, S)).astype(np.int32)
    for i in range(R):
        for j in range(C):
            for m in range(C):
                t = np.flatnonzero(rng.random(S) < p)
                ids[i, j, m, :t.size] = j * S + t
    got = PR.scatter_min_received(
        T(ids), T(vals), X.receiver_cols(StackedTopology(grid, CPU)), S)
    for i in range(R):
        for j in range(C):
            eq(got[i, j], JPR.scatter_min_received(
                jnp.asarray(ids[i, j]), jnp.asarray(vals[i, j]),
                jnp.int32(j), S))


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_owned_to_front(R, C, p, kernel_ops, rng):
    S = 19
    grid = Grid2D(R, C, R * C * S)
    changed = rng.random((R, C, S)) < p
    vals = rng.integers(0, 10**6, size=(R, C, S)).astype(np.int32)
    front, pay, cnt = PR.owned_to_front(T(changed), T(vals), grid,
                                        ops=KF if kernel_ops else None)
    for i in range(R):
        for j in range(C):
            want = JPR.owned_to_front(jnp.asarray(changed[i, j]),
                                      jnp.asarray(vals[i, j]), jnp.int32(i),
                                      S)
            for a, b in zip((front[i, j], pay[i, j], cnt[i, j]), want):
                eq(a, b)


# ----------------------------------------------------------------------------
# The delta codec
# ----------------------------------------------------------------------------

def _buckets(rng, R, C, S, p, canonical):
    """(R, C, C, S) fold buckets: bucket m holds distinct local rows
    m*S + t, front-packed (ascending when canonical, in discovery order
    otherwise), padded -1; values aligned."""
    ids = np.full((R, C, C, S), -1, np.int32)
    vals = np.full((R, C, C, S), I32_MAX, np.int32)
    cnt = np.zeros((R, C, C), np.int32)
    for i in range(R):
        for j in range(C):
            for m in range(C):
                t = np.flatnonzero(rng.random(S) < p)
                if not canonical:
                    t = rng.permutation(t)
                ids[i, j, m, :t.size] = m * S + t
                vals[i, j, m, :t.size] = rng.integers(-2**31, 2**31 - 1,
                                                      t.size)
                cnt[i, j, m] = t.size
    return ids, cnt, vals


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
@pytest.mark.parametrize("S", [1, 33])
@pytest.mark.parametrize("p", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("kernel_ops", [False, True])
def test_delta_fold_equals_jax(R, C, S, p, kernel_ops, rng):
    """DeltaFold.fold on discovery-ordered buckets and fold_values on
    canonical ones equal the JAX codec's encode / decode over
    `emulate_exchange`, processor by processor, wire arrays included."""
    grid = Grid2D(R, C, R * C * S)
    topo = StackedTopology(grid, CPU)
    codec = X.get_fold_codec("delta", grid, ops=KF if kernel_ops else None)
    dst, dcnt, _ = _buckets(rng, R, C, S, p, canonical=False)
    ids, cnt, vals = _buckets(rng, R, C, S, p, canonical=True)
    iv, ic = codec.fold(T(dst), T(dcnt), topo=topo)
    ri, rc, rv = codec.fold_values(T(ids), T(cnt), T(vals), topo=topo)
    gaps = u16(codec.encode(T(dst), T(dcnt), S, codec.ops))
    for i in range(R):
        msgs, vmsgs = [], []
        for j in range(C):
            jg = np.asarray(JX.DeltaFold.encode(jnp.asarray(dst[i, j]),
                                                jnp.asarray(dcnt[i, j]), S))
            eq(gaps[i, j], jg)
            hdr = np.asarray(JX.DeltaFold._header(jnp.asarray(dcnt[i, j])))
            msgs.append(np.concatenate([hdr, jg], axis=1))
            vmsgs.append(np.concatenate([
                np.asarray(JX.DeltaFold._header(jnp.asarray(cnt[i, j]))),
                np.asarray(JX.DeltaFold.encode(jnp.asarray(ids[i, j]),
                                               jnp.asarray(cnt[i, j]), S)),
                np.asarray(JX._i32_to_u16(jnp.asarray(vals[i, j])))],
                axis=1))
        recv = emulate_exchange(np.stack(msgs), "flat")
        vrecv = emulate_exchange(np.stack(vmsgs), "flat")
        for j in range(C):
            jcnt = JX.DeltaFold._read_header(jnp.asarray(recv[j, :, :2]))
            jv, jc = JX.DeltaFold.decode(jnp.asarray(recv[j, :, 2:]), jcnt,
                                         jnp.int32(j), S)
            eq(iv[i, j], jv)
            eq(ic[i, j], jc)
            vc = JX.DeltaFold._read_header(jnp.asarray(vrecv[j, :, :2]))
            vi, _ = JX.DeltaFold.decode(jnp.asarray(vrecv[j, :, 2:2 + S]),
                                        vc, jnp.int32(j), S)
            eq(ri[i, j], vi)
            eq(rc[i, j], vc)
            eq(rv[i, j], JX._u16_to_i32(jnp.asarray(vrecv[j, :, 2 + S:])))
    jcodec = JX.DeltaFold(JGrid2D(R, C, R * C * S))
    assert codec.wire_bytes(grid) == jcodec.wire_bytes(grid) \
        == C * (2 * S + 4)
    assert codec.wire_bytes_values_sent(grid, int(cnt.sum())) == \
        jcodec.wire_bytes_values_sent(grid, int(cnt.sum()))


def test_delta_full_block_header():
    """A bucket of count S = 65536: the count needs the header's high
    word, and every id arrives."""
    S = 1 << 16
    grid = Grid2D(1, 1, S)
    ids = np.arange(S, dtype=np.int32)[None, None, None]
    cnt = np.full((1, 1, 1), S, np.int32)
    vals = np.arange(S, dtype=np.int32)[None, None, None] * 40503
    codec = X.get_fold_codec("delta", grid)
    hdr = u16(codec._header(T(cnt)))[0, 0]
    eq(hdr, np.asarray(JX.DeltaFold._header(jnp.asarray(cnt[0, 0]))))
    eq(hdr.reshape(-1), [0, 1])
    ri, rc, rv = codec.fold_values(T(ids), T(cnt), T(vals),
                                   topo=StackedTopology(grid, CPU))
    assert int(rc) == S
    eq(ri, ids)
    eq(rv, vals)


# ----------------------------------------------------------------------------
# Per-edge values in the partition
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 4), (2, 4)])
def test_partition_edge_vals_equal_jax(R, C):
    n = 1 << 9
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), 9, 16))
    w = np.random.default_rng(1).integers(1, 256, size=edges.shape[1]) \
        .astype(np.uint8)
    jgrid, grid = JGrid2D(R, C, n), Grid2D(R, C, n)
    te = torch.from_numpy(edges.copy())
    got = P.partition_edge_vals(te, T(w), grid)
    got_csr = P.partition_edge_vals_csr(te, T(w), grid)
    assert got.dtype == torch.uint8
    eq(got, JP.partition_edge_vals(edges, w, jgrid))
    eq(got_csr, JP.partition_edge_vals_csr(edges, w, jgrid))
    # edge ids as the values: entry k names the edge at row_idx[k]
    ids = P.partition_edge_vals(te, torch.arange(edges.shape[1],
                                                 dtype=torch.int32), grid)
    csc = P.partition_2d(te, grid)
    live = torch.arange(ids.shape[2]) < csc.nnz[..., None]
    eq(P.local_row(te[1][ids.long()], grid)[live], csc.row_idx[live])
    with pytest.raises(ValueError, match="edge values for"):
        P.partition_edge_vals(te, T(w[:-1]), grid)
