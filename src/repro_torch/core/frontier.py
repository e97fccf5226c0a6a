"""Per-processor frontier expansion and update (paper sec. 3.4, 3.5), the
port of `repro/core/frontier.py`.

The formulas are the JAX package's plain (reference) path, op for op; the
kernels of `repro_torch.kernels` replace the hot chunk ops (top-down and
bottom-up) and the compaction on a card.  Three differences from JAX are
deliberate:

  * masked scatters: JAX drops them with `mode="drop"` on the index
    `n_rows`; torch rejects that index, so per-vertex state carries a
    trailing sink slot (`n_rows + 1` entries, `core.types`) that masked
    lanes write and nothing reads;
  * in place: `expand_frontier` / `update_frontier` update the caller's
    level / pred / visited tensors instead of returning fresh ones;
  * bitmaps are int32 tensors holding the uint32 bit patterns.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.partition import row2col
from repro_torch.core.types import Grid2D

I32_MAX = 2**31 - 1


def _i32(x, like):
    """A scalar as an int32 tensor on `like`'s device."""
    return torch.tensor(x, dtype=torch.int32, device=like.device)


def _arange(n, like):
    return torch.arange(n, dtype=torch.int32, device=like.device)


def exclusive_cumsum(x):
    """Thrust exclusive_scan equivalent, returns len(x)+1 (with total)."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    torch.cumsum(x, 0, dtype=torch.int32, out=out[1:])
    return out


def compact_blocks(vals, cnts, fill=-1, ops=None):
    """Concatenate R padded blocks (R, S) with per-block counts into one
    padded (R*S,) array (valid entries first, order preserved).

    ops: the fold-kernel bundle (`repro_torch.kernels.fold`) whose prefix-sum
    compaction replaces the argsort; None = the plain path.  Both are
    bit-identical.  Returns (out, total) with total a () int32 tensor."""
    R, S = vals.shape
    mask = _arange(S, vals)[None, :] < cnts[:, None]
    total = cnts.sum(dtype=torch.int32)
    if ops is not None:
        (out,), _ = ops.compact_rows(mask.reshape(1, -1),
                                     (vals.reshape(1, -1),), (fill,))
        return out[0], total
    flat_v = vals.reshape(-1)
    flat_m = mask.reshape(-1)
    order = torch.argsort((~flat_m).to(torch.int8), stable=True)
    out = torch.where(flat_m[order], flat_v[order], _i32(fill, vals))
    return out, total


def compact_offsets(mask, ops=None):
    """(N, S) bool -> (N, S) int32 offsets t of each row's set entries,
    ascending and front-packed, padded -1, and the (N,) int32 counts.

    ops: the fold-kernel bundle whose `compact_rows` front-packs the offsets;
    None = a stable argsort of ~mask, whose order IS the offsets.  Both are
    bit-identical."""
    N, S = mask.shape
    if ops is not None:
        t = torch.arange(S, dtype=torch.int32, device=mask.device)
        (ts,), cnt = ops.compact_rows(mask, (t.expand(N, S).contiguous(),),
                                      (-1,))
        return ts, cnt
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    ts = torch.where(torch.gather(mask, 1, order), order.to(torch.int32), -1)
    return ts, mask.sum(dim=1, dtype=torch.int32)


def winner_dedup(v, eligible, n_rows: int, method: str = "scatter"):
    """First-occurrence selection among eligible entries with equal v (the
    paper's atomicOr first-thread-wins, deterministically).

    "scatter": scatter-min of slot ids into an (n_rows,) claim array;
    "sort": stable sort by v, first of each run.  Returns a bool mask of
    winners (subset of `eligible`)."""
    slots = _arange(v.shape[0], v)
    if method == "sort":
        key = torch.where(eligible, v, I32_MAX)
        ks, order = torch.sort(key, stable=True)
        first = torch.ones_like(eligible)
        first[1:] = ks[1:] != ks[:-1]
        first &= ks < I32_MAX
        win = torch.empty_like(eligible)
        win[order] = first
        return win & eligible
    if method != "scatter":
        raise ValueError(f"dedup={method!r}: expected 'scatter' or 'sort'")
    # ineligible lanes add I32_MAX -- the identity of min -- at their own v,
    # instead of all meeting on one sink slot (JAX's drop index), where
    # their atomics would serialise
    v = v.clamp(0, n_rows - 1)
    claim = torch.full((n_rows,), I32_MAX, dtype=torch.int32,
                       device=v.device)
    claim.scatter_reduce_(0, v.long(),
                          torch.where(eligible, slots, I32_MAX), "amin")
    return eligible & (claim[v] == slots)


def _bucket_append_flat(flat, cap: int, dst_cnt, v, tgt, take,
                        n_buckets: int):
    """`bucket_append` into a flat (n_buckets * cap + 1,) buffer whose last
    slot is the sink; writes `flat` in place, returns the new counts."""
    key = torch.where(take, tgt, n_buckets).to(torch.int32)
    ks, order = torch.sort(key, stable=True)
    vs = v[order]
    seg_start = torch.searchsorted(ks, _arange(n_buckets + 1, ks),
                                   out_int32=True)
    pos = _arange(ks.shape[0], ks) - seg_start[ks.clamp(0, n_buckets)]
    ok = ks < n_buckets
    row = torch.where(ok, ks, 0)
    col = dst_cnt[row] + pos
    ok &= col < cap
    idx = torch.where(ok, row.long() * cap + col.clamp(0, cap - 1),
                      n_buckets * cap)
    flat[idx] = torch.where(ok, vs, -1).to(torch.int32)
    add = torch.diff(seg_start)[:n_buckets]
    return dst_cnt + torch.minimum(add, cap - dst_cnt)


def bucket_append(dst, dst_cnt, v, tgt, take, n_buckets: int):
    """Append v[take] into per-target buckets (paper Alg. 3 lines 9-14).

    dst: (n_buckets, cap) padded -1; dst_cnt: (n_buckets,).  Stable sort by
    target, per-segment positions, scatter at dst_cnt[tgt] + position;
    entries overflowing `cap` are dropped.  Returns (dst', dst_cnt')."""
    cap = dst.shape[1]
    flat = torch.cat([dst.reshape(-1), _i32([-1], dst)])
    cnt = _bucket_append_flat(flat, cap, dst_cnt, v, tgt, take, n_buckets)
    return flat[:-1].reshape(n_buckets, cap), cnt


def append_padded(buf, cnt, vals, valid):
    """Append vals[valid] to a padded (cap,) buffer at position cnt."""
    b, c = bucket_append(buf[None, :], cnt.reshape(1), vals,
                         torch.zeros_like(vals), valid, 1)
    return b[0], c[0]


def wrap_i32(x64):
    """int64 -> int32 with the two's-complement wrap of JAX's int32."""
    return ((x64 + 2**31) % 2**32 - 2**31).to(torch.int32)


def u16_bits(x):
    """Integers -> int16 tensor holding the uint16 bit pattern of x mod
    2^16 (the delta codec's wire type; torch's uint16 has few ops)."""
    x = x.to(torch.int32) & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16)


def u16_values(bits):
    """int16 uint16 bit patterns -> their int32 values in [0, 65536)."""
    return bits.to(torch.int32) & 0xFFFF


def pack_bitmap(mask):
    """(..., S) bool -> (..., ceil(S/32)) int32 words, little-endian bits."""
    S = mask.shape[-1]
    W = (S + 31) // 32
    pad = W * 32 - S
    if pad:
        mask = torch.cat([mask, torch.zeros(mask.shape[:-1] + (pad,),
                                            dtype=torch.bool,
                                            device=mask.device)], dim=-1)
    m = mask.reshape(mask.shape[:-1] + (W, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, device=mask.device)
    return wrap_i32((m * weights).sum(dim=-1))


def unpack_bitmap(words, S: int):
    """(..., W) int32 words -> (..., S) bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :S].to(torch.bool)


def set_bits(words, v, take):
    """Set bit v[take] in the packed bitmap, in place (the incremental twin
    of `pack_bitmap`).  Callers guarantee the taken v are DISTINCT and their
    bits unset (winner_dedup output on unvisited candidates), so adding the
    single-bit values is an exact OR that never overflows int32 (bit 31 is
    the int32 minimum).  Untaken lanes add 0 to their own word (not all to
    one word, where their atomics would serialise)."""
    bit = wrap_i32(torch.ones_like(v, dtype=torch.int64) << (v & 31).long())
    w = (v >> 5).clamp(0, words.shape[0] - 1)
    words.index_add_(0, w.long(), torch.where(take, bit, 0))
    return words


def reference_expand_chunk(gids, cumul, all_front, front_total, col_off,
                           row_idx):
    """One chunk of the paper's column scan in plain torch -- the JAX
    package's reference map/gather formulas.

    Returns (v, u, k, addr, valid): candidate local rows (masked lanes
    -> 0), parent frontier cols, frontier slot index, clipped CSC edge
    address, live-lane mask."""
    ncl = all_front.shape[0]
    nnz_cap = row_idx.shape[0]
    k = torch.searchsorted(cumul, gids, right=True, out_int32=True) - 1
    k = k.clamp(0, ncl - 1)
    u = all_front.clamp(0, ncl - 1)[k]
    addr = (col_off[u] + gids - cumul[k]).clamp(0, nnz_cap - 1)
    valid = gids < cumul[front_total]
    v = torch.where(valid, row_idx[addr], 0).to(torch.int32)
    return v, u, k, addr, valid


def test_bit_blocks(words, c, block: int):
    """Test bit `c` of a row-gathered blocked bitmap.

    words: (R * W,) int32, R per-processor blocks of W = ceil(block/32)
    words, each packing `block` bits (`pack_bitmap` of one owned frontier
    mask).  Local col c lives in block c // block at bit c % block, so the
    layout stays exact when block % 32 != 0."""
    W = (block + 31) // 32
    blk, off = c // block, c % block
    w = words[(blk * W + (off >> 5)).long()]
    return ((w >> (off & 31)) & 1) != 0


def reference_bottomup_chunk(gids, cumul, total, row_off, col_idx, words, *,
                             block: int):
    """One chunk of the bottom-up parent search in plain torch -- the JAX
    package's reference formulas (`searchsorted` on the unclipped masked
    cumsum).

    cumul: (nrl + 1,) exclusive cumsum of the per-row degrees with visited
    rows zeroed; total: () int32 live edge count.  Returns (r, c, hit):
    candidate local row, its neighbour's local col (masked lanes -> 0), and
    whether that neighbour is in the frontier."""
    nrl = cumul.shape[0] - 1
    nnz_cap = col_idx.shape[0]
    r = torch.searchsorted(cumul, gids, right=True, out_int32=True) - 1
    r = r.clamp(0, nrl - 1)
    addr = (row_off[r] + gids - cumul[r]).clamp(0, nnz_cap - 1)
    valid = gids < total
    c = torch.where(valid, col_idx[addr], 0).to(torch.int32)
    hit = valid & test_bit_blocks(words, c, block)
    return r, c, hit


def reference_bottomup_values_chunk(gids, cumul, total, row_off, col_idx,
                                    words, dense_pay, *, block: int):
    """`reference_bottomup_chunk` with the pulled value: the value programs
    read the frontier neighbour's label / distance / source from a dense
    per-col channel.  Returns (r, pay, addr, hit), addr the clipped CSR
    edge address (for per-edge values)."""
    r, c, hit = reference_bottomup_chunk(gids, cumul, total, row_off,
                                         col_idx, words, block=block)
    addr = (row_off[r] + gids - cumul[r]).clamp(0, col_idx.shape[0] - 1)
    return r, dense_pay[c], addr, hit


def scan_plan(col_off, all_front, front_total):
    """The level's workload: (cumul (ncl + 1,) int32 exclusive cumsum of
    the live frontier degrees, total () int32 = edges to scan)."""
    ncl = all_front.shape[0]
    u_safe = all_front.clamp(0, ncl - 1)
    deg = col_off[u_safe + 1] - col_off[u_safe]
    deg = torch.where(_arange(ncl, deg) < front_total, deg, 0)
    cumul = exclusive_cumsum(deg)
    return cumul, cumul[front_total]


class ExpandResult(NamedTuple):
    visited: torch.Tensor
    level: torch.Tensor
    pred: torch.Tensor
    dst: torch.Tensor        # (C, S) local-row ids grouped by owner column
    dst_cnt: torch.Tensor    # (C,)
    edges_scanned: int       # this block's edges scanned this level


def expand_frontier(col_off, row_idx, visited, level, pred, all_front,
                    front_total, lvl: int, *, grid: Grid2D, i, j,
                    edge_chunk: int = 8192, expand_fn=None,
                    dedup: str = "scatter", plan=None) -> ExpandResult:
    """Scan the CSC columns of the gathered frontier (paper Alg. 3).

    visited / level / pred: this block's (n_rows + 1,) state with the sink
    slot, updated in place.  all_front: (n_cols_local,) local col indices
    (valid first `front_total`).  expand_fn: the chunk kernel
    (`repro_torch.kernels.expand.expand_chunk`), fed the packed visited
    bitmap that this loop then maintains incrementally; None = the plain
    scan.  plan: `(cumul, total)` with total an int, when the caller already
    computed `scan_plan` (the engine does, to read every block's total in
    one host read per level); None computes it here.
    """
    n_rows = visited.shape[0] - 1
    S, C = grid.S, grid.C
    ncl = grid.n_cols_local
    if plan is None:
        cumul, total = scan_plan(col_off, all_front, front_total)
        total = int(total)
    else:
        cumul, total = plan

    dst = torch.full((C * S + 1,), -1, dtype=torch.int32,
                     device=visited.device)
    dst_cnt = torch.zeros(C, dtype=torch.int32, device=visited.device)
    words = pack_bitmap(visited[:n_rows]) if expand_fn is not None else None
    slots = _arange(edge_chunk, visited)
    for start in range(0, total, edge_chunk):
        if expand_fn is None:
            v, u, _, _, valid = reference_expand_chunk(
                start + slots, cumul, all_front, front_total, col_off,
                row_idx)
            unvis = valid & ~visited[v]
        else:
            v, unvis, u = expand_fn(start, edge_chunk, cumul, all_front,
                                    front_total, col_off, row_idx, words)
        win = winner_dedup(v, unvis, n_rows, method=dedup)
        # mark visited (paper: atomicOr on the full-local-row bitmap -- this
        # is what makes every remote vertex fold at most once per search)
        tgt = torch.where(win, v, n_rows).long()
        visited[tgt] = True
        if words is not None:
            set_bits(words, v, win)
        # predecessor: global parent id, stored also for remote rows
        # (deferred resolution, paper sec. 3.5 / [2])
        pred[tgt] = (j * ncl + u).to(torch.int32)
        # local rows get their level here (Alg. 3 line 15)
        m = v // S
        is_local = win & (m == j)
        level[torch.where(is_local, v, n_rows).long()] = lvl
        dst_cnt = _bucket_append_flat(dst, S, dst_cnt, v, m, win, C)
    return ExpandResult(visited, level, pred, dst[:-1].reshape(C, S),
                        dst_cnt, total)


class UpdateResult(NamedTuple):
    visited: torch.Tensor
    level: torch.Tensor
    pred: torch.Tensor
    new_front: torch.Tensor   # (S,) local col ids of newly frontier vertices
    new_cnt: torch.Tensor


def update_frontier(int_verts, int_cnt, visited, level, pred, lvl: int, *,
                    grid: Grid2D, i, j) -> UpdateResult:
    """Process fold-received vertices (paper sec. 3.5).

    int_verts: (C, S) local-row ids received from each processor-column
    (sender m in slot m).  Received vertices are OWNED here; unvisited ones
    get level/visited set, pred <- -(sender_col + 2) (deferred), and are
    appended to the next frontier as local COL indices.  visited / level /
    pred carry the sink slot and are updated in place.
    """
    n_rows = visited.shape[0] - 1
    C, S = int_verts.shape
    sender = _arange(C, int_verts)[:, None].expand(C, S)
    mask = _arange(S, int_verts)[None, :] < int_cnt[:, None]
    v = torch.where(mask, int_verts, 0).reshape(-1)
    snd = sender.reshape(-1)
    eligible = mask.reshape(-1) & ~visited[v]
    win = winner_dedup(v, eligible, n_rows)
    tgt = torch.where(win, v, n_rows).long()
    visited[tgt] = True
    level[tgt] = lvl
    pred[tgt] = -(snd + 2)
    # new frontier = winners, converted row -> col index
    lc = row2col(v, i, j, grid)
    nf = torch.full((C * S + 1,), -1, dtype=torch.int32, device=v.device)
    cnt = _bucket_append_flat(nf, C * S, torch.zeros(1, dtype=torch.int32,
                                                     device=v.device),
                              lc, torch.zeros_like(lc), win, 1)
    return UpdateResult(visited, level, pred, nf[:S], cnt[0])
