"""Expand/fold exchanges and the fold wire format (DESIGN.md sec. 4 + 10),
the port of `repro/dist/exchange.py`.

Every fold is ONE `col_all_to_all` of one fused message: the list codec
sends [cnt | ids] int32 per destination column, 4*S + 4 bytes each; the
bitmap codec sends ceil(S/32) int32 bit words, 32x fewer; the delta codec
sends [cnt lo, cnt hi | gaps] uint16, 2*S + 4 bytes, and needs S <= 65536.
Each codec folds the whole (Rl, Cl, C, S) tensor of the topology's block
at once (one kernel launch per stage per fold, not one per processor); the
leading dims are the block's (`topology.LocalBlock`), the exchanged axes
keep the grid's R and C.  The uint16 words are
int16 tensors holding the JAX bit pattern (`core.frontier.u16_bits`).
"""
from __future__ import annotations

import torch

from repro_torch.core import frontier as F
from repro_torch.core.types import Grid2D
from repro_torch.kernels import fold as KF


def expand_exchange(front, front_cnt, *, topo, ops=None):
    """Gather the frontiers of every processor-column (paper line 13).

    front: (Rl, Cl, S) int32, front_cnt: (Rl, Cl).  Returns (all_front
    (Rl, Cl, n_cols_local) -- valid entries first, grid-row order
    preserved -- and front_total (Rl, Cl) int32).  Every processor of a
    column receives the same gather, so each column is compacted once and
    shared by the block's processors in it.  ops: the fold-kernel bundle
    for the compaction (None = the plain argsort)."""
    Rl, Cl = front.shape[:2]
    af = topo.row_gather(front)            # (Rl, Cl, R, S)
    ac = topo.row_gather(front_cnt)        # (Rl, Cl, R)
    cols = [F.compact_blocks(af[0, lj], ac[0, lj], ops=ops)
            for lj in range(Cl)]
    all_front = torch.stack([c[0] for c in cols])            # (Cl, ncl)
    total = torch.stack([c[1] for c in cols])                # (Cl,)
    return (all_front.unsqueeze(0).expand(Rl, Cl, -1),
            total.unsqueeze(0).expand(Rl, Cl))


def expand_exchange_values(front, front_cnt, payload, *, topo, fill=0,
                           ops=None):
    """`expand_exchange` with an aligned per-vertex payload channel (the
    value programs' label / distance / source id).

    Returns (all_front (Rl, Cl, n_cols_local), all_payload aligned, padded
    `fill`, front_total (Rl, Cl) int32): the same compaction order as
    `expand_exchange`, applied to ids and payload in lockstep.  The block's
    columns are compacted in one call (rows of the compaction), shared by
    the column's processors.  ops: the fold-kernel bundle (None = the
    plain argsort)."""
    R, S = topo.grid.R, topo.grid.S
    Rl, Cl = front.shape[:2]
    af = topo.row_gather(front)[0].reshape(Cl, R * S)    # column j's gather
    ap = topo.row_gather(payload)[0].reshape(Cl, R * S)
    ac = topo.row_gather(front_cnt)[0]                   # (Cl, R)
    mask = (torch.arange(S, dtype=torch.int32, device=front.device)
            < ac[..., None]).reshape(Cl, R * S)
    total = ac.sum(dim=1, dtype=torch.int32)
    if ops is not None:
        (fr, pl), _ = ops.compact_rows(mask, (af, ap), (-1, fill))
    else:
        order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
        valid = torch.gather(mask, 1, order)
        fr = torch.where(valid, torch.gather(af, 1, order), -1)
        pl = torch.where(valid, torch.gather(ap, 1, order), fill)
    return (fr.unsqueeze(0).expand(Rl, Cl, -1),
            pl.unsqueeze(0).expand(Rl, Cl, -1),
            total.unsqueeze(0).expand(Rl, Cl))


def resolve_preds(pred, *, topo):
    """Final deferred-predecessor exchange (paper sec. 3.5 / contribution [2]).

    pred: (Rl, Cl, n_rows_local) with deferred markers -(c+2).  One
    all_to_all of the pred rows (viewed as C blocks of S) within each grid
    row delivers, for every owned vertex, the parent recorded by the
    processor-column that folded it.  Returns the owned blocks
    (Rl, Cl, S)."""
    C, S = topo.grid.C, topo.grid.S
    Rl, Cl = pred.shape[:2]
    pb = pred.reshape(Rl, Cl, C, S)
    recv = topo.col_all_to_all(pb)                     # recv[i, j, m]
    lj = torch.arange(Cl, device=pred.device)
    own = pb[:, lj, topo.local.j0 + lj]                # pb[i, j, j]
    deferred = own < -1
    sender = (-own - 2).clamp(0, C - 1)
    from_sender = torch.gather(recv, 2, sender.unsqueeze(2).long())[:, :, 0]
    return torch.where(deferred, from_sender, own)


# ----------------------------------------------------------------------------
# int32 <-> uint16 value-channel splitting (the delta value-fold rides a
# 16-bit message; the halves reassemble the exact bit pattern)
# ----------------------------------------------------------------------------

def _i32_to_u16(v):
    """(..., S) int32 -> (..., 2*S) uint16 [lo, hi] pairs (int16 bits)."""
    pairs = torch.stack([v & 0xFFFF, (v >> 16) & 0xFFFF], dim=-1)
    return F.u16_bits(pairs.reshape(v.shape[:-1] + (2 * v.shape[-1],)))


def _u16_to_i32(u):
    """(..., 2*S) uint16 [lo, hi] pairs (int16 bits) -> (..., S) int32,
    bit-exact."""
    p = F.u16_values(u).reshape(u.shape[:-1] + (-1, 2)).to(torch.int64)
    return F.wrap_i32((p[..., 1] << 16) | p[..., 0])


class FoldCodec:
    """Strategy for the fold exchange's wire format.

    fold() maps per-owner-column discovery buckets to received owned rows:
      dst: (Rl, Cl, C, S) int32 local-row ids, bucket m holding rows of
      block m, padded -1, packed at the front; dst_cnt: (Rl, Cl, C) int32;
    returns (int_verts (Rl, Cl, C, S) -- processor (i, j)'s owned rows,
    one row per sender -- and int_cnt (Rl, Cl, C)).

    ops: the fold-kernel bundle (`repro_torch.kernels.fold`) for the
    codec's encode / decode stages; None = the plain formulas.  grid: the
    grid the codec will fold on, for codecs that do not work at every block
    size (they raise ValueError)."""
    name = "?"

    def __init__(self, ops=None, grid: Grid2D = None):
        self.ops = ops

    def wire_bytes(self, grid: Grid2D) -> int:
        """Bytes one processor SENDS on one fused set-fold message."""
        raise NotImplementedError

    def fold(self, dst, dst_cnt, *, topo):
        raise NotImplementedError

    # -- value-carrying fold: every travelling vertex carries an int32 value
    # in the tail of the same message, front-packed in the CANONICAL
    # (ascending, front-packed) bucket order that `algos.program.pack_blocks`
    # provides, so every codec delivers the same values.

    def wire_bytes_values(self, grid: Grid2D) -> int:
        """Static capacity of one fused value-fold message (ids + header +
        the S-slot value channel)."""
        return self.wire_bytes(grid) + grid.C * 4 * grid.S

    def wire_bytes_values_sent(self, grid: Grid2D, total_count) -> int:
        """Count-proportional bytes of one value-fold: a count-aware
        transport ships only `total_count` value words beyond the set-fold
        message."""
        return self.wire_bytes(grid) + 4 * total_count

    def fold_values(self, ids, cnt, vals, *, topo):
        """ids: (Rl, Cl, C, S) local-row ids per owner bucket, ascending,
        front-packed, padded -1; cnt: (Rl, Cl, C); vals: aligned int32.
        Returns (recv_ids (Rl, Cl, C, S) owned rows j*S + t, ascending
        front-packed per sender, recv_cnt (Rl, Cl, C), recv_vals
        aligned)."""
        raise NotImplementedError


class ListFold(FoldCodec):
    """32-bit local indices, the paper's own wire format (sec. 3.3), with
    the count in the leading header word of each bucket."""
    name = "list"

    def wire_bytes(self, grid: Grid2D) -> int:
        return grid.C * (4 * grid.S + 4)

    def fold(self, dst, dst_cnt, *, topo):
        msg = torch.cat([dst_cnt.unsqueeze(-1), dst], dim=-1)
        recv = topo.col_all_to_all(msg)
        return recv[..., 1:], recv[..., 0]

    def fold_values(self, ids, cnt, vals, *, topo):
        S = topo.grid.S
        msg = torch.cat([cnt.unsqueeze(-1), ids, vals], dim=-1)
        recv = topo.col_all_to_all(msg)
        return recv[..., 1:1 + S], recv[..., 0], recv[..., 1 + S:]


def receiver_cols(topo):
    """Each of the block's processors' grid column j, broadcastable to
    (Rl, Cl, C, S): the receiver of recv[i, j, m]."""
    return topo.local.cols(topo.device).view(1, -1, 1, 1)


class BitmapFold(FoldCodec):
    """1-bit-per-vertex block bitmap: 32x below `list` at identical
    semantics.  No header word: counts are derived from the received
    bits."""
    name = "bitmap"

    def wire_bytes(self, grid: Grid2D) -> int:
        return grid.C * 4 * ((grid.S + 31) // 32)

    @staticmethod
    def encode(dst, dst_cnt, S: int, ops=None):
        """(..., S) id buckets -> (..., ceil(S/32)) int32 bit words."""
        lead = dst.shape[:-1]
        d = dst.reshape(-1, S)
        N = d.shape[0]
        valid = d >= 0
        # torch has no drop mode: a pad adds 0 at its own slot instead of
        # all pads meeting on one dump column, where their stores would
        # serialise; valid ids add 1 at their offset (dst % S of a -1 pad
        # would be S - 1, hence the where)
        slot = torch.arange(S, dtype=torch.int32, device=d.device)
        t = torch.where(valid, d % S, slot)
        row = torch.arange(N, dtype=torch.int64, device=d.device)[:, None]
        hits = torch.zeros(N * S, dtype=torch.int32, device=d.device)
        hits.index_add_(0, (row * S + t).reshape(-1),
                        valid.reshape(-1).to(torch.int32))
        onehot = (hits != 0).reshape(N, S)
        words = ops.pack_bits(onehot) if ops is not None \
            else F.pack_bitmap(onehot)
        return words.reshape(lead + (words.shape[-1],))

    @staticmethod
    def decode(words, j, S: int, ops=None):
        """(..., W) received words -> ascending owned rows j*S + t per
        sender, front-packed, padded -1, and their counts.  j: the
        receiver's grid column, broadcastable against (..., S).  The
        offsets t are compacted and j*S added after, so no (..., S) tensor
        of owned rows is built."""
        lead = words.shape[:-1]
        w = words.reshape(-1, words.shape[-1]).contiguous()
        mask = ops.unpack_bits(w, S) if ops is not None \
            else F.unpack_bitmap(w, S)
        ts, cnt = F.compact_offsets(mask, ops)
        ts = ts.reshape(lead + (S,))
        return torch.where(ts >= 0, j * S + ts, -1), cnt.reshape(lead)

    def fold(self, dst, dst_cnt, *, topo):
        S = topo.grid.S
        words = topo.col_all_to_all(self.encode(dst, dst_cnt, S, self.ops))
        return self.decode(words, receiver_cols(topo), S, self.ops)

    def fold_values(self, ids, cnt, vals, *, topo):
        # decode delivers ascending front-packed rows -- exactly the
        # canonical order the ids (and hence the values channel) arrived in;
        # the values travel as the same int32 words (no uint32 bitcast)
        S = topo.grid.S
        words = self.encode(ids, cnt, S, self.ops)
        W = words.shape[-1]
        recv = topo.col_all_to_all(torch.cat([words, vals], dim=-1))
        ri, rc = self.decode(recv[..., :W], receiver_cols(topo), S,
                             self.ops)
        return ri, rc, recv[..., W:]


class DeltaFold(FoldCodec):
    """Sort + delta + 16-bit narrowing (Romera & Froning 2017, sec. III):
    within one fold message all ids share the destination block, so after
    sorting, consecutive gaps are < S and fit a uint16 -- half the bytes of
    `list` whatever the frontier density.  The count rides a two-uint16
    header ahead of the gaps (a count may be S = 65536, one past uint16)."""
    name = "delta"

    def __init__(self, ops=None, grid: Grid2D = None):
        if grid is not None and grid.S > (1 << 16):
            raise ValueError(
                f"delta fold needs S <= 65536 (16-bit gaps), got S={grid.S}")
        super().__init__(ops, grid)

    def wire_bytes(self, grid: Grid2D) -> int:
        return grid.C * (2 * grid.S + 4)

    @staticmethod
    def encode(dst, dst_cnt, S: int, ops=None):
        """(..., S) id buckets -> (..., S) uint16 ascending first-order
        gaps (slot 0 is the absolute first offset)."""
        lead = dst.shape[:-1]
        valid = (torch.arange(S, dtype=torch.int32, device=dst.device)
                 < dst_cnt[..., None]).reshape(-1, S)
        t = torch.where(valid, dst.reshape(-1, S) % S, F.I32_MAX)
        ts = torch.sort(t, dim=1).values          # valid entries sort first
        gaps = ops.delta_gaps(ts, valid) if ops is not None \
            else KF.plain_delta_gaps(ts, valid)
        return gaps.reshape(lead + (S,))

    @staticmethod
    def decode(gaps, cnt, j, S: int, ops=None):
        """(..., S) uint16 gaps + (...) counts -> owned rows j*S + t,
        front-packed, padded -1.  j: the receiver's grid column,
        broadcastable against (..., S)."""
        g = gaps.reshape(-1, S).contiguous()
        pos = ops.delta_positions(g) if ops is not None \
            else KF.plain_delta_positions(g)
        valid = torch.arange(S, dtype=torch.int32,
                             device=gaps.device) < cnt[..., None]
        return torch.where(valid, j * S + pos.reshape(gaps.shape), -1), cnt

    @staticmethod
    def _header(cnt):
        """(...) int32 counts -> (..., 2) uint16 [lo, hi] header words."""
        return _i32_to_u16(cnt[..., None])

    @staticmethod
    def _read_header(hdr):
        return _u16_to_i32(hdr)[..., 0]

    def fold(self, dst, dst_cnt, *, topo):
        S = topo.grid.S
        msg = torch.cat([self._header(dst_cnt),
                         self.encode(dst, dst_cnt, S, self.ops)], dim=-1)
        recv = topo.col_all_to_all(msg)
        cnt = self._read_header(recv[..., :2])
        return self.decode(recv[..., 2:], cnt, receiver_cols(topo), S,
                           self.ops)

    def fold_values(self, ids, cnt, vals, *, topo):
        # encode sorts per bucket; canonical input is already sorted, so the
        # delivered order equals the sent order and the values align
        S = topo.grid.S
        msg = torch.cat([self._header(cnt),
                         self.encode(ids, cnt, S, self.ops),
                         _i32_to_u16(vals)], dim=-1)
        recv = topo.col_all_to_all(msg)
        rc = self._read_header(recv[..., :2])
        ri, _ = self.decode(recv[..., 2:2 + S], rc, receiver_cols(topo), S,
                            self.ops)
        return ri, rc, _u16_to_i32(recv[..., 2 + S:])


FOLD_CODECS = {"list": ListFold, "bitmap": BitmapFold, "delta": DeltaFold}


def get_fold_codec(spec, grid: Grid2D, ops=None) -> FoldCodec:
    """Resolve "list" | "bitmap" | "delta" | a FoldCodec instance for
    `grid`.  ops: the fold-kernel bundle threaded into a constructed codec
    (ignored for an instance).  A codec that cannot run at this grid's
    block size (delta needs S <= 65536) raises a ValueError naming the
    codecs that do."""
    if isinstance(spec, FoldCodec):
        return spec
    try:
        cls = FOLD_CODECS[spec]
    except KeyError:
        raise ValueError(
            f"unknown fold codec {spec!r}; choose from {sorted(FOLD_CODECS)}")
    try:
        return cls(ops, grid)
    except ValueError as e:
        working = []
        for name, other in FOLD_CODECS.items():
            if name == spec:
                continue
            try:
                other(ops, grid)
            except ValueError:
                continue
            working.append(name)
        raise ValueError(
            f"fold_codec={spec!r} cannot run on this grid ({grid.R}x{grid.C},"
            f" block size S={grid.S}): {e}; codecs that do work at this "
            f"block size: {sorted(working)}") from e
