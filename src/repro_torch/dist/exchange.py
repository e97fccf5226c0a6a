"""Expand/fold exchanges and the fold wire format (DESIGN.md sec. 4 + 10),
the port of `repro/dist/exchange.py` on the stacked grid.

Every fold is ONE `col_all_to_all` of one fused message: the list codec
sends [cnt | ids] int32 per destination column, 4*S + 4 bytes each; the
bitmap codec sends ceil(S/32) int32 bit words, 32x fewer.  Each codec folds
the whole stacked (R, C, C, S) tensor at once (one `pack_bits` launch per
fold, not one per processor).  The delta codec comes with ROADMAP A8.
"""
from __future__ import annotations

import torch

from repro_torch.core import frontier as F
from repro_torch.core.types import Grid2D


def expand_exchange(front, front_cnt, *, topo, ops=None):
    """Gather the frontiers of every processor-column (paper line 13).

    front: (R, C, S) int32, front_cnt: (R, C).  Returns (all_front
    (R, C, n_cols_local) -- valid entries first, grid-row order preserved --
    and front_total (R, C) int32).  Every processor of a column receives
    the same gather, so each column is compacted once and shared by its R
    processors.  ops: the fold-kernel bundle for the compaction (None = the
    plain argsort)."""
    R, C = topo.grid.R, topo.grid.C
    af = topo.row_gather(front)            # (R, C, R, S)
    ac = topo.row_gather(front_cnt)        # (R, C, R)
    cols = [F.compact_blocks(af[0, j], ac[0, j], ops=ops) for j in range(C)]
    all_front = torch.stack([c[0] for c in cols])            # (C, ncl)
    total = torch.stack([c[1] for c in cols])                # (C,)
    return (all_front.unsqueeze(0).expand(R, C, -1),
            total.unsqueeze(0).expand(R, C))


def resolve_preds(pred, *, topo):
    """Final deferred-predecessor exchange (paper sec. 3.5 / contribution [2]).

    pred: (R, C, n_rows_local) with deferred markers -(c+2).  One
    all_to_all of the pred rows (viewed as C blocks of S) within each grid
    row delivers, for every owned vertex, the parent recorded by the
    processor-column that folded it.  Returns the owned blocks (R, C, S)."""
    R, C, S = topo.grid.R, topo.grid.C, topo.grid.S
    pb = pred.reshape(R, C, C, S)
    recv = topo.col_all_to_all(pb)                     # recv[i, j, m]
    cols = torch.arange(C, device=pred.device)
    own = pb[:, cols, cols]                            # (R, C, S) = pb[i, j, j]
    deferred = own < -1
    sender = (-own - 2).clamp(0, C - 1)
    from_sender = torch.gather(recv, 2, sender.unsqueeze(2).long())[:, :, 0]
    return torch.where(deferred, from_sender, own)


class FoldCodec:
    """Strategy for the fold exchange's wire format.

    fold() maps per-owner-column discovery buckets to received owned rows:
      dst: (R, C, C, S) int32 local-row ids, bucket m holding rows of block
      m, padded -1, packed at the front; dst_cnt: (R, C, C) int32;
    returns (int_verts (R, C, C, S) -- processor (i, j)'s owned rows, one
    row per sender -- and int_cnt (R, C, C)).

    ops: the fold-kernel bundle (`repro_torch.kernels.fold`) for the
    codec's encode / decode stages; None = the plain formulas."""
    name = "?"

    def __init__(self, ops=None):
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
        """ids: (R, C, C, S) local-row ids per owner bucket, ascending,
        front-packed, padded -1; cnt: (R, C, C); vals: aligned int32.
        Returns (recv_ids (R, C, C, S) owned rows j*S + t, ascending
        front-packed per sender, recv_cnt (R, C, C), recv_vals aligned)."""
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


def _receiver_col(topo):
    """Each stacked processor's grid column j, broadcastable to
    (R, C, C, S): the receiver of recv[i, j, m]."""
    return torch.arange(topo.grid.C, dtype=torch.int32,
                        device=topo.device).view(1, -1, 1, 1)


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
        return self.decode(words, _receiver_col(topo), S, self.ops)

    def fold_values(self, ids, cnt, vals, *, topo):
        # decode delivers ascending front-packed rows -- exactly the
        # canonical order the ids (and hence the values channel) arrived in;
        # the values travel as the same int32 words (no uint32 bitcast)
        S = topo.grid.S
        words = self.encode(ids, cnt, S, self.ops)
        W = words.shape[-1]
        recv = topo.col_all_to_all(torch.cat([words, vals], dim=-1))
        ri, rc = self.decode(recv[..., :W], _receiver_col(topo), S,
                             self.ops)
        return ri, rc, recv[..., W:]


FOLD_CODECS = {"list": ListFold, "bitmap": BitmapFold}


def get_fold_codec(spec, grid: Grid2D, ops=None) -> FoldCodec:
    """Resolve "list" | "bitmap" | a FoldCodec instance for `grid`.  ops:
    the fold-kernel bundle threaded into a constructed codec (ignored for
    an instance)."""
    if isinstance(spec, FoldCodec):
        return spec
    if spec == "delta":
        raise ValueError(
            f"fold_codec='delta' is not ported yet (ROADMAP A8; it needs "
            f"S <= 65536, this grid has S={grid.S}); the port has "
            f"{sorted(FOLD_CODECS)}")
    try:
        return FOLD_CODECS[spec](ops)
    except KeyError:
        raise ValueError(
            f"unknown fold codec {spec!r}; choose from {sorted(FOLD_CODECS)}")
