"""Expand/fold exchanges and the fold wire format (DESIGN.md sec. 4 + 10),
the port of `repro/dist/exchange.py` on the stacked grid.

Every fold is ONE `col_all_to_all` of one fused message: the list codec
sends [cnt | ids] int32 per destination column, 4*S + 4 bytes each.  Only
`list` is ported; `bitmap` and `delta` come with ROADMAP A6.
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
    row per sender -- and int_cnt (R, C, C))."""
    name = "?"

    def wire_bytes(self, grid: Grid2D) -> int:
        """Bytes one processor SENDS on one fused set-fold message."""
        raise NotImplementedError

    def fold(self, dst, dst_cnt, *, topo):
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


FOLD_CODECS = {"list": ListFold}


def get_fold_codec(spec, grid: Grid2D) -> FoldCodec:
    """Resolve a fold codec spelling; only "list" is ported."""
    if isinstance(spec, FoldCodec):
        return spec
    if spec in ("bitmap", "delta"):
        raise ValueError(
            f"fold_codec={spec!r} is not ported yet (ROADMAP A6); the port "
            f"has {sorted(FOLD_CODECS)}")
    try:
        return FOLD_CODECS[spec]()
    except KeyError:
        raise ValueError(
            f"unknown fold codec {spec!r}; choose from {sorted(FOLD_CODECS)}")
