"""EmbeddingBag, the port of `repro/sparse/embedding_bag.py`: multi-hot
bags with optional per-sample weights, built from a row gather and a
segment sum with the JAX package's formula.

`torch.nn.functional.embedding_bag` is not used: its padding and
empty-bag rules differ (JAX pads fixed bags with -1, clips the ids it
gathers and sums the CSR bags by `searchsorted` segment ids)."""
from __future__ import annotations

import torch

from repro_torch.sparse.segment import segment_sum


def embedding_bag(table, indices, offsets=None, *, weights=None, mode="sum"):
    """table: (V, d); either
         indices (B, L) fixed-size bags (padded with -1), or
         flat indices (NNZ,) + offsets (B+1,) CSR-style ragged bags.
    Returns (B, d); a fixed bag's sum keeps its rows' dtype (an int32
    table sums in int32, as in JAX), a mean divides into float32."""
    V = table.shape[0]
    if offsets is None:
        valid = indices >= 0
        emb = table[indices.long().clamp(0, V - 1)]
        if weights is not None:
            emb = emb * weights[..., None]
        emb = torch.where(valid[..., None], emb, 0)
        out = emb.sum(dim=1, dtype=emb.dtype)
        if mode == "mean":
            out = out / torch.clamp(valid.sum(dim=1), min=1)[:, None]
        return out
    B = offsets.shape[0] - 1
    nnz = indices.shape[0]
    ends = offsets[1:].long()
    seg = torch.searchsorted(
        ends, torch.arange(nnz, dtype=torch.int64, device=ends.device),
        right=True).to(torch.int32)
    emb = table[indices.long().clamp(0, V - 1)]
    if weights is not None:
        emb = emb * weights[:, None]
    out = segment_sum(emb, seg, B)
    if mode == "mean":
        cnt = torch.clamp(torch.diff(offsets), min=1)
        out = out / cnt[:, None]
    return out
