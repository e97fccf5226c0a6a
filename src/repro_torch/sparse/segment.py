"""Segment-based message passing (the GNN primitive), the port of
`repro/sparse/segment.py`.

Neighbour aggregation is gather -> transform -> segment-reduce over an edge
index, as in the JAX package.  Three of JAX's index rules are ported with
care, because torch raises where JAX drops or fills:

  * `jax.ops.segment_*` drop every segment id outside [0, num_segments),
    negative ones included;
  * `x.at[idx].add(v, mode="drop")` first wraps an index in [-n, -1] to
    idx + n (numpy's rule), then drops what is still outside [0, n);
  * `jnp.take(table, idx, axis=0)` wraps the same way and fills a row
    outside the table with NaN.

The port scatters a dropped entry into one sink row past the end, which it
then slices away (`at_add`, `at_max`, `segment_*`), and fills with NaN where
`take_rows` finds no row.
"""
from __future__ import annotations

import torch


def _trail(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row mask viewed against `like`'s trailing dims."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _sink(idx: torch.Tensor, n: int, *, wrap: bool) -> torch.Tensor:
    """int64 indices with every dropped entry moved to the sink row n."""
    idx = idx.long()
    if wrap:
        idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _lowest(dtype) -> float:
    return -float("inf") if dtype.is_floating_point else torch.iinfo(dtype).min


def _scatter_add(values, idx, n: int) -> torch.Tensor:
    out = values.new_zeros((n + 1,) + tuple(values.shape[1:]))
    return out.index_add(0, idx, values)[:n]


def _scatter_max(values, idx, n: int, init) -> torch.Tensor:
    out = values.new_full((n + 1,) + tuple(values.shape[1:]), init)
    full = _trail(idx, values).expand_as(values)
    return out.scatter_reduce(0, full, values, "amax", include_self=True)[:n]


def at_add(n: int, idx, values) -> torch.Tensor:
    """`jnp.zeros((n,) + values.shape[1:]).at[idx].add(values,
    mode="drop")`."""
    return _scatter_add(values, _sink(idx, n, wrap=True), n)


def at_max(n: int, idx, values) -> torch.Tensor:
    """`jnp.full((n,) + values.shape[1:], lowest).at[idx].max(values,
    mode="drop")`, lowest the dtype's (-inf for floats)."""
    return _scatter_max(values, _sink(idx, n, wrap=True), n,
                        _lowest(values.dtype))


def take_rows(table: torch.Tensor, idx) -> torch.Tensor:
    """`jnp.take(table, idx, axis=0)`: negative ids wrap, a row past either
    end is NaN (floating tables)."""
    n = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    ok = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)]
    return torch.where(_trail(ok, rows), rows, float("nan"))


def segment_sum(values, segment_ids, num_segments: int):
    return _scatter_add(values, _sink(segment_ids, num_segments, wrap=False),
                        num_segments)


def segment_mean(values, segment_ids, num_segments: int):
    s = segment_sum(values, segment_ids, num_segments)
    c = segment_sum(values.new_ones((values.shape[0],)), segment_ids,
                    num_segments)
    return s / torch.clamp(c, min=1)[..., None] if values.dim() > 1 else \
        s / torch.clamp(c, min=1)


def segment_max(values, segment_ids, num_segments: int):
    """An empty segment holds the lowest value of the dtype (-inf for
    floats), as `jax.ops.segment_max` does."""
    return _scatter_max(values, _sink(segment_ids, num_segments, wrap=False),
                        num_segments, _lowest(values.dtype))


def degree_norm(edge_dst, edge_src, n: int, valid=None):
    """GCN symmetric normalisation 1/sqrt(d_i d_j) per edge."""
    ones = torch.ones(edge_dst.shape, dtype=torch.float32,
                      device=edge_dst.device)
    if valid is not None:
        ones = torch.where(valid, ones, 0.0)
    deg = at_add(n, edge_dst, ones)
    # JAX's second scatter adds zeros over edge_src (kept for the shape)
    deg = deg + at_add(n, edge_src, torch.zeros_like(ones))
    d = torch.clamp(deg, min=1.0)
    return torch.rsqrt(d[edge_dst.long().clamp(0, n - 1)]) * \
        torch.rsqrt(d[edge_src.long().clamp(0, n - 1)])


def gather_scatter(h, edge_src, edge_dst, n: int, *, reduce="sum",
                   edge_weight=None, valid=None):
    """y[i] = reduce_j over edges (j -> i) of w_e * h[j]."""
    msg = h[edge_src.long().clamp(0, n - 1)]
    if edge_weight is not None:
        msg = msg * edge_weight[:, None]
    if valid is not None:
        msg = torch.where(_trail(valid, msg), msg,
                          0.0 if reduce != "max" else -float("inf"))
    dst = torch.where(valid, edge_dst.long(), n) if valid is not None \
        else edge_dst
    if reduce == "sum":
        return at_add(n, dst, msg)
    if reduce == "mean":
        s = at_add(n, dst, msg)
        c = at_add(n, dst, h.new_ones(dst.shape))
        return s / torch.clamp(c, min=1)[:, None]
    if reduce == "max":
        out = at_max(n, dst, msg)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(reduce)
