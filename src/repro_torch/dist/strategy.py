"""Pluggable exchange strategies for the fold all-to-all (DESIGN.md sec. 14),
the port of `repro/dist/strategy.py` on the stacked grid.

Every fold (and the final `resolve_preds`) routes an (R, C, C, ...) message
tensor within each processor-row: x[i, j, d] is processor (i, j)'s payload
for column d.  How those payloads travel is a swappable concern:

  flat       ONE all-to-all: the sender and receiver column axes swapped
             (recv[i, j, m] = x[i, m, j]); every column sends C-1 direct
             messages per exchange.
  butterfly  log2(C) XOR-paired stages over the sender column axis.
             Payload (j -> d) sits at label row r = j XOR d and hops once
             per set bit of r, so each column sends log2(C) messages of
             C/2 fused rows per exchange: fewer messages ((C/2)*log2(C)
             row payloads of volume against C-1).

Both deliver the identical received tensor, byte for byte: the butterfly
is store-and-forward (rows are re-fused into each stage's message but never
re-encoded), so every codec, `resolve_preds` and the value channels are
strategy-agnostic.  The strategy binds at the topology
(`StackedTopology.with_exchange`); `BFSConfig(exchange=...)` selects, and
"auto" resolves to the butterfly on power-of-two C >= 4 (where it strictly
reduces the message count), flat otherwise.

On the stacked grid every column lives on one device, so no payload travels
and both strategies route with the same transpose-copy; the strategy's
validation and accounting (the trace's `msgs` and `wire`) are what differ.
Across a process group (`dist.topology.GroupTopology`) flat is one
all_to_all within the row group and the butterfly's stages are real
transfers: a stage whose partner column lies in the rank's own block is a
local copy, any other one pairwise exchange.  Their XOR schedule is the JAX
package's `repro.dist.strategy.emulate_exchange`, which the tests hold this
route to.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import Grid2D

U32_MASK = 0xFFFFFFFF           # the JAX accounting's uint32 wrap
# the integer dtype of each element size: the butterfly routes a same-size
# integer view (torch has no index_put for uint16 / uint32)
_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}


def _log2_exact(c: int) -> int:
    """log2(C) for power-of-two C (validated before use)."""
    return int(c).bit_length() - 1


def flat_all_to_all(x):
    """(R, C, C, ...) with x[i, j, d] = processor (i, j)'s payload for
    column d -> recv[i, j, m] = x[i, m, j] (what column m sent to j)."""
    return x.transpose(1, 2).contiguous()


class ExchangeStrategy:
    """Strategy for routing the fold's stacked message tensor.

    `all_to_all(x, topo)` must return exactly what the topology's flat
    route returns -- same values, same order, same bytes (topo None: the
    stacked grid, `flat_all_to_all`).  The accounting methods
    price one exchange for the telemetry trace: `msgs_per_exchange` counts
    the point-to-point messages one column sends, `wire_bytes` scales a
    codec's flat per-exchange byte figure to this route (set folds), and
    `value_extra_bytes` the count-proportional value-channel bytes beyond
    it (value folds)."""
    name = "?"

    def validate(self, grid: Grid2D, col_axes: tuple) -> None:
        """Raise ValueError when this strategy cannot run on the grid."""

    def all_to_all(self, x, topo=None):
        raise NotImplementedError

    def msgs_per_exchange(self, C: int) -> int:
        raise NotImplementedError

    def wire_bytes(self, flat_bytes: int, C: int) -> int:
        """Bytes one column sends per exchange, given the codec's flat
        figure (C equal per-destination buckets, own bucket included)."""
        raise NotImplementedError

    def value_extra_bytes(self, cnt, j, C: int):
        """Per-processor value-channel bytes beyond `wire_bytes`: cnt
        (..., C) int32 entries per destination bucket, j the sending
        column(s), broadcastable against cnt's leading dims.  4 bytes per
        entry per hop, as an int64 tensor wrapped to uint32 (the JAX
        channel's dtype)."""
        raise NotImplementedError


class FlatExchange(ExchangeStrategy):
    """The single-collective route: one all-to-all."""
    name = "flat"

    def all_to_all(self, x, topo=None):
        return flat_all_to_all(x) if topo is None \
            else topo.flat_all_to_all(x)

    def msgs_per_exchange(self, C: int) -> int:
        return max(C - 1, 0)            # the own bucket never leaves

    def wire_bytes(self, flat_bytes: int, C: int) -> int:
        return flat_bytes               # the codec formulas ARE this route

    def value_extra_bytes(self, cnt, j, C: int):
        return (4 * cnt.sum(dim=-1, dtype=torch.int64)) & U32_MASK


class ButterflyExchange(ExchangeStrategy):
    """log2(C)-stage XOR-hypercube route (ButterFly BFS, Green 2103.13577).

    Column j stores payload (j -> d) at label row r = j XOR d:
    H[i, j, r] = x[i, j, j ^ r].  Stage s = 0..log2(C)-1 ships the C/2 rows
    with bit s of r set to partner column j XOR 2^s, so after it
    H[i, j, r] = H[i, j ^ 2^s, r] on those rows (the others stay).  A
    payload with label r hops popcount(r) times and lands on j XOR r = d;
    recv[i, j, m] = H[i, j, m ^ j] is byte-identical to the flat route.
    This schedule prices the trace's `msgs` and `wire`.  On the stacked
    grid no payload travels, so the route is flat's copy; across a process
    group the stages run (`topo.butterfly_swap`)."""
    name = "butterfly"

    def validate(self, grid: Grid2D, col_axes: tuple) -> None:
        C = grid.C
        if C & (C - 1):
            raise ValueError(
                f"exchange='butterfly' needs a power-of-two column count, "
                f"got C={C} (grid {grid.R}x{grid.C}); exchange='flat' works "
                f"on any grid")
        if len(col_axes) > 1:
            raise ValueError(
                f"exchange='butterfly' routes over ONE column mesh axis, "
                f"got col_axes={col_axes}; exchange='flat' works on "
                f"multi-axis columns")

    def all_to_all(self, x, topo=None):
        if topo is None:                    # the stacked grid
            return flat_all_to_all(x)
        C = topo.grid.C
        dtype = x.dtype
        x = x.view(_SAME_SIZE_INT[x.element_size()])
        lj = torch.arange(x.shape[1], device=x.device)
        # lab[lj, r] = j ^ r: H[:, lj, r] = x[:, lj, j ^ r], and since XOR
        # is an involution the same map reads recv back out of H
        r = torch.arange(C, device=x.device)
        lab = (topo.local.j0 + lj)[:, None] ^ r
        h = x[:, lj[:, None], lab]
        for s in range(_log2_exact(C)):
            rows = torch.nonzero((r >> s) & 1).flatten()  # bit s of the label
            h[:, :, rows] = topo.butterfly_swap(h[:, :, rows], s)
        return h[:, lj[:, None], lab].view(dtype)

    def msgs_per_exchange(self, C: int) -> int:
        return _log2_exact(C)

    def wire_bytes(self, flat_bytes: int, C: int) -> int:
        # each of the log2(C) stages ships C/2 of the C per-destination
        # buckets: (C/2)*log2(C) bucket payloads vs the flat route's C-1
        return (flat_bytes // C) * (C // 2) * _log2_exact(C)

    def value_extra_bytes(self, cnt, j, C: int):
        # bucket d's value words hop popcount(j ^ d) times
        lab = torch.as_tensor(j, dtype=torch.int64, device=cnt.device) \
            .unsqueeze(-1) ^ torch.arange(C, dtype=torch.int64,
                                          device=cnt.device)
        hops = torch.zeros_like(lab)
        for s in range(_log2_exact(C)):
            hops += (lab >> s) & 1
        return (4 * (cnt.to(torch.int64) * hops).sum(dim=-1)) & U32_MASK


EXCHANGES = {"flat": FlatExchange, "butterfly": ButterflyExchange}


def resolve_exchange_name(spec: str, grid: Grid2D, col_axes: tuple) -> str:
    """"auto" -> the strategy this grid runs best: butterfly when it
    strictly reduces messages (power-of-two C >= 4, single column axis),
    flat otherwise.  Explicit names pass through (validated by
    `get_exchange`)."""
    if spec != "auto":
        return spec
    C = grid.C
    if C >= 4 and not (C & (C - 1)) and len(col_axes) <= 1:
        return "butterfly"
    return "flat"


def get_exchange(spec, grid: Grid2D, col_axes: tuple = ("c",)
                 ) -> ExchangeStrategy:
    """Resolve "flat" | "butterfly" | "auto" | ExchangeStrategy instance,
    validated against the grid (a strategy that cannot run here raises a
    ValueError naming the one that does)."""
    if isinstance(spec, ExchangeStrategy):
        spec.validate(grid, tuple(col_axes))
        return spec
    name = resolve_exchange_name(spec, grid, tuple(col_axes))
    try:
        cls = EXCHANGES[name]
    except KeyError:
        raise ValueError(
            f"unknown exchange {spec!r}; choose from "
            f"{sorted(EXCHANGES)} or 'auto'")
    strat = cls()
    strat.validate(grid, tuple(col_axes))
    return strat
