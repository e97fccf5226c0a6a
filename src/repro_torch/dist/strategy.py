"""Fold exchange strategies (DESIGN.md sec. 14), the port of
`repro/dist/strategy.py`.

Only the flat route is ported: ONE all-to-all per fold, every column
sending C-1 direct messages.  The butterfly route and "auto" come with
ROADMAP A9.
"""
from __future__ import annotations

from repro_torch.core.types import Grid2D


class FlatExchange:
    """The single-collective route (`col_all_to_all` of the topology)."""
    name = "flat"

    def all_to_all(self, x, topo):
        return topo.col_all_to_all(x)

    def msgs_per_exchange(self, C: int) -> int:
        return max(C - 1, 0)            # the own bucket never leaves

    def wire_bytes(self, flat_bytes: int, C: int) -> int:
        return flat_bytes               # the codec formulas ARE this route


def get_exchange(spec, grid: Grid2D) -> FlatExchange:
    """Resolve the exchange spelling; only "flat" exists in the port."""
    if spec == "flat":
        return FlatExchange()
    if spec in ("butterfly", "auto"):
        raise ValueError(
            f"exchange={spec!r} is not ported yet (ROADMAP A9); "
            f"exchange='flat' works on any grid")
    raise ValueError(f"unknown exchange {spec!r}; the port has 'flat'")
