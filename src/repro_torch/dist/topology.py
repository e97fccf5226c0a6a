"""The processor grid stacked on one device (DESIGN.md sec. 5).

The JAX package binds the R x C grid to a device mesh and runs the level
loop under `shard_map`.  The port keeps every per-processor array with
leading (R, C) dims on one device, and the collectives become tensor
operations on those dims:

  row_gather      (paper line 13)  all_gather within a processor-column:
                  processor (i, j) receives x[:, j] from every grid row;
  col_all_to_all  (paper line 17)  the all_to_all within a
                  processor-row: recv[i, j, m] = x[i, m, j], the sender and
                  receiver column axes swapped -- exactly
                  the JAX package's `emulate_exchange(x, "flat")`; routed
                  by the bound exchange strategy;
  psum_all        a sum over the grid.

The interface is the one a `torch.distributed` topology (one GPU per
processor, NCCL collectives) implements later (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import Grid2D
from repro_torch.dist.strategy import ExchangeStrategy, FlatExchange


@dataclasses.dataclass(frozen=True)
class StackedTopology:
    """The whole processor grid as leading (R, C) dims on one device.

    `exchange` binds an `ExchangeStrategy` (`dist/strategy.py`, flat by
    default): `col_all_to_all` routes through it, so every fold codec and
    the predecessor resolution pick the strategy up without knowing it
    exists."""
    grid: Grid2D
    device: torch.device
    exchange: ExchangeStrategy = dataclasses.field(
        default_factory=FlatExchange)

    def coords(self):
        """Every processor's (i, j) grid coordinates, row-major."""
        return [(i, j) for i in range(self.grid.R) for j in range(self.grid.C)]

    def row_gather(self, x):
        """(R, C, ...) -> (R, C, R, ...): out[i, j, r] = x[r, j], a
        broadcast view (every grid row of a column receives the same
        gather)."""
        R = self.grid.R
        return x.transpose(0, 1).unsqueeze(0).expand((R,) + x.transpose(
            0, 1).shape)

    def col_all_to_all(self, x):
        """(R, C, C, ...) with x[i, j, d] = processor (i, j)'s payload for
        column d -> recv[i, j, m] = x[i, m, j] (what column m sent to j),
        routed by the bound exchange strategy."""
        return self.exchange.all_to_all(x)

    def with_exchange(self, strategy) -> "StackedTopology":
        """This topology with an `ExchangeStrategy` bound (the engine binds
        its resolved strategy here so every exchange routes through it)."""
        return dataclasses.replace(self, exchange=strategy)

    def psum_all(self, x):
        """Sum of a per-processor (R, C) quantity over the grid."""
        return x.sum(dim=(0, 1), dtype=x.dtype)
