"""The processor grid stacked on one device (DESIGN.md sec. 5).

The JAX package binds the R x C grid to a device mesh and runs the level
loop under `shard_map`.  The port keeps every per-processor array with
leading (R, C) dims on one device, and the collectives become tensor
operations on those dims:

  row_gather      (paper line 13)  all_gather within a processor-column:
                  processor (i, j) receives x[:, j] from every grid row;
  col_all_to_all  (paper line 17)  the flat all_to_all within a
                  processor-row: recv[i, j, m] = x[i, m, j], the sender and
                  receiver column axes swapped -- exactly
                  `repro/dist/strategy.py:emulate_exchange(x, "flat")`;
  psum_all        a sum over the grid.

The interface is the one a `torch.distributed` topology (one GPU per
processor, NCCL collectives) implements later (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import Grid2D


@dataclasses.dataclass(frozen=True)
class StackedTopology:
    """The whole processor grid as leading (R, C) dims on one device."""
    grid: Grid2D
    device: torch.device

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
        column d -> recv[i, j, m] = x[i, m, j] (what column m sent to j)."""
        return x.transpose(1, 2).contiguous()

    def psum_all(self, x):
        """Sum of a per-processor (R, C) quantity over the grid."""
        return x.sum(dim=(0, 1), dtype=x.dtype)
