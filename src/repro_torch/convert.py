"""Carry a partitioned graph from the JAX package into the port.

`graph_from_partition` takes the arrays of `repro.core.partition.
partition_2d` (numpy, leading (R, C) dims) and builds the port's
`LocalGraph2D` on a device, and `csr_from_partition` does the same for the
CSR twin of `partition_2d_csr`, and `edge_vals_from_partition` for the
per-edge values of `partition_edge_vals(_csr)` (SSSP's weights), so both
packages can search the very same partition with the very same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.types import Grid2D, LocalGraph2D


def graph_from_partition(grid: Grid2D, col_off, row_idx, nnz,
                         device) -> LocalGraph2D:
    """(R, C, ncl + 1), (R, C, e_max), (R, C) int32 arrays -> LocalGraph2D
    on `device`, shapes checked against `grid`."""
    arrays = {"col_off": col_off, "row_idx": row_idx, "nnz": nnz}
    out = {k: torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
           for k, a in arrays.items()}
    R, C, ncl = grid.R, grid.C, grid.n_cols_local
    if (out["col_off"].shape != (R, C, ncl + 1)
            or out["row_idx"].dim() != 3
            or out["row_idx"].shape[:2] != (R, C)
            or out["nnz"].shape != (R, C)):
        raise ValueError(
            f"partition shapes {[tuple(t.shape) for t in out.values()]} do "
            f"not fit grid {R}x{C} with {ncl} local columns")
    return LocalGraph2D(**out)


def csr_from_partition(grid: Grid2D, row_off, col_idx, nnz, device) -> dict:
    """(R, C, nrl + 1), (R, C, e_max), (R, C) int32 arrays -> the port's
    CSR twin dict on `device`, shapes checked against `grid`."""
    arrays = {"row_off": row_off, "col_idx": col_idx, "nnz": nnz}
    out = {k: torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)
           for k, a in arrays.items()}
    R, C, nrl = grid.R, grid.C, grid.n_rows_local
    if (out["row_off"].shape != (R, C, nrl + 1)
            or out["col_idx"].dim() != 3
            or out["col_idx"].shape[:2] != (R, C)
            or out["nnz"].shape != (R, C)):
        raise ValueError(
            f"CSR shapes {[tuple(t.shape) for t in out.values()]} do not "
            f"fit grid {R}x{C} with {nrl} local rows")
    return out


def edge_vals_from_partition(grid: Grid2D, vals, device) -> torch.Tensor:
    """(R, C, e_max) per-edge values (numpy, any integer dtype, e.g. the
    uint8 weights of `partition_edge_vals`) -> a tensor of that dtype on
    `device`, its leading dims checked against `grid`."""
    out = torch.as_tensor(np.asarray(vals), device=device)
    if out.dim() != 3 or out.shape[:2] != (grid.R, grid.C):
        raise ValueError(f"edge values of shape {tuple(out.shape)} do not "
                         f"fit grid {grid.R}x{grid.C}")
    return out
