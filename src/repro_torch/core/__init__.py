"""Core types, partitioning, frontier ops and validation (the port of
`repro.core`; `partition_1d`, `bfs_single` and `bfs_reference_py` come
with later work, ROADMAP A14 and A15)."""
from repro_torch.core.types import BFSOutput, BFSState, Grid2D, LocalGraph2D
from repro_torch.core.partition import (global_from_row, local_col,
                                        local_row, owner_of, partition_2d,
                                        row2col)
from repro_torch.core.validate import (count_component_edges, teps,
                                       validate_bfs)

__all__ = ["Grid2D", "LocalGraph2D", "BFSState", "BFSOutput",
           "partition_2d", "local_row", "local_col", "row2col", "owner_of",
           "global_from_row", "validate_bfs", "count_component_edges",
           "teps"]
