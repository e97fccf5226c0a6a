"""Core types, partitioning, the single-device BFS, frontier ops and
validation (the port of `repro.core`)."""
from repro_torch.core.types import BFSOutput, BFSState, Grid2D, LocalGraph2D
from repro_torch.core.partition import (global_from_row, local_col,
                                        local_row, owner_of, partition_1d,
                                        partition_2d, row2col)
from repro_torch.core.bfs_single import bfs_reference_py, bfs_single
from repro_torch.core.validate import (count_component_edges, teps,
                                       validate_bfs)

__all__ = ["Grid2D", "LocalGraph2D", "BFSState", "BFSOutput",
           "partition_2d", "partition_1d", "local_row", "local_col",
           "row2col", "owner_of", "global_from_row", "bfs_reference_py",
           "bfs_single", "validate_bfs", "count_component_edges", "teps"]
