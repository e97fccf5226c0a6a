"""Distributed BFS with 2D partitioning (paper Alg. 2), the deprecated
driver, the port of `repro/core/bfs2d.py`.

The grid's ROWS span `row_axes` and its COLUMNS span `col_axes` of the
mesh (`dist.compat.make_mesh`; on one device every processor is stacked):

  expand (paper line 13)  = all_gather of frontiers within a processor
                            column (`row_gather`);
  fold   (paper line 17)  = all_to_all of discovered vertices within a
                            processor row (`col_all_to_all`).

The level loop, init and deferred-predecessor resolution live in the
frontier engine (`repro_torch.algos`); what goes on the fold wire is a
pluggable codec (`dist.exchange`): 32-bit local indices ("list"), a 1-bit
block bitmap ("bitmap") or sorted 16-bit deltas ("delta").
"""
from __future__ import annotations

from repro_torch.core.types import BFSOutput, Grid2D, LocalGraph2D
from repro_torch.dist.topology import Topology


class BFS2D:
    """DEPRECATED shim over the session API (`repro_torch.api`).

    Equivalent to `DistGraph(...).session()` with `BFSConfig(...)`; kept so
    callers of the JAX package's driver port line for line.  The graph is
    `core.partition_2d`'s stacked (R, C, ...) blocks; results come back as
    global (n,) tensors in vertex-block order (b = j*R + i), i.e. plain
    global vertex ids.

    fold_codec selects the fold wire format ("list" | "bitmap" | "delta");
    `fold_bitmap=True` is the deprecated legacy spelling of
    fold_codec="bitmap".  expand_fn: a chunk hook (`BFSConfig.expand_fn`).
    """

    def __init__(self, grid: Grid2D, mesh, row_axes=("r",), col_axes=("c",),
                 edge_chunk: int = 8192, expand_fn=None,
                 fold_bitmap: bool = None, max_levels: int = 64,
                 dedup: str = "scatter", fold_codec=None):
        import warnings

        from repro_torch.api.config import BFSConfig, resolve_fold_codec
        from repro_torch.api.session import AOTCache, build_engine

        warnings.warn(
            "BFS2D is deprecated; use repro_torch.api.DistGraph.from_edges"
            "(...).session() instead", DeprecationWarning, stacklevel=2)
        fold_codec = resolve_fold_codec(fold_codec, fold_bitmap)
        self.config = BFSConfig(
            grid=grid, fold_codec=fold_codec, edge_chunk=edge_chunk,
            dedup=dedup, max_levels=max_levels, expand_fn=expand_fn,
            row_axes=tuple(row_axes), col_axes=tuple(col_axes))
        self.grid = grid
        self.mesh = mesh
        self.topology = Topology(grid, mesh, row_axes=row_axes,
                                 col_axes=col_axes)
        self.engine = build_engine(self.topology, self.config)
        # one executable cache shared by every graph run through this shim
        self._compiled = AOTCache()

    def _session(self, graph: LocalGraph2D):
        from repro_torch.api.session import DistGraph, GraphSession

        dg = DistGraph(self.topology, graph, config=self.config)
        dg._compiled = self._compiled   # entries rebind to each graph
        return GraphSession(dg, self.config, engine=self.engine)

    def run(self, graph: LocalGraph2D, root) -> BFSOutput:
        return self._session(graph).bfs(root)
