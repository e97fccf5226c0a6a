"""DEPRECATED shim: direction-optimising 2D BFS, the port of
`repro/core/direction.py`.

Direction optimisation (Beamer et al. [7] + [20]) is a mode of the frontier
engine: `BFSConfig(direction=True | "adaptive" | "bottomup")` routes BFS --
and CC / SSSP / multi-source BFS -- through the
`repro_torch.algos.direction.DirectionProgram` wrapper, whose bottom-up
CUDA kernels live in `repro_torch.kernels.bottomup`.  Nothing on the hot
path imports this module.

`BFS2DDirection` remains as a deprecated drop-in for callers of the JAX
package's driver: a thin veneer over `BFSConfig(direction=True)` on a
`GraphSession`.
"""
from __future__ import annotations

from repro_torch.core.types import BFSOutput, Grid2D, LocalGraph2D
from repro_torch.dist.topology import Topology


class BFS2DDirection:
    """DEPRECATED shim over the session API (drop-in for BFS2D.run).

    Equivalent to `BFSConfig(direction=True)` on a `GraphSession`.  Use
    `repro_torch.api.DistGraph.from_edges(edges, BFSConfig(direction=
    True))`.  `run` takes the graph's CSR twin (`core.partition.
    partition_2d_csr`'s dict) beside its CSC.
    """

    def __init__(self, grid: Grid2D, mesh, row_axes=("r",), col_axes=("c",),
                 edge_chunk: int = 8192, alpha: int = 24,
                 max_levels: int = 64, fold_codec="list"):
        import warnings

        from repro_torch.api.config import BFSConfig
        from repro_torch.api.session import AOTCache, build_engine

        warnings.warn(
            "BFS2DDirection is deprecated; use repro_torch.api.DistGraph/"
            "GraphSession with BFSConfig(direction=True)",
            DeprecationWarning, stacklevel=2)
        self.grid, self.mesh = grid, mesh
        self.alpha = alpha
        self.config = BFSConfig(
            grid=grid, fold_codec=fold_codec, edge_chunk=edge_chunk,
            max_levels=max_levels, direction=True, alpha=alpha,
            row_axes=tuple(row_axes), col_axes=tuple(col_axes))
        self.topology = Topology(grid, mesh, row_axes=row_axes,
                                 col_axes=col_axes)
        self.engine = build_engine(self.topology, self.config)
        # one executable cache shared by every graph run through this shim
        self._compiled = AOTCache()

    def _session(self, graph: LocalGraph2D, csr: dict):
        from repro_torch.api.session import DistGraph, GraphSession

        dg = DistGraph(self.topology, graph, csr=csr, config=self.config)
        dg._compiled = self._compiled   # entries rebind to each graph
        return GraphSession(dg, self.config, engine=self.engine)

    def run(self, graph: LocalGraph2D, csr: dict, root) -> BFSOutput:
        return self._session(graph, csr).bfs(root)
