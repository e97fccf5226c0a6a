"""The paper's 1D comparison baseline as the DEGENERATE 1 x P grid, the
deprecated driver, the port of `repro/core/bfs1d.py`.

The original 1D code ([1]/[2]) has the two scalability limits the 2D code
removes (paper sec. 2.1): every level is an all-to-all among ALL P
processors, and duplicate filtering needs a full-size map (O(n) per
processor).  Both fall out of the shared engine at the 1 x P topology with
no driver code of its own: the expand gather spans a single processor, the
fold all_to_all spans all P, and the local row space -- hence the visited
bitmap -- is the whole vertex set.  Vertices are laid out in owner blocks
(`partition_2d` on the 1 x P grid), not by the modulo rule of
`partition_1d`, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.core.types import BFSOutput, LocalGraph2D
from repro_torch.dist.topology import Topology


class BFS1D:
    """DEPRECATED shim: the 1 x P degenerate grid through the session API.

    Partition the edge list with `partition_2d(edges, bfs.grid)` (the 1 x P
    grid pads n up to a multiple of P); results come back as plain global
    (n,) tensors.  New code should build a `BFSConfig(grid=(1, P),
    row_axes=(), col_axes=axes)` session instead.
    """

    def __init__(self, n: int, mesh, axes=("p",), edge_chunk: int = 8192,
                 max_levels: int = 64, fold_codec="list"):
        import warnings

        from repro_torch.api.config import BFSConfig
        from repro_torch.api.session import AOTCache, build_engine

        warnings.warn(
            "BFS1D is deprecated; use repro_torch.api.DistGraph/"
            "GraphSession with BFSConfig(grid=(1, P), row_axes=(), "
            "col_axes=axes)", DeprecationWarning, stacklevel=2)
        self.n = n
        self.mesh = mesh
        self.topology = Topology.one_d(n, mesh, axes)
        self.grid = self.topology.grid
        self.P = self.grid.C
        self.ncl = self.grid.n_cols_local
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        self.config = BFSConfig(
            grid=self.grid, fold_codec=fold_codec, edge_chunk=edge_chunk,
            max_levels=max_levels, row_axes=(), col_axes=axes)
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
