"""repro_torch: the PyTorch/CUDA port of the 2D-partitioned distributed BFS.

The JAX package `repro` is the reference; this package runs the same
algorithm on one NVIDIA GPU with the processor grid stacked in leading
(R, C) tensor dims, through hand-written CUDA kernels (`csrc/`).  It imports
torch and never jax or `repro`.

    from repro_torch import BFSConfig, DistGraph, rmat_edges
    edges = rmat_edges(20, 16)                       # on the card
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)))
    out = graph.session().bfs(root)
"""
from repro_torch.api import BFSConfig, DistGraph, GraphSession
from repro_torch.graphgen import rmat_edges

__all__ = ["BFSConfig", "DistGraph", "GraphSession", "rmat_edges"]
