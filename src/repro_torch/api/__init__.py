"""Session API (DESIGN.md sec. 7): plan once, query many.

    from repro_torch.api import BFSConfig, DistGraph

    graph = DistGraph.from_edges(edges, BFSConfig(grid=(2, 2)))
    session = graph.session()
    out = session.bfs(roots)        # scalar root, or a (B,) batch
    cc = session.connected_components()
    sp = session.sssp(root)         # needs from_edges(..., weights=w)
    mb = session.multi_bfs(sources, k=2)
"""
from repro_torch.algos import CCOutput, MultiBFSOutput, SSSPOutput
from repro_torch.api.config import BFSConfig, resolve_fold_codec
from repro_torch.api.session import (AOTCache, DistGraph, GraphSession,
                                     build_engine, check_vertex_ids)

__all__ = ["BFSConfig", "DistGraph", "GraphSession", "build_engine",
           "resolve_fold_codec", "CCOutput", "SSSPOutput", "MultiBFSOutput",
           "AOTCache", "check_vertex_ids"]
