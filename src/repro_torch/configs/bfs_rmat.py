"""The paper's own workload: distributed BFS on R-MAT graphs (Table 1), the
port of `repro/configs/bfs_rmat.py`.

The JAX module's dry run lowers the whole search program at the Table-1
scale for the mesh size (256 GPUs -> scale 29, 512 -> scale 30, edge
factor 16); its counterpart comes with the port's dry run (ROADMAP A16
part 2).  `smoke_bfs` runs the port's `BFS2D` at SCALE 7 on 1x1.
"""
from __future__ import annotations

from repro_torch.models.common import init_generator

# paper Table 1: #GPUs -> (grid, scale)
TABLE1 = {1: ((1, 1), 21), 2: ((1, 2), 22), 4: ((2, 2), 23), 8: ((2, 4), 24),
          16: ((4, 4), 25), 32: ((4, 8), 26), 64: ((8, 8), 27),
          128: ((8, 16), 28), 256: ((16, 16), 29), 512: ((16, 32), 30),
          1024: ((32, 32), 31), 2048: ((32, 64), 32), 4096: ((64, 64), 33)}
EDGE_FACTOR = 16

SHAPES = {"rmat_weak": dict(kind="bfs")}
SKIP_SHAPES = {}


def smoke_bfs(device=None):
    from repro_torch.core import bfs_reference_py, partition_2d
    from repro_torch.core.bfs2d import BFS2D
    from repro_torch.core.types import Grid2D
    from repro_torch.dist.compat import make_mesh
    from repro_torch.graphgen import build_csc, rmat_edges
    dev, gen = init_generator(None, device)
    n = 1 << 7
    edges = rmat_edges(7, 6, gen, dev)
    mesh = make_mesh((1, 1), ("r", "c"), device=dev)
    grid = Grid2D.for_vertices(n, 1, 1)
    bfs = BFS2D(grid, mesh, edge_chunk=256)
    out = bfs.run(partition_2d(edges, grid), 3)
    co, ri = build_csc(edges, n)
    ref, _ = bfs_reference_py(co.cpu().numpy(), ri.cpu().numpy(), 3, n)
    if not (out.level[:n].cpu().numpy() == ref).all():
        raise AssertionError("smoke failed: BFS2D levels differ from the "
                             "python BFS")
