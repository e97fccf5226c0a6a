"""The paper's own workload: distributed BFS on R-MAT graphs (Table 1).
The port of `repro/configs/bfs_rmat.py`.

The JAX module's dry run lowers the whole search program (BFS2D's
while_loop over levels) at the Table-1 scale for the mesh size (256 GPUs
-> scale 29, 512 -> scale 30, edge factor 16); its roofline weights the
loop body, a loop of unknown trip count, once.  The port's dry run traces
one top-down level of the search on the meta device -- the expand
exchange, the CSC scan of one chunk of the engine's `edge_chunk` (2^20
edges in the dry-run cell) on every processor with the frontier at its
padded maximum, the fold and the frontier update -- then the
deferred-predecessor `finalize`.  The engine reads each level's scan
total on the host; the traced level is given one chunk instead
(`_one_level`, a route only the dry run and the hillclimb take), as
JAX's analyzer weights the chunk loop's body once.  `smoke_bfs` runs the
port's `BFS2D` at SCALE 7 on 1x1.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.common import DryrunSpec, MeshAxes
from repro_torch.core.types import Grid2D
from repro_torch.models.common import init_generator

# paper Table 1: #GPUs -> (grid, scale)
TABLE1 = {1: ((1, 1), 21), 2: ((1, 2), 22), 4: ((2, 2), 23), 8: ((2, 4), 24),
          16: ((4, 4), 25), 32: ((4, 8), 26), 64: ((8, 8), 27),
          128: ((8, 16), 28), 256: ((16, 16), 29), 512: ((16, 32), 30),
          1024: ((32, 32), 31), 2048: ((32, 64), 32), 4096: ((64, 64), 33)}
EDGE_FACTOR = 16

SHAPES = {"rmat_weak": dict(kind="bfs")}
SKIP_SHAPES = {}


EDGE_CHUNK = 1 << 20


def _engine(grid: Grid2D, mesh, axes: MeshAxes):
    from repro_torch.api.config import BFSConfig
    from repro_torch.api.session import build_engine
    from repro_torch.dist.topology import Topology
    cfg = BFSConfig(grid=grid, edge_chunk=EDGE_CHUNK,
                    row_axes=tuple(axes.dp), col_axes=(axes.tp,))
    return build_engine(Topology(grid, mesh, row_axes=axes.dp,
                                 col_axes=(axes.tp,)), cfg)


def _one_level(engine, col_off, row_idx, nnz, root):
    """One top-down level with every processor's frontier full (S
    vertices) and one chunk of the engine's `edge_chunk` edges to scan,
    then `finalize`.  `root` is the search's, as in JAX's spec; a full
    frontier stands for it.  The level's plan is `plan_level`'s with each
    scan total left on the device (a (1,) index where the engine reads a
    0-dim one back)."""
    from repro_torch.algos.bfs import LevelPlan, topdown_step
    from repro_torch.core import frontier as F
    from repro_torch.core.types import BFSState, LocalGraph2D
    from repro_torch.dist import exchange as X
    del root
    grid, topo = engine.grid, engine.topo
    dev = col_off.device
    lead = (grid.R, grid.C)
    rows = lead + (grid.n_rows_local + 1,)
    st = BFSState(level=torch.empty(rows, dtype=torch.int32, device=dev),
                  pred=torch.empty(rows, dtype=torch.int32, device=dev),
                  visited=torch.empty(rows, dtype=torch.bool, device=dev),
                  front=torch.empty(lead + (grid.S,), dtype=torch.int32,
                                    device=dev),
                  front_cnt=torch.empty(lead, dtype=torch.int32, device=dev),
                  lvl=1)
    graph = LocalGraph2D(col_off, row_idx, nnz)
    all_front, front_total = X.expand_exchange(
        st.front, st.front_cnt, topo=topo, ops=engine.fold_ops)
    cumul = [F.scan_plan(col_off[i, j], all_front[i, j],
                         front_total[i, j].reshape(1))[0]
             for i, j in topo.coords()]
    counts = topo.psum_all(st.front_cnt)
    plan = LevelPlan(all_front, front_total[..., None], cumul, counts)
    st, _ = topdown_step(engine, graph, st, plan,
                         [engine.edge_chunk] * grid.P)
    return engine.program.finalize(engine, st)


def build_bfs_dryrun(_cfg, shape, mesh, axes: MeshAxes):
    """`mesh`: a `StackedMesh` on the meta device."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    _, scale = TABLE1[mesh.size]
    R = math.prod(sizes[a] for a in axes.dp)
    C = sizes[axes.tp]
    n = 1 << scale
    grid = Grid2D.for_vertices(n, R, C)
    # undirected doubling: 2 * ef * n directed edges; 1.5x padding for skew
    e_max = int(2 * EDGE_FACTOR * n / (R * C) * 1.5)
    engine = _engine(grid, mesh, axes)
    i32 = dict(dtype=torch.int32, device=mesh.device)
    col_off = torch.empty((R, C, grid.n_cols_local + 1), **i32)
    row_idx = torch.empty((R, C, e_max), **i32)
    nnz = torch.empty((R, C), **i32)
    root = torch.empty((), **i32)
    return DryrunSpec(
        fn=lambda *a: _one_level(engine, *a),
        args=(col_off, row_idx, nnz, root), in_splits=None, out_splits=None,
        note=f"one top-down level (full frontier, one "
             f"{engine.edge_chunk}-edge chunk a processor) + finalize, "
             f"scale={scale} grid={R}x{C} e_max/dev={e_max}")


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
