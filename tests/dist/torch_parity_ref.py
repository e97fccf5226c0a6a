"""JAX-side reference searches for the port's parity tests
(tests/test_torch_bfs.py, tests/test_torch_direction.py), on forced host
devices.

Runs `DistGraph.from_edges(edges, BFSConfig(grid=(R, C))).session().bfs`
of the JAX package for every requested grid: one scalar search from the
first root and one batched search over all roots, and writes levels, preds,
n_levels and edges_scanned to an .npz under keys "{RxC}_{scalar|batch}_*".

With --direction it also runs, per grid, one batched search over all roots
for each of DIRECTION_CONFIGS (direction x fold codec), under keys
"{RxC}_{direction}_{codec}_batch_*", with the `directions` trace.  The
batched search equals the scalar one root by root (the JAX package's own
contract), so a scalar port search is held to its batch row.

With --algos (EDGES.npz then also holds `weights` (E,) uint8) it plans the
graph with those weights and runs, per grid and per (direction, codec) of
ALGO_CONFIGS, `connected_components()` under "{tag}_cc_*", `sssp(roots)`
under "{tag}_sssp_*", `multi_bfs(roots)` under "{tag}_mbfs_*", for the
list codec `multi_bfs(roots, k=2)` under "{tag}_khop_*" and, for the delta
codec, `bfs(roots)` under "{tag}_bfs_*" (tag = "{RxC}_{direction}_{codec}").

Usage: torch_parity_ref.py EDGES.npz OUT.npz GRID [GRID ...] [--direction]
[--algos] (GRID = RxC).  EDGES.npz holds `edges` (2, E), `roots` (B,) and
`n`.
"""
import os
import sys

FLAGS = ("--direction", "--algos")
ARGS = [a for a in sys.argv[3:] if a not in FLAGS]
DIRECTION = "--direction" in sys.argv[3:]
ALGOS = "--algos" in sys.argv[3:]
DIRECTION_CONFIGS = [(False, "bitmap"), (True, "list"), (True, "bitmap"),
                     ("bottomup", "list"), ("bottomup", "bitmap")]
ALGO_CONFIGS = [(d, c) for d in (False, True, "bottomup")
                for c in ("list", "bitmap", "delta")]
GRIDS = [tuple(int(x) for x in g.split("x")) for g in ARGS]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{max(r * c for r, c in GRIDS)}")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import BFSConfig, DistGraph  # noqa: E402
from repro.dist.compat import make_mesh  # noqa: E402


def direction_tag(direction) -> str:
    return {False: "td", True: "adaptive"}.get(direction, direction)


def put(out, prefix, res, fields=("level", "pred", "n_levels")):
    for f in fields:
        out[f"{prefix}_{f}"] = np.asarray(getattr(res, f))
    out[f"{prefix}_edges"] = np.asarray(res.edges_scanned, np.int64)
    if res.directions is not None:
        out[f"{prefix}_directions"] = np.asarray(res.directions)


def put_algos(out, graph, grid, roots):
    """Every value program (and delta BFS) for every ALGO_CONFIGS entry."""
    R, C = grid
    for direction, codec in ALGO_CONFIGS:
        sess = graph.session(BFSConfig(grid=grid, direction=direction,
                                       fold_codec=codec))
        tag = f"{R}x{C}_{direction_tag(direction)}_{codec}"
        put(out, f"{tag}_cc", sess.connected_components(),
            ("labels", "n_iters"))
        put(out, f"{tag}_sssp", sess.sssp(roots), ("dist", "n_iters"))
        put(out, f"{tag}_mbfs", sess.multi_bfs(roots),
            ("level", "src", "n_levels"))
        if codec == "list":
            put(out, f"{tag}_khop", sess.multi_bfs(roots, k=2),
                ("level", "src", "n_levels"))
        if codec == "delta":
            put(out, f"{tag}_bfs", sess.bfs(roots))


data = np.load(sys.argv[1])
edges, roots, n = data["edges"], data["roots"], int(data["n"])
out = {}
for R, C in GRIDS:
    mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(R, C)), mesh=mesh, n=n,
        weights=data["weights"] if ALGOS else None)
    sess = graph.session()
    tag = f"{R}x{C}"
    put(out, f"{tag}_scalar", sess.bfs(int(roots[0])))
    put(out, f"{tag}_batch", sess.bfs(roots))
    if DIRECTION:
        for direction, codec in DIRECTION_CONFIGS:
            sess = graph.session(BFSConfig(grid=(R, C), direction=direction,
                                           fold_codec=codec))
            put(out, f"{tag}_{direction_tag(direction)}_{codec}_batch",
                sess.bfs(roots))
    if ALGOS:
        put_algos(out, graph, (R, C), roots)
np.savez(sys.argv[2], **out)
print("OK")
