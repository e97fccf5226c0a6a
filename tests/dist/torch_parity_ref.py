"""JAX-side reference searches for the port's parity tests
(tests/test_torch_bfs.py), on forced host devices.

Runs `DistGraph.from_edges(edges, BFSConfig(grid=(R, C))).session().bfs`
of the JAX package for every requested grid: one scalar search from the
first root and one batched search over all roots, and writes levels, preds,
n_levels and edges_scanned to an .npz.

Usage: torch_parity_ref.py EDGES.npz OUT.npz GRID [GRID ...]   (GRID = RxC)
EDGES.npz holds `edges` (2, E), `roots` (B,) and `n`.
"""
import os
import sys

GRIDS = [tuple(int(x) for x in g.split("x")) for g in sys.argv[3:]]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{max(r * c for r, c in GRIDS)}")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import BFSConfig, DistGraph  # noqa: E402
from repro.dist.compat import make_mesh  # noqa: E402

data = np.load(sys.argv[1])
edges, roots, n = data["edges"], data["roots"], int(data["n"])
out = {}
for R, C in GRIDS:
    mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
    sess = DistGraph.from_edges(edges, BFSConfig(grid=(R, C)), mesh=mesh,
                                n=n).session()
    tag = f"{R}x{C}"
    one = sess.bfs(int(roots[0]))
    out[f"{tag}_scalar_level"] = np.asarray(one.level)
    out[f"{tag}_scalar_pred"] = np.asarray(one.pred)
    out[f"{tag}_scalar_n_levels"] = np.asarray(one.n_levels)
    out[f"{tag}_scalar_edges"] = np.asarray(one.edges_scanned, np.int64)
    many = sess.bfs(roots)
    out[f"{tag}_batch_level"] = np.asarray(many.level)
    out[f"{tag}_batch_pred"] = np.asarray(many.pred)
    out[f"{tag}_batch_n_levels"] = np.asarray(many.n_levels)
    out[f"{tag}_batch_edges"] = np.asarray(many.edges_scanned, np.int64)
np.savez(sys.argv[2], **out)
print("OK")
