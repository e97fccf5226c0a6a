"""END-TO-END DRIVER (the paper's workload) on the PyTorch port: 2D-
partitioned BFS over an R x C processor grid stacked on one device,
Graph500-style -- 64 searches from random roots, validated output,
harmonic-mean TEPS (paper sec. 4); the twin of
examples/distributed_bfs.py.

Uses the session API: plan the graph into residency once with
`DistGraph.from_edges`, then answer many queries with `GraphSession.bfs`
-- per root, and the whole sweep batched as one call.

    python scripts/torch_distributed_bfs.py [R] [C] [scale] [ef] [n_roots]
                                            [fold] [--device cuda|cpu]

fold in {list, bitmap, delta} picks the fold wire codec.  The graph is
generated on --device (cuda by default; without a card pass --device cpu)
from a torch generator seeded with 1; validation and edge counts run there.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import BFSConfig, DistGraph  # noqa: E402
from repro_torch.core import validate_bfs  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.core.validate import (EdgeIndex,  # noqa: E402
                                       count_component_edges, harmonic_mean)
from repro_torch.graphgen import degrees, rmat_edges  # noqa: E402


def main(R=2, C=4, SCALE=14, EF=16, N_ROOTS=64, FOLD="list",
         device="cuda"):
    device = resolve_device(device)

    def ready():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = 1 << SCALE
    print(f"grid {R}x{C} | R-MAT scale={SCALE} ef={EF} | {N_ROOTS} roots")
    edges = rmat_edges(SCALE, EF,
                       torch.Generator(device=device).manual_seed(1), device)

    # phase 1: plan once -- partition on the device, resident thereafter
    t0 = time.perf_counter()
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(R, C), fold_codec=FOLD, edge_chunk=16384),
        n=n, device=device)
    ready()
    print(f"2D partition in {time.perf_counter() - t0:.1f}s "
          f"(max {int(graph.csc.nnz.max()):,} edges/device)")

    # phase 2: query -- many searches against the resident graph
    session = graph.session()
    cand = torch.nonzero(degrees(edges[0], n) > 0).flatten().cpu().numpy()
    roots = np.random.default_rng(7).choice(cand, N_ROOTS, replace=False)
    session.bfs(int(roots[0]))                     # warm-up (B=1 entry)
    ready()

    teps, validated, index = [], 0, EdgeIndex(edges, n)
    for i, root in enumerate(roots):
        t0 = time.perf_counter()
        out = session.bfs(int(root))
        ready()
        dt = time.perf_counter() - t0
        lvl = out.level[:n]
        m = count_component_edges(edges, lvl)
        teps.append(m / dt)
        if i < 8:  # validate a subset, as the JAX driver does
            validate_bfs(edges, lvl, out.pred[:n], int(root), index=index)
            validated += 1
    print(f"harmonic mean TEPS: {harmonic_mean(teps):.3e} "
          f"({validated} searches fully validated)")

    # the same sweep as one call (amortised Graph500 view)
    session.bfs(roots)                             # warm-up (B=N entry)
    ready()
    t0 = time.perf_counter()
    bout = session.bfs(roots)
    ready()
    sweep_s = time.perf_counter() - t0
    swept = sum(count_component_edges(edges, bout.level[b][:n])
                for b in range(N_ROOTS))
    print(f"batched {N_ROOTS}-root sweep: {sweep_s:.3f}s, "
          f"amortised {swept / sweep_s:.3e} TEPS")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("args", nargs="*",
                    help="R, C, scale, ef, n_roots (ints), fold")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    pos = [int(x) for x in a.args[:5]] + a.args[5:6]
    main(*pos, device=a.device)
