"""Quickstart on the PyTorch port: generate an R-MAT graph, run the
single-device BFS, validate, report TEPS (the twin of
examples/quickstart.py).

    python scripts/torch_quickstart.py [scale] [edge_factor] [n_roots]
                                       [--device cuda|cpu]

The graph is generated on --device (cuda by default; without a card pass
--device cpu) from a torch generator seeded with 1, built into a CSC there
(`graphgen.build_csc`) and searched by `core.bfs_single`; the validation
and the edge counts run there too.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import bfs_single, validate_bfs  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.core.validate import (count_component_edges,  # noqa: E402
                                       harmonic_mean)
from repro_torch.graphgen import build_csc, degrees, rmat_edges  # noqa: E402


def main(scale=14, ef=16, n_roots=8, device="cuda"):
    device = resolve_device(device)
    n = 1 << scale
    print(f"generating R-MAT scale={scale} ef={ef} "
          f"({ef * n:,} input edges)...")
    edges = rmat_edges(scale, ef,
                       torch.Generator(device=device).manual_seed(1), device)
    co, ri = build_csc(edges, n)

    cand = torch.nonzero(degrees(edges[0], n) > 0).flatten().cpu().numpy()
    roots = np.random.default_rng(0).choice(cand, n_roots, replace=False)

    def ready():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    bfs_single(co, ri, int(roots[0]))                    # warm-up
    ready()

    teps = []
    for root in roots:
        t0 = time.perf_counter()
        lvl, pred = bfs_single(co, ri, int(root))
        ready()
        dt = time.perf_counter() - t0
        validate_bfs(edges, lvl, pred, int(root))
        m = count_component_edges(edges, lvl)
        teps.append(m / dt)
        print(f"  root={int(root):7d} levels={int(lvl.max())} "
              f"visited={int((lvl >= 0).sum()):8,} "
              f"TEPS={m / dt:.3e}  [validated]")
    print(f"harmonic mean TEPS over {n_roots} roots: "
          f"{harmonic_mean(teps):.3e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ints", nargs="*", type=int,
                    help="scale, edge_factor, n_roots")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(*args.ints, device=args.device)
