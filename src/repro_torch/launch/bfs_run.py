"""Distributed-BFS driver CLI (the paper's workload as a service), the port
of `repro/launch/bfs_run.py`.

    PYTHONPATH=src python -m repro_torch.launch.bfs_run --grid 2x4 \
        --scale 14 --ef 16 --roots 64 [--fold bitmap] [--direction]

Built on the session API: the graph is generated on the device from
`--seed`, planned and made resident once (`DistGraph.from_edges`; the CSR
twin is planned only when --direction is on), then the root sweep runs
through `GraphSession.bfs` -- per root for harmonic TEPS, plus the whole
batch as one call for the amortised Graph500-style number.  The first
--validate roots are checked by the Graph500 rules after their timing
window.  The flags and defaults are the JAX driver's; its --devices (a
host-device count for the CPU) has no counterpart, since the grid is
stacked on one device.  --device picks it (cuda by default: without a
card the driver raises unless --device cpu is given); --edge-chunk sets
the CSC scan chunk (16384, the JAX driver's; a card at SCALE 26 wants
2^22, since each chunk refills a claim array of a block's rows).

The edge list stays on the device: the degree count, the per-root
component edge count and the validation (an `EdgeIndex` built once) run
there, so a SCALE 26 run moves no edge list to the host."""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="2x4")
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--fold", default="list",
                    choices=["list", "bitmap", "delta"])
    ap.add_argument("--direction", action="store_true")
    ap.add_argument("--validate", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="torch device the graph lives on (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=1,
                    help="seed of the torch generator drawing the graph")
    ap.add_argument("--edge-chunk", type=int, default=16384,
                    help="CSC scan chunk of the expand phase")
    args = ap.parse_args(argv)

    import time

    import numpy as np
    import torch

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.core.types import resolve_device
    from repro_torch.core.validate import (EdgeIndex, count_component_edges,
                                           harmonic_mean, validate_bfs)
    from repro_torch.graphgen import degrees, rmat_edges

    device = resolve_device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --device cpu to "
                           "run the driver on the CPU")

    def ready():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = 1 << args.scale
    edges = rmat_edges(args.scale, args.ef,
                       torch.Generator(device=device).manual_seed(args.seed),
                       device)

    config = BFSConfig(grid=args.grid, fold_codec=args.fold,
                       edge_chunk=args.edge_chunk, direction=args.direction)
    graph = DistGraph.from_edges(edges, config, n=n, device=device)
    session = graph.session()

    cand = torch.nonzero(degrees(edges[0], n) > 0).flatten()
    roots = np.random.default_rng(7).choice(cand.cpu().numpy(), args.roots,
                                            replace=False)
    del cand
    index = None

    # per-root queries (harmonic-mean TEPS, the paper's headline metric);
    # the first --validate roots run the Graph500 rules AFTER the timing
    # window (the O(E) check must not skew the reported TEPS)
    session.bfs(int(roots[0]))                                  # warm B=1
    ready()
    teps, comp_m = [], []
    for i, root in enumerate(roots):
        t0 = time.perf_counter()
        out = session.bfs(int(root))
        ready()
        dt = time.perf_counter() - t0
        lvl = out.level[:n]
        m = count_component_edges(edges, lvl)
        comp_m.append(m)
        teps.append(m / dt)
        if i < args.validate:
            if index is None:
                index = EdgeIndex(edges, n)
            validate_bfs(edges, lvl, out.pred[:n], int(root), index=index)
    del out, lvl

    # the whole sweep as one call; harmonic-mean TEPS uses the SAME
    # count_component_edges numerators as the per-root path, over the
    # amortised per-root time sweep_s / n_roots (the batch has ONE wall
    # time), alongside the aggregate amortised number
    session.bfs(roots)                                          # warm B=roots
    ready()
    t0 = time.perf_counter()
    session.bfs(roots)
    ready()
    sweep_s = time.perf_counter() - t0
    swept = sum(comp_m)
    batched_hm = harmonic_mean([m / (sweep_s / len(roots)) for m in comp_m])

    R, C = graph.grid.R, graph.grid.C
    print(f"grid={R}x{C} scale={args.scale} ef={args.ef} fold={args.fold} "
          f"dir={args.direction}: harmonic TEPS {harmonic_mean(teps):.3e} "
          f"({min(args.validate, len(roots))} validated) | "
          f"{len(roots)}-root sweep {sweep_s:.3f}s, "
          f"amortised {swept / sweep_s:.3e} TEPS, "
          f"harmonic {batched_hm:.3e} TEPS")


if __name__ == "__main__":
    main()
