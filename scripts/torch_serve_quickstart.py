"""Serve quickstart on the PyTorch port: two resident graphs behind one
GraphServer, mixed BFS / SSSP traffic from two tenants, coalesced by
continuous batching (the twin of examples/serve_quickstart.py).

    python scripts/torch_serve_quickstart.py [scale] [edge_factor]
                                             [--device cuda|cpu]

One device, grid 1x1; the graphs are generated on --device (cuda by
default; without a card pass --device cpu) from torch generators seeded
with 1 and 2, with uint8 weights (|31 u + v| mod 254) + 1.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.api import BFSConfig, DistGraph  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.graphgen import degrees, rmat_edges  # noqa: E402
from repro_torch.serve import GraphServer, ServeConfig  # noqa: E402


def main(scale=12, ef=8, device="cuda"):
    device = resolve_device(device)
    config = BFSConfig(grid=(1, 1), edge_chunk=16384)

    def plan(s, seed):
        edges = rmat_edges(s, ef,
                           torch.Generator(device=device).manual_seed(seed),
                           device)
        w = ((edges[0].long() * 31 + edges[1]).abs() % 254 + 1).to(
            torch.uint8)
        g = DistGraph.from_edges(edges, config, n=1 << s, weights=w,
                                 device=device)
        roots = torch.nonzero(degrees(edges[0], 1 << s) > 0).flatten()
        return g, roots[:32:4].tolist()

    print(f"planning two graphs (scale {scale} and {scale - 1})...")
    (g_web, roots_web), (g_road, roots_road) = plan(scale, 1), \
        plan(scale - 1, 2)

    with GraphServer({"web": g_web, "road": g_road},
                     ServeConfig(max_batch=8, window_s=0.01)) as server:
        server.warm(("bfs", "sssp"))
        print(f"serving {server.graphs}; submitting mixed traffic...")

        tickets = []
        for i in range(8):       # alice: BFS on the web graph (coalesces)
            tickets.append(("bfs", server.bfs(
                "web", roots_web[i], tenant="alice")))
        for i in range(4):       # bob: SSSP on the road graph
            tickets.append(("sssp", server.sssp(
                "road", roots_road[i], tenant="bob")))
        server.drain()

        for program, ticket in tickets:
            res = ticket.result(timeout=60)
            assert res.ok, res.error
            reached = int((res.value.level if program == "bfs"
                           else res.value.dist).ge(0).sum())
            print(f"  {res.tenant:5s} {program:4s} on {res.graph:4s}: "
                  f"reached {reached:6,} vertices in a batch of "
                  f"{res.batch_size} (padded to {res.padded_to}), "
                  f"queued {res.queued_s * 1e3:5.1f} ms")

        stats = server.metrics_snapshot()
        occ = stats["mean_occupancy"]
        print(f"batches: {stats['n_batches']}  mean occupancy: {occ:.2f}  "
              f"pad waste: {stats['pad_waste_frac']:.0%}")
        print(f"aot cache: {stats['aot_cache']}")
        for tenant, s in sorted(stats["tenants"].items()):
            print(f"  tenant {tenant}: {s['queries']} queries, "
                  f"{s['edges_scanned']:,} edges scanned")
        assert occ and occ > 1, "expected coalescing (occupancy > 1)"
        print("OK (coalesced; every result bit-identical to a direct "
              "session call)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ints", nargs="*", type=int, help="scale, edge_factor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(*args.ints[:2], device=args.device)
