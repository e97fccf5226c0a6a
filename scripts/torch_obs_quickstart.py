"""Telemetry quickstart on the PyTorch port: a traced BFS printing the
per-level LevelTrace table, then a small served run dumping the request's
span lifecycle, the Prometheus exposition and the event-log tail (the twin
of examples/obs_quickstart.py).

    python scripts/torch_obs_quickstart.py [scale] [edge_factor]
                                           [--device cuda|cpu]

One device, grid 1x1; the graph is generated on --device (cuda by default;
without a card pass --device cpu) from a torch generator seeded with 42.
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
    n = 1 << scale
    edges = rmat_edges(scale, ef,
                       torch.Generator(device=device).manual_seed(42),
                       device)
    config = BFSConfig(grid=(1, 1), edge_chunk=16384, telemetry=True)
    graph = DistGraph.from_edges(edges, config, n=n, device=device)
    roots = torch.nonzero(degrees(edges[0], n) > 0).flatten()[:32:4] \
        .tolist()

    # --- layer 1: the per-level trace ---------------------------------------
    sess = graph.session()
    out = sess.bfs(roots[0])
    trace = sess.last_trace()           # also out.trace
    print(f"BFS from root {roots[0]}: {int(out.n_levels)} levels, "
          f"{out.edges_scanned} edges scanned")
    print(f"{'level':>5} {'frontier':>9} {'scanned':>9} {'folded':>7} "
          f"{'wire_B':>7} {'dir':>4}")
    for row in trace.levels():
        print(f"{row['level']:>5} {row['frontier']:>9} {row['scanned']:>9} "
              f"{row['folded']:>7} {row['wire_bytes']:>7} {row['dir']:>4}")
    assert trace.total_scanned == out.edges_scanned

    # --- layers 2+3: the server's registry, spans and event log ------------
    with GraphServer({"g": graph},
                     ServeConfig(max_batch=4, window_s=0.01)) as server:
        tickets = [server.bfs("g", r, tenant=("alice", "bob")[i % 2])
                   for i, r in enumerate(roots[:6])]
        results = [t.result(timeout=300) for t in tickets]
        assert all(r.ok for r in results)

        r0 = results[0]
        print(f"\nrequest seq={r0.seq} spans "
              f"(batch of {r0.batch_size}, padded to {r0.padded_to}):")
        for span in r0.trace.spans:
            print(f"  {span.name:>9} {span.dur_s * 1e3:8.2f} ms")

        print("\nPrometheus exposition (first 12 lines):")
        for line in server.prometheus().splitlines()[:12]:
            print(f"  {line}")

        print("\nevent-log tail:")
        for event in server.events.tail(3):
            print(f"  {event}")
    print("\nOK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("ints", nargs="*", type=int, help="scale, edge_factor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(*args.ints[:2], device=args.device)
