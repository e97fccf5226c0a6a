"""GraphSAGE full-graph training where the neighbour aggregation runs on the
paper's 2D expand/fold pattern (`repro_torch.core.spmm2d`) over a 2x2
processor grid stacked on one device -- the BFS communication schedule as
a GNN training substrate; the twin of examples/gnn_fullgraph_2d.py.

    python scripts/torch_gnn_fullgraph_2d.py [--device cuda|cpu]

The graph, features and weights are drawn on --device (cuda by default;
without a card pass --device cpu) from torch generators seeded 0 to 3;
AdamW (`repro_torch.optim`) trains 80 full-graph steps.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.core import Grid2D, partition_2d  # noqa: E402
from repro_torch.core.spmm2d import make_spmm2d  # noqa: E402
from repro_torch.core.types import resolve_device  # noqa: E402
from repro_torch.dist import make_mesh  # noqa: E402
from repro_torch.graphgen import rmat_edges  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.models.gnn import graphsage as GS  # noqa: E402
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update)


def main(device="cuda"):
    dev = resolve_device(device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    R = C = 2
    scale, d_in, classes = 10, 16, 5
    n = 1 << scale
    mesh = make_mesh((R, C), ("r", "c"), device=dev)
    grid = Grid2D.for_vertices(n, R, C)
    edges = rmat_edges(scale, 8, gen(0), dev)
    graph = partition_2d(edges, grid)
    spmm2d = make_spmm2d(grid, mesh)

    def spmm(h):
        return spmm2d(graph.col_off, graph.row_idx, graph.nnz, h)

    # learnable task: labels = argmax over class-prototype features of the
    # aggregated neighbourhood (so aggregation actually matters)
    feats = torch.randn((grid.n, d_in), generator=gen(1), device=dev)
    agg0 = spmm(feats)
    proto = torch.randn((d_in, classes), generator=gen(2), device=dev)
    labels = torch.argmax(agg0 @ proto, -1)

    cfg = GS.SAGEConfig("sage-2d", 2, 32, d_in, classes)
    model = GS.init_params(cfg, gen(3), dev)

    def loss_fn():
        return cross_entropy(model(feats, None, None, spmm=spmm), labels)

    oc = AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=0,
                     total_steps=10_000, grad_clip=1.0)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    first = None
    for i in range(80):
        model.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        _, opt, _ = adamw_update(oc, params, {k: p.grad for k, p in
                                              params.items()}, opt)
        first = first if first is not None else loss.item()
        if i % 10 == 0:
            print(f"step {i:3d} loss={loss.item():.4f}")
    with torch.no_grad():
        final = float(loss_fn())
    print(f"loss {first:.3f} -> {final:.4f} "
          f"({'learning works' if final < 0.5 * first else 'unexpected'})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
