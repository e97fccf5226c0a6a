"""The four GNN architectures' shapes and smokes, the port of
`repro/configs/gnn_common.py`.

Shapes (assignment):
  full_graph_sm   n=2,708  e=10,556  d_feat=1,433   (Cora-size full batch)
  minibatch_lg    n=232,965 e=114.6M batch=1,024 fanout 15-10 (Reddit-size,
                  REAL neighbour sampler feeds static blocks)
  ogb_products    n=2,449,029 e=61.86M d_feat=100   (full-batch large)
  molecule        n=30 e=64 batch=128               (batched small graphs)

Distribution: full-graph aggregation for graphsage runs on the paper's 2D
expand/fold SpMM (`repro_torch.core.spmm2d`) -- the adjacency is
partitioned exactly like the BFS.  The JAX module's `build_*_dryrun`
builders lower these shapes for a device mesh; their counterpart comes with
the port's dry run (ROADMAP A16 part 3).  The smokes run on `device`
(None = CUDA, raising without a card; "cpu" for the CPU tests), their
random draws from one torch.Generator seeded 0.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import init_generator
from repro_torch.models.gnn import egnn as EG
from repro_torch.models.gnn import equivariant as EQ
from repro_torch.models.gnn import graphsage as GS

SHAPES = {
    "full_graph_sm": dict(kind="full", n=2708, e=10556, d_feat=1433,
                          classes=7),
    "minibatch_lg": dict(kind="block", n=232965, e=114_615_892,
                         batch=1024, fanout=(15, 10), d_feat=602, classes=41),
    "ogb_products": dict(kind="full", n=2_449_029, e=61_859_140, d_feat=100,
                         classes=47),
    "molecule": dict(kind="mol", n=30, e=64, batch=128),
}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"smoke failed: {what}")


def smoke_sage(device=None):
    from repro_torch.graphgen import rmat_edges
    dev, gen = init_generator(None, device)
    cfg = GS.SAGEConfig("sage-smoke", 2, 16, 8, 5)
    model = GS.init_params(cfg, gen, dev)
    e = rmat_edges(7, 4, gen, dev)
    x = torch.randn((128, 8), generator=gen, device=dev)
    lab = torch.randint(0, 5, (128,), generator=gen, device=dev)
    loss = model.loss(x, e[0], e[1], lab)
    _check(bool(torch.isfinite(loss)), "GraphSAGE loss not finite")


def smoke_equiv(corr, device=None):
    dev, gen = init_generator(None, device)
    cfg = EQ.EquivConfig("eq-smoke", 2, 8, 4, 2.5, correlation_order=corr)
    model = EQ.init_params(cfg, gen, dev)
    pos = torch.randn((10, 3), generator=gen, device=dev)
    sp = torch.randint(0, 8, (10,), generator=gen, device=dev)
    src = torch.arange(10, dtype=torch.int32, device=dev)
    dst = (src + 1) % 10
    en, node_e = model(sp, pos, src, dst)
    _check(bool(torch.isfinite(en)) and node_e.shape == (10,),
           "equivariant energy")


def smoke_egnn(device=None):
    dev, gen = init_generator(None, device)
    cfg = EG.EGNNConfig("egnn-smoke", 2, 16, 4)
    model = EG.init_params(cfg, gen, dev)
    pos = torch.randn((10, 3), generator=gen, device=dev)
    f = torch.randn((10, 4), generator=gen, device=dev)
    src = torch.arange(10, dtype=torch.int32, device=dev)
    dst = (src + 1) % 10
    en, h, x = model(f, pos, src, dst)
    _check(bool(torch.isfinite(en)) and x.shape == (10, 3), "EGNN energy")
