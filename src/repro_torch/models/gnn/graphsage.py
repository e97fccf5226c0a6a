"""GraphSAGE [arXiv:1706.02216] -- mean aggregator, full-graph and sampled
(block) modes, the port of `repro/models/gnn/graphsage.py`.  Full-graph
aggregation can run distributed on the paper's 2D expand/fold pattern via
`repro_torch.core.spmm2d`.

`GraphSAGE` is an `nn.Module` whose methods are the JAX package's
functions: `forward` = `apply_fullgraph`, `apply_block`, `loss` =
`loss_fn`.  Its weights are (in, out) parameters applied as `x @ w`, named
as the JAX tree's paths (`layers.0.w_self`, `layers.0.w_neigh`, `out`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import cross_entropy, dense, init_generator
from repro_torch.sparse.segment import gather_scatter


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    n_classes: int = 41
    aggregator: str = "mean"


class GraphSAGE(nn.Module):
    def __init__(self, cfg: SAGEConfig, generator=None, device=None):
        super().__init__()
        dev, gen = init_generator(generator, device)
        self.cfg = cfg
        dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
        self.layers = nn.ModuleList(nn.ParameterDict({
            "w_self": dense(dims[l], dims[l + 1], gen, dev),
            "w_neigh": dense(dims[l], dims[l + 1], gen, dev),
        }) for l in range(cfg.n_layers))
        self.out = dense(cfg.d_hidden, cfg.n_classes, gen, dev)

    def forward(self, feats, edge_src, edge_dst, edge_valid=None,
                spmm=None):
        """`apply_fullgraph`.  spmm: optional distributed aggregation fn
        h -> agg(h) (the 2D expand/fold SpMM); defaults to local segment
        ops."""
        h = feats
        n = feats.shape[0]
        for lp in self.layers:
            if spmm is None:
                agg = gather_scatter(h, edge_src, edge_dst, n,
                                     reduce=self.cfg.aggregator,
                                     valid=edge_valid)
            else:
                agg = spmm(h)
            h = torch.relu(h @ lp["w_self"] + agg @ lp["w_neigh"])
        return h @ self.out

    apply_fullgraph = forward

    def apply_block(self, block_feats, fanouts):
        """Sampled minibatch: block_feats[k] = features of hop-k nodes, hop
        k has B * prod(fanouts[:k]) rows.  Aggregates innermost-out."""
        hs = list(block_feats)
        for lp in self.layers:
            nxt = []
            for k in range(len(hs) - 1):
                f = fanouts[k]
                neigh = hs[k + 1].reshape(hs[k].shape[0], f, -1).mean(dim=1)
                nxt.append(torch.relu(hs[k] @ lp["w_self"]
                                      + neigh @ lp["w_neigh"]))
            hs = nxt
        return hs[0] @ self.out

    def loss(self, feats, edge_src, edge_dst, labels, edge_valid=None,
             label_mask=None, spmm=None):
        """`loss_fn` (with the forward's `spmm` too)."""
        logits = self.forward(feats, edge_src, edge_dst, edge_valid, spmm)
        return cross_entropy(logits, labels, label_mask)


def init_params(cfg: SAGEConfig, generator=None, device=None) -> GraphSAGE:
    """A `GraphSAGE` with JAX's shapes and scales, drawn from `generator`
    on `device` (None = CUDA)."""
    return GraphSAGE(cfg, generator, device)
