"""EGNN [arXiv:2102.09844]: E(n)-equivariant message passing without
spherical harmonics -- scalar messages from invariant distances + coordinate
updates along relative displacements.  The port of
`repro/models/gnn/egnn.py`: `EGNN.forward` is JAX's `apply`, returning
(energy, h, x)."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import apply_mlp, dense, init_generator, mlp
from repro_torch.sparse.segment import at_add


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int = 8


class EGNN(nn.Module):
    def __init__(self, cfg: EGNNConfig, generator=None, device=None):
        super().__init__()
        dev, gen = init_generator(generator, device)
        self.cfg = cfg
        d = cfg.d_hidden
        self.layers = nn.ModuleList(nn.ModuleDict({
            "msg": mlp([2 * d + 1, d, d], gen, dev),
            "coord": mlp([d, d, 1], gen, dev),
            "upd": mlp([2 * d, d, d], gen, dev),
        }) for _ in range(cfg.n_layers))
        self.embed = dense(cfg.d_in, d, gen, dev)
        self.readout = dense(d, 1, gen, dev)

    def forward(self, feats, positions, edge_src, edge_dst,
                edge_valid=None):
        n = feats.shape[0]
        h = feats @ self.embed
        x = positions
        src = edge_src.long().clamp(0, n - 1)
        dst = edge_dst.long().clamp(0, n - 1)
        for lp in self.layers:
            rij = x[src] - x[dst]
            d2 = torch.sum(rij**2, dim=-1, keepdim=True)
            m = apply_mlp(lp["msg"], torch.cat([h[src], h[dst], d2], -1))
            if edge_valid is not None:
                m = torch.where(edge_valid[:, None], m, 0.0)
            cw = apply_mlp(lp["coord"], m)
            dx = at_add(n, dst, rij * cw)
            cnt = at_add(n, dst,
                         torch.where(edge_valid, 1.0, 0.0).to(x.dtype)
                         if edge_valid is not None
                         else torch.ones(dst.shape, dtype=x.dtype,
                                         device=x.device))
            x = x + dx / torch.clamp(cnt, min=1)[:, None]
            agg = at_add(n, dst, m)
            h = h + apply_mlp(lp["upd"], torch.cat([h, agg], -1))
        energy = torch.sum(h @ self.readout)
        return energy, h, x


def init_params(cfg: EGNNConfig, generator=None, device=None) -> EGNN:
    """An `EGNN` with JAX's shapes and scales, drawn from `generator` on
    `device` (None = CUDA)."""
    return EGNN(cfg, generator, device)
