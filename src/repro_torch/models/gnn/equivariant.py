"""NequIP and MACE on the Cartesian l<=2 algebra (`repro_torch.models.gnn.
e3`), the port of `repro/models/gnn/equivariant.py`.

NequIP [arXiv:2101.03164]: per-edge tensor product of neighbour features
with edge harmonics, radial-MLP path weights, segment-sum aggregation,
gated nonlinearity, n_layers interaction blocks, per-atom scalar readout ->
energy.

MACE [arXiv:2206.07697]: one/two interaction layers building the A-basis
(aggregated TP features), then higher-order B-basis via repeated
self-tensor-products (correlation order 3 = two quadratic couplings),
linear readout per layer.

`EquivariantNet.forward` is JAX's `apply` (energy, per-node scalars) and
`energy_and_forces` its autograd twin (forces = -dE/dpositions).  The
species embedding is JAX's `jnp.take`: a negative id wraps, an id past
either end gives a NaN row (`sparse.segment.take_rows`).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models.common import dense, init_generator, normal
from repro_torch.models.gnn import e3
from repro_torch.sparse.segment import take_rows


@dataclasses.dataclass(frozen=True)
class EquivConfig:
    name: str
    n_layers: int
    d_hidden: int          # channels per irrep
    n_rbf: int
    cutoff: float
    n_species: int = 8
    correlation_order: int = 1   # 1 = NequIP; 3 = MACE
    radial_hidden: int = 64


class EquivariantNet(nn.Module):
    def __init__(self, cfg: EquivConfig, generator=None, device=None):
        super().__init__()
        dev, gen = init_generator(generator, device)
        self.cfg = cfg
        C = cfg.d_hidden
        layers = []
        for _ in range(cfg.n_layers):
            lp = {
                "radial1": dense(cfg.n_rbf, cfg.radial_hidden, gen, dev),
                "radial2": dense(cfg.radial_hidden, C * e3.N_PATHS, gen,
                                 dev),
                "mix_s": dense(C, C, gen, dev),
                "mix_v": dense(C, C, gen, dev),
                "mix_t": dense(C, C, gen, dev),
                "gate_v": dense(C, C, gen, dev),
                "gate_t": dense(C, C, gen, dev),
            }
            if cfg.correlation_order >= 2:
                lp["stp_w"] = normal((1, C, 6), 0.3, gen, dev)
            if cfg.correlation_order >= 3:
                lp["stp_w2"] = normal((1, C, 6), 0.3, gen, dev)
            layers.append(nn.ParameterDict(lp))
        self.embed = dense(cfg.n_species, C, gen, dev, scale=1.0)
        self.layers = nn.ModuleList(layers)
        self.readout1 = dense(C, C, gen, dev)
        self.readout2 = dense(C, 1, gen, dev)

    def forward(self, species, positions, edge_src, edge_dst,
                edge_valid=None):
        """species (N,) int; positions (N, 3); edges j=src -> i=dst.
        Returns (energy scalar, per-node scalars)."""
        cfg = self.cfg
        n = species.shape[0]
        C = cfg.d_hidden
        f = e3.zeros(n, C, self.embed.dtype, positions.device)
        f = {**f, "s": take_rows(self.embed, species)}

        src = edge_src.long().clamp(0, n - 1)
        r = positions[src] - positions[edge_dst.long().clamp(0, n - 1)]
        rhat, y2, d = e3.sph(r)
        rbf, env = e3.bessel_basis(d, cfg.n_rbf, cfg.cutoff)
        if edge_valid is not None:
            rbf = torch.where(edge_valid[:, None], rbf, 0.0)

        for lp in self.layers:
            w = torch.nn.functional.silu(rbf @ lp["radial1"]) @ lp["radial2"]
            w = w.reshape(-1, C, e3.N_PATHS)
            fj = {k: x[src] for k, x in f.items()}
            msg = e3.edge_tensor_product(fj, rhat, y2, w)
            agg = e3.scatter_nodes(msg, edge_dst, n, valid=edge_valid)
            agg = e3.linear_mix(agg, lp["mix_s"], lp["mix_v"], lp["mix_t"])
            if cfg.correlation_order >= 2:
                agg = e3.add(agg, e3.self_tensor_product(agg, lp["stp_w"]))
            if cfg.correlation_order >= 3:
                agg = e3.add(agg, e3.self_tensor_product(agg, lp["stp_w2"]))
            f = e3.add(f, e3.gate(agg, lp["gate_v"], lp["gate_t"]))

        h = torch.nn.functional.silu(f["s"] @ self.readout1) @ self.readout2
        return torch.sum(h), h[:, 0]

    def energy_and_forces(self, species, positions, edge_src, edge_dst,
                          edge_valid=None):
        """(energy, forces = -dE/dpositions)."""
        with torch.enable_grad():
            pos = positions.detach().requires_grad_(True)
            e = self.forward(species, pos, edge_src, edge_dst,
                             edge_valid)[0]
            (grad,) = torch.autograd.grad(e, pos)
        return e, -grad


def init_params(cfg: EquivConfig, generator=None,
                device=None) -> EquivariantNet:
    """An `EquivariantNet` with JAX's shapes and scales, drawn from
    `generator` on `device` (None = CUDA)."""
    return EquivariantNet(cfg, generator, device)
