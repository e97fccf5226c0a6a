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
partitioned exactly like the BFS.  Equivariant nets (positions + messages
along edge vectors) run edge-sharded segment ops; citation-graph shapes
synthesise positions/species for them (the shapes, not the semantics, are
the assigned quantity -- see DESIGN.md sec. 6).

The `build_*_dryrun` functions give the JAX module's specs on the meta
device (the step traced over a `StackedMesh`, each argument's split the
JAX spec's PartitionSpec).  JAX vmaps the molecule step over the batch;
the port loops over it.  The smokes run on `device` (None = CUDA, raising
without a card; "cpu" for the CPU tests), their random draws from one
torch.Generator seeded 0.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.common import (DryrunSpec, MeshAxes, S,
                                        apply_params, param_tree,
                                        value_and_grad)
from repro_torch.core.types import Grid2D
from repro_torch.models.common import cross_entropy, init_generator
from repro_torch.optim.adamw import tree_map
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


def _meta(shape, dtype, mesh):
    return torch.empty(shape, dtype=dtype, device=mesh.device)


def _replicated(params):
    return tree_map(lambda _: S(), params)


def _axis_size(mesh, axes) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return math.prod(sizes[a] for a in axes)


# ---------------------------------------------------------------------------
# graphsage
# ---------------------------------------------------------------------------

def build_sage_dryrun(cfg: GS.SAGEConfig, shape, mesh, axes: MeshAxes):
    sh = SHAPES[shape]
    dp = tuple(axes.dp)
    f32, i32 = torch.float32, torch.int32

    if sh["kind"] == "block":
        # sampled minibatch: data-parallel over seeds
        B, (f1, f2) = sh["batch"], sh["fanout"]
        c2 = GS.SAGEConfig(cfg.name, cfg.n_layers, cfg.d_hidden,
                           sh["d_feat"], sh["classes"], cfg.aggregator)
        model = GS.init_params(c2, None, mesh.device)
        params = param_tree(model)
        feats = [_meta((B * f, sh["d_feat"]), f32, mesh)
                 for f in (1, f1, f1 * f2)]
        labels = _meta((B,), i32, mesh)

        def loss_fn(p, bf, lab):
            return cross_entropy(apply_params(model, p, "apply_block")(
                bf, [f1, f2]), lab)

        return DryrunSpec(fn=value_and_grad(loss_fn),
                          args=(params, feats, labels),
                          in_splits=(_replicated(params), [S(dp, None)] * 3,
                                     S(dp)),
                          out_splits=None,
                          note=f"sampled block B={B} fanout={f1}x{f2}")

    if sh["kind"] == "full":
        # full-graph on the paper's 2D partition (spmm2d expand/fold)
        from repro_torch.core.spmm2d import make_spmm2d
        R, C = _axis_size(mesh, dp), _axis_size(mesh, (axes.tp,))
        grid = Grid2D.for_vertices(sh["n"], R, C)
        e_max = int(sh["e"] / (R * C) * 1.5) + 64
        c2 = GS.SAGEConfig(cfg.name, cfg.n_layers, cfg.d_hidden,
                           sh["d_feat"], sh["classes"], cfg.aggregator)
        model = GS.init_params(c2, None, mesh.device)
        params = param_tree(model)
        col_off = _meta((R, C, grid.n_cols_local + 1), i32, mesh)
        row_idx = _meta((R, C, e_max), i32, mesh)
        feats = _meta((grid.n, sh["d_feat"]), f32, mesh)
        labels = _meta((grid.n,), i32, mesh)
        spmm2d = make_spmm2d(grid, mesh, row_axes=dp, col_axes=(axes.tp,))

        def loss_fn(p, co, ri, x, lab):
            logits = apply_params(model, p)(
                x, None, None, spmm=lambda h: spmm2d(co, ri, None, h))
            return cross_entropy(logits, lab)

        blocks = S(dp, axes.tp, None)
        return DryrunSpec(
            fn=value_and_grad(loss_fn),
            args=(params, col_off, row_idx, feats, labels),
            in_splits=(_replicated(params), blocks, blocks,
                       S((axes.tp, *dp), None), S((axes.tp, *dp))),
            out_splits=None,
            note=f"full-graph 2D expand/fold SpMM n={sh['n']} e={sh['e']}")

    # molecule: SAGE over batched small dense graphs; positions are
    # ignored by SAGE (feature-only model)
    c3 = GS.SAGEConfig(cfg.name, cfg.n_layers, cfg.d_hidden, 16, 8)
    return _molecule_dryrun_generic(
        GS.init_params(c3, None, mesh.device),
        lambda fwd, f, pos, es, ed: fwd(f, es, ed).sum(),
        mesh, axes, feat_dim=16)


def _molecule_dryrun_generic(model, energy_fn, mesh, axes, *, feat_dim=None,
                             with_species=False):
    """energy_fn(model's forward over the traced parameters, x, pos,
    edge_src, edge_dst) -> one molecule's energy."""
    sh = SHAPES["molecule"]
    B, n, e = sh["batch"], sh["n"], sh["e"]
    dp = tuple(axes.dp)
    params = param_tree(model)
    pos = _meta((B, n, 3), torch.float32, mesh)
    es = _meta((B, e), torch.int32, mesh)
    ed = _meta((B, e), torch.int32, mesh)
    tgt = _meta((B,), torch.float32, mesh)
    if with_species:
        extra = _meta((B, n), torch.int32, mesh)
    else:
        extra = _meta((B, n, feat_dim), torch.float32, mesh)

    def loss(p, x, pos, es, ed, tgt):
        fwd = apply_params(model, p)
        en = torch.stack([energy_fn(fwd, x[b], pos[b], es[b], ed[b])
                          for b in range(B)])
        return torch.mean((en - tgt) ** 2)

    return DryrunSpec(
        fn=value_and_grad(loss), args=(params, extra, pos, es, ed, tgt),
        in_splits=(_replicated(params),
                   S(dp, None) if with_species else S(dp, None, None),
                   S(dp, None, None), S(dp, None), S(dp, None), S(dp)),
        out_splits=None, note=f"molecule batch={B}")


# ---------------------------------------------------------------------------
# equivariant (nequip / mace) + egnn
# ---------------------------------------------------------------------------

def _graph_size(sh) -> tuple:
    """(n, e) of a full or block shape, e padded to a multiple of 512 so
    the edges split over 256 / 512 devices."""
    n = sh["n"] if sh["kind"] == "full" else sh["batch"] * (
        1 + sh["fanout"][0] + sh["fanout"][0] * sh["fanout"][1])
    e = sh["e"] if sh["kind"] == "full" else n * 8
    return n, ((e + 511) // 512) * 512


def build_equiv_dryrun(cfg: EQ.EquivConfig, shape, mesh, axes: MeshAxes):
    sh = SHAPES[shape]
    allax = (*axes.dp, axes.tp)
    model = EQ.init_params(cfg, None, mesh.device)

    if sh["kind"] == "mol":
        return _molecule_dryrun_generic(
            model, lambda fwd, sp, pos, es, ed: fwd(sp, pos, es, ed)[0],
            mesh, axes, with_species=True)

    # full / block shapes: synthesized positions + species over the graph's
    # node/edge counts; edge arrays split over ALL devices, nodes
    # replicated
    n, e = _graph_size(sh)
    params = param_tree(model)
    spec_a = _meta((n,), torch.int32, mesh)
    pos = _meta((n, 3), torch.float32, mesh)
    es = _meta((e,), torch.int32, mesh)
    ed = _meta((e,), torch.int32, mesh)
    tgt = _meta((n,), torch.float32, mesh)

    def loss(p, sp, pos, es, ed, tgt):
        _, node_e = apply_params(model, p)(sp, pos, es, ed)
        return torch.mean((node_e - tgt) ** 2)

    esh = S(allax)
    return DryrunSpec(
        fn=value_and_grad(loss), args=(params, spec_a, pos, es, ed, tgt),
        in_splits=(_replicated(params), S(None), S(None, None), esh, esh,
                   S(None)),
        out_splits=None,
        note=f"{sh['kind']} n={n} e={e} edge-sharded")


def build_egnn_dryrun(cfg: EG.EGNNConfig, shape, mesh, axes: MeshAxes):
    sh = SHAPES[shape]
    allax = (*axes.dp, axes.tp)
    model = EG.init_params(cfg, None, mesh.device)

    if sh["kind"] == "mol":
        return _molecule_dryrun_generic(
            model, lambda fwd, f, pos, es, ed: fwd(f, pos, es, ed)[0],
            mesh, axes, feat_dim=cfg.d_in)

    n, e = _graph_size(sh)
    params = param_tree(model)
    feats = _meta((n, cfg.d_in), torch.float32, mesh)
    pos = _meta((n, 3), torch.float32, mesh)
    es = _meta((e,), torch.int32, mesh)
    ed = _meta((e,), torch.int32, mesh)
    tgt = _meta((n,), torch.float32, mesh)

    def loss(p, f, pos, es, ed, tgt):
        _, h, _ = apply_params(model, p)(f, pos, es, ed)
        return torch.mean((h[:, 0] - tgt) ** 2)

    esh = S(allax)
    return DryrunSpec(
        fn=value_and_grad(loss), args=(params, feats, pos, es, ed, tgt),
        in_splits=(_replicated(params), S(None, None), S(None, None), esh,
                   esh, S(None)),
        out_splits=None, note=f"{sh['kind']} n={n} e={e} edge-sharded")


# ---------------------------------------------------------------------------
# smokes
# ---------------------------------------------------------------------------

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
