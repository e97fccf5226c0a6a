"""The port's GNN models (`repro_torch.models.gnn`) against the JAX
package's, on the CPU, with JAX's own parameters carried across
(`convert.load_jax_params`):

  * GraphSAGE: the full graph under each aggregator, with an edge mask,
    and with an `spmm` (the port's `make_spmm2d` against JAX's), the
    sampled block of a `NeighborSampler`, the loss with a label mask, and
    the gradients against `jax.value_and_grad`;
  * the e3 functions one by one, and the equivariant net with correlation
    orders 1 (NequIP) and 3 (MACE): `forward` (= JAX's `apply`),
    `energy_and_forces` and the parameter gradients;
  * EGNN's (energy, h, x) and gradients;
  * the invariance and equivariance properties of tests/test_models_gnn.py
    on the port alone;
  * `load_jax_params` refusing a missing, an extra, a misshapen or a
    mistyped leaf, and `params_to_numpy` returning JAX's tree.

Sizes follow the JAX smokes (`repro/configs/gnn_common.py`).  Tolerance:
rtol 1e-4, atol 1e-5 on outputs, losses and gradients; a gradient whose
largest entry g_max passes 1 takes atol 1e-5 * g_max (MACE's reach 1e3,
past float32's resolution for an absolute 1e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Grid2D as JGrid2D
from repro.core import partition_2d as jax_partition_2d
from repro.core.spmm2d import make_spmm2d as jax_make_spmm2d
from repro.dist.compat import make_mesh as jax_make_mesh
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.models.gnn import e3 as je3
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import equivariant as jeq
from repro.models.gnn import graphsage as jsage
from repro_torch.convert import load_jax_params, params_to_numpy
from repro_torch.core import partition_2d
from repro_torch.core.spmm2d import make_spmm2d
from repro_torch.core.types import Grid2D
from repro_torch.dist import make_mesh
from repro_torch.models.gnn import e3, egnn, equivariant, graphsage
from repro_torch.sparse import NeighborSampler

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, atol=ATOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


def _flat(tree) -> dict:
    """A JAX tree as {"layers.0.w_self": array}."""
    def name(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
    return {name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_cfg(jmod, cfg):
    cls = getattr(jmod, type(cfg).__name__)
    return cls(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _pair(jmod, pmod, cfg, key=0):
    """(JAX params, port module with the same weights, JAX config)."""
    jcfg = _jax_cfg(jmod, cfg)
    jp = jmod.init_params(jcfg, jax.random.key(key))
    model = pmod.init_params(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jp))
    return jp, model, jcfg


def _same_grads(model, jgrads):
    want = _flat(jgrads)
    # a parameter the output does not reach has no grad (JAX's is zero)
    got = {k: torch.zeros_like(p) if p.grad is None else p.grad
           for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        # atol in units of the gradient's largest entry once that passes 1:
        # MACE's gradients reach 1e3, where float32 resolves 6e-5
        _close(got[k], want[k],
               ATOL * max(1.0, float(np.abs(want[k]).max())))


def _mol(seed, n=12, cutoff=2.5):
    """tests/test_models_gnn.py's molecule in numpy: edges within the
    cutoff, padded to n*n with masked (0, 0) slots."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, 3)) * 1.2).astype(np.float32)
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    adj = (d < cutoff) & ~np.eye(n, dtype=bool)
    src, dst = np.nonzero(adj)
    pad = n * n - src.size
    valid = np.concatenate([np.ones(src.size, bool), np.zeros(pad, bool)])
    src = np.concatenate([src, np.zeros(pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst, np.zeros(pad, np.int64)]).astype(np.int32)
    return pos, src, dst, valid


def _rot(seed):
    """A random rotation (det +1) in float32."""
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))[None, :]
    return (q * np.linalg.det(q)).astype(np.float32)


# ---------------------------------------------------------------------------
# GraphSAGE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sage_graph():
    n = 1 << 7
    edges = np.asarray(jax_rmat_edges(jax.random.key(1), 7, 4))
    rng = np.random.default_rng(4)
    return {"n": n, "edges": edges,
            "x": rng.standard_normal((n, 8)).astype(np.float32),
            "labels": rng.integers(0, 5, n).astype(np.int32),
            "valid": rng.random(edges.shape[1]) < 0.8,
            "mask": rng.random(n) < 0.5}


@pytest.mark.parametrize("aggregator", ["mean", "sum", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_graphsage_fullgraph_loss_and_grads(sage_graph, aggregator, masked):
    g = sage_graph
    cfg = graphsage.SAGEConfig("sage-smoke", 2, 16, 8, 5, aggregator)
    jp, model, jcfg = _pair(jsage, graphsage, cfg)
    e, valid = g["edges"], g["valid"] if masked else None
    mask = g["mask"] if masked else None

    def jloss(p):
        return jsage.loss_fn(jcfg, p, jnp.asarray(g["x"]), jnp.asarray(e[0]),
                             jnp.asarray(e[1]), jnp.asarray(g["labels"]),
                             None if valid is None else jnp.asarray(valid),
                             None if mask is None else jnp.asarray(mask))
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    logits = model(_t(g["x"]), _t(e[0]), _t(e[1]),
                   None if valid is None else _t(valid))
    _close(logits, jax.jit(lambda p: jsage.apply_fullgraph(
        jcfg, p, jnp.asarray(g["x"]), jnp.asarray(e[0]), jnp.asarray(e[1]),
        None if valid is None else jnp.asarray(valid)))(jp))
    loss = model.loss(_t(g["x"]), _t(e[0]), _t(e[1]), _t(g["labels"]),
                      None if valid is None else _t(valid),
                      None if mask is None else _t(mask))
    _close(loss, want)
    loss.backward()
    _same_grads(model, jgrads)


def test_graphsage_fullgraph_on_spmm2d(sage_graph):
    """`forward(spmm=)` with the port's make_spmm2d equals JAX's
    apply_fullgraph with JAX's, value and gradients (2x2 grid on the
    port, 1x1 on JAX: the product is the same)."""
    g = sage_graph
    cfg = graphsage.SAGEConfig("sage-2d", 2, 16, 8, 5)
    jp, model, jcfg = _pair(jsage, graphsage, cfg, key=3)
    jgrid = JGrid2D.for_vertices(g["n"], 1, 1)
    lg = jax_partition_2d(g["edges"], jgrid)
    arrays = [jnp.asarray(a) for a in (lg.col_off, lg.row_idx, lg.nnz)]
    jspmm = jax_make_spmm2d(jgrid, jax_make_mesh((1, 1), ("r", "c")))

    def jloss(p):
        logits = jsage.apply_fullgraph(
            jcfg, p, jnp.asarray(g["x"]), None, None,
            spmm=lambda h: jspmm(*arrays, h))
        lse = jax.nn.logsumexp(logits, -1)
        ll = jnp.take_along_axis(logits, jnp.asarray(g["labels"])[:, None],
                                 1)[:, 0]
        return (lse - ll).mean()
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    grid = Grid2D.for_vertices(g["n"], 2, 2)
    pg = partition_2d(_t(g["edges"]), grid)
    spmm = make_spmm2d(grid, make_mesh((2, 2), ("r", "c"), device="cpu"))
    loss = model.loss(_t(g["x"]), None, None, _t(g["labels"]),
                      spmm=lambda h: spmm(pg.col_off, pg.row_idx, pg.nnz, h))
    _close(loss, want)
    loss.backward()
    _same_grads(model, jgrads)


def test_graphsage_sampled_block(sage_graph):
    """A NeighborSampler block (fanout 15-10) through `apply_block`, the
    loss and its gradients."""
    g = sage_graph
    n = g["n"]
    e = g["edges"]
    order = np.argsort(e[0], kind="stable")
    row_off = np.concatenate([[0], np.cumsum(np.bincount(e[0], minlength=n))])
    block = NeighborSampler(row_off, e[1][order], seed=3).sample_block(
        np.arange(16), [15, 10])
    feats = [g["x"][nodes] for nodes in block["nodes"]]
    labels = g["labels"][:16]
    cfg = graphsage.SAGEConfig("sage-block", 2, 16, 8, 5)
    jp, model, jcfg = _pair(jsage, graphsage, cfg, key=5)

    def jloss(p):
        logits = jsage.apply_block(jcfg, p, [jnp.asarray(f) for f in feats],
                                   [15, 10])
        lse = jax.nn.logsumexp(logits, -1)
        ll = jnp.take_along_axis(logits, jnp.asarray(labels)[:, None],
                                 1)[:, 0]
        return (lse - ll).mean()
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    logits = model.apply_block([_t(f) for f in feats], [15, 10])
    lse = torch.logsumexp(logits, -1)
    loss = (lse - logits.gather(1, _t(labels).long()[:, None])[:, 0]).mean()
    _close(loss, want)
    loss.backward()
    _same_grads(model, jgrads)


# ---------------------------------------------------------------------------
# e3 and the equivariant nets
# ---------------------------------------------------------------------------

def test_e3_functions_equal_jax():
    rng = np.random.default_rng(8)
    E, C = 7, 4
    r = rng.standard_normal((E, 3)).astype(np.float32)
    r[0] = 0                                      # a zero displacement
    m = rng.standard_normal((E, 3, 3)).astype(np.float32)
    d = np.abs(rng.standard_normal(E)).astype(np.float32) * 3
    feat = {"s": rng.standard_normal((E, C)), "v": rng.standard_normal(
        (E, C, 3)), "t": rng.standard_normal((E, C, 3, 3))}
    feat = {k: v.astype(np.float32) for k, v in feat.items()}
    w = rng.standard_normal((E, C, e3.N_PATHS)).astype(np.float32)
    w6 = rng.standard_normal((E, C, 6)).astype(np.float32)
    ws = [rng.standard_normal((C, C)).astype(np.float32) for _ in range(3)]
    dst = np.array([0, 2, 2, -1, 5, 1, 3], np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1, 0], bool)

    def calls(E3, f, r, m, d, w, w6, ws, dst, valid):
        rhat, y2, _ = E3.sph(r)
        return [E3.traceless_sym(m), E3.sph(r), E3.bessel_basis(d, 5, 2.5),
                E3.edge_tensor_product(f, rhat, y2, w),
                E3.self_tensor_product(f, w6), E3.linear_mix(f, *ws),
                E3.gate(f, ws[0], ws[1]), E3.add(f, f),
                E3.scatter_nodes(f, dst, 4, valid),
                E3.scatter_nodes(f, dst, 4)]

    args = (feat, r, m, d, w, w6, ws, dst, valid)
    want = jax.jit(lambda *a: calls(je3, *a))(*jax.tree.map(jnp.asarray,
                                                            args))
    got = calls(e3, *jax.tree.map(_t, args))
    for g, w_ in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w_)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(jax.tree.map(lambda x: x.numpy(), got))


def _ring(seed, n=10):
    """`smoke_equiv`'s input: n atoms at random positions, edges i -> i+1
    around a ring, random species."""
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    src = np.arange(n, dtype=np.int32)
    spec = rng.integers(0, 8, n).astype(np.int32)
    return spec, pos, src, (src + 1) % n


@pytest.mark.parametrize("corr", [1, 3])
def test_equivariant_net_equals_jax(corr):
    """On `smoke_equiv`'s config and input (a ring of 10 atoms)."""
    cfg = equivariant.EquivConfig("eq-smoke", 2, 8, 4, 2.5,
                                  correlation_order=corr)
    jp, model, jcfg = _pair(jeq, equivariant, cfg)
    arrays = _ring(2)
    args = [jnp.asarray(a) for a in arrays]
    targs = [_t(a) for a in arrays]
    (jen, jnode), (je, jf), (want, jgrads) = jax.jit(lambda p: (
        jeq.apply(jcfg, p, *args),
        jeq.energy_and_forces(jcfg, p, *args),
        jax.value_and_grad(lambda q: jeq.apply(jcfg, q, *args)[0])(p)))(jp)
    en, node = model(*targs)
    _close(en, jen)
    _close(node, jnode)
    e, f = model.energy_and_forces(*targs)
    _close(e, je)
    _close(f, jf)
    model(*targs)[0].backward()
    _same_grads(model, jgrads)


def test_equivariant_species_take_matches_jax():
    """Negative species ids wrap and ids past either end give NaN rows,
    as JAX's `jnp.take` does."""
    cfg = equivariant.EquivConfig("eq", 1, 4, 4, 2.5)
    jp, model, jcfg = _pair(jeq, equivariant, cfg)
    pos, src, dst, valid = _mol(3, n=6)
    for spec in ([-1, 2, 0, 7, 1, 3], [0, 1, 8, 2, -9, 3]):
        spec = np.asarray(spec, np.int32)
        got = model(*(_t(a) for a in (spec, pos, src, dst, valid)))[1]
        want = jax.jit(lambda p, s: jeq.apply(
            jcfg, p, s, *(jnp.asarray(a) for a in (pos, src, dst, valid)))[1])(
                jp, jnp.asarray(spec))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("corr", [1, 3])
def test_equivariant_energy_invariance(corr):
    cfg = equivariant.EquivConfig("t", 2, 8, 4, 2.5, correlation_order=corr)
    model = equivariant.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    pos, src, dst, valid = (_t(a) for a in _mol(1))
    spec = torch.randint(0, cfg.n_species, (12,),
                         generator=torch.Generator().manual_seed(2))
    e0, _ = model(spec, pos, src, dst, valid)
    for i in range(3):
        R = _t(_rot(10 + i))
        shift = torch.randn(3, generator=torch.Generator().manual_seed(i))
        e1, _ = model(spec, pos @ R.T + shift, src, dst, valid)
        np.testing.assert_allclose(float(e0.detach()), float(e1.detach()), rtol=2e-4)


def test_equivariant_force_covariance():
    """F(Rx) = R F(x): forces rotate with the frame (the padded (0, 0)
    slots give NaN forces in JAX and the port alike; they compare equal)."""
    cfg = equivariant.EquivConfig("t", 2, 8, 4, 2.5, correlation_order=3)
    model = equivariant.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    pos, src, dst, valid = (_t(a) for a in _mol(1))
    spec = torch.randint(0, cfg.n_species, (12,),
                         generator=torch.Generator().manual_seed(2))
    _, f0 = model.energy_and_forces(spec, pos, src, dst, valid)
    R = _t(_rot(5))
    _, f1 = model.energy_and_forces(spec, pos @ R.T, src, dst, valid)
    np.testing.assert_allclose(f1.numpy(), (f0 @ R.T).numpy(), rtol=5e-3,
                               atol=1e-5)


def test_traceless_sym_projects():
    m = torch.randn((4, 3, 3), generator=torch.Generator().manual_seed(0))
    t = e3.traceless_sym(m)
    np.testing.assert_allclose(torch.diagonal(t, dim1=-2, dim2=-1).sum(-1)
                               .numpy(), 0, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), t.transpose(-1, -2).numpy(),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# EGNN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_egnn_equals_jax(masked):
    cfg = egnn.EGNNConfig("egnn-smoke", 2, 16, 4)
    jp, model, jcfg = _pair(jegnn, egnn, cfg)
    pos, src, dst, valid = _mol(4)
    if not masked:
        src, dst, valid = src[valid], dst[valid], None
    feats = np.random.default_rng(6).standard_normal((12, 4)).astype(
        np.float32)
    arrays = (feats, pos, src, dst, valid)
    args = [None if a is None else jnp.asarray(a) for a in arrays]
    targs = [None if a is None else _t(a) for a in arrays]
    outs, (want, jgrads) = jax.jit(lambda p: (
        jegnn.apply(jcfg, p, *args),
        jax.value_and_grad(lambda q: jegnn.apply(jcfg, q, *args)[0])(p)))(
            jp)
    for got, w in zip(model(*targs), outs):
        _close(got, w)
    en = model(*targs)[0]
    _close(en, want)
    en.backward()
    _same_grads(model, jgrads)


def test_egnn_equivariance():
    cfg = egnn.EGNNConfig("t", 3, 16, 4)
    model = egnn.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    pos, src, dst, valid = (_t(a) for a in _mol(1))
    feats = torch.randn((12, 4), generator=torch.Generator().manual_seed(2))
    e0, h0, x0 = model(feats, pos, src, dst, valid)
    R = _t(_rot(3))
    shift = torch.tensor([1., -2., 0.5])
    e1, h1, x1 = model(feats, pos @ R.T + shift, src, dst, valid)
    np.testing.assert_allclose(float(e0.detach()), float(e1.detach()), rtol=1e-4)
    np.testing.assert_allclose(h1.detach().numpy(), h0.detach().numpy(),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(x1.detach().numpy(),
                               (x0 @ R.T + shift).detach().numpy(),
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# load_jax_params / params_to_numpy
# ---------------------------------------------------------------------------

def test_load_jax_params_refuses_a_wrong_tree():
    cfg = graphsage.SAGEConfig("s", 2, 16, 8, 5)
    tree = jax.tree.map(np.asarray, jsage.init_params(_jax_cfg(jsage, cfg),
                                                      jax.random.key(0)))
    model = graphsage.init_params(cfg, device="cpu")
    missing = {"layers": tree["layers"]}
    extra = {**tree, "bias": np.zeros((), np.float32)}
    shape = {**tree, "out": tree["out"][:, :4]}
    dtype = {**tree, "out": tree["out"].astype(np.float64)}
    for bad, match in ((missing, r"missing \['out'\]"),
                       (extra, r"extra \['bias'\]"),
                       (shape, r"out: the tree holds \(16, 4\)"),
                       (dtype, "float64")):
        with pytest.raises(ValueError, match=match):
            load_jax_params(model, bad)
    load_jax_params(model, tree)
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


def test_params_to_numpy_keeps_lists_past_ten_items():
    """A list level of 12 items comes back a list in index order (its keys
    "10" and "11" sort before "2" as strings), and loads back."""
    model = torch.nn.Module()
    model.mlp = torch.nn.ParameterList(
        torch.nn.Parameter(torch.full((i + 1,), float(i))) for i in range(12))
    tree = params_to_numpy(model)
    assert isinstance(tree["mlp"], list) and len(tree["mlp"]) == 12
    assert [int(a[0]) for a in tree["mlp"]] == list(range(12))
    load_jax_params(model, tree)
