"""The port's 1D partition, deprecated drivers and `DistBFSEngine` against
the JAX package's, on the CPU, exactly:

  * `partition_1d` returns JAX's dict array for array (several P, pad_to,
    no edges), and raises where JAX refuses n % P != 0;
  * `BFS2D` under every fold codec and the legacy `fold_bitmap` kwarg,
    `BFS1D` and `BFS2DDirection` warn with a DeprecationWarning naming the
    class and the port's API, rerun a graph from their shared cache (one
    build), and equal the JAX drivers' levels, preds, n_levels,
    edges_scanned (and directions) -- at 1x1 in this process, at 2x2 and
    1x4 against tests/dist/torch_parity_ref.py --shims (four forced host
    devices) in one subprocess;
  * `DistBFSEngine` with the default step and with an identity
    `step_factory` equals JAX's, `run_batch` and `assemble_batch` equal the
    scalar runs, a custom step's telemetry and edge count hold, and the
    mesh counterpart (`make_mesh`, `Topology`, `Topology.one_d`) binds and
    refuses as JAX's does.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(7), 8, 8)` as numpy;
roots from `np.random.default_rng(3)` among degree > 0 vertices.
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Grid2D as JGrid2D
from repro.core import partition_2d as jax_partition_2d
from repro.core.partition import partition_1d as jax_partition_1d
from repro.core.partition import partition_2d_csr as jax_partition_2d_csr
from repro.core.types import LocalGraph2D as JLocalGraph2D
from repro.dist.compat import make_mesh as jax_make_mesh
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.core import Grid2D, partition_1d, partition_2d
from repro_torch.core.bfs1d import BFS1D
from repro_torch.core.bfs2d import BFS2D
from repro_torch.core.direction import BFS2DDirection
from repro_torch.core.partition import partition_2d_csr
from repro_torch.dist import DistBFSEngine, Topology, make_mesh

SCALE, EF = 8, 8
N = 1 << SCALE
CHUNK = 512
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gdata():
    edges = np.asarray(jax_rmat_edges(jax.random.key(7), SCALE, EF))
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(3).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, roots


@pytest.fixture(scope="module")
def jax_ref(gdata, tmp_path_factory):
    """The JAX drivers at 2x2 and 1x4, from one subprocess."""
    edges, roots = gdata
    d = tmp_path_factory.mktemp("jax_shims")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4", "--shims"], capture_output=True, text=True,
        timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


def _tedges(edges):
    return torch.from_numpy(edges.copy())


def _mesh(R, C):
    return make_mesh((R, C), ("r", "c"), device="cpu")


def _same(out, ref, prefix):
    """A port output equals the JAX one (an output or an .npz prefix)."""
    def get(f):
        if isinstance(ref, dict):
            return ref[f"{prefix}_{f}"]
        v = getattr(ref, f)
        return np.asarray(v, np.int64) if f == "edges" else np.asarray(v)
    for f in ("level", "pred", "n_levels"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), get(f))
    np.testing.assert_array_equal(np.asarray(out.edges_scanned, np.int64),
                                  get("edges" if isinstance(ref, dict)
                                      else "edges_scanned"))
    if out.directions is not None:
        np.testing.assert_array_equal(out.directions.numpy(),
                                      get("directions"))


# ---------------------------------------------------------------------------
# partition_1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P,pad_to", [(1, None), (4, None), (8, None),
                                      (4, 3000), (16, None)])
def test_partition_1d_equals_jax(gdata, P, pad_to):
    edges, _ = gdata
    want = jax_partition_1d(edges, N, P, pad_to=pad_to)
    got = partition_1d(_tedges(edges), N, P, pad_to=pad_to)
    assert sorted(got) == sorted(want)
    for k in ("col_off", "row_idx", "nnz"):
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    assert (got["n"], got["P"]) == (want["n"], want["P"])


def test_partition_1d_edge_cases(gdata):
    edges, _ = gdata
    empty = np.zeros((2, 0), np.int32)
    want = jax_partition_1d(empty, 16, 4)
    got = partition_1d(torch.from_numpy(empty), 16, 4)
    for k in ("col_off", "row_idx", "nnz"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(ValueError, match="divisible"):
        partition_1d(_tedges(edges), N + 1, 4)
    with pytest.raises(ValueError, match="pad_to=10"):
        partition_1d(_tedges(edges), N, 4, pad_to=10)


# ---------------------------------------------------------------------------
# The deprecated drivers
# ---------------------------------------------------------------------------

def _jax_graph(edges, grid):
    lg = jax_partition_2d(edges, grid)
    return JLocalGraph2D(jnp.asarray(lg.col_off), jnp.asarray(lg.row_idx),
                         jnp.asarray(lg.nnz))


@pytest.mark.parametrize("codec", ["list", "bitmap", "delta", "legacy"])
def test_bfs2d_equals_jax_at_1x1(gdata, codec):
    from repro.core.bfs2d import BFS2D as JaxBFS2D

    edges, roots = gdata
    kw = {"fold_bitmap": True} if codec == "legacy" \
        else {"fold_codec": codec}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jdrv = JaxBFS2D(JGrid2D.for_vertices(N, 1, 1),
                        jax_make_mesh((1, 1), ("r", "c")), edge_chunk=CHUNK,
                        **kw)
    with pytest.warns(DeprecationWarning, match="BFS2D is deprecated; use "
                      "repro_torch.api"):
        drv = BFS2D(Grid2D.for_vertices(N, 1, 1), _mesh(1, 1),
                    edge_chunk=CHUNK, **kw)
    assert drv.engine.codec.name == jdrv.engine.codec.name
    graph = partition_2d(_tedges(edges), drv.grid)
    jgraph = _jax_graph(edges, JGrid2D.for_vertices(N, 1, 1))
    for root in roots:
        _same(drv.run(graph, int(root)), jdrv.run(jgraph, int(root)), None)
    again = partition_2d(_tedges(edges), drv.grid)   # another graph object
    _same(drv.run(again, int(roots[0])), jdrv.run(jgraph, int(roots[0])),
          None)
    assert drv.engine.trace_count == 1, "reruns must hit the shared cache"


def test_bfs1d_and_direction_equal_jax_at_1x1(gdata):
    from repro.core.bfs1d import BFS1D as JaxBFS1D
    from repro.core.direction import BFS2DDirection as JaxBFS2DDirection

    edges, roots = gdata
    root = int(roots[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        j1 = JaxBFS1D(N, jax_make_mesh((1,), ("p",)), edge_chunk=CHUNK)
        jd = JaxBFS2DDirection(JGrid2D.for_vertices(N, 1, 1),
                               jax_make_mesh((1, 1), ("r", "c")),
                               edge_chunk=CHUNK)
    with pytest.warns(DeprecationWarning, match="BFS1D is deprecated; use "
                      "repro_torch.api"):
        b1 = BFS1D(N, make_mesh((1,), ("p",), device="cpu"),
                   edge_chunk=CHUNK)
    assert (b1.P, b1.ncl, b1.grid.n) == (j1.P, j1.ncl, j1.grid.n)
    _same(b1.run(partition_2d(_tedges(edges), b1.grid), root),
          j1.run(_jax_graph(edges, j1.grid), root), None)
    with pytest.warns(DeprecationWarning, match="BFS2DDirection is "
                      "deprecated; use repro_torch.api"):
        bd = BFS2DDirection(Grid2D.for_vertices(N, 1, 1), _mesh(1, 1),
                            edge_chunk=CHUNK)
    grid = bd.grid
    csr = partition_2d_csr(_tedges(edges), grid)
    jcsr = {k: jnp.asarray(v) for k, v in jax_partition_2d_csr(
        edges, JGrid2D.for_vertices(N, 1, 1)).items()}
    jout = jd.run(_jax_graph(edges, JGrid2D.for_vertices(N, 1, 1)), jcsr,
                  root)
    out = bd.run(partition_2d(_tedges(edges), grid), csr, root)
    _same(out, jout, None)
    bd.run(partition_2d(_tedges(edges), grid), csr, root)
    assert bd.engine.trace_count == 1


@pytest.mark.parametrize("R,C", [(2, 2), (1, 4)])
def test_drivers_equal_jax_on_multi_device_grids(gdata, jax_ref, R, C):
    """At 2x2 and 1x4 the port's drivers equal the JAX drivers run on four
    forced host devices: BFS2D under each codec, BFS2DDirection, BFS1D
    (1 x P), the engine's default and identity steps and its batch."""
    edges, roots = gdata
    tag, root = f"{R}x{C}", int(roots[0])
    grid = Grid2D.for_vertices(N, R, C)
    mesh = _mesh(R, C)
    graph = partition_2d(_tedges(edges), grid)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for codec in ("list", "bitmap", "delta"):
            _same(BFS2D(grid, mesh, edge_chunk=CHUNK, fold_codec=codec)
                  .run(graph, root), jax_ref, f"{tag}_bfs2d_{codec}")
        _same(BFS2DDirection(grid, mesh, edge_chunk=CHUNK).run(
            graph, partition_2d_csr(_tedges(edges), grid), root), jax_ref,
            f"{tag}_dir")
        if R == 1:
            b1 = BFS1D(N, make_mesh((C,), ("p",), device="cpu"),
                       edge_chunk=CHUNK)
            _same(b1.run(partition_2d(_tedges(edges), b1.grid), root),
                  jax_ref, f"{tag}_bfs1d")
    topo = Topology(grid, mesh)
    eng = DistBFSEngine(topo, edge_chunk=CHUNK)
    _same(eng.run(graph, root), jax_ref, f"{tag}_engine")
    _same(eng.run_batch(graph, roots), jax_ref, f"{tag}_engine_batch")
    ident = DistBFSEngine(topo, edge_chunk=CHUNK,
                          step_factory=lambda e, g, x, topdown: (
                              lambda st, prev_total: topdown(st)))
    _same(ident.run(graph, root), jax_ref, f"{tag}_ident")


# ---------------------------------------------------------------------------
# DistBFSEngine
# ---------------------------------------------------------------------------

def test_engine_batches_equal_scalar_runs(gdata):
    edges, roots = gdata
    grid = Grid2D.for_vertices(N, 2, 2)
    graph = partition_2d(_tedges(edges), grid)
    eng = DistBFSEngine(Topology(grid, _mesh(2, 2)), edge_chunk=CHUNK,
                        fold_codec="bitmap")
    outs = [eng.run(graph, int(r)) for r in roots]
    batch = eng.run_batch(graph, roots)
    again = eng.assemble_batch([eng._search(graph, int(r), ())
                                for r in roots], len(roots))
    for b, out in enumerate(outs):
        for got in (batch, again):
            assert torch.equal(got.level[b], out.level)
            assert torch.equal(got.pred[b], out.pred)
            assert int(got.n_levels[b]) == int(out.n_levels)
            assert got.edges_scanned[b] == out.edges_scanned
    assert eng.program.key == ("bfs", None, 0) and eng.n_extra == 0


def test_custom_step_factory_contract(gdata):
    """A step_factory sees the global frontier entering each level; a
    custom step's per-processor `scanned` is summed exactly, and with
    telemetry a 3-tuple step records it per processor."""
    edges, roots = gdata
    grid = Grid2D.for_vertices(N, 2, 2)
    graph = partition_2d(_tedges(edges), grid)
    topo = Topology(grid, _mesh(2, 2))
    ref = DistBFSEngine(topo, edge_chunk=CHUNK, telemetry=True).run(
        graph, int(roots[0]))
    seen = []

    def factory(engine, g, extra, topdown):
        assert engine.grid == grid and extra == ()

        def step(st, prev_total):
            seen.append(prev_total)
            st2, total, scanned, _ = topdown(st)
            return st2, total, torch.tensor(scanned)
        return step

    eng = DistBFSEngine(topo, edge_chunk=CHUNK, telemetry=True,
                        step_factory=factory)
    out = eng.run(graph, int(roots[0]))
    assert torch.equal(out.level, ref.level)
    assert torch.equal(out.pred, ref.pred)
    assert out.edges_scanned == ref.edges_scanned
    assert seen == ref.trace.frontier[:len(seen)].tolist()
    np.testing.assert_array_equal(out.trace.scanned, ref.trace.scanned)
    assert eng.program.key == ("bfs", factory, 0)


def test_topdown_step_is_one_level(gdata):
    from repro_torch.algos.bfs import init_state

    edges, roots = gdata
    grid = Grid2D.for_vertices(N, 2, 2)
    graph = partition_2d(_tedges(edges), grid)
    eng = DistBFSEngine(Topology(grid, _mesh(2, 2)), edge_chunk=CHUNK)
    st = init_state(int(roots[0]), grid=grid, device=eng.device)
    st2, total, scanned, aux = eng.topdown_step(graph, st)
    assert st2.lvl == 2 and aux is None
    assert int(total) == int(st2.front_cnt.sum())
    assert sum(scanned) > 0 and len(scanned) == grid.P


def test_mesh_counterpart_binds_as_jax():
    from repro.dist.topology import Topology as JaxTopology

    grid = Grid2D.for_vertices(N, 2, 2)
    mesh = make_mesh((2, 2), ("r", "c"), device="cpu")
    assert mesh.size == 4 and mesh.device == torch.device("cpu")
    topo = Topology(grid, mesh)
    assert topo.grid == grid and not topo.distributed
    one = Topology.one_d(N + 3, make_mesh((4,), ("p",), device="cpu"))
    assert (one.grid.R, one.grid.C, one.grid.n) == (1, 4, N + 4)
    one = Topology.one_d(N + 3, make_mesh((1,), ("p",), device="cpu"))
    jone = JaxTopology.one_d(N + 3, jax_make_mesh((1,), ("p",)))
    assert (one.grid.R, one.grid.C, one.grid.n) == \
        (jone.grid.R, jone.grid.C, jone.grid.n)
    with pytest.raises(ValueError, match="mesh axes give a 2x2 grid"):
        Topology(Grid2D.for_vertices(N, 1, 4), mesh)
    with pytest.raises(ValueError, match="axis sizes"):
        make_mesh((2, 2), ("r",), device="cpu")
