"""The value programs as a whole: `connected_components()`, `sssp(root |
roots)`, `multi_bfs(sources[, k])` and `bfs` with the delta codec, through
`DistGraph.from_edges(edges, BFSConfig(...), weights=w).session()` on the
CPU, equal the JAX package's exactly -- labels, distances, levels, sources,
`n_iters` / `n_levels`, `edges_scanned` and the `directions` trace.

  * every codec (list, bitmap, delta) x direction (False, True,
    "bottomup") at 1x1 against the JAX session in this process, and at 2x2
    and 1x4 against one JAX run in a subprocess with four forced host
    devices (tests/dist/torch_parity_ref.py --algos), which computes every
    configuration in one call;
  * the same programs with the kernel wrappers wired in (on CPU tensors
    they run their plain twins), and from the JAX package's own partition
    and weights through `repro_torch.convert`;
  * the star tie-break, the graph-level references, the checks on the
    card's validators, and the error paths with JAX's wording.

A scalar SSSP is held to the JAX batch row of its root (the JAX package's
scalar SSSP is its batch of one).  Inputs: `repro.graphgen.rmat_edges(
jax.random.key(42), 8, 16)` as numpy, uint8 weights from
`np.random.default_rng(1).integers(1, 256)` (as `benchmarks/algos_sweep.py`
draws them), roots from `np.random.default_rng(0)` among degree > 0
vertices.  Integer outputs: exact equality.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.algos import reference as jax_reference
from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.core.partition import partition_2d as jax_partition_2d
from repro.core.partition import partition_2d_csr as jax_partition_2d_csr
from repro.core.partition import partition_edge_vals as jax_edge_vals
from repro.core.partition import partition_edge_vals_csr as \
    jax_edge_vals_csr
from repro.core.types import Grid2D as JGrid2D
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.algos.reference import cc_reference, k_hop_neighborhood, \
    multi_bfs_reference, sssp_reference
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.convert import csr_from_partition, \
    edge_vals_from_partition, graph_from_partition
from repro_torch.core.types import Grid2D
from repro_torch.core.validate import validate_cc, validate_sssp
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as KE
from repro_torch.kernels import fold as KF

SCALE, EF = 8, 16
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
DIRECTIONS = (False, True, "bottomup")
CODECS = ("list", "bitmap", "delta")
GRIDS = [(1, 1), (2, 2), (1, 4)]
FIELDS = {"cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
          "mbfs": ("level", "src", "n_levels"),
          "khop": ("level", "src", "n_levels"),
          "bfs": ("level", "pred", "n_levels")}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny; on a busy machine (a parallel
    test run) torch's intra-op thread pool only waits for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dtag(direction):
    return {False: "td", True: "adaptive"}.get(direction, direction)


def star_edges(n):
    """Hub 0 joined to every spoke, both directions."""
    spokes = np.arange(1, n, dtype=np.int64)
    hub = np.zeros_like(spokes)
    return np.stack([np.concatenate([hub, spokes]),
                     np.concatenate([spokes, hub])])


@pytest.fixture(scope="module")
def graph_data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, EF))
    w = np.random.default_rng(1).integers(1, 256, size=edges.shape[1]) \
        .astype(np.uint8)
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, w, roots


def _put(out, prefix, res, fields):
    for f in fields:
        out[f"{prefix}_{f}"] = np.asarray(getattr(res, f))
    out[f"{prefix}_edges"] = np.asarray(res.edges_scanned, np.int64)
    if res.directions is not None:
        out[f"{prefix}_directions"] = np.asarray(res.directions)


@pytest.fixture(scope="module")
def jax_1x1(graph_data):
    """The JAX outputs at 1x1, in process, under the subprocess's keys."""
    edges, w, roots = graph_data
    graph = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=N,
                                    weights=w)
    ref = {}
    for direction in DIRECTIONS:
        for codec in CODECS:
            sess = graph.session(JaxBFSConfig(grid=(1, 1),
                                              direction=direction,
                                              fold_codec=codec))
            tag = f"1x1_{dtag(direction)}_{codec}"
            _put(ref, f"{tag}_cc", sess.connected_components(),
                 FIELDS["cc"])
            _put(ref, f"{tag}_sssp", sess.sssp(roots), FIELDS["sssp"])
            _put(ref, f"{tag}_mbfs", sess.multi_bfs(roots), FIELDS["mbfs"])
            if codec == "list":
                _put(ref, f"{tag}_khop", sess.multi_bfs(roots, k=2),
                     FIELDS["khop"])
            if codec == "delta":
                _put(ref, f"{tag}_bfs", sess.bfs(roots), FIELDS["bfs"])
    return ref


@pytest.fixture(scope="module")
def jax_multi(graph_data, tmp_path_factory):
    """The JAX outputs at 2x2 and 1x4 for every configuration, one
    subprocess."""
    edges, w, roots = graph_data
    d = tmp_path_factory.mktemp("jax_algo_ref")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N, weights=w)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4", "--algos"], capture_output=True, text=True,
        timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def graphs(graph_data):
    """One weighted port graph per grid, shared by every configuration
    (sessions plan the CSR twin and its weights on first need)."""
    edges, w, _ = graph_data
    return {g: DistGraph.from_edges(edges, BFSConfig(grid=g), device="cpu",
                                    n=N, weights=w) for g in GRIDS}


def _ref(grid, jax_1x1, jax_multi):
    return jax_1x1 if grid == (1, 1) else jax_multi


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), want)


def _assert_out(out, ref, prefix, kind, row=None):
    """One port output against the JAX arrays under `prefix` (row: the
    batch row a scalar search is held to)."""
    pick = (lambda a: a) if row is None else (lambda a: a[row])
    for f in FIELDS[kind]:
        _eq(getattr(out, f).numpy(), pick(ref[f"{prefix}_{f}"]))
    want_edges = pick(ref[f"{prefix}_edges"])
    got_edges = out.edges_scanned
    if isinstance(got_edges, tuple):
        assert list(got_edges) == want_edges.tolist()
    else:
        assert got_edges == int(want_edges)
    want_dirs = ref.get(f"{prefix}_directions")
    if want_dirs is None:
        assert out.directions is None
    else:
        _eq(out.directions.numpy(), pick(want_dirs))


def _session(graphs, grid, direction, codec):
    return graphs[grid].session(BFSConfig(grid=grid, direction=direction,
                                          fold_codec=codec))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("codec", CODECS)
def test_cc_equals_jax(graphs, jax_1x1, jax_multi, grid, direction, codec):
    sess = _session(graphs, grid, direction, codec)
    out = sess.connected_components()
    tag = f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}"
    _assert_out(out, _ref(grid, jax_1x1, jax_multi), f"{tag}_cc", "cc")
    if direction == "bottomup":
        dirs = out.directions.numpy()
        assert set(dirs[dirs >= 0].tolist()) == {1}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("codec", CODECS)
def test_sssp_equals_jax(graph_data, graphs, jax_1x1, jax_multi, grid,
                         direction, codec):
    """Scalar SSSP of the first two roots against their batch rows, then
    the batch."""
    _, _, roots = graph_data
    sess = _session(graphs, grid, direction, codec)
    ref = _ref(grid, jax_1x1, jax_multi)
    prefix = f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}_sssp"
    for b, root in enumerate(roots[:2]):
        _assert_out(sess.sssp(int(root)), ref, prefix, "sssp", row=b)
    _assert_out(sess.sssp(roots), ref, prefix, "sssp")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("codec", CODECS)
def test_multi_bfs_equals_jax(graph_data, graphs, jax_1x1, jax_multi, grid,
                              direction, codec):
    """All waves; under the list codec also the k = 2 hop truncation (its
    fold is the full sweep's, and every codec folds alike)."""
    _, _, roots = graph_data
    sess = _session(graphs, grid, direction, codec)
    ref = _ref(grid, jax_1x1, jax_multi)
    tag = f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}"
    _assert_out(sess.multi_bfs(roots), ref, f"{tag}_mbfs", "mbfs")
    if codec == "list":
        _assert_out(sess.multi_bfs(roots, k=2), ref, f"{tag}_khop", "khop")


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_delta_bfs_equals_jax(graph_data, graphs, jax_1x1, jax_multi, grid,
                              direction):
    """`BFSConfig(fold_codec="delta")` for BFS: scalar roots against their
    batch rows, then the batch."""
    _, _, roots = graph_data
    sess = _session(graphs, grid, direction, "delta")
    assert sess.engine.codec.name == "delta"
    ref = _ref(grid, jax_1x1, jax_multi)
    prefix = f"{grid[0]}x{grid[1]}_{dtag(direction)}_delta_bfs"
    for b, root in enumerate(roots[:2]):
        _assert_out(sess.bfs(int(root)), ref, prefix, "bfs", row=b)
    _assert_out(sess.bfs(roots), ref, prefix, "bfs")


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
@pytest.mark.parametrize("direction,codec", [(False, "delta"),
                                             (True, "bitmap"),
                                             ("bottomup", "delta")])
def test_kernel_wrappers_equal_jax(graph_data, graphs, jax_multi, grid,
                                   direction, codec):
    """The kernel path's wiring -- the value chunk hooks and `fold_ops`
    through the codecs, `expand_exchange_values`, `pack_blocks` and
    `owned_to_front` -- with the wrappers on CPU tensors, where they run
    their plain twins."""
    _, _, roots = graph_data
    sess = _session(graphs, grid, direction, codec)
    tag = f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}"
    for program, call in (("cc", lambda s: s.connected_components()),
                          ("sssp", lambda s: s.sssp(roots)),
                          ("mbfs", lambda s: s.multi_bfs(roots))):
        call(sess)                       # builds the program's engine
        for eng in sess.graph._engines.values():
            eng.value_expand_fn = KE.expand_chunk_values
            eng.value_bottomup_fn = KB.bottomup_chunk_values \
                if eng.program.uses_bottomup else None
            eng.fold_ops = eng.codec.ops = KF
        _assert_out(call(sess), jax_multi, f"{tag}_{program}", program)
    # drop the rewired engines and the cache entries bound to them
    sess.graph._engines.clear()
    sess.graph._compiled._entries.clear()


@pytest.mark.parametrize("grid", [(2, 2), (1, 4)])
def test_from_jax_partition_and_weights_equal_jax(graph_data, jax_multi,
                                                  grid):
    """Both packages run SSSP over the very same CSC, CSR and weights."""
    edges, w, roots = graph_data
    R, C = grid
    jgrid, tgrid = JGrid2D(R, C, N), Grid2D(R, C, N)
    lg = jax_partition_2d(edges, jgrid)
    csr = jax_partition_2d_csr(edges, jgrid)
    graph = DistGraph.from_partition(
        tgrid, graph_from_partition(tgrid, lg.col_off, lg.row_idx, lg.nnz,
                                    "cpu"),
        BFSConfig(direction=True, fold_codec="list"), n=N,
        csr=csr_from_partition(tgrid, csr["row_off"], csr["col_idx"],
                               csr["nnz"], "cpu"),
        weights=edge_vals_from_partition(
            tgrid, jax_edge_vals(edges, w, jgrid), "cpu"),
        csr_weights=edge_vals_from_partition(
            tgrid, jax_edge_vals_csr(edges, w, jgrid), "cpu"))
    assert graph.weights.dtype == torch.uint8
    _assert_out(graph.session().sssp(roots), jax_multi,
                f"{R}x{C}_adaptive_list_sssp", "sssp")


def test_references_and_validators(graph_data, graphs):
    """The port's outputs equal the numpy references, and pass the card's
    checks (`validate_cc`, `validate_sssp`)."""
    edges, w, roots = graph_data
    sess = graphs[(2, 2)].session()
    te, tw = torch.tensor(edges, dtype=torch.int32), torch.from_numpy(w)
    labels = sess.connected_components().labels
    _eq(labels.numpy(), cc_reference(edges, N))
    validate_cc(te, labels)
    for root in roots:
        dist = sess.sssp(int(root)).dist
        _eq(dist.numpy(), sssp_reference(edges, w, N, int(root)))
        validate_sssp(te, tw, dist, int(root))
    out = sess.multi_bfs(roots, k=2)
    lref, sref = multi_bfs_reference(edges, N, roots, max_levels=2)
    _eq(out.level.numpy(), lref)
    _eq(out.src.numpy(), sref)


def test_references_equal_jax_copies(graph_data):
    """The port's numpy references (`repro_torch.algos.reference`, a copy)
    equal the JAX package's on the test graph and on a directed star."""
    edges, w, roots = graph_data
    star = np.array([[0, 0, 0, 3], [1, 2, 3, 4]], np.int32)
    for e, n in ((edges, N), (star, 5)):
        _eq(cc_reference(e, n), jax_reference.cc_reference(e, n))
        for root in roots[:2] if n == N else (0,):
            ww = w if n == N else np.array([5, 1, 2, 7], np.uint8)
            _eq(sssp_reference(e, ww, n, int(root)),
                jax_reference.sssp_reference(e, ww, n, int(root)))
        srcs = roots if n == N else [3, 0]
        for k in (None, 1, 2):
            for a, b in zip(multi_bfs_reference(e, n, srcs, max_levels=k),
                            jax_reference.multi_bfs_reference(
                                e, n, srcs, max_levels=k)):
                _eq(a, b)
        _eq(k_hop_neighborhood(e, n, srcs, 2),
            jax_reference.k_hop_neighborhood(e, n, srcs, 2))


def _relabel_self(x):
    """A vertex that is not its component's minimum takes its own id."""
    v = int(torch.nonzero(x < torch.arange(x.numel()))[0])
    x[v] = v


@pytest.mark.parametrize("what,mutate,msg", [
    ("cc", lambda x: x.__setitem__(x.argmax(), x.argmax() + 1),
     "label above its vertex"),
    ("cc", _relabel_self, "edge joins two labels"),
    ("sssp", lambda x: x.__setitem__(x.argmax(), x.max() - 1),
     "no tight in-edge"),
    ("sssp", lambda x: x.__setitem__(x.argmax(), x.max() + 1),
     "dist\\[v\\] > dist\\[u\\] \\+ w"),
    ("sssp", lambda x: x.__setitem__(x.argmax(), -1), "reached and"),
])
def test_validators_catch_broken_outputs(graph_data, graphs, what, mutate,
                                         msg):
    edges, w, roots = graph_data
    sess = graphs[(1, 1)].session()
    te, tw = torch.tensor(edges, dtype=torch.int32), torch.from_numpy(w)
    if what == "cc":
        labels = sess.connected_components().labels.clone()
        mutate(labels)
        with pytest.raises(AssertionError, match=msg):
            validate_cc(te, labels)
    else:
        dist = sess.sssp(int(roots[0])).dist.clone()
        mutate(dist)
        with pytest.raises(AssertionError, match=msg):
            validate_sssp(te, tw, dist, int(roots[0]))


@pytest.mark.parametrize("grid", GRIDS)
def test_multi_bfs_star_tie_break(grid):
    """Every spoke adjacent to two sources in one wave: the minimum index
    wins, as in the JAX package and the numpy reference."""
    n = 17
    edges = star_edges(n)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=grid), device="cpu",
                                 n=n)
    out = graph.session().multi_bfs(np.array([5, 3]))
    lref, sref = multi_bfs_reference(edges, n, [5, 3])
    _eq(out.level.numpy()[:n], lref)
    _eq(out.src.numpy()[:n], sref)
    assert int(out.src[0]) == 0                  # hub claimed by index 0
    jax_out = JaxDistGraph.from_edges(
        edges, JaxBFSConfig(grid=(1, 1)), n=n).session().multi_bfs(
        np.array([5, 3]))
    _eq(out.src.numpy()[:n], np.asarray(jax_out.src)[:n])


def test_sssp_without_weights_raises(graph_data):
    edges, _, _ = graph_data
    graph = DistGraph.from_edges(edges, BFSConfig(), device="cpu", n=N)
    with pytest.raises(ValueError, match="sssp needs resident per-edge "
                                         "weights"):
        graph.session().sssp(0)


def test_multi_bfs_rejects_empty_sources(graphs):
    with pytest.raises(ValueError, match="non-empty 1D array"):
        graphs[(1, 1)].session().multi_bfs(np.array([], np.int32))
    with pytest.raises(ValueError, match="out-of-range vertex id"):
        graphs[(1, 1)].session().multi_bfs([0, N])


def test_delta_refuses_big_blocks_with_jax_wording():
    """S > 65536 cannot carry 16-bit gaps: the session refuses with the
    JAX package's message, naming the codecs that do work."""
    n = (1 << 16) + 16
    edges = np.array([[0, 1], [1, 0]])
    graph = DistGraph.from_edges(edges, BFSConfig(), device="cpu", n=n)
    with pytest.raises(ValueError) as ours:
        graph.session(BFSConfig(fold_codec="delta"))
    jgraph = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=n)
    with pytest.raises(ValueError) as theirs:
        jgraph.session(JaxBFSConfig(grid=(1, 1), fold_codec="delta"))
    assert str(ours.value) == str(theirs.value)
    assert "codecs that do work at this block size: ['bitmap', 'list']" \
        in str(ours.value)
    with pytest.raises(ValueError, match="S=65552"):
        graph.session().connected_components(fold_codec="delta")


def test_algo_engines_cached_on_graph(graphs):
    graph = graphs[(1, 1)]
    s1, s2 = graph.session(), graph.session()
    s1.connected_components()
    n_engines = len(graph._engines)
    s2.connected_components()
    assert len(graph._engines) == n_engines
    s1.connected_components(fold_codec="delta")
    assert len(graph._engines) == n_engines + 1
