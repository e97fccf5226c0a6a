"""The port's session and package surface against the JAX package's, on the
CPU at 1x1 and 2x2 (mirroring tests/test_api_session.py's residency and
cache tests):

  * residency: the edge list, its weights and the `EdgeIndex` live only
    while the CSR twin is unplanned -- `ensure_csr` and `release_edges`
    drop them, `bfs(validate=True)` then raises the "released" ValueError
    as JAX's does, and a direction session on a graph with neither raises
    "CSR";
  * the executable cache (`AOTCache`): bounded LRU with hit / miss /
    eviction counters, `compiled_for(B)`, engine `trace_count`, and
    `cache_stats()` equal to the JAX graph's on one session call sequence;
  * the engine key by codec name (a `ListFold()` instance and "list" share
    one engine), `build_engine`, `resolve_fold_codec`, `wide_add` /
    `wide_total`, `teps`;
  * every name of the JAX packages' `__all__` / import lists resolves on
    the port, except those a later ROADMAP item brings and those with no
    counterpart in the port (each listed here with its reason); for the
    graph-learning, recsys and LM modules, the registry and the dry run
    every module-level name of each JAX module has a counterpart in the
    port's module or model class, and the private JAX helpers listed here
    (XLA's HLO text, NamedShardings) have none.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(0), 8, 8)` as numpy,
uint8 weights `(|31 u + v| mod 255) + 1`, roots from
`np.random.default_rng(1)` among degree > 0 vertices.
"""
import importlib
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.api import (AOTCache, BFSConfig, DistGraph, build_engine,
                             resolve_fold_codec)
from repro_torch.dist.exchange import BitmapFold, ListFold

SCALE, EF = 8, 8
N = 1 << SCALE
GRIDS = [(1, 1), (2, 2)]
# JAX names whose port comes with a later ROADMAP item
WAITING = {}
# JAX names with no counterpart in the port, and why
JAX_ONLY = {"repro.dist": {
    "shard_map": "the port runs no shard_map program: the stacked grid's "
                 "collectives are tensor operations, a process group's "
                 "torch.distributed calls",
    "axis_types_kwargs": "torch meshes have no axis types"}}
# the graph-learning, recsys and LM modules: each JAX module-level function,
# class and constant has a counterpart of the same name in the port's
# module, or is a method of the module's nn.Module (under METHODS' name),
# or is listed here
MODULE_CLASSES = {"models.gnn.graphsage": "GraphSAGE",
                  "models.gnn.equivariant": "EquivariantNet",
                  "models.gnn.egnn": "EGNN",
                  "models.recsys.deepfm": "DeepFM",
                  "models.lm": "LM"}
METHODS = {"apply": "forward", "loss_fn": "loss"}
MODULE_WAITING = {}
_HLO = ("reads the text of XLA's compiled HLO module; the port traces its "
        "steps on the meta device and has no HLO (launch/roofline.py)")
MODULE_JAX_ONLY = {
    "models.recsys.deepfm": {
        "param_shardings": "PartitionSpecs of the table over a device mesh; "
                           "the port holds the table on one card"},
    "models.gnn.e3": {
        "I3": "a module-level identity array; the port builds it on the "
              "features' device and dtype (`e3._eye`)"},
    "models.lm": {
        "param_shardings": "PartitionSpecs of the weights over a device "
                           "mesh (Megatron TP, EP); the port holds the "
                           "weights on one card"},
    "train.train_step": {
        "state_shardings": "PartitionSpecs of the ZeRO-1 optimizer state "
                           "over a device mesh; the port holds the state "
                           "on one card"},
    "launch.roofline": {"parse_collective_bytes": _HLO, "analyze_hlo": _HLO,
                        "cost_analysis_dict": _HLO}}
# private JAX helpers with no counterpart, and why (the names above are
# the modules' public ones)
_NS = ("builds a jax NamedSharding, which has no counterpart: the port's "
       "specs carry each leaf's split as a configs.common.Split")
PRIVATE_JAX_ONLY = {
    "launch.roofline": {"_shape_bytes": _HLO, "_group_size": _HLO},
    "configs.lm_common": {"_ns": _NS, "_cache_shardings": _NS},
    "configs.gnn_common": {"_ns": _NS, "_edges_abs": "ShapeDtypeStructs of "
                           "an edge list, which the port's build_*_dryrun "
                           "functions make as meta tensors in place"},
    "configs.recsys_common": {"_ns": _NS}}
PORTED_MODULES = (
    "sparse.segment", "sparse.embedding_bag", "sparse.sampler",
    "core.spmm2d", "optim.adamw", "optim.grad_compress",
    "models.gnn.graphsage", "models.gnn.e3", "models.gnn.equivariant",
    "models.gnn.egnn", "models.recsys.deepfm", "configs.common",
    "configs.gnn_common", "configs.recsys_common", "configs.bfs_rmat",
    "configs.graphsage_reddit", "configs.nequip", "configs.mace",
    "configs.egnn", "configs.deepfm", "models.lm", "models.moe",
    "configs.lm_common", "configs.gemma2_2b", "configs.glm4_9b",
    "configs.h2o_danube_1_8b", "configs.kimi_k2_1t_a32b",
    "configs.qwen2_moe_a2_7b", "train.train_step", "train.serve_step",
    "data.pipeline", "launch.train", "configs.registry", "launch.mesh",
    "launch.roofline", "launch.dryrun")
PACKAGES = ("algos", "api", "core", "ckpt", "serve", "obs", "runtime",
            "scenarios", "graphgen", "dist", "sparse", "optim", "configs",
            "train", "data")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gdata():
    edges = np.asarray(jax_rmat_edges(jax.random.key(0), SCALE, EF))
    w = (np.abs(edges[0] * 31 + edges[1]) % 255 + 1).astype(np.uint8)
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(1).choice(np.flatnonzero(deg > 0), 8,
                                            replace=False)
    return edges, w, roots


def _plan(edges, grid, **kw):
    kw.setdefault("edge_chunk", 512)
    return DistGraph.from_edges(edges, BFSConfig(grid=grid, **kw), n=N,
                                device="cpu")


# ---------------------------------------------------------------------------
# Residency: the edges live only while the CSR twin is unplanned
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_csr_planning_releases_edges(gdata, grid):
    """The edge list exists only to plan the CSR twin lazily (and to
    validate before it exists): gone, with its weights and its EdgeIndex,
    once the CSR is resident; `from_edges` never plans CSR eagerly -- even
    for a direction config it waits for the first bottom-up consumer."""
    edges, w, roots = gdata
    lazy_dir = DistGraph.from_edges(
        edges, BFSConfig(grid=grid, edge_chunk=512, direction=True), n=N,
        weights=w, device="cpu")
    assert lazy_dir.csr is None and lazy_dir.edges is not None
    assert lazy_dir.edge_weights is not None
    lazy_dir.session()                 # first direction session plans it
    assert lazy_dir.csr is not None and lazy_dir.edges is None
    assert lazy_dir.edge_weights is None and lazy_dir._edge_index is None
    assert lazy_dir.csr_weights is not None
    lazy = _plan(edges, grid)
    lazy.session().bfs(int(roots[0]), validate=True)
    assert lazy.edges is not None and lazy._edge_index is not None
    lazy.ensure_csr()
    assert lazy.csr is not None and lazy.edges is None
    assert lazy._edge_index is None
    rel = _plan(edges, grid)
    rel.edge_index()
    rel.release_edges()
    assert rel.edges is None and rel._edge_index is None
    with pytest.raises(ValueError, match="CSR"):
        rel.session(BFSConfig(grid=grid, direction=True))


@pytest.mark.parametrize("grid", GRIDS)
def test_validate_true_after_release_raises_released(gdata, grid):
    """`bfs(validate=True)` with the edges dropped raises the "released"
    ValueError naming `validate=edges`, as JAX's does; an edge array still
    validates, scalar and batch alike."""
    edges, w, roots = gdata
    for drop in ("ensure_csr", "release_edges"):
        graph = _plan(edges, grid)
        getattr(graph, drop)()
        sess = graph.session()
        with pytest.raises(ValueError, match="released"):
            sess.bfs(int(roots[0]), validate=True)
        with pytest.raises(ValueError, match="validate=edges"):
            sess.bfs(roots, validate=True)
        sess.bfs(int(roots[0]), validate=edges)
        sess.bfs(roots, validate=torch.from_numpy(edges.copy()))
    jgraph = JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=N)
    jgraph.ensure_csr()
    with pytest.raises(ValueError, match="released"):
        jgraph.session().bfs(int(roots[0]), validate=True)


# ---------------------------------------------------------------------------
# The executable cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
def test_aot_cache_bounded_with_stats(gdata, grid):
    """A sweep over many batch sizes B stays under the cache's cap (LRU
    eviction), with hit / miss / eviction counters for serve accounting;
    eviction costs a rebuilt entry, never correctness."""
    edges, w, roots = gdata
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=grid, fold_codec="list", edge_chunk=512), n=N,
        aot_cache_size=3, device="cpu")
    sess = graph.session()
    for B in range(1, 7):                    # 6 distinct capacity classes
        sess.bfs(roots[:B])
    stats = graph.cache_stats()
    assert len(graph._compiled) <= 3, "cache exceeded its cap"
    assert stats["size"] <= 3 and stats["maxsize"] == 3
    assert stats["misses"] == 6 and stats["evictions"] == 3
    traces = sess.engine.trace_count
    assert traces == 6
    out6 = sess.bfs(roots[:6])
    assert graph.cache_stats()["hits"] == stats["hits"] + 1
    assert sess.engine.trace_count == traces
    out1 = sess.bfs(roots[:1])               # B=1 was evicted
    assert graph.cache_stats()["misses"] == stats["misses"] + 1
    assert sess.engine.trace_count == traces + 1
    assert torch.equal(out1.level[0], out6.level[0])


def test_aot_cache_lru_and_introspection():
    cache = AOTCache(2)
    cache["a"], cache["b"] = 1, 2
    assert "a" in cache and cache.stats()["hits"] == 0   # `in` counts none
    assert cache.get("a") == 1                           # a most recent
    cache["c"] = 3                                       # evicts b
    assert cache.get("b") is None and "c" in cache
    assert cache.stats() == {"size": 2, "maxsize": 2, "hits": 1,
                             "misses": 1, "evictions": 1}
    with pytest.raises(ValueError, match="maxsize >= 1"):
        AOTCache(0)


def test_compiled_for_is_the_scalar_and_batched_entry(gdata):
    """`compiled_for(B)` raises for B < 1, returns one entry per class (a
    scalar root is the B = 1 entry), and its entry computes the batch."""
    edges, w, roots = gdata
    graph = _plan(edges, (1, 1))
    sess = graph.session()
    with pytest.raises(ValueError, match="B must be >= 1"):
        sess.compiled_for(0)
    e3 = sess.compiled_for(3)
    assert sess.compiled_for(3) is e3 and sess.engine.trace_count == 1
    out = e3(roots[:3].tolist())
    ref = sess.bfs(roots[:3])
    assert torch.equal(out.level, ref.level) and torch.equal(out.pred,
                                                             ref.pred)
    one = sess.bfs(int(roots[0]))
    assert sess.compiled_for(1) is graph._compiled.get(
        (sess.config.engine_key, tuple(graph.csc.col_off.shape),
         tuple(graph.csc.row_idx.shape), 1))
    assert torch.equal(one.level, ref.level[0])
    with pytest.warns(DeprecationWarning, match="cache_stats"):
        assert graph.aot_cache_stats() == graph.cache_stats()


def _session_sequence(sess, roots):
    """One call sequence over every cached entry point: BFS scalar and
    batches (a repeat hits), SSSP scalar (the B = 1 batched entry) and
    batch, CC twice, multi-BFS with and without k, a second codec."""
    sess.bfs(int(roots[0]))
    sess.bfs(roots[:3])
    sess.bfs(roots[3:6])
    sess.bfs(roots[:1])
    sess.sssp(int(roots[1]))
    sess.sssp(roots[:1])
    sess.sssp(roots[:2])
    sess.connected_components()
    sess.connected_components()
    sess.connected_components(fold_codec="list")
    sess.multi_bfs(roots[:3], k=2)
    sess.multi_bfs(roots[:3])
    sess.multi_bfs(roots[:2])


def test_cache_stats_equal_jax_on_one_sequence(gdata):
    """The same session calls on a JAX graph and a port graph (1x1) leave
    equal `cache_stats()` -- the keys and the call paths are JAX's."""
    edges, w, roots = gdata
    cfg = dict(grid=(1, 1), edge_chunk=512)
    jgraph = JaxDistGraph.from_edges(edges, JaxBFSConfig(**cfg), n=N,
                                     weights=w, aot_cache_size=4)
    graph = DistGraph.from_edges(edges, BFSConfig(**cfg), n=N, weights=w,
                                 aot_cache_size=4, device="cpu")
    _session_sequence(jgraph.session(), roots)
    _session_sequence(graph.session(), roots)
    assert graph.cache_stats() == jgraph.cache_stats()
    assert graph.cache_stats()["evictions"] > 0


def test_fault_tolerant_queries_bypass_the_cache(gdata):
    edges, w, roots = gdata
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(1, 1), fault_tolerance=True), n=N,
        weights=w, device="cpu")
    sess = graph.session()
    sess.bfs(int(roots[0]))
    sess.sssp(roots[:2])
    sess.connected_components()
    assert graph.cache_stats() == {"size": 0, "maxsize": 32, "hits": 0,
                                   "misses": 0, "evictions": 0}


# ---------------------------------------------------------------------------
# Engine keys, build_engine, the small helpers
# ---------------------------------------------------------------------------

def test_codec_instance_and_name_share_one_engine(gdata):
    """`BFSConfig.codec_name` leads the engine key, as in JAX: a
    `ListFold()` request and a "list" request build one engine (and share
    cache entries); "bitmap" and a `BitmapFold()` likewise."""
    edges, w, roots = gdata
    graph = _plan(edges, (2, 2))
    by_name = graph.session(BFSConfig(grid=(2, 2), edge_chunk=512))
    by_obj = graph.session(BFSConfig(grid=(2, 2), edge_chunk=512,
                                     fold_codec=ListFold()))
    assert by_obj.config.codec_name == "list" == \
        JaxBFSConfig(fold_codec="list").codec_name
    assert by_obj.engine is by_name.engine and len(graph._engines) == 1
    a = by_name.bfs(int(roots[0]))
    b = by_obj.bfs(int(roots[0]))
    assert torch.equal(a.level, b.level)
    assert graph.cache_stats()["hits"] == 1
    bm = BFSConfig(grid=(2, 2), edge_chunk=512, fold_codec=BitmapFold())
    assert bm.engine_key == BFSConfig(grid=(2, 2), edge_chunk=512,
                                      fold_codec="bitmap").engine_key


def test_build_engine_bakes_in_the_config(gdata):
    edges, w, roots = gdata
    graph = _plan(edges, (2, 2))
    eng = build_engine(graph.topology, BFSConfig(
        grid=(2, 2), fold_codec="bitmap", direction=True, alpha=12,
        edge_chunk=64))
    assert eng.codec.name == "bitmap" and eng.edge_chunk == 64
    assert eng.program.mode == "adaptive" and eng.program.alpha == 12
    assert eng.trace_count == 0
    assert build_engine(graph.topology, BFSConfig()).program.name == "bfs"


@pytest.mark.parametrize("fold_codec,fold_bitmap", [
    (None, None), ("delta", None), (None, True), (None, False),
    ("list", True)])
def test_resolve_fold_codec_matches_jax(fold_codec, fold_bitmap):
    from repro.api import resolve_fold_codec as jax_resolve

    with warnings.catch_warnings(record=True) as ours:
        warnings.simplefilter("always")
        got = resolve_fold_codec(fold_codec, fold_bitmap)
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = jax_resolve(fold_codec, fold_bitmap)
    assert got == want
    assert [w.category for w in ours] == [w.category for w in theirs]


def test_wide_add_and_total_match_jax():
    from repro.algos import wide_add as jax_wide_add
    from repro.algos import wide_total as jax_wide_total
    from repro_torch.algos import wide_add, wide_total

    rng = np.random.default_rng(5)
    hi = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    lo[:8] = 2**32 - 1
    delta = rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    jh, jl = jax_wide_add(jnp.asarray(hi), jnp.asarray(lo),
                          jnp.asarray(delta))
    th, tl = wide_add(torch.from_numpy(hi), torch.from_numpy(lo),
                      torch.from_numpy(delta.astype(np.int64)))
    assert th.dtype == torch.uint32 and tl.dtype == torch.uint32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert wide_total(th, tl) == jax_wide_total(jh, jl)


def test_teps_matches_jax(gdata):
    from repro.core import teps as jax_teps
    from repro_torch.core import teps

    edges, w, roots = gdata
    level = _plan(edges, (1, 1)).session().bfs(int(roots[0])).level[:N]
    assert teps(torch.from_numpy(edges.copy()), level, 0.5) == \
        jax_teps(edges, level.numpy(), 0.5)


# ---------------------------------------------------------------------------
# Re-exports
# ---------------------------------------------------------------------------

def _public_names(mod) -> list:
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [k for k, v in vars(mod).items()
            if not k.startswith("_") and not isinstance(v, types.ModuleType)
            and k != "annotations"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_name_resolves_on_the_port(pkg):
    """Each name in the JAX package's `__all__` (or its import list) is an
    attribute of the port's package, except the names a later ROADMAP item
    brings and the JAX-only names; a waiting or JAX-only name must really
    be missing (so the lists shrink as the port grows)."""
    jax_mod = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    waiting = WAITING.get(f"repro.{pkg}", {})
    jax_only = JAX_ONLY.get(f"repro.{pkg}", {})
    missing = [name for name in _public_names(jax_mod)
               if name not in waiting and name not in jax_only
               and not hasattr(port, name)]
    assert missing == []
    for name in list(waiting) + list(jax_only):
        assert name in _public_names(jax_mod), name
        assert not hasattr(port, name), f"{name} arrived: drop it from the list"


def _defined_names(mod) -> list:
    """A module's own public functions, classes and UPPER_CASE constants
    (not what it imports)."""
    out = []
    for k, v in vars(mod).items():
        if k.startswith("_") or isinstance(v, types.ModuleType):
            continue
        if callable(v) and getattr(v, "__module__", None) == mod.__name__:
            out.append(k)
        elif not callable(v) and k.isupper():
            out.append(k)
    return out


def _jax_module(name):
    """repro.{name}, imported with the environment kept: the JAX dry run
    sets XLA_FLAGS (512 host devices) when imported, which this process's
    children must not inherit."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.{name}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@pytest.mark.parametrize("name", PORTED_MODULES)
def test_every_jax_module_name_has_a_counterpart(name):
    jax_mod = _jax_module(name)
    port = importlib.import_module(f"repro_torch.{name}")
    cls = getattr(port, MODULE_CLASSES[name]) if name in MODULE_CLASSES \
        else None
    waiting = MODULE_WAITING.get(name, {})
    jax_only = MODULE_JAX_ONLY.get(name, {})
    missing = [k for k in _defined_names(jax_mod)
               if k not in waiting and k not in jax_only
               and not hasattr(port, k)
               and not (cls and hasattr(cls, METHODS.get(k, k)))]
    assert missing == []
    for k in list(waiting) + list(jax_only):
        assert k in _defined_names(jax_mod), k
        assert not hasattr(port, k), f"{k} arrived: drop it from the list"


@pytest.mark.parametrize("name", sorted(PRIVATE_JAX_ONLY))
def test_private_jax_only_helpers_have_no_counterpart(name):
    jax_mod = _jax_module(name)
    port = importlib.import_module(f"repro_torch.{name}")
    for k in PRIVATE_JAX_ONLY[name]:
        assert callable(getattr(jax_mod, k)), k
        assert not hasattr(port, k), f"{k} arrived: drop it from the list"


def test_kernel_build_and_load_run_once_under_two_threads(tmp_path,
                                                         monkeypatch):
    """`kernels.build.library` under two threads making their first call
    together: the lock lets one build and load, the other waits and gets
    the same handle (the build and the loader are stand-ins here; the gpu
    test runs nvcc)."""
    import threading
    import time

    from repro_torch.kernels import build

    lib = tmp_path / "libbits.so"
    builds, loads = [], []

    def slow_build():
        time.sleep(0.2)                    # both threads are waiting now
        lib.write_bytes(b"")
        builds.append(1)
        return {}

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_lib_path", lambda name: lib)
    monkeypatch.setattr(build, "_build_missing", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    barrier = threading.Barrier(2)
    got = []

    def first():
        barrier.wait()
        got.append(build.library("bits"))

    threads = [threading.Thread(target=first) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(loads) == 1
    assert got[0] is got[1] is build._libs["bits"]
