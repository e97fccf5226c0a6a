"""The port's kernel-stage surface against the JAX package's.

  * B10: the plain `binsearch_map` equals `repro.kernels.binsearch_map(...,
    interpret=True)` on every lane of `tests/test_kernels.py`'s sweep and of
    the BINSEARCH_CASES of `scripts/torch_stage_cases.py`, and the oracle
    on valid lanes; `clip_cumul` equals JAX's;
  * B11: the plain `visited_filter` equals `repro.kernels.visited_filter`
    (interpret mode) on every lane, also on the hash-claim stress cases of
    `scripts/torch_stage_cases.py` at tiles 64 to 1024 (the kernel is held
    to it on the card); the torch oracles of `kernels/ref.py` equal JAX's;
  * `local_expand(path="reference")` equals JAX `local_expand` under
    "reference" and "pallas-interpret" on all five fields, and its chunk-
    hook branch (the kernel path's code, with the hook on CPU tensors)
    equals it too;
  * the chunk-hook factories and `BFSConfig(expand_fn=...)` (ROADMAP A17):
    a custom hook gives the default BFS and CC, keys its own engine, and
    leaves the value programs on the plain value scan;
  * CPU tensors take the plain versions and launch nothing; `E % tile != 0`
    raises; `scripts/torch_kernel_bench.py` holds its cases to the oracles.

The kernels themselves run only on a card: tests/test_torch_gpu.py.
Everything is integer or bool, so every comparison is exact equality.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.kernels import binsearch_map as jax_binsearch_map
from repro.kernels import clip_cumul as jax_clip_cumul
from repro.kernels import local_expand as jax_local_expand
from repro.kernels import ref as JR
from repro.kernels import visited_filter as jax_visited_filter
from repro_torch.algos.cc import ConnectedComponentsProgram
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.kernels import bottomup as KB
from repro_torch.kernels import expand as K
from repro_torch.kernels import ref as R
from repro_torch.kernels import stages as S

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SC = _load_script("torch_stage_cases")
OUT_FIELDS = ("verts", "parents", "count", "visited", "edges_scanned")


def _cumul(rng, n_seg, max_deg):
    deg = rng.integers(0, max_deg, size=n_seg).astype(np.int32)
    return np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)


# ----------------------------------------------------------------------------
# B10 binsearch_map
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("tile,window", [(128, 32), (256, 128), (512, 256),
                                         (128, 512)])
@pytest.mark.parametrize("n_seg", [1, 7, 100, 1000])
def test_plain_binsearch_map_equals_pallas(tile, window, n_seg, rng):
    """Every lane, masked lanes (k = front_total) included, against the
    Pallas kernel; valid lanes against the oracle."""
    cumul = _cumul(rng, n_seg, 17)
    total = int(cumul[-1])
    e = max(tile, ((total + tile - 1) // tile) * tile)
    gids = np.arange(e, dtype=np.int32)
    jcc = jax_clip_cumul(jnp.asarray(cumul), jnp.int32(n_seg))
    tcc = S.clip_cumul(torch.from_numpy(cumul),
                       torch.tensor(n_seg, dtype=torch.int32))
    np.testing.assert_array_equal(tcc.numpy(), np.asarray(jcc))
    jk = np.asarray(jax_binsearch_map(jcc, jnp.asarray(gids), tile=tile,
                                      window=window, interpret=True))
    tk = S.binsearch_map(tcc, torch.from_numpy(gids), tile=tile).numpy()
    np.testing.assert_array_equal(tk, jk)
    ok = gids < total
    k_ref = np.asarray(JR.binsearch_map_ref(jnp.asarray(cumul),
                                            jnp.asarray(gids)))
    np.testing.assert_array_equal(tk[ok], k_ref[ok])
    assert (tk[~ok] == n_seg).all()


@pytest.mark.parametrize("case", ["zero_runs", "below_first", "front_prefix",
                                  "straddle"])
def test_plain_binsearch_map_edge_cases(case, rng):
    """Runs of zero-degree frontier vertices, lanes below cumul[0] (0 here
    and in the Pallas kernel, -1 in the oracle), a clip inside the array,
    and a chunk straddling the live total."""
    deg = rng.integers(0, 9, size=300).astype(np.int32)
    deg[40:90] = 0
    deg[200:260] = 0
    cumul = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ft, start = 300, 0
    if case == "below_first":
        cumul = cumul + 37
    elif case == "front_prefix":
        ft = 120
    elif case == "straddle":
        start = int(cumul[-1]) - 100
    gids = start + np.arange(512, dtype=np.int32)
    jcc = jax_clip_cumul(jnp.asarray(cumul), jnp.int32(ft))
    jk = np.asarray(jax_binsearch_map(jcc, jnp.asarray(gids), tile=256,
                                      window=64, interpret=True))
    tk = S.binsearch_map(torch.from_numpy(np.array(jcc)),
                         torch.from_numpy(gids), tile=256).numpy()
    np.testing.assert_array_equal(tk, jk)
    k_ref = R.binsearch_map_ref(torch.from_numpy(np.array(jcc)),
                                torch.from_numpy(gids)).numpy()
    ok = (gids >= cumul[0]) & (gids < cumul[ft])
    np.testing.assert_array_equal(tk[ok], k_ref[ok])
    if case == "below_first":
        assert (tk[gids < cumul[0]] == 0).all()
        assert (k_ref[gids < cumul[0]] == -1).all()


@pytest.mark.parametrize("name", SC.BINSEARCH_CASES)
def test_plain_binsearch_map_stage_cases_equal_pallas(name):
    """The block-search stress cases (consecutive gids, random gaps wide
    and narrow, repeated gids, tiles sorted but descending across tiles,
    one tile spanning the whole cumul, lanes below cumul[0], lanes past the
    live total, zero-degree runs): every lane against the Pallas kernel."""
    c = SC.binsearch_case(name)
    gids, tile, ft = c["gids"], c["tile"], c["front_total"]
    jcc = jax_clip_cumul(jnp.asarray(c["cumul"]), jnp.int32(ft))
    jk = np.asarray(jax_binsearch_map(jcc, jnp.asarray(gids), tile=tile,
                                      interpret=True))
    tcc = S.clip_cumul(torch.from_numpy(c["cumul"]),
                       torch.tensor(ft, dtype=torch.int32))
    tk = S.binsearch_map(tcc, torch.from_numpy(gids), tile=tile).numpy()
    np.testing.assert_array_equal(tk, jk)
    live = (gids >= c["cumul"][0]) & (gids < c["cumul"][ft])
    k_ref = R.binsearch_map_ref(torch.from_numpy(c["cumul"]),
                                torch.from_numpy(gids)).numpy()
    np.testing.assert_array_equal(tk[live], k_ref[live])
    assert (tk[gids >= c["cumul"][ft]] == ft).all()
    assert (tk[gids < c["cumul"][0]] == 0).all()
    if name == "descending_tiles":
        assert (np.diff(gids.reshape(-1, tile)[:, 0]) < 0).any()


# ----------------------------------------------------------------------------
# B11 visited_filter
# ----------------------------------------------------------------------------

def _filter_inputs(rng, tile, n_rows, e=None):
    e = 4 * tile if e is None else e
    v = rng.integers(0, n_rows, size=e).astype(np.int32)
    valid = rng.random(e) < 0.7
    words = rng.integers(0, 2**32, size=(n_rows + 31) // 32,
                         dtype=np.uint64).astype(np.uint32)
    return v, valid, words


@pytest.mark.parametrize("tile", [64, 128, 512])
@pytest.mark.parametrize("n_rows", [33, 256, 4096])
def test_plain_visited_filter_equals_pallas(tile, n_rows, rng):
    v, valid, words = _filter_inputs(rng, tile, n_rows)
    jwon = np.asarray(jax_visited_filter(jnp.asarray(v), jnp.asarray(valid),
                                         jnp.asarray(words), tile=tile,
                                         interpret=True))
    twon = S.visited_filter(torch.from_numpy(v), torch.from_numpy(valid),
                            torch.from_numpy(words.view(np.int32)),
                            tile=tile).numpy()
    np.testing.assert_array_equal(twon, jwon)
    for t in range(4):                       # the oracles, tile by tile
        s = slice(t * tile, (t + 1) * tile)
        jref = np.asarray(JR.visited_filter_ref(
            jnp.asarray(v[s]), jnp.asarray(valid[s]), jnp.asarray(words)))
        tref = R.visited_filter_ref(
            torch.from_numpy(v[s]), torch.from_numpy(valid[s]),
            torch.from_numpy(words.view(np.int32))).numpy()
        np.testing.assert_array_equal(tref, jref)
        np.testing.assert_array_equal(twon[s], tref)


@pytest.mark.parametrize("words_kind", ["all_visited", "all_clear"])
@pytest.mark.parametrize("valid_kind", ["all_invalid", "mixed"])
def test_plain_visited_filter_extremes(words_kind, valid_kind, rng):
    tile, n_rows = 64, 100                   # n_rows % 32 != 0
    v, valid, words = _filter_inputs(rng, tile, n_rows)
    v[:tile] = rng.integers(0, 8, size=tile)          # many duplicates
    words[:] = 0xFFFFFFFF if words_kind == "all_visited" else 0
    if valid_kind == "all_invalid":
        valid[:] = False
    jwon = np.asarray(jax_visited_filter(jnp.asarray(v), jnp.asarray(valid),
                                         jnp.asarray(words), tile=tile,
                                         interpret=True))
    twon = S.visited_filter(torch.from_numpy(v), torch.from_numpy(valid),
                            torch.from_numpy(words.view(np.int32)),
                            tile=tile).numpy()
    np.testing.assert_array_equal(twon, jwon)
    if words_kind == "all_visited" or valid_kind == "all_invalid":
        assert not twon.any()


@pytest.mark.parametrize("tile", SC.FILTER_TILES)
@pytest.mark.parametrize("name", SC.FILTER_CASES)
def test_plain_visited_filter_hash_cases_equal_pallas(name, tile):
    """The hash-claim stress cases: one vertex on every valid lane,
    vertices congruent modulo the tile's table size, v = -1 / INT32_MIN /
    INT32_MAX, all-visited and all-clear words; every lane against the
    Pallas kernel."""
    c = SC.filter_case(name, tile)
    jwon = np.asarray(jax_visited_filter(
        jnp.asarray(c["v"]), jnp.asarray(c["valid"]),
        jnp.asarray(c["words"].view(np.uint32)), tile=tile, interpret=True))
    twon = S.visited_filter(*SC.filter_args(c, "cpu"), tile=tile).numpy()
    np.testing.assert_array_equal(twon, jwon)
    if name == "one_vertex":
        assert twon.sum() == 4
    elif name == "extremes":
        assert twon.sum() == 4 * 6
    elif name == "all_visited":
        assert not twon.any()


def test_visited_filter_semantics():
    """Paper Alg. 3: only the first slot of a duplicate vertex wins, and
    already-visited vertices never win."""
    words = torch.tensor([0b100], dtype=torch.int32)   # vertex 2 visited
    v = torch.tensor([2, 5, 5, 7], dtype=torch.int32)
    won = S.visited_filter(v, torch.ones(4, dtype=torch.bool), words, tile=4)
    assert won.tolist() == [False, True, False, True]
    assert R.visited_filter_ref(v, torch.ones(4, dtype=torch.bool),
                                words).tolist() == won.tolist()


# ----------------------------------------------------------------------------
# the CPU path of the stage ops
# ----------------------------------------------------------------------------

def test_stage_ops_on_cpu_launch_nothing(rng):
    before = (S.binsearch_map.launches, S.visited_filter.launches)
    cumul = torch.from_numpy(_cumul(rng, 50, 9))
    S.binsearch_map(cumul, torch.arange(256, dtype=torch.int32), tile=128)
    v, valid, words = _filter_inputs(rng, 64, 300)
    S.visited_filter(torch.from_numpy(v), torch.from_numpy(valid),
                     torch.from_numpy(words.view(np.int32)), tile=64)
    assert (S.binsearch_map.launches, S.visited_filter.launches) == before


@pytest.mark.parametrize("op", ["binsearch_map", "visited_filter"])
def test_stage_ops_check_their_inputs(op, rng):
    """A lane count that is not a multiple of the tile raises, as JAX's
    assert does; so do wrong dtypes."""
    if op == "binsearch_map":
        cumul = torch.from_numpy(_cumul(rng, 10, 9))
        gids = torch.arange(300, dtype=torch.int32)
        with pytest.raises(ValueError, match="multiple of tile"):
            S.binsearch_map(cumul, gids, tile=128)
        with pytest.raises(ValueError, match="int32"):
            S.binsearch_map(cumul.long(), gids[:256], tile=128)
    else:
        v, valid, words = _filter_inputs(rng, 64, 300, e=200)
        args = (torch.from_numpy(v), torch.from_numpy(valid),
                torch.from_numpy(words.view(np.int32)))
        with pytest.raises(ValueError, match="multiple of tile"):
            S.visited_filter(*args, tile=64)
        with pytest.raises(ValueError, match="bool"):
            S.visited_filter(args[0], args[0], args[2], tile=100)


# ----------------------------------------------------------------------------
# local_expand
# ----------------------------------------------------------------------------

def _random_csc(rng, n, max_deg):
    deg = rng.integers(0, max_deg + 1, size=n)
    col_off = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    row_idx = rng.integers(0, n, size=max(int(col_off[-1]), 1)) \
        .astype(np.int32)
    return col_off, row_idx


def _assert_local_expand_equal(frontier, csc, visited, *, edge_chunk, tile,
                               window):
    """The port's reference path and its hook branch against JAX's two
    paths, on all five fields."""
    jax_out = [jax_local_expand(frontier, csc, visited, path=p,
                                edge_chunk=edge_chunk, tile=tile,
                                window=window)
               for p in ("reference", "pallas-interpret")]
    ours = K.local_expand(frontier, csc, visited, path="reference",
                          edge_chunk=edge_chunk, tile=tile, device="cpu")
    if isinstance(frontier, tuple):
        front, count = frontier
    else:
        front, count = frontier, int((np.asarray(frontier) >= 0).sum())
    ncl = csc[0].shape[0] - 1
    front = np.concatenate([front, np.full(ncl - len(front), -1, np.int32)])
    hooked = K._local_expand(
        torch.from_numpy(front), torch.tensor(count, dtype=torch.int32),
        torch.from_numpy(csc[0]), torch.from_numpy(csc[1]),
        torch.from_numpy(visited), expand_fn=K.make_expand_fn(tile=tile),
        edge_chunk=edge_chunk, dedup="scatter")
    for out in (ours, hooked):
        for j in jax_out:
            for f in OUT_FIELDS[:4]:
                np.testing.assert_array_equal(getattr(out, f).numpy(),
                                              np.asarray(getattr(j, f)),
                                              err_msg=f)
            # JAX's count wraps as uint32, the port's is exact
            assert int(out.edges_scanned) == int(j.edges_scanned)
    return ours


@pytest.mark.parametrize("kind", ["empty", "isolated", "full"])
def test_local_expand_equals_jax_edges(kind, rng):
    """An empty frontier, a frontier of only isolated vertices, and a
    full-frontier level."""
    n = 64
    col_off, row_idx = _random_csc(rng, n, 4)
    if kind == "isolated":
        col_off = np.zeros(n + 1, np.int32)
        row_idx = np.zeros(1, np.int32)
    cnt = 0 if kind == "empty" else n
    front = np.full(n, -1, np.int32)
    front[:cnt] = np.arange(cnt, dtype=np.int32)
    out = _assert_local_expand_equal((front, cnt), (col_off, row_idx),
                                     np.zeros(n, bool), edge_chunk=64,
                                     tile=32, window=16)
    if kind in ("empty", "isolated"):
        assert int(out.count) == 0 and int(out.edges_scanned) == 0


@pytest.mark.parametrize("seed", range(6))
def test_local_expand_equals_jax_random(seed):
    """Random CSC graphs, visited sets and frontier sizes from empty to
    full, as (front, count) pairs and as padded frontiers (the
    deterministic form of `tests/test_expand.py`'s property)."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(8, 48))
    col_off, row_idx = _random_csc(rng, n, 7)
    cnt = int(rng.integers(0, n + 1))
    front = np.full(n, -1, np.int32)
    front[:cnt] = np.sort(rng.permutation(n)[:cnt])
    visited = rng.random(n) < 0.3
    frontier = (front, cnt) if seed % 2 else front[:max(cnt, 1)]
    _assert_local_expand_equal(frontier, (col_off, row_idx), visited,
                               edge_chunk=32, tile=16, window=8)


def test_local_expand_against_host_reference(rng):
    """Winners = first unvisited occurrence in CSC scan order, compacted
    ascending; the csc given as an object with col_off / row_idx."""
    n = 96
    col_off, row_idx = _random_csc(rng, n, 5)
    cnt = 17
    ids = np.sort(rng.choice(n, cnt, replace=False)).astype(np.int32)
    front = np.full(n, -1, np.int32)
    front[:cnt] = ids
    visited = np.zeros(n, bool)
    visited[rng.choice(n, 10, replace=False)] = True
    _assert_local_expand_equal((front, cnt), (col_off, row_idx), visited,
                               edge_chunk=32, tile=16, window=8)

    class CSC:
        pass
    csc = CSC()
    csc.col_off, csc.row_idx = torch.from_numpy(col_off), \
        torch.from_numpy(row_idx)
    out = K.local_expand(torch.from_numpy(front), csc,
                         torch.from_numpy(visited), edge_chunk=32, tile=16)
    seen, host = set(), {}
    for u in ids:
        for e in range(col_off[u], col_off[u + 1]):
            v = int(row_idx[e])
            if not visited[v] and v not in seen:
                seen.add(v)
                host[v] = int(u)
    verts = sorted(host)
    assert out.verts[:len(verts)].tolist() == verts
    assert out.parents[:len(verts)].tolist() == [host[v] for v in verts]
    assert int(out.count) == len(verts)
    assert int(out.edges_scanned) == sum(
        int(col_off[u + 1] - col_off[u]) for u in ids)
    visited[verts] = True
    assert out.visited.tolist() == visited.tolist()


def test_local_expand_paths_on_cpu(rng):
    col_off, row_idx = _random_csc(rng, 16, 3)
    args = (np.arange(16, dtype=np.int32), (col_off, row_idx),
            np.zeros(16, bool))
    with pytest.raises(ValueError, match="path='kernel' needs a CUDA"):
        K.local_expand(*args, path="kernel", device="cpu")
    a = K.local_expand(*args, path="auto", edge_chunk=8, tile=4,
                       device="cpu")
    b = K.local_expand(*args, path="reference", edge_chunk=8, tile=4,
                       device="cpu")
    for f in OUT_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="exceeds"):
        K.local_expand(np.arange(17, dtype=np.int32), (col_off, row_idx),
                       np.zeros(16, bool), device="cpu")


def test_local_expand_places_inputs_like_the_entry_points(rng, monkeypatch):
    """Numpy inputs go to `device`: CUDA unless named, so without a card
    and without `device` the op raises instead of running on the CPU.
    Tensors keep their device; a `device` that contradicts them, or
    tensors on two devices, raise."""
    col_off, row_idx = _random_csc(rng, 16, 3)
    args = (np.arange(16, dtype=np.int32), (col_off, row_idx),
            np.zeros(16, bool))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        K.local_expand(*args)
    assert K.local_expand(*args, device="cpu").verts.device.type == "cpu"
    tensors = (torch.from_numpy(args[0]),
               tuple(map(torch.from_numpy, args[1])),
               torch.from_numpy(args[2]))
    a = K.local_expand(*tensors)             # tensors: no device needed
    b = K.local_expand(tensors[0], args[1], args[2])   # mixed: numpy joins
    for f in OUT_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="device=cuda"):
        K.local_expand(*tensors, device="cuda")
    with pytest.raises(ValueError, match="several devices"):
        K.local_expand(tensors[0].to("meta"), *tensors[1:])


# ----------------------------------------------------------------------------
# the chunk-hook factories and BFSConfig(expand_fn=...) (ROADMAP A17)
# ----------------------------------------------------------------------------

SCALE = 8
N = 1 << SCALE


@pytest.fixture(scope="module")
def graph_data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, 8))
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, [int(r) for r in roots]


def _counting(fn):
    def hook(*args, **kw):
        hook.calls += 1
        return fn(*args, **kw)
    hook.calls = 0
    return hook


def _bfs_fields(out):
    return (out.level, out.pred, out.n_levels, out.edges_scanned)


def _equal(a, b):
    for x, y in zip(a, b):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("hook_kind", ["factory", "wrapper"])
def test_custom_expand_fn_equals_default_bfs(graph_data, grid, hook_kind):
    """A counting hook -- from `make_expand_fn(path="reference")`, or a
    plain wrapper over `plain_expand_chunk` -- gives the default BFS."""
    edges, roots = graph_data
    base = K.make_expand_fn(path="reference") if hook_kind == "factory" \
        else (lambda *a: K.plain_expand_chunk(*a, tile=64))
    hook = _counting(base)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=grid), device="cpu",
                                 n=N)
    want = graph.session().bfs(roots)
    sess = graph.session(BFSConfig(grid=grid, expand_fn=hook))
    assert sess.engine.expand_path == "custom"
    assert sess.engine.expand_fn is hook
    assert sess.engine.value_expand_fn is None
    _equal(_bfs_fields(sess.bfs(roots)), _bfs_fields(want))
    assert hook.calls > 0
    for r in roots:
        _equal(_bfs_fields(sess.bfs(r)), _bfs_fields(graph.session().bfs(r)))


@pytest.mark.parametrize("direction", [False, True])
def test_custom_expand_fn_cc_uses_plain_value_scan(graph_data, direction):
    """CC under the hook equals CC without it; its engine takes the hook,
    with no value hook; BFS and CC engines are keyed apart from the
    default's."""
    edges, _ = graph_data
    knobs = dict(grid=(2, 2), direction=direction, fold_codec="bitmap")
    hook = _counting(K.make_expand_fn(path="reference"))
    graph = DistGraph.from_edges(edges, BFSConfig(**knobs), device="cpu",
                                 n=N)
    plain_cfg, hook_cfg = BFSConfig(**knobs), BFSConfig(**knobs,
                                                        expand_fn=hook)
    assert plain_cfg.engine_key != hook_cfg.engine_key
    key = ConnectedComponentsProgram().key
    assert plain_cfg.algo_engine_key(key, "bitmap", 64) != \
        hook_cfg.algo_engine_key(key, "bitmap", 64)
    want = graph.session(plain_cfg).connected_components()
    sess = graph.session(hook_cfg)
    got = sess.connected_components()
    assert torch.equal(got.labels, want.labels)
    assert int(got.n_iters) == int(want.n_iters)
    assert got.edges_scanned == want.edges_scanned
    engines = [e for e in graph._engines.values() if e.expand_fn is hook]
    assert engines and all(e.expand_path == "custom"
                           and e.value_expand_fn is None for e in engines)
    assert hook.calls == 0        # CC runs the plain value scan


@pytest.mark.parametrize("direction", [False, True, "bottomup"])
def test_bottomup_factories_equal_defaults(graph_data, direction):
    """`make_bottomup_fn` / `make_value_bottomup_fn` and
    `make_value_expand_fn` in the engines give the engines' default
    results."""
    edges, roots = graph_data
    knobs = dict(grid=(2, 2), direction=direction, fold_codec="bitmap")
    graph = DistGraph.from_edges(edges, BFSConfig(**knobs), device="cpu",
                                 n=N)
    want_bfs = graph.session().bfs(roots)
    want_cc = graph.session().connected_components()
    # fresh engines, and no cache entry bound to the old ones
    graph._engines.clear()
    graph._compiled._entries.clear()
    sess = graph.session()
    sess.bfs(roots[0])
    sess.connected_components()
    bu = _counting(KB.make_bottomup_fn(path="reference"))
    vbu = _counting(KB.make_value_bottomup_fn(path="reference"))
    vex = _counting(K.make_value_expand_fn(path="reference"))
    for eng in graph._engines.values():
        eng.bottomup_fn, eng.value_bottomup_fn = bu, vbu
        eng.value_expand_fn = vex
    _equal(_bfs_fields(sess.bfs(roots)), _bfs_fields(want_bfs))
    cc = sess.connected_components()
    assert torch.equal(cc.labels, want_cc.labels)
    assert cc.edges_scanned == want_cc.edges_scanned
    if direction:
        assert bu.calls > 0 and vbu.calls > 0
    else:
        assert vex.calls > 0


def test_hook_factories_check_their_path():
    for make in (K.make_expand_fn, K.make_value_expand_fn,
                 KB.make_bottomup_fn, KB.make_value_bottomup_fn):
        with pytest.raises(ValueError, match="path='pallas'"):
            make(path="pallas")
        with pytest.raises(TypeError):      # no tile stage, no tile knob
            make(path="auto", tile=64) if make is not K.make_expand_fn \
                else make(path="auto", window=64)
    # a concrete path is fixed when the hook is made: "reference" is the
    # plain function, "auto" the kernel wrapper (it picks by device itself)
    pairs = [(K.make_expand_fn, K.expand_chunk, K.plain_expand_chunk),
             (K.make_value_expand_fn, K.expand_chunk_values,
              K.plain_expand_chunk_values),
             (KB.make_bottomup_fn, KB.bottomup_chunk,
              KB.plain_bottomup_chunk),
             (KB.make_value_bottomup_fn, KB.bottomup_chunk_values,
              KB.plain_bottomup_chunk_values)]
    for make, kernel, plain in pairs:
        assert make(path="reference").func is plain
        assert make(path="auto").func is kernel
    assert K.make_expand_fn(path="reference", tile=64).keywords == \
        {"tile": 64}
    hook = K.make_expand_fn(path="kernel")
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        hook(0, 4, z, z[:1], z[0], z, z, z)


# ----------------------------------------------------------------------------
# the kernel bench's cases on the CPU
# ----------------------------------------------------------------------------

def test_kernel_bench_cases_match_oracles():
    """The bench's inputs at its shapes: the stage ops (their plain
    versions here) against the oracles, and local_expand's two paths
    against each other; timing them needs a card."""
    bench = _load_script("torch_kernel_bench")
    bench.check(torch.device("cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(torch.device("cpu"))
