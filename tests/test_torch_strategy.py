"""The port's exchange strategies (`repro_torch.dist.strategy`) held to the
JAX package's (`repro.dist.strategy`), mirroring
tests/test_exchange_strategy.py:

  * the stacked butterfly route equals JAX's `emulate_exchange(x,
    "butterfly")` byte for byte, grid row by grid row, for C in
    {1, 2, 4, 8} and every message dtype (int32 lists and bit words, int16
    delta bit patterns, bytes, unsigned and 64-bit views), and equals the
    flat route;
  * every codec's set and value folds give the same outputs through both
    routes, and each routed message equals JAX's emulation;
  * the "auto" rule, the validation errors (naming flat), `BFSConfig.
    resolve_exchange` at session construction and the engine keys;
  * the accounting (msgs_per_exchange, wire_bytes, value_extra_bytes)
    equal to JAX's numbers, value_extra_bytes on random counts and
    columns, wrapped to uint32 as JAX wraps;
  * whole searches under `exchange="butterfly"` at 1x4 equal the JAX
    package's butterfly: BFS top-down and direction-optimised, CC, SSSP,
    multi-BFS and delta BFS under every codec (the JAX side: one
    subprocess, tests/dist/torch_parity_ref.py --exchange butterfly).

Inputs: random numpy arrays from `np.random.default_rng`; the graph is
`repro.graphgen.rmat_edges(jax.random.key(42), 8, 16)` with uint8 weights
from `np.random.default_rng(1)` and roots from `np.random.default_rng(0)`,
as tests/test_torch_algos.py draws them.  Integer outputs: exact equality.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.types import Grid2D as JaxGrid2D
from repro.dist import strategy as JES
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.core.types import Grid2D
from repro_torch.dist import exchange as X
from repro_torch.dist import strategy as ES
from repro_torch.dist.topology import StackedTopology
from repro_torch.kernels import fold as KF

CPU = torch.device("cpu")
SCALE, EF = 8, 16
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
DTYPES = [np.int32, np.int16, np.uint8, np.uint16, np.uint32, np.int64]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny; a parallel test run keeps the intra-op
    pool waiting for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(R, C, S=8):
    return Grid2D(R, C, R * C * S)


def _jgrid(R, C, S=8):
    return JaxGrid2D(R, C, R * C * S)


def _topo(R, C, exchange=ES.FlatExchange(), S=8):
    return StackedTopology(_grid(R, C, S), CPU, exchange)


def _jax_route(x, name):
    """JAX's emulation of one exchange, grid row by grid row."""
    return np.stack([JES.emulate_exchange(row, name) for row in x])


# ----------------------------------------------------------------------------
# Routing equality
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_butterfly_route_equals_jax_emulation(C, dtype):
    info = np.iinfo(dtype)
    rng = np.random.default_rng(C * 100 + np.dtype(dtype).itemsize)
    x = rng.integers(info.min, info.max, (3, C, C, 5, 2), dtype=dtype,
                     endpoint=True)
    topo = _topo(3, C, ES.ButterflyExchange())
    got = topo.col_all_to_all(torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    want = _jax_route(x.reshape(3, C, C, -1), "butterfly").reshape(x.shape)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(x, 1, 2))
    np.testing.assert_array_equal(
        ES.flat_all_to_all(torch.from_numpy(x)).numpy(), want)


class Recording(ES.ButterflyExchange):
    """The butterfly, keeping every message it routes and its result."""

    def __init__(self):
        super().__init__()
        self.routed = []

    def all_to_all(self, x):
        out = super().all_to_all(x)
        self.routed.append((x.clone(), out))
        return out


def _buckets(rng, R, C, S):
    """Canonical (R, C, C, S) fold buckets: bucket m holds ascending local
    rows of block m, front-packed, padded -1."""
    dst = np.full((R, C, C, S), -1, np.int32)
    cnt = np.zeros((R, C, C), np.int32)
    for i in range(R):
        for j in range(C):
            for m in range(C):
                k = int(rng.integers(0, S + 1))
                dst[i, j, m, :k] = np.sort(rng.choice(S, k, replace=False)) \
                    + m * S
                cnt[i, j, m] = k
    return torch.from_numpy(dst), torch.from_numpy(cnt)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("codec", ["list", "bitmap", "delta"])
@pytest.mark.parametrize("ops", [None, KF], ids=["plain", "kernel-ops"])
def test_codec_folds_route_identically(C, codec, ops):
    """Set and value folds of every codec give the same outputs through
    the flat and the butterfly route; every message the butterfly routed
    (int32 ids or words, int16 delta bit patterns, value channels) equals
    JAX's emulation of it."""
    R, S = 2, 37
    rng = np.random.default_rng(C)
    dst, cnt = _buckets(rng, R, C, S)
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (R, C, C, S),
                                         dtype=np.int64).astype(np.int32))
    vals = torch.where(dst >= 0, vals, 2**31 - 1)
    grid = _grid(R, C, S)
    cdc = X.get_fold_codec(codec, grid, ops=ops)
    flat = StackedTopology(grid, CPU)
    rec = Recording()
    bfly = flat.with_exchange(rec)
    for a, b in ((cdc.fold(dst, cnt, topo=flat),
                  cdc.fold(dst, cnt, topo=bfly)),
                 (cdc.fold_values(dst, cnt, vals, topo=flat),
                  cdc.fold_values(dst, cnt, vals, topo=bfly))):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert len(rec.routed) == 2
    for x, out in rec.routed:
        xn = x.numpy()
        want = _jax_route(xn.reshape(R, C, C, -1), "butterfly")
        np.testing.assert_array_equal(out.numpy().reshape(want.shape), want)


def test_resolve_preds_routes_through_the_bound_strategy():
    """The final predecessor exchange picks the strategy up from the
    topology: deferred markers resolve the same on both routes."""
    R, C, S = 2, 4, 6
    rng = np.random.default_rng(3)
    pred = rng.integers(-(C + 1), 50, (R, C, C * S)).astype(np.int32)
    pred = torch.from_numpy(pred)
    flat = _topo(R, C, S=S)
    rec = Recording()
    a = X.resolve_preds(pred, topo=flat)
    b = X.resolve_preds(pred, topo=flat.with_exchange(rec))
    assert torch.equal(a, b) and len(rec.routed) == 1


# ----------------------------------------------------------------------------
# Resolution and validation rules
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 3, 4, 6, 8, 16])
def test_auto_resolution_rule(C):
    """auto = butterfly exactly when it strictly reduces message count:
    power-of-two C >= 4 over a single column axis; as in JAX."""
    for axes in (("c",), ("c1", "c2"), ()):
        want = JES.resolve_exchange_name("auto", _jgrid(1, C), axes)
        assert ES.resolve_exchange_name("auto", _grid(1, C), axes) == want
        assert ES.get_exchange("auto", _grid(1, C), axes).name == want
    assert ES.resolve_exchange_name("flat", _grid(1, C), ("c",)) == "flat"


def test_explicit_butterfly_validation_errors_name_flat():
    with pytest.raises(ValueError, match="power-of-two.*flat"):
        ES.get_exchange("butterfly", _grid(1, 3), ("c",))
    with pytest.raises(ValueError, match="ONE column.*flat"):
        ES.get_exchange("butterfly", _grid(1, 4), ("c1", "c2"))
    with pytest.raises(ValueError, match="unknown exchange"):
        ES.get_exchange("hypercube", _grid(1, 4), ("c",))
    with pytest.raises(ValueError, match="flat"):
        ES.get_exchange(ES.ButterflyExchange(), _grid(1, 6), ("c",))
    inst = ES.ButterflyExchange()
    assert ES.get_exchange(inst, _grid(1, 4)) is inst
    assert ES.get_exchange("butterfly", _grid(1, 4)).name == "butterfly"
    assert ES.get_exchange("flat", _grid(1, 3)).name == "flat"


def test_session_resolves_and_validates_exchange():
    """`GraphSession` resolves "auto" against the planned grid and refuses
    an impossible butterfly at construction, naming flat; an instance
    passes through to the engine, bound into its topology."""
    edges = np.array([[0, 1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 0]], np.int32)
    g3 = DistGraph.from_edges(edges, BFSConfig(grid=(1, 3)), device="cpu")
    assert g3.session(BFSConfig(grid=(1, 3), exchange="auto")) \
        .config.exchange == "flat"
    with pytest.raises(ValueError, match="power-of-two.*flat"):
        g3.session(BFSConfig(grid=(1, 3), exchange="butterfly"))
    g4 = DistGraph.from_edges(edges, BFSConfig(grid=(1, 4)), device="cpu",
                              n=8)
    with pytest.raises(ValueError, match="ONE column.*flat"):
        g4.session(BFSConfig(grid=(1, 4), exchange="butterfly",
                             col_axes=("c1", "c2")))
    sess = g4.session(BFSConfig(grid=(1, 4), exchange="auto"))
    assert sess.config.exchange == "butterfly"
    assert sess.engine.exchange.name == "butterfly"
    assert sess.engine.topo.exchange is sess.engine.exchange
    inst = ES.ButterflyExchange()
    sess = g4.session(BFSConfig(grid=(1, 4), exchange=inst,
                                fold_codec="bitmap"))
    assert sess.engine.exchange is inst
    out = sess.bfs(0)
    assert out.level.tolist() == [0, 1, 2, 3, 4, 5, -1, -1]


def test_config_resolves_auto_and_keys_on_exchange():
    cfg = BFSConfig(exchange="auto")
    assert cfg.exchange_name == "auto"
    assert cfg.resolve_exchange(_grid(1, 4)).exchange == "butterfly"
    assert cfg.resolve_exchange(_grid(1, 2)).exchange == "flat"
    pinned = BFSConfig(exchange="butterfly")
    assert pinned.resolve_exchange(_grid(1, 4)) is pinned
    with pytest.raises(ValueError, match="flat"):
        pinned.resolve_exchange(_grid(1, 3))
    flat, bfly = BFSConfig(exchange="flat"), BFSConfig(exchange="butterfly")
    assert flat.engine_key != bfly.engine_key
    assert flat.algo_engine_key(("cc",), "bitmap", 10) \
        != bfly.algo_engine_key(("cc",), "bitmap", 10)
    inst = BFSConfig(exchange=ES.ButterflyExchange())
    assert inst.exchange_name == "butterfly"
    assert inst.engine_key == bfly.engine_key


def test_sessions_differing_in_exchange_get_their_own_engines():
    edges = np.asarray(jax_rmat_edges(jax.random.key(2), 8, 8))
    g = DistGraph.from_edges(edges, BFSConfig(grid=(1, 4)), n=256,
                             device="cpu")
    s_flat = g.session(BFSConfig(grid=(1, 4), exchange="flat"))
    s_bfly = g.session(BFSConfig(grid=(1, 4), exchange="butterfly"))
    assert s_flat.engine is not s_bfly.engine
    assert s_flat.engine.exchange.name == "flat"
    assert s_bfly.engine.exchange.name == "butterfly"
    assert g.session(BFSConfig(grid=(1, 4), exchange="auto")).engine \
        is s_bfly.engine
    a, b = s_flat.bfs(3), s_bfly.bfs(3)
    assert torch.equal(a.level, b.level) and torch.equal(a.pred, b.pred)
    assert a.edges_scanned == b.edges_scanned


# ----------------------------------------------------------------------------
# Accounting
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_message_and_byte_accounting(C):
    for name in ("flat", "butterfly"):
        ours, theirs = ES.EXCHANGES[name](), JES.EXCHANGES[name]()
        assert ours.msgs_per_exchange(C) == theirs.msgs_per_exchange(C)
        for fb in (0, 8 * C, 800 * C, C * (4 * 65536 + 4), 12345):
            assert ours.wire_bytes(fb, C) == theirs.wire_bytes(fb, C)


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["flat", "butterfly"])
def test_value_extra_bytes_equal_jax(C, name):
    """Random counts, every column j, as the programs call it (a (R, C, C)
    count tensor, j broadcast over the grid) and one processor at a time;
    counts large enough that 4 bytes an entry wraps uint32."""
    ours, theirs = ES.EXCHANGES[name](), JES.EXCHANGES[name]()
    rng = np.random.default_rng(C)
    for hi in (50, 2**28):
        cnt = rng.integers(0, hi, (3, C, C), dtype=np.int64) \
            .astype(np.int32)
        cols = torch.arange(C).view(1, C)
        got = ours.value_extra_bytes(torch.from_numpy(cnt), cols, C)
        assert got.shape == (3, C) and got.dtype == torch.int64
        for i in range(3):
            for j in range(C):
                want = int(theirs.value_extra_bytes(
                    jnp.asarray(cnt[i, j]), jnp.int32(j), C))
                assert int(got[i, j]) == want
                assert int(ours.value_extra_bytes(
                    torch.from_numpy(cnt[i, j]), j, C)) == want


# ----------------------------------------------------------------------------
# Whole searches under the butterfly at 1x4
# ----------------------------------------------------------------------------

DIRECTION_CONFIGS = [(False, "bitmap"), (True, "list"), (True, "bitmap"),
                     ("bottomup", "list"), ("bottomup", "bitmap")]
ALGO_CONFIGS = [(d, c) for d in (False, True, "bottomup")
                for c in ("list", "bitmap", "delta")]
FIELDS = {"cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
          "mbfs": ("level", "src", "n_levels"),
          "khop": ("level", "src", "n_levels"),
          "bfs": ("level", "pred", "n_levels")}


def dtag(direction):
    return {False: "td", True: "adaptive"}.get(direction, direction)


@pytest.fixture(scope="module")
def graph_data():
    edges = np.asarray(jax_rmat_edges(jax.random.key(42), SCALE, EF))
    w = np.random.default_rng(1).integers(1, 256, size=edges.shape[1]) \
        .astype(np.uint8)
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 3,
                                            replace=False)
    return edges, w, roots


@pytest.fixture(scope="module")
def jax_bfly(graph_data, tmp_path_factory):
    """The JAX package's butterfly at 1x4 for every configuration, one
    subprocess."""
    edges, w, roots = graph_data
    d = tmp_path_factory.mktemp("jax_bfly_ref")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N, weights=w)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "1x4", "--direction", "--algos", "--exchange", "butterfly"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def graph14(graph_data):
    edges, w, _ = graph_data
    return DistGraph.from_edges(edges, BFSConfig(grid=(1, 4)), device="cpu",
                                n=N, weights=w)


def _session(graph14, **knobs):
    sess = graph14.session(BFSConfig(grid=(1, 4), exchange="butterfly",
                                     **knobs))
    assert sess.engine.exchange.name == "butterfly"
    return sess


def _assert_out(out, ref, prefix, fields, row=None):
    pick = (lambda a: a) if row is None else (lambda a: a[row])
    for f in fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      pick(ref[f"{prefix}_{f}"]))
    want = pick(ref[f"{prefix}_edges"])
    got = out.edges_scanned
    assert (list(got) if isinstance(got, tuple) else got) == want.tolist()
    want_dirs = ref.get(f"{prefix}_directions")
    if want_dirs is None:
        assert out.directions is None
    else:
        np.testing.assert_array_equal(out.directions.numpy(),
                                      pick(want_dirs))


def test_bfs_butterfly_equals_jax(graph_data, graph14, jax_bfly):
    _, _, roots = graph_data
    sess = _session(graph14)
    _assert_out(sess.bfs(int(roots[0])), jax_bfly, "1x4_scalar",
                FIELDS["bfs"])
    _assert_out(sess.bfs(roots), jax_bfly, "1x4_batch", FIELDS["bfs"])


@pytest.mark.parametrize("direction,codec", DIRECTION_CONFIGS)
def test_direction_bfs_butterfly_equals_jax(graph_data, graph14, jax_bfly,
                                            direction, codec):
    _, _, roots = graph_data
    sess = _session(graph14, direction=direction, fold_codec=codec)
    _assert_out(sess.bfs(roots), jax_bfly,
                f"1x4_{dtag(direction)}_{codec}_batch", FIELDS["bfs"])


@pytest.mark.parametrize("direction,codec", ALGO_CONFIGS)
def test_value_programs_butterfly_equal_jax(graph_data, graph14, jax_bfly,
                                            direction, codec):
    """CC, SSSP (a scalar root against its batch row, then the batch),
    multi-BFS (and k = 2 under list), and BFS under delta."""
    _, _, roots = graph_data
    sess = _session(graph14, direction=direction, fold_codec=codec)
    tag = f"1x4_{dtag(direction)}_{codec}"
    _assert_out(sess.connected_components(), jax_bfly, f"{tag}_cc",
                FIELDS["cc"])
    _assert_out(sess.sssp(int(roots[1])), jax_bfly, f"{tag}_sssp",
                FIELDS["sssp"], row=1)
    _assert_out(sess.sssp(roots), jax_bfly, f"{tag}_sssp", FIELDS["sssp"])
    _assert_out(sess.multi_bfs(roots), jax_bfly, f"{tag}_mbfs",
                FIELDS["mbfs"])
    if codec == "list":
        _assert_out(sess.multi_bfs(roots, k=2), jax_bfly, f"{tag}_khop",
                    FIELDS["khop"])
    if codec == "delta":
        _assert_out(sess.bfs(roots), jax_bfly, f"{tag}_bfs", FIELDS["bfs"])
