"""The port's telemetry (`repro_torch.obs`) held to the JAX package's
(`repro.obs`), mirroring tests/test_obs.py:

  * the metrics registry, the Prometheus exposition pinned golden, the
    JSONL `EventLog` and `request_trace` on the port's copies, whose
    `__all__` is `repro.obs`'s;
  * outputs identical with telemetry on and off, for every codec and
    direction mode, and no trace when it is off;
  * `LevelTrace` equal to JAX's field for field (program, codec, grid,
    n_levels, every channel and every `*_dev` array): at 1x1 against the
    JAX session in this process, and at 2x2 (auto -> flat) and 1x4
    (auto -> butterfly) against one JAX run in a subprocess
    (tests/dist/torch_parity_ref.py --exchange auto --telemetry), for BFS
    top-down / adaptive / bottom-up, CC, SSSP and multi-BFS; 2x2 pins the
    processor order of the `*_dev` arrays (row-major, p = i*C + j);
  * the channels against an independent recomputation (the frontier from
    the output levels, the scanned total, the static wire formula, the
    `directions` output), one trace per root of a batch, and the
    `max_levels` clamp.

Inputs: `repro.graphgen.rmat_edges(jax.random.key(42), 8, 16)` as numpy,
uint8 weights from `np.random.default_rng(1)`, roots from
`np.random.default_rng(0)` among degree > 0 vertices (the graph of
tests/test_torch_algos.py).  Integer outputs: exact equality.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.obs
from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch import obs
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.obs import (PHASES, EventLog, LevelTrace, MetricsRegistry,
                             request_trace, to_prometheus)

SCALE, EF = 8, 16
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
CODECS = ("list", "bitmap", "delta")
DIRECTIONS = (False, True, "bottomup")
DIRECTION_CONFIGS = [(False, "bitmap"), (True, "list"), (True, "bitmap"),
                     ("bottomup", "list"), ("bottomup", "bitmap")]
ALGO_CONFIGS = [(d, c) for d in DIRECTIONS for c in CODECS]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny; a parallel test run keeps the intra-op
    pool waiting for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def graph11(graph_data):
    edges, w, _ = graph_data
    return DistGraph.from_edges(edges, BFSConfig(grid=(1, 1)), device="cpu",
                                n=N, weights=w)


@pytest.fixture(scope="module")
def jax11(graph_data):
    edges, w, _ = graph_data
    return JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=N,
                                   weights=w)


def _traces(out):
    return out.trace if isinstance(out.trace, tuple) else (out.trace,)


def assert_trace_equal(got: LevelTrace, want):
    """Port trace against a JAX `LevelTrace`, field for field, dtypes too."""
    for f in dataclasses.fields(LevelTrace):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray) or hasattr(b, "dtype"):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


def assert_trace_ref(got: LevelTrace, ref, prefix, b):
    """Port trace against the subprocess's arrays of trace `b`."""
    for f in dataclasses.fields(LevelTrace):
        want = ref[f"{prefix}_trace{b}_{f.name}"]
        a = getattr(got, f.name)
        if f.name in ("program", "codec"):
            assert a == str(want), (f.name, a, want)
        elif f.name == "grid":
            assert a == tuple(want.tolist())
        elif f.name == "n_levels":
            assert a == int(want)
        else:
            assert a.dtype == want.dtype and a.shape == want.shape, f.name
            np.testing.assert_array_equal(a, want, err_msg=f"{prefix} "
                                          f"trace {b} {f.name}")


# ---------------------------------------------------------------------------
# Registry, exposition, event log, request traces (the port's copies)
# ---------------------------------------------------------------------------

def test_obs_surface_matches_jax():
    assert sorted(obs.__all__) == sorted(repro.obs.__all__)
    assert obs.TRACE_CHANNELS == repro.obs.TRACE_CHANNELS
    assert obs.N_TRACE_OUTS == repro.obs.N_TRACE_OUTS
    assert obs.PHASES == repro.obs.PHASES
    assert obs.DEFAULT_BUCKETS == repro.obs.DEFAULT_BUCKETS


def test_registry_get_or_create_and_mismatches():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", "help", labelnames=("tenant",))
    assert reg.counter("x_total", labelnames=("tenant",)) is c1
    with pytest.raises(ValueError):        # kind changed
        reg.gauge("x_total", labelnames=("tenant",))
    with pytest.raises(ValueError):        # label set changed
        reg.counter("x_total", labelnames=("graph",))
    with pytest.raises(ValueError):        # wrong labels at bind time
        c1.labels(graph="g").inc()


def test_counter_monotone_gauge_histogram():
    reg = MetricsRegistry()
    c = reg.counter("c_total")
    c.inc()
    c.inc(2)
    assert c.value == 3 and isinstance(c.value, int)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(5)
    g.dec()
    assert g.value == 4
    h = reg.histogram("h_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    plain = h.series()[()]
    assert plain["count"] == 3 and plain["sum"] == pytest.approx(5.55)
    assert list(plain["buckets"].values()) == [1, 2, 3]  # cumulative


def test_prometheus_golden():
    reg = MetricsRegistry()
    c = reg.counter("requests_total", "Total requests",
                    labelnames=("tenant",))
    c.labels(tenant="alice").inc()
    c.labels(tenant="bob").inc(2)
    reg.gauge("pending", "Pending").set(3)
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    assert to_prometheus(reg) == """\
# HELP lat_seconds Latency
# TYPE lat_seconds histogram
lat_seconds_bucket{le="0.1"} 1
lat_seconds_bucket{le="1.0"} 2
lat_seconds_bucket{le="+Inf"} 3
lat_seconds_sum 5.55
lat_seconds_count 3
# HELP pending Pending
# TYPE pending gauge
pending 3
# HELP requests_total Total requests
# TYPE requests_total counter
requests_total{tenant="alice"} 1
requests_total{tenant="bob"} 2
"""


def test_collector_samples_in_exposition_and_snapshot():
    reg = MetricsRegistry()
    reg.register_collector(
        lambda: [("cache_size", "gauge", "AOT cache", {"graph": "g"}, 7)])
    assert 'cache_size{graph="g"} 7' in to_prometheus(reg)
    assert reg.snapshot()["cache_size"]["series"] == {"graph=g": 7}


def test_event_log_jsonl(tmp_path):
    path = tmp_path / "events.jsonl"
    log = EventLog(path)
    log.emit("batch", live=3)
    log.emit("retry", tenants=["a"])
    assert len(log) == 2
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["batch", "retry"]
    assert [r["seq"] for r in rows] == [0, 1] and rows[0]["live"] == 3
    log.close()


def test_request_trace_builder_tiles():
    tr = request_trace(3, "g", "bfs", t_admit=1.0, t_dispatch=1.5,
                       t_exec_start=1.6, t_exec_end=2.0, t_done=2.1, live=4)
    assert [s.name for s in tr.spans] == list(PHASES)
    for a, b in zip(tr.spans, tr.spans[1:]):
        assert a.t1 == b.t0
    assert tr.total_s == pytest.approx(1.1)
    assert tr.span("execute").attrs == {"live": 4}


# ---------------------------------------------------------------------------
# Telemetry on / off
# ---------------------------------------------------------------------------

def _queries(sess, roots):
    return {"bfs": sess.bfs(int(roots[0])), "bfs_batch": sess.bfs(roots),
            "cc": sess.connected_components(),
            "sssp": sess.sssp(int(roots[1])), "sssp_batch": sess.sssp(roots),
            "mbfs": sess.multi_bfs(roots)}


def _fields(out):
    return {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
            if f.name != "trace"}


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("codec", CODECS)
def test_outputs_equal_with_telemetry_on_and_off(graph_data, graph11,
                                                 direction, codec):
    _, _, roots = graph_data
    knobs = dict(grid=(1, 1), direction=direction, fold_codec=codec)
    on = graph11.session(BFSConfig(**knobs, telemetry=True))
    off = graph11.session(BFSConfig(**knobs))
    assert on.engine is not off.engine
    a, b = _queries(on, roots), _queries(off, roots)
    for kind in a:
        fa, fb = _fields(a[kind]), _fields(b[kind])
        for name, x in fa.items():
            y = fb[name]
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), (kind, name)
            else:
                assert x == y, (kind, name)
        assert b[kind].trace is None and a[kind].trace is not None
    assert off.last_trace() is None
    assert on.last_trace() is a["mbfs"].trace


# ---------------------------------------------------------------------------
# LevelTrace against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("codec", CODECS)
def test_trace_equals_jax_1x1(graph_data, graph11, jax11, direction, codec):
    """Every query of a telemetry session at 1x1, in process: BFS scalar
    and batched, CC, SSSP scalar and batched, multi-BFS."""
    _, _, roots = graph_data
    knobs = dict(grid=(1, 1), direction=direction, fold_codec=codec,
                 telemetry=True)
    ours = _queries(graph11.session(BFSConfig(**knobs)), roots)
    theirs = _queries(jax11.session(JaxBFSConfig(**knobs)), roots)
    for kind in ours:
        a, b = _traces(ours[kind]), _traces(theirs[kind])
        assert len(a) == len(b), kind
        for x, y in zip(a, b):
            assert_trace_equal(x, y)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_max_levels_clamp_equals_jax(graph_data, graph11, jax11, direction):
    """A search cut by `max_levels` below the graph's depth (BFS at 2
    levels, multi-BFS at k = 1) records the levels it ran, as JAX does."""
    _, _, roots = graph_data
    knobs = dict(grid=(1, 1), direction=direction, max_levels=2,
                 telemetry=True)
    ours = graph11.session(BFSConfig(**knobs))
    theirs = jax11.session(JaxBFSConfig(**knobs))
    full = graph11.session(BFSConfig(grid=(1, 1), telemetry=True)) \
        .bfs(int(roots[0])).trace
    assert full.n_levels > 2
    a, b = ours.bfs(int(roots[0])), theirs.bfs(int(roots[0]))
    assert a.trace.n_levels == 2
    assert_trace_equal(a.trace, b.trace)
    np.testing.assert_array_equal(a.level.numpy(), np.asarray(b.level))
    a, b = ours.multi_bfs(roots, k=1), theirs.multi_bfs(roots, k=1)
    assert a.trace.n_levels == 1
    assert_trace_equal(a.trace, b.trace)


@pytest.mark.parametrize("direction", [False, "bottomup"])
def test_long_searches_grow_the_record(direction):
    """Past the record's first 64 levels it grows: BFS down a 150-vertex
    path with max_levels = 130 (clamped, growing twice), CC and SSSP along
    it (L = n + 1), equal to JAX's traces."""
    n = 150
    path = np.arange(n - 1, dtype=np.int32)
    edges = np.stack([np.concatenate([path, path + 1]),
                      np.concatenate([path + 1, path])])
    w = np.full(edges.shape[1], 3, np.uint8)
    knobs = dict(grid=(1, 1), direction=direction, max_levels=130,
                 telemetry=True)
    ours = DistGraph.from_edges(edges, BFSConfig(**knobs), device="cpu",
                                weights=w).session()
    theirs = JaxDistGraph.from_edges(edges, JaxBFSConfig(**knobs),
                                     weights=w).session()
    a, b = ours.bfs(0), theirs.bfs(0)
    assert a.trace.n_levels == 130
    assert_trace_equal(a.trace, b.trace)
    for call in (lambda s: s.connected_components(), lambda s: s.sssp(0)):
        a, b = call(ours), call(theirs)
        assert a.trace.n_levels >= n - 1
        assert_trace_equal(a.trace, b.trace)


@pytest.fixture(scope="module")
def jax_multi(graph_data, tmp_path_factory):
    """The JAX traces and outputs at 2x2 and 1x4 under exchange="auto",
    telemetry on, for every configuration: one subprocess."""
    edges, w, roots = graph_data
    d = tmp_path_factory.mktemp("jax_obs_ref")
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N, weights=w)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "1x4", "--direction", "--algos", "--exchange", "auto",
         "--telemetry"], capture_output=True, text=True, timeout=900,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def graphs(graph_data):
    edges, w, _ = graph_data
    return {g: DistGraph.from_edges(edges, BFSConfig(grid=g), device="cpu",
                                    n=N, weights=w)
            for g in ((2, 2), (1, 4))}


def _check(out, ref, prefix, fields):
    """Outputs and every trace of one query against the subprocess."""
    for f in fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      ref[f"{prefix}_{f}"])
    got = out.edges_scanned
    assert (list(got) if isinstance(got, tuple) else got) \
        == ref[f"{prefix}_edges"].tolist()
    traces = _traces(out)
    assert f"{prefix}_trace{len(traces)}_n_levels" not in ref
    for b, tr in enumerate(traces):
        assert_trace_ref(tr, ref, prefix, b)


GRIDS = [(2, 2), (1, 4)]
BFS_FIELDS = ("level", "pred", "n_levels")


@pytest.mark.parametrize("grid", GRIDS)
def test_bfs_trace_equals_jax(graph_data, graphs, jax_multi, grid):
    _, _, roots = graph_data
    sess = graphs[grid].session(BFSConfig(grid=grid, exchange="auto",
                                          telemetry=True))
    assert sess.config.exchange == ("butterfly" if grid[1] == 4
                                    else "flat")
    tag = f"{grid[0]}x{grid[1]}"
    _check(sess.bfs(int(roots[0])), jax_multi, f"{tag}_scalar", BFS_FIELDS)
    _check(sess.bfs(roots), jax_multi, f"{tag}_batch", BFS_FIELDS)
    assert len(sess.last_trace()) == len(roots)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction,codec", DIRECTION_CONFIGS)
def test_direction_trace_equals_jax(graph_data, graphs, jax_multi, grid,
                                    direction, codec):
    _, _, roots = graph_data
    sess = graphs[grid].session(BFSConfig(
        grid=grid, direction=direction, fold_codec=codec, exchange="auto",
        telemetry=True))
    out = sess.bfs(roots)
    _check(out, jax_multi,
           f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}_batch",
           BFS_FIELDS)
    for b, tr in enumerate(out.trace):
        if direction is False:
            assert tr.program == "bfs" and (tr.direction == 0).all()
            continue
        assert tr.program == "dir+bfs"
        np.testing.assert_array_equal(
            tr.direction, out.directions[b].numpy()[:tr.n_levels])


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("direction,codec", ALGO_CONFIGS)
def test_value_program_traces_equal_jax(graph_data, graphs, jax_multi,
                                        grid, direction, codec):
    """CC, SSSP (batched), multi-BFS (and k = 2 under list), and BFS
    under delta.  Multi-BFS keeps JAX's accounting: its wire is not
    scaled by the strategy and its `msgs` are 0."""
    _, _, roots = graph_data
    sess = graphs[grid].session(BFSConfig(
        grid=grid, direction=direction, fold_codec=codec, exchange="auto",
        telemetry=True))
    tag = f"{grid[0]}x{grid[1]}_{dtag(direction)}_{codec}"
    _check(sess.connected_components(), jax_multi, f"{tag}_cc",
           ("labels", "n_iters"))
    _check(sess.sssp(roots), jax_multi, f"{tag}_sssp", ("dist", "n_iters"))
    mb = sess.multi_bfs(roots)
    _check(mb, jax_multi, f"{tag}_mbfs", ("level", "src", "n_levels"))
    assert mb.trace.total_msgs == 0
    if codec == "list":
        _check(sess.multi_bfs(roots, k=2), jax_multi, f"{tag}_khop",
               ("level", "src", "n_levels"))
    if codec == "delta":
        _check(sess.bfs(roots), jax_multi, f"{tag}_bfs", BFS_FIELDS)


# ---------------------------------------------------------------------------
# The channels against a recomputation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("codec", CODECS)
def test_trace_agrees_with_recomputation(graph_data, graphs, grid, codec):
    _, _, roots = graph_data
    sess = graphs[grid].session(BFSConfig(grid=grid, fold_codec=codec,
                                          exchange="auto", telemetry=True))
    out = sess.bfs(int(roots[0]))
    tr = sess.last_trace()
    assert isinstance(tr, LevelTrace) and out.trace is tr
    assert tr.codec == codec and tr.grid == grid and tr.program == "bfs"
    level = out.level.numpy()[:N]
    bc = np.bincount(level[level >= 0])
    assert tr.n_levels == len(bc) == int(out.n_levels) - 1
    assert tr.frontier.tolist() == bc.tolist()
    assert (tr.frontier_dev.sum(axis=0) == tr.frontier).all()
    assert tr.total_scanned == out.edges_scanned
    C = grid[1]
    strat = sess.engine.exchange
    wb = strat.wire_bytes(sess.engine.codec.wire_bytes(graphs[grid].grid), C)
    assert (tr.wire_dev == wb).all()
    msgs = C.bit_length() - 1 if strat.name == "butterfly" else C - 1
    assert (tr.msgs_dev == msgs).all() and tr.msgs_dev.shape == \
        (grid[0] * C, tr.n_levels)
    assert (tr.direction == 0).all()


def test_batched_trace_per_root(graph_data, graph11):
    _, _, roots = graph_data
    sess = graph11.session(BFSConfig(grid=(1, 1), telemetry=True))
    out = sess.bfs(roots)
    traces = sess.last_trace()
    assert isinstance(traces, tuple) and len(traces) == len(roots)
    assert out.trace is traces
    for b, tr in enumerate(traces):
        assert_trace_equal(tr, sess.bfs(int(roots[b])).trace)
        lv = out.level[b].numpy()[:N]
        assert tr.frontier.tolist() == np.bincount(lv[lv >= 0]).tolist()


def test_value_fold_traces_for_algos(graph_data, graph11):
    """CC, SSSP and multi-BFS fold values: per-level wire bytes follow the
    count-proportional formula wb + 4*folded (P = 1, flat)."""
    from repro_torch.dist.exchange import FOLD_CODECS

    _, _, roots = graph_data
    sess = graph11.session(BFSConfig(grid=(1, 1), telemetry=True))
    outs = (sess.connected_components(), sess.sssp(int(roots[0])),
            sess.multi_bfs(roots, k=2))
    assert sess.last_trace() is outs[-1].trace
    for out in outs:
        tr = out.trace
        assert isinstance(tr, LevelTrace) and tr.n_levels >= 1
        wb = FOLD_CODECS[tr.codec]().wire_bytes(graph11.grid)
        assert tr.wire_bytes.tolist() == (wb + 4 * tr.folded).tolist()
