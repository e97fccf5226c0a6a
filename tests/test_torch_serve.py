"""The serving layer in the port (`repro_torch.serve`, DESIGN.md sec. 12),
on the CPU at SCALE 7, 1x1: each of the JAX package's serve tests
(tests/test_serve.py) on the port's server, and one request sequence
through both packages' servers side by side.

  * coalescing correctness: interleaved requests across programs and
    codecs, served through the continuous-batching scheduler with padding,
    equal direct `GraphSession` calls (a deterministic matrix, and the
    JAX file's property test over random interleavings as four seeded
    cases: this environment has no `hypothesis`);
  * cache discipline: engine `trace_count` (cache entries built) proves no
    rebuild beyond the first batch per (program, padded capacity class);
  * fault path: a transient fault is absorbed by the StepRunner retries; a
    poisoned request fails alone through the isolation replay; a
    fault-tolerant batch drains through recovery;
  * admission: validation rejects bad requests before they reach an
    engine; `max_pending` backpressure raises ServerSaturated;
  * CC dedup-coalescing and the scheduler's units;
  * JAX's `GraphServer` and the port's on one pre-queued sequence: every
    value field for field, `batch_size` / `padded_to`, the accounting
    counts and `cache_stats()` equal (times are not part of the contract).

Inputs as tests/test_serve.py makes them: `repro.graphgen.rmat_edges(
jax.random.key(0), 7, 8)` as numpy, uint8 weights `(|31 u + v| mod 255) +
1`, roots from `np.random.default_rng(1)` among degree > 0 vertices.
"""
import dataclasses
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.graphgen import rmat_edges as jax_rmat_edges
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.runtime import DeviceLossInjector, FaultInjector, \
    RetryPolicy
from repro_torch.serve import (BatchKey, ContinuousBatcher, Entry,
                               GraphServer, QueryRequest, QueryTicket,
                               ServeConfig, ServerSaturated, pad_class,
                               pad_classes)

SCALE, EF = 7, 8
N = 1 << SCALE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so a parallel test run does not
    wait on busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gdata():
    edges = np.asarray(jax_rmat_edges(jax.random.key(0), SCALE, EF))
    w = (np.abs(edges[0] * 31 + edges[1]) % 255 + 1).astype(np.uint8)
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(1).choice(np.flatnonzero(deg > 0), 16,
                                            replace=False)
    return edges, w, roots


@pytest.fixture(scope="module")
def graphs(gdata):
    """Two resident graphs: 'a' unweighted, 'b' weighted (SSSP-capable)."""
    edges, w, roots = gdata
    cfg = BFSConfig(grid=(1, 1), edge_chunk=256)
    ga = DistGraph.from_edges(edges, cfg, n=N, device="cpu")
    gb = DistGraph.from_edges(edges, cfg, n=N, weights=w, device="cpu")
    return ga, gb, roots


def _server(ga, gb, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("window_s", 0.01)
    return GraphServer({"a": ga, "b": gb}, ServeConfig(**kw))


def _value(ticket, timeout=120):
    res = ticket.result(timeout)
    assert res.ok, f"query failed: {res.error}"
    return res


# ---------------------------------------------------------------------------
# Coalescing correctness: served == direct GraphSession, bit-identical
# ---------------------------------------------------------------------------

def test_mixed_programs_bitexact(graphs):
    """BFS / CC / SSSP / multi-BFS on two resident graphs, interleaved,
    each result bit-identical to the direct session call."""
    ga, gb, roots = graphs
    with _server(ga, gb) as srv:
        tickets = []
        for i, r in enumerate(roots[:6]):
            tickets.append(("bfs", r, srv.bfs("a", int(r),
                                              tenant=f"t{i % 2}")))
            if i % 2 == 0:
                tickets.append(("sssp", r, srv.sssp("b", int(r))))
            if i % 3 == 0:
                tickets.append(("cc", None, srv.connected_components("a")))
        tickets.append(("mb", None,
                        srv.multi_bfs("a", roots[:3].astype(int), k=2)))
        srv.drain()
    sa, sb = ga.session(), gb.session()
    cc = sa.connected_components()
    mb = sa.multi_bfs(roots[:3].astype(int), k=2)
    for kind, r, t in tickets:
        out = _value(t).value
        if kind == "bfs":
            direct = sa.bfs(int(r))
            assert torch.equal(out.level, direct.level)
            assert torch.equal(out.pred, direct.pred)
            assert int(out.n_levels) == int(direct.n_levels)
            assert out.edges_scanned == direct.edges_scanned
        elif kind == "sssp":
            direct = sb.sssp(int(r))
            assert torch.equal(out.dist, direct.dist)
            assert out.edges_scanned == direct.edges_scanned
        elif kind == "cc":
            assert torch.equal(out.labels, cc.labels)
        else:
            assert torch.equal(out.level, mb.level)
            assert torch.equal(out.src, mb.src)


def test_full_batch_coalesces_and_traces_once(graphs):
    """max_batch pre-queued BFS roots run as ONE padded batch through ONE
    cache entry; a second identical wave builds nothing."""
    ga, gb, roots = graphs
    srv = _server(ga, gb)                      # NOT started: queue fills
    tickets = [srv.bfs("a", int(r)) for r in roots[:4]]
    srv.start()
    srv.drain()
    engine = ga.session().engine
    first_traces = engine.trace_count
    for t in tickets:
        res = _value(t)
        assert res.batch_size == 4 and res.padded_to == 4
    occ = srv.accounting.occupancy()
    assert occ == 4.0, f"expected full occupancy, got {occ}"
    # second wave: same (program, B class) -> zero new entries
    tickets = [srv.bfs("a", int(r)) for r in roots[4:8]]
    srv.drain()
    for t in tickets:
        _value(t)
    assert engine.trace_count == first_traces, \
        "repeat batch of the same capacity class must not rebuild"
    srv.stop()


def test_padding_demux_discards_pad_slots(graphs):
    """A 3-live batch pads to class 4; every live slot demuxes to its own
    root's result (padding repeats root 0 and is discarded)."""
    ga, gb, roots = graphs
    srv = _server(ga, gb)
    tickets = [srv.bfs("a", int(r)) for r in roots[:3]]
    srv.start()
    srv.drain()
    sess = ga.session()
    for t, r in zip(tickets, roots[:3]):
        res = _value(t)
        assert res.batch_size == 3 and res.padded_to == 4
        assert torch.equal(res.value.level, sess.bfs(int(r)).level)
    srv.stop()


def test_cc_requests_share_one_run(graphs):
    """Argument-free CC coalesces by dedup: K callers, ONE execution."""
    ga, gb, roots = graphs
    srv = _server(ga, gb)
    tickets = [srv.connected_components("a", tenant=f"t{i}")
               for i in range(3)]
    srv.start()
    srv.drain()
    direct = ga.session().connected_components()
    for t in tickets:
        res = _value(t)
        assert res.batch_size == 3
        assert torch.equal(res.value.labels, direct.labels)
    batches = [b for b in srv.accounting.batches if b.program == "cc"]
    assert len(batches) == 1 and batches[0].live == 3
    srv.stop()


def _interleaving(seed):
    """One random request list of the JAX file's property test: 1 to 10
    (kind, root index) pairs."""
    rng = np.random.default_rng(seed)
    kinds = ["bfs-list", "bfs-bitmap", "cc"]
    return [(kinds[int(rng.integers(3))], int(rng.integers(16)))
            for _ in range(int(rng.integers(1, 11)))]


@pytest.mark.parametrize("seed", range(4))
def test_interleaved_requests_property(graphs, seed):
    """K interleaved requests across programs AND codecs, served with
    padding, are bit-identical to direct session calls, and trace counts
    prove no rebuilds beyond the first batch per (program, padded B)."""
    ga, gb, roots = graphs
    cfg_bitmap = BFSConfig(grid=(1, 1), edge_chunk=256, fold_codec="bitmap")
    srv = _server(ga, gb)
    tickets = []
    for kind, ridx in _interleaving(seed):
        root = int(roots[ridx])
        if kind == "bfs-list":
            tickets.append((kind, root, srv.bfs("a", root)))
        elif kind == "bfs-bitmap":
            tickets.append((kind, root,
                            srv.bfs("a", root, config=cfg_bitmap)))
        else:
            tickets.append((kind, None, srv.connected_components("a")))
    srv.start()
    srv.drain()
    srv.stop()
    sess_list = ga.session()
    sess_bitmap = ga.session(cfg_bitmap)
    cc = sess_list.connected_components()
    for kind, root, t in tickets:
        out = _value(t).value
        if kind == "cc":
            assert torch.equal(out.labels, cc.labels)
        else:
            sess = sess_list if kind == "bfs-list" else sess_bitmap
            direct = sess.bfs(root)
            assert torch.equal(out.level, direct.level)
            assert torch.equal(out.pred, direct.pred)
            assert out.edges_scanned == direct.edges_scanned
    classes = set(pad_classes(srv.config.max_batch)) | {1}
    for key, eng in ga._engines.items():
        assert eng.trace_count <= len(classes) + 1, \
            f"engine {key} built {eng.trace_count} entries"


# ---------------------------------------------------------------------------
# Fault path
# ---------------------------------------------------------------------------

def test_transient_fault_retried_invisibly(graphs):
    """A fault on the first attempt is absorbed by StepRunner retries; the
    request succeeds and the retry is visible in runner stats."""
    ga, gb, roots = graphs
    with _server(ga, gb, retry=RetryPolicy(max_retries=2,
                                           backoff_s=0.001)) as srv:
        t = srv.bfs("a", int(roots[0]),
                    injector=FaultInjector({0: RuntimeError}))
        res = _value(t)
        assert torch.equal(res.value.level, ga.session().bfs(int(roots[0])).level)
        assert srv.metrics_snapshot()["runners"]["a"]["retries"] >= 1


def test_poisoned_request_fails_alone(graphs):
    """An injected mid-query fault fails ONLY its own request (isolation
    replay); batchmates succeed and the server keeps serving."""
    ga, gb, roots = graphs
    srv = _server(ga, gb, retry=RetryPolicy(max_retries=1, backoff_s=0.001))
    poisoned = FaultInjector({i: RuntimeError for i in range(16)})
    good = [srv.bfs("a", int(r)) for r in roots[:2]]
    bad = srv.bfs("a", int(roots[2]), injector=poisoned)
    more = [srv.bfs("a", int(r)) for r in roots[3:4]]
    srv.start()
    srv.drain()
    sess = ga.session()
    for t, r in zip(good + more, list(roots[:2]) + list(roots[3:4])):
        res = _value(t)
        assert torch.equal(res.value.level, sess.bfs(int(r)).level)
    res = bad.result(120)
    assert not res.ok and "RuntimeError" in res.error
    assert "injected" in res.error
    after = srv.bfs("a", int(roots[5]))
    srv.drain()
    assert _value(after).ok
    stats = srv.metrics_snapshot()
    assert stats["tenants"]["default"]["failed"] == 1
    assert stats["n_isolated"] >= 1
    srv.stop()


def test_ft_batch_drains_through_recovery(gdata, tmp_path):
    """A fault-tolerant batch whose device loss escapes the segmented loop
    (max_retries=0) is re-dispatched once and resumes from its last
    checkpointed level: no lost query, values equal the plain session's."""
    edges, w, roots = gdata
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(1, 1), edge_chunk=256, fault_tolerance=True,
                         ckpt_every=1), n=N, device="cpu")
    cfg = ServeConfig(retry=RetryPolicy(max_retries=0, backoff_s=0.0),
                      recovery_dir=str(tmp_path), max_batch=2)
    srv = GraphServer({"g": graph}, cfg)
    tickets = [srv.bfs("g", int(r), injector=DeviceLossInjector(2, fires=1)
                       if i == 0 else None)
               for i, r in enumerate(roots[:2])]
    with srv:
        srv.drain()
        snap = srv.metrics_snapshot()["runners"]["g"]
    assert snap["recovery_resumes"] == 1 and snap["recovery_drained"] == 2
    plain = DistGraph.from_edges(edges, BFSConfig(grid=(1, 1)), n=N,
                                 device="cpu").session()
    for t, r in zip(tickets, roots[:2]):
        res = _value(t)
        direct = plain.bfs(int(r))
        assert torch.equal(res.value.level, direct.level)
        assert torch.equal(res.value.pred, direct.pred)
        assert res.value.edges_scanned == direct.edges_scanned
    assert sorted(p.name for p in tmp_path.iterdir()), \
        "the drained batch wrote no checkpoint"


# ---------------------------------------------------------------------------
# Admission: validation + backpressure
# ---------------------------------------------------------------------------

def test_submit_validates_before_compiled_program(graphs):
    ga, gb, roots = graphs
    srv = _server(ga, gb)
    with pytest.raises(ValueError, match="no resident graph"):
        srv.bfs("nope", 0)
    with pytest.raises(ValueError, match="unknown program"):
        srv.submit("a", "pagerank", 0)
    with pytest.raises(ValueError, match=f"n = {N}"):
        srv.bfs("a", N + 3)
    with pytest.raises(ValueError, match="integer"):
        srv.bfs("a", 1.5)
    with pytest.raises(ValueError, match="one root per request"):
        srv.bfs("a", np.array([1, 2]))
    with pytest.raises(ValueError, match="one root per request"):
        srv.bfs("a", torch.tensor([1, 2]))
    with pytest.raises(ValueError, match="weights"):
        srv.sssp("a", 0)              # graph 'a' is weightless
    with pytest.raises(ValueError, match=f"n = {N}"):
        srv.multi_bfs("a", [0, N])
    with pytest.raises(ValueError, match="integer"):
        srv.multi_bfs("a", torch.tensor([0.5, 1.0]))
    with pytest.raises(ValueError, match="argument-free"):
        srv.submit("a", "cc", 5)
    assert srv.accounting.snapshot()["tenants"] == {}, \
        "rejected requests must not be admitted"


def test_backpressure_raises_server_saturated(graphs):
    ga, gb, roots = graphs
    srv = _server(ga, gb, max_pending=2)     # not started: queue holds
    srv.bfs("a", int(roots[0]))
    srv.bfs("a", torch.tensor(int(roots[1])))
    with pytest.raises(ServerSaturated, match="max_pending"):
        srv.bfs("a", int(roots[2]))
    assert srv.metrics_snapshot()["tenants"]["default"]["rejected"] == 1
    srv.start()
    srv.drain()
    srv.stop()


def test_stop_flushes_pending_requests(graphs):
    """stop() on a started server serves what was admitted, then exits."""
    ga, gb, roots = graphs
    srv = _server(ga, gb)
    tickets = [srv.bfs("a", int(r)) for r in roots[:2]]
    srv.start()
    srv.stop()
    for t in tickets:
        assert _value(t, timeout=10).ok


def test_warm_builds_every_class_and_exposes_the_cache(graphs):
    """`warm` builds the capacity classes' entries through `compiled_for`
    (no search), the snapshot and the Prometheus text carry the cache and
    the engines' entry counts, and `stats()` is the deprecated spelling."""
    ga, gb, roots = graphs
    srv = GraphServer({"b": gb}, ServeConfig(max_batch=4))
    sess = gb.session()
    srv.warm(("bfs",))
    g = gb.csc
    for B in pad_classes(4):
        assert (sess.config.engine_key, tuple(g.col_off.shape),
                tuple(g.row_idx.shape), B) in gb._compiled
    snap = srv.metrics_snapshot()
    assert snap["aot_cache"]["b"] == gb.cache_stats()
    assert str(sess.config.engine_key) in snap["trace_counts"]["b"]
    text = srv.prometheus()
    assert "aot_cache_size" in text and "engine_trace_count" in text
    with pytest.warns(DeprecationWarning, match="metrics_snapshot"):
        assert srv.stats()["aot_cache"] == snap["aot_cache"]


# ---------------------------------------------------------------------------
# Scheduler / protocol units (no device work)
# ---------------------------------------------------------------------------

def _entry(key, seq=0):
    req = QueryRequest(seq=seq, tenant="t", graph=key.graph,
                       program=key.program, arg=0, config=key.config)
    return Entry(key=key, req=req, ticket=QueryTicket(req))


def test_pad_classes():
    assert pad_class(1, 8) == 1 and pad_class(3, 8) == 4
    assert pad_class(5, 8) == 8 and pad_class(5, 6) == 6
    assert pad_classes(8) == (1, 2, 4, 8)
    assert pad_classes(6) == (1, 2, 4, 6)
    with pytest.raises(ValueError):
        pad_class(0, 8)


def test_batcher_dispatches_full_batch_immediately():
    b = ContinuousBatcher(window_s=60.0, max_pending=16)
    key = BatchKey("g", "bfs", None, (), cap=2)
    for i in range(3):
        b.put(_entry(key, i))
    t0 = time.perf_counter()
    got_key, entries = b.next_batch()
    assert time.perf_counter() - t0 < 1.0, "full batch must not wait window"
    assert got_key == key and len(entries) == 2
    assert [e.req.seq for e in entries] == [0, 1], "FIFO order"
    b.close()
    _, rest = b.next_batch()            # flush: window not waited out
    assert [e.req.seq for e in rest] == [2]
    assert b.next_batch() is None


def test_batcher_window_dispatches_partial_batch():
    b = ContinuousBatcher(window_s=0.05, max_pending=16)
    key = BatchKey("g", "bfs", None, (), cap=8)
    b.put(_entry(key))
    t0 = time.perf_counter()
    _, entries = b.next_batch()
    waited = time.perf_counter() - t0
    assert len(entries) == 1
    assert waited >= 0.03, f"partial batch dispatched too early ({waited})"
    b.close()


def test_batcher_wakes_blocked_consumer():
    b = ContinuousBatcher(window_s=0.01, max_pending=16)
    key = BatchKey("g", "bfs", None, (), cap=8)
    out = []
    consumer = threading.Thread(target=lambda: out.append(b.next_batch()))
    consumer.start()
    time.sleep(0.05)
    b.put(_entry(key, 7))
    consumer.join(timeout=5)
    assert not consumer.is_alive() and out[0][1][0].req.seq == 7
    b.close()


# ---------------------------------------------------------------------------
# The two packages side by side
# ---------------------------------------------------------------------------

# one pre-queued sequence: list-codec BFS (a batch of 4 and one of 1), SSSP
# (2 -> class 2), two CC callers sharing a run, a multi-BFS, a bitmap BFS
SEQUENCE = [("bfs", 0), ("bfs", 1), ("sssp", 2), ("bfs", 2), ("cc", None),
            ("bfs", 3), ("multi_bfs", None), ("cc", None), ("bfs", 4),
            ("sssp", 5), ("bfs-bitmap", 6)]


def _run_sequence(GraphServer_, ServeConfig_, graph, bitmap_cfg, roots,
                  tenants):
    """Pre-queue SEQUENCE (plus one request the full queue rejects), then
    serve it; returns (results, server)."""
    srv = GraphServer_({"g": graph}, ServeConfig_(
        max_batch=4, window_s=0.01, max_pending=len(SEQUENCE)))
    tickets = []
    for i, (kind, ridx) in enumerate(SEQUENCE):
        tenant = tenants[i % len(tenants)]
        if kind == "bfs":
            t = srv.bfs("g", int(roots[ridx]), tenant=tenant)
        elif kind == "bfs-bitmap":
            t = srv.bfs("g", int(roots[ridx]), tenant=tenant,
                        config=bitmap_cfg)
        elif kind == "sssp":
            t = srv.sssp("g", int(roots[ridx]), tenant=tenant)
        elif kind == "cc":
            t = srv.connected_components("g", tenant=tenant)
        else:
            t = srv.multi_bfs("g", roots[:3].astype(np.int32), k=2,
                              tenant=tenant)
        tickets.append(t)
    with pytest.raises(Exception, match="max_pending"):
        srv.bfs("g", int(roots[7]), tenant=tenants[0])
    srv.start()
    srv.drain()
    srv.stop()
    return [t.result(60) for t in tickets], srv


def _fields_equal(mine, theirs, what):
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if a is None:
            assert b is None, (what, f.name)
        elif isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{what} {f.name}")
        else:
            assert np.asarray(a).tolist() == np.asarray(b).tolist(), \
                (what, f.name, a, b)


def test_server_equals_jax_server(gdata):
    """One pre-queued sequence through JAX's GraphServer and the port's,
    both 1x1 in process: every value equal field for field, the same
    batch_size and padded_to, the same accounting counts (admitted,
    rejected, ok, edges, batches, occupancy, padding) and the same
    cache_stats()."""
    from repro.api import BFSConfig as JaxBFSConfig
    from repro.api import DistGraph as JaxDistGraph
    from repro.serve import GraphServer as JaxGraphServer
    from repro.serve import ServeConfig as JaxServeConfig

    edges, w, roots = gdata
    tenants = ("alice", "bob", "carol")
    jgraph = JaxDistGraph.from_edges(
        edges, JaxBFSConfig(grid=(1, 1), edge_chunk=256), n=N, weights=w)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=(1, 1),
                                                  edge_chunk=256),
                                 n=N, weights=w, device="cpu")
    theirs, jsrv = _run_sequence(
        JaxGraphServer, JaxServeConfig, jgraph,
        JaxBFSConfig(grid=(1, 1), edge_chunk=256, fold_codec="bitmap"),
        roots, tenants)
    mine, srv = _run_sequence(
        GraphServer, ServeConfig, graph,
        BFSConfig(grid=(1, 1), edge_chunk=256, fold_codec="bitmap"),
        roots, tenants)
    for (kind, _), a, b in zip(SEQUENCE, mine, theirs):
        assert a.ok and b.ok, (kind, a.error, b.error)
        assert (a.program, a.tenant, a.batch_size, a.padded_to) == \
            (b.program, b.tenant, b.batch_size, b.padded_to), kind
        _fields_equal(a.value, b.value, kind)
    ms, js = srv.accounting.snapshot(), jsrv.accounting.snapshot()
    timeless = ("exec_s", "queued_s")
    assert {t: {k: v for k, v in s.items() if k not in timeless}
            for t, s in ms["tenants"].items()} == \
        {t: {k: v for k, v in s.items() if k not in timeless}
         for t, s in js["tenants"].items()}
    for k in ("n_batches", "n_isolated", "mean_occupancy", "mean_padded_to",
              "pad_waste_frac"):
        assert ms[k] == js[k], k
    assert sorted((b.program, b.live, b.padded_to, b.isolated)
                  for b in srv.accounting.batches) == \
        sorted((b.program, b.live, b.padded_to, b.isolated)
               for b in jsrv.accounting.batches)
    assert graph.cache_stats() == jgraph.cache_stats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert graph.aot_cache_stats() == jgraph.aot_cache_stats()
