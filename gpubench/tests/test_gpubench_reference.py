"""The benchmark's reference against the port's plain path and the port's
numpy references at small sizes, the controls, and the metric
arithmetic on fixed inputs."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.reference import graph as RG
from gpubench.reference import graph500 as G5
from gpubench.reference import profile as RP
from gpubench.reference.peaks import HBM_BYTES_PER_S
from gpubench.reference.rmat import rmat_edges, symmetric_weights

ABCD = (0.57, 0.19, 0.19, 0.05)


def small_graph(scale, seed, weights=True):
    gen = torch.Generator().manual_seed(seed)
    edges = rmat_edges(scale, 8, ABCD, gen, "cpu")
    w = symmetric_weights(edges.shape[1] // 2, 1, 255, gen, "cpu") \
        if weights else None
    return edges, w, 1 << scale


def some_roots(edges, n, k=3):
    deg = RG.out_degrees(edges, n)
    cand = torch.nonzero(deg > 0).flatten()
    return [int(cand[0]), int(cand[len(cand) // 2]), int(torch.argmax(deg))][:k]


@pytest.mark.parametrize("direction", [False, True], ids=["topdown", "do"])
@pytest.mark.parametrize("scale,seed", [(8, 1), (10, 2)])
def test_reference_equals_port_plain_path(scale, seed, direction):
    from repro_torch import BFSConfig, DistGraph
    edges, w, n = small_graph(scale, seed)
    knobs = dict(direction=True, fold_codec="bitmap") if direction else {}
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(2, 2), edge_chunk=1024, **knobs),
        device="cpu", n=n, weights=w)
    sess = graph.session()
    ref = RG.RefGraph(edges, w, n)
    for root in some_roots(edges, n):
        out = sess.bfs(root)
        level, depth = RG.bfs_levels(ref, root)
        assert torch.equal(out.level[:n], level)
        assert int(out.n_levels) == depth + 2
        assert G5.bad_preds(edges, out.level[:n], out.pred[:n], root) == 0
        assert torch.equal(sess.sssp(root).dist[:n], RG.sssp_dist(ref, root))


@pytest.mark.parametrize("scale,seed", [(7, 3), (9, 4)])
def test_reference_equals_port_numpy_references(scale, seed):
    from repro_torch.algos.reference import cc_reference, sssp_reference
    edges, w, n = small_graph(scale, seed)
    lab = RG.component_labels(edges, n)
    assert np.array_equal(lab.numpy(), cc_reference(edges.numpy(), n))
    ref = RG.RefGraph(edges, w, n)
    for root in some_roots(edges, n):
        want = sssp_reference(edges.numpy(), w.numpy(), n, root)
        assert np.array_equal(RG.sssp_dist(ref, root).numpy(), want)


def test_csr_holds_every_edge_once(monkeypatch):
    monkeypatch.setattr(RG, "PIECE", 1000)       # several pieces and chunks
    edges, w, n = small_graph(8, 5)
    g = RG.RefGraph(edges, w, n)
    rows = torch.repeat_interleave(torch.arange(n), g.deg)
    got = sorted(zip(rows.tolist(), g.col.tolist(), g.w.tolist()))
    want = sorted(zip(edges[0].tolist(), edges[1].tolist(), w.tolist()))
    assert got == want
    root = int(torch.argmax(g.deg))
    level, _ = RG.bfs_levels(g, root)
    monkeypatch.setattr(RG, "PIECE", 1 << 27)
    assert torch.equal(level, RG.bfs_levels(RG.RefGraph(edges, w, n),
                                            root)[0])


def test_component_edges_count_graph500s_way():
    edges, _, n = small_graph(8, 6, weights=False)
    lab = RG.component_labels(edges, n)
    comp = RG.component_edges(edges, lab)
    g = RG.RefGraph(edges, None, n)
    for root in some_roots(edges, n):
        level, _ = RG.bfs_levels(g, root)
        both = (level[edges[0].long()] >= 0) & (level[edges[1].long()] >= 0)
        assert int(comp[lab[root]]) == int(both.sum()) // 2


def test_bad_preds_counts_each_broken_rule():
    edges, _, n = small_graph(8, 7, weights=False)
    g = RG.RefGraph(edges, None, n)
    root = int(torch.argmax(g.deg))
    level, _ = RG.bfs_levels(g, root)
    # a valid tree: each vertex's parent is a neighbour one level up
    pred = torch.full((n,), -1, dtype=torch.int32)
    pred[root] = root
    for v in torch.nonzero(level > 0).flatten().tolist():
        nb = g.col[g.row_off[v]:g.row_off[v + 1]].long()
        pred[v] = int(nb[level[nb] == level[v] - 1][0])
    assert G5.bad_preds(edges, level, pred, root) == 0
    deep = int(torch.nonzero(level == level.max())[0])
    wrong = pred.clone()
    wrong[deep] = deep                      # not one level up
    assert G5.bad_preds(edges, level, wrong, root) == 1
    far = pred.clone()
    up = torch.nonzero(level == level[deep] - 1).flatten()
    nb = set(g.col[g.row_off[deep]:g.row_off[deep + 1]].tolist())
    stranger = [int(u) for u in up if int(u) not in nb]
    if stranger:
        far[deep] = stranger[0]             # one level up, no edge
        assert G5.bad_preds(edges, level, far, root) == 1
    none = pred.clone()
    none[deep] = -1                         # reached without a parent
    assert G5.bad_preds(edges, level, none, root) == 1


def test_controls_break_their_guarantee():
    edges, w, n = small_graph(9, 8)
    g = RG.RefGraph(edges, w, n)
    root = int(torch.argmax(g.deg))
    level, depth = RG.bfs_levels(g, root)
    assert depth >= 2
    bad, bad_pred, _ = RG.bfs_levels_in_place(g, root)
    assert int((bad != level).sum()) > 0
    assert G5.bad_preds(edges, bad, bad_pred, root) > 0
    assert int((RG.sssp_dist(g, root, weight_bits=4)
                != RG.sssp_dist(g, root)).sum()) > 0


def test_inputs_follow_their_seeds_and_the_seed_orders_the_roots():
    config = {"scale": 7, "edgefactor": 8, "rmat_abcd": list(ABCD),
              "graph_seed": 2**31 + 5, "weights": {"range": [1, 255]}}
    a = harness.make_inputs(config, "cpu")
    b = harness.make_inputs(config, "cpu")
    c = harness.make_inputs(dict(config, graph_seed=6), "cpu")
    assert torch.equal(a.edges, b.edges) and torch.equal(a.weights, b.weights)
    assert a.digest == b.digest != c.digest
    half = a.edges.shape[1] // 2
    assert torch.equal(a.edges[:, half:], a.edges.flip(0)[:, :half])
    assert torch.equal(a.weights[half:], a.weights[:half])
    assert int(a.weights.min()) >= 1
    deg = RG.out_degrees(a.edges, a.n)
    mix = {"roots": 16, "root_seed": 1, "min_degree": 1}
    r1 = harness.draw_roots(deg, mix, 2**31 + 11)
    r2 = harness.draw_roots(deg, mix, 2**31 + 12)
    assert r1 == harness.draw_roots(deg, mix, 2**31 + 11)
    assert r1 != r2 and sorted(r1) == sorted(r2)
    assert len(set(r1)) == 16 and all(int(deg[r]) >= 1 for r in r1)
    assert sorted(r1) != sorted(harness.draw_roots(
        deg, dict(mix, root_seed=2), 2**31 + 11))


def ev(start, end, name, device, thread=1):
    return types.SimpleNamespace(
        time_range=types.SimpleNamespace(start=start, end=end), name=name,
        device_type=device, thread=thread)


def test_profile_arithmetic_on_fixed_events():
    D, H = "dev", "host"
    events = [ev(0, 10, "k1", D), ev(5, 20, "k2", D), ev(30, 40, "k1", D),
              ev(0, 100, "outer", H), ev(22, 28, "aten::item", H),
              ev(21, 29, "aten::nonzero", H), ev(50, 60, "other", H, 2)]
    s = RP.summarise(events, 100e-6, D)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["idle_share"] == pytest.approx(0.7)
    assert s["device_ops"] == [["k1", pytest.approx(20e-6)],
                               ["k2", pytest.approx(15e-6)]]
    assert s["idle_gaps"] == [["aten::item", pytest.approx(10e-6)]]


def record(profile=None, traversed=(100, 300)):
    return harness.RunRecord(setup_s=12.5, plan_s=4.0, window_s=2.0,
                             traversed=list(traversed),
                             peak_bytes=3 * 2**30, profile=profile)


def test_metric_readers_on_fixed_records():
    read = harness.metric_reader
    assert read("bfs_teps")(record()) == pytest.approx(200.0)
    assert read("sssp_teps")(record()) == pytest.approx(200.0)
    assert read("setup_s")(record()) == 12.5
    assert read("plan_s")(record()) == 4.0
    assert read("peak_gib")(record()) == pytest.approx(3.0)
    for name in ("device_idle.bfs", "device_idle.sssp", "hbm_roofline.bfs",
                 "hbm_roofline.sssp"):
        assert read(name)(record()) is None     # an untraced run
    prof = {"busy_s": 1.6, "window_s": 2.0, "idle_share": 0.2}
    assert read("device_idle.bfs")(record(prof)) == pytest.approx(20.0)
    assert read("device_idle.sssp")(record(prof)) == pytest.approx(20.0)
    traversed = (HBM_BYTES_PER_S / 8, HBM_BYTES_PER_S / 8)
    assert read("hbm_roofline.bfs")(record(prof, traversed)) == \
        pytest.approx(100.0 * 2 / 1.6)
    assert read("hbm_roofline.sssp")(record(prof, traversed)) == \
        pytest.approx(100.0 * 2 * 10 / 8 / 1.6)
    assert read("hbm_roofline.bfs")(record(dict(prof, busy_s=0.0))) is None


def test_teps_and_hbm_share():
    assert G5.teps(10, 2.0) == 5.0
    assert RP.hbm_share(HBM_BYTES_PER_S, 1.0) == pytest.approx(100.0)
