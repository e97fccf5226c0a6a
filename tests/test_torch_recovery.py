"""Mid-traversal fault tolerance in the port (DESIGN.md sec. 15): the
segmented level loop, grid-canonical snapshots, retry, checkpoints and the
elastic shrink, held to the JAX package exactly.

  * segmented bit-identity: `BFSConfig(fault_tolerance=True, ckpt_every=K)`
    for K in {1, 2, 5} equals the port's unsegmented path and the JAX
    package, field for field: BFS scalar and batched, CC, SSSP and
    multi-BFS, under list / bitmap / delta, direction off and adaptive --
    at 1x1 against JAX in process, at 2x2 against one JAX run in a
    subprocess with four forced host devices (tests/dist/
    torch_parity_ref.py --ft);
  * no extra work at a segment boundary, and a segment leaves its input
    carry untouched;
  * transient loss absorbed by one retry, `stats` equal to JAX's;
    persistent loss raising UnrecoverableLoss whose snapshot resumes
    bit-identically, predecessors included;
  * snapshots equal across the packages array for array and meta for
    meta, and each package resuming the other's, at 1x1 and 2x2, for
    every program, in direction mode from a level after the switch to
    bottom-up, and under telemetry; checkpoint directories written by one
    package resumed by the other, a `query_key` mismatch refused;
  * `DeviceLossInjector` crossing semantics (mirroring tests/
    test_recovery.py), `recovery=` without FT refused, the checkpoint
    manager's layout, GC and error path;
  * the elastic shrink 2x2 -> 1x3 (and a repeated loss: two shrinks):
    every grid-independent field equal to the uninterrupted run, BFS
    predecessors Graph500-valid and equal to JAX's elastic run.

Inputs as tests/test_recovery.py makes them: `repro.graphgen.rmat_edges(
jax.random.key(3), 7, 8)` as numpy, uint8 weights `(|31 u + v| mod 254) +
1`, roots from `np.random.default_rng(0)` among degree > 0 vertices.  Every
comparison is exact.
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

from repro.api import BFSConfig as JaxBFSConfig
from repro.api import DistGraph as JaxDistGraph
from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.ckpt.elastic import shrink_grid as jax_shrink_grid
from repro.graphgen import rmat_edges as jax_rmat_edges
from repro.runtime import DeviceLossInjector as JaxInjector
from repro.runtime import RecoveryPlan as JaxPlan
from repro.runtime import RetryPolicy as JaxRetryPolicy
from repro.runtime import TraversalCheckpointer as JaxCheckpointer
from repro.runtime import UnrecoverableLoss as JaxUnrecoverableLoss
from repro_torch.algos.cc import ConnectedComponentsProgram
from repro_torch.algos.multi_bfs import MultiSourceBFSProgram
from repro_torch.algos.sssp import SSSPProgram
from repro_torch.api import BFSConfig, DistGraph
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.elastic import reshard_state, shrink_grid
from repro_torch.core.validate import validate_bfs
from repro_torch.runtime import (DeviceLoss, DeviceLossInjector,
                                 ElasticCoordinator, RecoveryPlan,
                                 RetryPolicy, TraversalCheckpointer,
                                 UnrecoverableLoss)

SCALE, EF = 7, 8
N = 1 << SCALE
REF_SCRIPT = os.path.join(os.path.dirname(__file__), "dist",
                          "torch_parity_ref.py")
CONFIGS = [(d, c) for d in (False, True) for c in ("list", "bitmap", "delta")]
FIELDS = {"bfs1": ("level", "pred", "n_levels"),
          "bfs": ("level", "pred", "n_levels"),
          "cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
          "mbfs": ("level", "src", "n_levels")}
METHODS = {"bfs1": "bfs", "bfs": "bfs", "cc": "connected_components",
           "sssp": "sssp", "mbfs": "multi_bfs"}
# snapshot cases: top-down at the crossing of level 3; direction-optimised
# at level 4, past every query's first bottom-up level (asserted)
SNAP_CASES = (
    [{"tag": f"{q}_td", "query": q, "direction": False, "codec": "list",
      "at": 3, "telemetry": False} for q in FIELDS]
    + [{"tag": f"{q}_dir", "query": q, "direction": True, "codec": "bitmap",
        "at": 4, "telemetry": False} for q in FIELDS]
    + [{"tag": "bfs_dir_tel", "query": "bfs", "direction": True,
        "codec": "bitmap", "at": 4, "telemetry": True},
       {"tag": "cc_td_tel", "query": "cc", "direction": False,
        "codec": "bitmap", "at": 3, "telemetry": True}])
ELASTIC_CASES = ([{"tag": q, "query": q, "kind": "persistent"}
                  for q in ("bfs", "cc", "sssp", "mbfs")]
                 + [{"tag": "bfs_repeated", "query": "bfs",
                     "kind": "repeated"}])


def dtag(direction):
    return {False: "td", True: "adaptive"}.get(direction, direction)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tensors here are tiny; on a busy machine (a parallel
    test run) torch's intra-op thread pool only waits for busy cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gdata():
    edges = np.asarray(jax_rmat_edges(jax.random.key(3), SCALE, EF))
    w = ((np.abs(edges[0] * 31 + edges[1]) % 254) + 1).astype(np.uint8)
    deg = np.bincount(edges[0], minlength=N)
    roots = np.random.default_rng(0).choice(np.flatnonzero(deg > 0), 4,
                                            replace=False).astype(np.int32)
    return edges, w, roots


@pytest.fixture(scope="module")
def graphs(gdata):
    """One weighted port graph per grid; sessions pick their config."""
    edges, w, _ = gdata
    return {g: DistGraph.from_edges(edges, BFSConfig(grid=g), device="cpu",
                                    n=N, weights=w)
            for g in ((1, 1), (2, 2))}


@pytest.fixture(scope="module")
def jax_graph(gdata):
    edges, w, _ = gdata
    return JaxDistGraph.from_edges(edges, JaxBFSConfig(grid=(1, 1)), n=N,
                                   weights=w)


def _cfg(cls, grid, direction=False, codec="list", ft=False, K=1,
         telemetry=False):
    return cls(grid=grid, edge_chunk=512, direction=direction,
               fold_codec=codec, fault_tolerance=ft, ckpt_every=K,
               telemetry=telemetry)


def _session(graphs, grid, **kw):
    return graphs[grid].session(_cfg(BFSConfig, grid, **kw))


def _jax_session(jax_graph, **kw):
    return jax_graph.session(_cfg(JaxBFSConfig, (1, 1), **kw))


def _arg(query, roots):
    return {"bfs1": int(roots[0]), "bfs": roots[:2], "cc": None,
            "sssp": roots[:2], "mbfs": roots}[query]


def _run(sess, query, roots, **kw):
    arg = _arg(query, roots)
    return getattr(sess, METHODS[query])(*(() if arg is None else (arg,)),
                                         **kw)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _put(ref, prefix, res, fields):
    """A JAX output under the subprocess's keys."""
    for f in fields:
        ref[f"{prefix}_{f}"] = np.asarray(getattr(res, f))
    ref[f"{prefix}_edges"] = np.asarray(res.edges_scanned, np.int64)
    if res.directions is not None:
        ref[f"{prefix}_directions"] = np.asarray(res.directions)


def _assert_ref(out, ref, prefix, query, n=None, edges=True):
    """A port output against JAX arrays under `prefix` (n: compare the
    first n vertices -- a shrunken grid pads differently; edges=False:
    leave edges_scanned out)."""
    cut = (lambda a: a) if n is None else (lambda a: a[..., :n])
    for f in FIELDS[query]:
        want = ref[f"{prefix}_{f}"]
        got = _np(getattr(out, f))
        if f in ("n_levels", "n_iters"):
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_array_equal(cut(got), cut(want), err_msg=f)
    if edges:
        assert np.array_equal(np.asarray(out.edges_scanned, np.int64),
                              ref[f"{prefix}_edges"])
    want_dirs = ref.get(f"{prefix}_directions")
    if want_dirs is None:
        assert out.directions is None
    else:
        np.testing.assert_array_equal(_np(out.directions), want_dirs)


def _assert_same(out, base):
    """Two port outputs equal in every field but the trace."""
    assert type(out) is type(base)
    for f in dataclasses.fields(out):
        if f.name == "trace":
            continue
        a, b = getattr(out, f.name), getattr(base, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def _assert_tree(a, b, path=""):
    """Nested dicts of arrays equal: keys, dtypes, shapes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_tree(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), path
    np.testing.assert_array_equal(a, b, err_msg=path)


def _assert_snapshots(a, b):
    _assert_tree(a["arrays"], b["arrays"])
    assert a["meta"] == b["meta"]


def _loss_snapshot(sess, query, roots, at, err=UnrecoverableLoss,
                   plan_cls=RecoveryPlan, inj_cls=DeviceLossInjector,
                   policy_cls=RetryPolicy):
    """The UnrecoverableLoss snapshot of `query` under a loss crossing
    level `at`, retries off."""
    plan = plan_cls(injector=inj_cls(at, fires=1),
                    policy=policy_cls(max_retries=0))
    with pytest.raises(err) as ei:
        _run(sess, query, roots, recovery=plan)
    return ei.value.snapshot


def _dirs_done(snap):
    """The direction list a snapshot records (first query of a batch)."""
    st = snap["arrays"]["st"]
    st = st.get("b0", st)
    return st["dirs"][:int(st["k"])].tolist()


# ----------------------------------------------------------------------------
# Segmented bit-identity
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_1x1(gdata, jax_graph):
    """The JAX package's unsegmented outputs at 1x1, every config."""
    _, _, roots = gdata
    ref = {}
    for direction, codec in CONFIGS:
        sess = _jax_session(jax_graph, direction=direction, codec=codec)
        for q, fields in FIELDS.items():
            _put(ref, f"ft_1x1_{dtag(direction)}_{codec}_{q}",
                 _run(sess, q, roots), fields)
    return ref


@pytest.fixture(scope="module")
def ref_2x2(gdata, graphs, tmp_path_factory):
    """One JAX run at 2x2 (tests/dist/torch_parity_ref.py --ft): the
    unsegmented outputs of every config, JAX's loss snapshots of every
    SNAP_CASES entry (written as checkpoint directories), JAX's resume of
    the port's snapshots of the same cases (which this fixture writes
    first, as checkpoint directories) and JAX's elastic runs."""
    edges, w, roots = gdata
    d = tmp_path_factory.mktemp("ft_ref")
    with open(d / "cases.json", "w") as f:
        json.dump({"configs": CONFIGS, "snapshots": SNAP_CASES,
                   "elastic": ELASTIC_CASES}, f)
    snaps = {}
    for case in SNAP_CASES:
        sess = _session(graphs, (2, 2), direction=case["direction"],
                        codec=case["codec"], ft=True,
                        telemetry=case["telemetry"])
        snap = _loss_snapshot(sess, case["query"], roots, case["at"])
        ck = TraversalCheckpointer(str(d / f"torch_2x2_{case['tag']}"),
                                   case["tag"])
        ck.save(snap)
        ck.join()
        snaps[case["tag"]] = snap
    np.savez(d / "in.npz", edges=edges, roots=roots, n=N, weights=w)
    res = subprocess.run(
        [sys.executable, REF_SCRIPT, str(d / "in.npz"), str(d / "out.npz"),
         "2x2", "--ft", str(d)], capture_output=True, text=True,
        timeout=900, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stdout + res.stderr
    return {"ref": dict(np.load(d / "out.npz")), "dir": d, "snaps": snaps}


@pytest.mark.parametrize("direction,codec", CONFIGS)
def test_segmented_equals_unsegmented_and_jax_1x1(gdata, graphs, jax_1x1,
                                                  direction, codec):
    _, _, roots = gdata
    base = _session(graphs, (1, 1), direction=direction, codec=codec)
    for K in (1, 2, 5):
        sess = _session(graphs, (1, 1), direction=direction, codec=codec,
                        ft=True, K=K)
        for q in FIELDS:
            out = _run(sess, q, roots)
            _assert_same(out, _run(base, q, roots))
            _assert_ref(out, jax_1x1, f"ft_1x1_{dtag(direction)}_{codec}_{q}",
                        q)


@pytest.mark.parametrize("direction,codec", CONFIGS)
def test_segmented_equals_unsegmented_and_jax_2x2(gdata, graphs, ref_2x2,
                                                  direction, codec):
    _, _, roots = gdata
    base = _session(graphs, (2, 2), direction=direction, codec=codec)
    for K in (1, 2, 5):
        sess = _session(graphs, (2, 2), direction=direction, codec=codec,
                        ft=True, K=K)
        for q in FIELDS:
            out = _run(sess, q, roots)
            _assert_same(out, _run(base, q, roots))
            _assert_ref(out, ref_2x2["ref"],
                        f"ft_2x2_{dtag(direction)}_{codec}_{q}", q)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
def test_segment_boundaries_add_no_level_work(gdata, graphs, grid):
    """The segmented loop (K = 1) plans and reads exactly the levels the
    unsegmented loop does: one `program.plan` (and one host read of its
    counts) a level, plus the first."""
    _, _, roots = gdata
    calls = {}
    for ft in (False, True):
        sess = _session(graphs, grid, direction=True, codec="bitmap", ft=ft)
        prog = sess.engine.program
        n = [0]
        orig = prog.plan

        def counted(*a, _orig=orig, _n=n):
            _n[0] += 1
            return _orig(*a)

        prog.plan = counted
        try:
            sess.bfs(int(roots[0]))
        finally:
            del prog.plan
        calls[ft] = n[0]
    assert calls[True] == calls[False]


def test_ft_off_engine_refuses_segments(gdata, graphs):
    """fault_tolerance=False builds the engine as before: its segmented
    entry points refuse, and the flags key a separate engine."""
    _, _, roots = gdata
    off = _session(graphs, (1, 1))
    on = _session(graphs, (1, 1), ft=True, K=2)
    assert not off.engine.fault_tolerance and on.engine is not off.engine
    assert on.engine.fault_tolerance and on.engine.ckpt_every == 2
    with pytest.raises(ValueError, match="fault_tolerance=True"):
        off.engine.ft_start(graphs[(1, 1)].csc, int(roots[0]))


# ----------------------------------------------------------------------------
# The carry
# ----------------------------------------------------------------------------

def _snapshot_carry(x):
    """A deep host copy of a carry (tensors, lists, dicts, dataclasses)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", x.dtype, x.clone())
    if dataclasses.is_dataclass(x):
        return {f.name: _snapshot_carry(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _snapshot_carry(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_snapshot_carry(v) for v in x]
    return x


def _assert_carry_equal(a, b, path=""):
    if isinstance(a, tuple) and a and a[0] == "tensor":
        assert b[0] == "tensor" and a[1] == b[1], path
        assert torch.equal(a[2], b[2]), path
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_carry_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for k, (x, y) in enumerate(zip(a, b)):
            _assert_carry_equal(x, y, f"{path}[{k}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("query,direction,telemetry", [
    ("bfs", False, True), ("bfs", True, False), ("cc", True, True),
    ("sssp", False, False), ("mbfs", True, False)])
def test_segment_leaves_input_carry_untouched(gdata, graphs, grid, query,
                                             direction, telemetry):
    """ft_segment works on clones: the input carry -- states, plans, read
    counts, totals, traces -- is unchanged after a segment, and a second
    segment from it (a retry) gives the same carry as the first."""
    _, _, roots = gdata
    sess = _session(graphs, grid, direction=direction, codec="bitmap",
                    ft=True, K=2, telemetry=telemetry)
    eng, csc = sess.engine, graphs[grid].csc
    extra = sess.extra
    if query != "bfs":
        extra = sess._algo_csr_extra(weights=query == "sssp")
        if query == "sssp":
            extra = (graphs[grid].weights,) + extra
        program, max_levels = {
            "cc": (ConnectedComponentsProgram, N + 1),
            "sssp": (SSSPProgram, N + 1),
            "mbfs": (MultiSourceBFSProgram, sess.config.max_levels)}[query]
        eng = sess._algo_engine(program(), None, max_levels)
    arg = _arg(query, roots)
    batched = query in ("bfs", "sssp")
    carry = eng.ft_start(csc, list(arg) if batched else arg, *extra,
                         batched=batched)
    for _ in range(2):              # mid-search too, not only at init
        before = _snapshot_carry(carry)
        out1 = eng.ft_segment(csc, carry, *extra, batched=batched)
        _assert_carry_equal(_snapshot_carry(carry), before)
        out2 = eng.ft_segment(csc, carry, *extra, batched=batched)
        _assert_carry_equal(_snapshot_carry(out2), _snapshot_carry(out1))
        carry = out1


# ----------------------------------------------------------------------------
# Retry, loss and resume
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("query", list(FIELDS))
def test_transient_loss_absorbed_by_retry(gdata, graphs, jax_graph, query):
    """One loss crossing level 2: one retry, the output unchanged, and the
    plan's stats (segments, retries, the jittered delays) equal JAX's."""
    _, _, roots = gdata
    base = _run(_session(graphs, (1, 1)), query, roots)
    policy = dict(max_retries=2, backoff_s=1e-4, jitter_s=1e-4, seed=7)
    plan = RecoveryPlan(injector=DeviceLossInjector(2, transient=True),
                        policy=RetryPolicy(**policy))
    out = _run(_session(graphs, (1, 1), ft=True), query, roots,
               recovery=plan)
    _assert_same(out, base)
    jplan = JaxPlan(injector=JaxInjector(2, transient=True),
                    policy=JaxRetryPolicy(**policy))
    _run(_jax_session(jax_graph, ft=True), query, roots, recovery=jplan)
    assert plan.stats["retries"] == 1 == plan.injector.count
    for k in ("segments", "retries", "delays", "resumes",
              "resumed_from_level"):
        assert plan.stats[k] == jplan.stats[k], k


@pytest.mark.parametrize("grid", [(1, 1), (2, 2)])
@pytest.mark.parametrize("query", list(FIELDS))
def test_persistent_loss_snapshot_resumes_bit_identical(gdata, graphs, grid,
                                                        query):
    """Retries exhaust -> UnrecoverableLoss carries the carry before the
    failed segment; a FRESH session resumes it to the uninterrupted
    output, predecessors included (same grid)."""
    _, _, roots = gdata
    base = _run(_session(graphs, grid), query, roots)
    policy = RetryPolicy(max_retries=1, backoff_s=1e-5)
    plan = RecoveryPlan(injector=DeviceLossInjector(2, fires=2),
                        policy=policy)
    with pytest.raises(UnrecoverableLoss) as ei:
        _run(_session(graphs, grid, ft=True), query, roots, recovery=plan)
    assert ei.value.level == 1     # K=1 segments: failed crossing into 2
    assert plan.stats["retries"] == 1
    fresh = DistGraph.from_edges(gdata[0], BFSConfig(grid=grid),
                                 device="cpu", n=N, weights=gdata[1])
    plan2 = RecoveryPlan(resume=ei.value.snapshot, policy=policy)
    out = _run(fresh.session(_cfg(BFSConfig, grid, ft=True)), query, roots,
               recovery=plan2)
    _assert_same(out, base)
    assert plan2.stats["resumes"] == 1
    assert plan2.stats["resumed_from_level"] == ei.value.level
    assert plan2.stats["time_to_first_resumed_level_s"] > 0


def test_scalar_bfs_snapshot_is_a_batch_of_one(gdata, graphs):
    """A scalar FT search runs as a batch of one, as in the JAX package:
    its snapshot's `st` holds "b0" and meta B = 1."""
    _, _, roots = gdata
    snap = _loss_snapshot(_session(graphs, (1, 1), ft=True), "bfs1", roots,
                          3)
    assert snap["meta"]["B"] == 1 and list(snap["arrays"]["st"]) == ["b0"]
    assert snap["arrays"]["scanned"].shape == (1,)


# ----------------------------------------------------------------------------
# Snapshots across the packages
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", SNAP_CASES, ids=lambda c: c["tag"])
def test_snapshots_and_resume_across_packages_1x1(gdata, graphs, jax_graph,
                                                  case):
    """JAX's snapshot == the port's, array for array and meta for meta;
    each package resumes the other's to the JAX package's uninterrupted
    output (and, under telemetry, its trace)."""
    _, _, roots = gdata
    q = case["query"]
    kw = dict(direction=case["direction"], codec=case["codec"],
              telemetry=case["telemetry"])
    jsnap = _loss_snapshot(_jax_session(jax_graph, ft=True, **kw), q, roots,
                           case["at"], err=JaxUnrecoverableLoss,
                           plan_cls=JaxPlan, inj_cls=JaxInjector,
                           policy_cls=JaxRetryPolicy)
    tsnap = _loss_snapshot(_session(graphs, (1, 1), ft=True, **kw), q, roots,
                           case["at"])
    _assert_snapshots(tsnap, jsnap)
    if case["direction"]:
        assert 1 in _dirs_done(tsnap), "snapshot precedes the switch"
    base = _run(_jax_session(jax_graph, **kw), q, roots)
    ref = {}
    _put(ref, "base", base, FIELDS[q])
    mine = _run(_session(graphs, (1, 1), ft=True, **kw), q, roots,
                recovery=RecoveryPlan(resume=jsnap))
    _assert_ref(mine, ref, "base", q)
    theirs = _run(_jax_session(jax_graph, ft=True, **kw), q, roots,
                  recovery=JaxPlan(resume=tsnap))
    ref2 = {}
    _put(ref2, "x", theirs, FIELDS[q])
    _assert_ref(mine, ref2, "x", q)
    if case["telemetry"]:
        for got, want in zip(_traces(mine), _traces(base)):
            _assert_trace(got, want)


def _traces(out):
    return out.trace if isinstance(out.trace, tuple) else (out.trace,)


def _assert_trace(got, want):
    assert (got.program, got.codec, tuple(got.grid), got.n_levels) == \
        (want.program, want.codec, tuple(want.grid), int(want.n_levels))
    for f in dataclasses.fields(want):
        if f.name in ("program", "codec", "grid", "n_levels"):
            continue
        np.testing.assert_array_equal(np.asarray(getattr(got, f.name)),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("case", SNAP_CASES, ids=lambda c: c["tag"])
def test_snapshots_and_resume_across_packages_2x2(gdata, graphs, ref_2x2,
                                                  case):
    """At 2x2, through checkpoint directories both ways: the JAX
    directory's snapshot equals the port's; the port resumes it to what
    JAX's resume of the port's directory gives, field for field, and to
    the uninterrupted JAX output.

    One exception, the reference's own: a direction-optimised BFS resumed
    on a grid with more than one processor counts fewer bottom-up
    `edges_scanned` than the uninterrupted search (here 840 against 843),
    in the JAX package as in the port.  The import rebuilds every
    processor's visited cache from the global levels, a superset of the
    cache the uninterrupted search grew, and the bottom-up workload skips
    visited rows.  Levels, preds and directions stay equal."""
    _, _, roots = gdata
    q, tag = case["query"], case["tag"]
    ref = ref_2x2["ref"]
    jsnap = TraversalCheckpointer(str(ref_2x2["dir"] / f"jax_2x2_{tag}"),
                                  tag).load()
    _assert_snapshots(ref_2x2["snaps"][tag], jsnap)
    if case["direction"]:
        assert 1 in _dirs_done(jsnap), "snapshot precedes the switch"
    sess = _session(graphs, (2, 2), direction=case["direction"],
                    codec=case["codec"], ft=True,
                    telemetry=case["telemetry"])
    mine = _run(sess, q, roots, recovery=RecoveryPlan(resume=jsnap))
    base_key = f"ft_2x2_{dtag(case['direction'])}_{case['codec']}_{q}"
    _assert_ref(mine, ref, f"ftx_2x2_{tag}", q)
    bottomup_bfs = case["direction"] and q.startswith("bfs")
    _assert_ref(mine, ref, base_key, q, edges=not bottomup_bfs)
    if bottomup_bfs:
        assert np.asarray(mine.edges_scanned).sum() \
            < ref[f"{base_key}_edges"].sum()


def test_checkpoint_directories_across_packages(gdata, graphs, jax_graph,
                                                tmp_path):
    """A directory written step by step by JAX's TraversalCheckpointer
    (through its CheckpointManager) resumes in the port after the query
    died, and the reverse; a different query_key is refused by both."""
    _, _, roots = gdata
    base = _run(_session(graphs, (1, 1)), "sssp", roots)
    ref = {}
    _put(ref, "base", _run(_jax_session(jax_graph), "sssp", roots),
         FIELDS["sssp"])
    policy = dict(max_retries=0, backoff_s=0.0)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    with pytest.raises(JaxUnrecoverableLoss):
        _run(_jax_session(jax_graph, ft=True), "sssp", roots,
             recovery=JaxPlan(checkpointer=JaxCheckpointer(jd, "q1"),
                              injector=JaxInjector(3, fires=1),
                              policy=JaxRetryPolicy(**policy)))
    plan = RecoveryPlan(checkpointer=TraversalCheckpointer(jd, "q1"),
                        policy=RetryPolicy(**policy))
    out = _run(_session(graphs, (1, 1), ft=True), "sssp", roots,
               recovery=plan)
    _assert_same(out, base)
    assert plan.stats["resumes"] == 1 and plan.stats["resumed_from_level"] \
        == 2

    with pytest.raises(UnrecoverableLoss):
        _run(_session(graphs, (1, 1), ft=True), "sssp", roots,
             recovery=RecoveryPlan(
                 checkpointer=TraversalCheckpointer(td, "q1"),
                 injector=DeviceLossInjector(3, fires=1),
                 policy=RetryPolicy(**policy)))
    assert JaxCheckpointManager(td).steps() == [1, 2]
    jplan = JaxPlan(checkpointer=JaxCheckpointer(td, "q1"),
                    policy=JaxRetryPolicy(**policy))
    theirs = _run(_jax_session(jax_graph, ft=True), "sssp", roots,
                  recovery=jplan)
    ref2 = {}
    _put(ref2, "x", theirs, FIELDS["sssp"])
    _assert_ref(out, ref2, "x", "sssp")
    _assert_ref(out, ref, "base", "sssp")
    assert jplan.stats["resumes"] == 1

    for d in (jd, td):
        with pytest.raises(ValueError, match="query_key"):
            TraversalCheckpointer(d, "OTHER").load()
        with pytest.raises(ValueError, match="query_key"):
            JaxCheckpointer(d, "OTHER").load()


# ----------------------------------------------------------------------------
# The driver's pieces
# ----------------------------------------------------------------------------

def test_injector_crossing_semantics():
    inj = DeviceLossInjector(3, transient=True)
    inj.check(0, 1)                      # below: quiet
    inj.check(3, 4)                      # already past: quiet
    with pytest.raises(DeviceLoss):
        inj.check(2, 3)                  # crossing fires
    inj.check(2, 3)                      # transient: budget spent
    assert inj.count == 1

    unbounded = DeviceLossInjector(1, devices=2)
    for _ in range(4):                   # fires=None: every crossing
        with pytest.raises(DeviceLoss) as ei:
            unbounded.check(0, 5)
        assert ei.value.devices == 2
    assert unbounded.count == 4

    with pytest.raises(ValueError, match="phase"):
        DeviceLossInjector(1, phase="warp")


@pytest.mark.parametrize("query", list(FIELDS))
def test_recovery_kwarg_requires_ft_session(gdata, graphs, query):
    _, _, roots = gdata
    with pytest.raises(ValueError, match="fault-tolerant"):
        _run(_session(graphs, (1, 1)), query, roots,
             recovery=RecoveryPlan())


def test_checkpoint_manager_layout_gc_and_errors(tmp_path):
    """The port's manager writes JAX's layout (leaves in sorted-key order,
    the manifest's fields), keeps the last `keep` steps, restores by
    example and by paths, and re-raises a failed async write."""
    tree = {"b": {"y": np.arange(3, dtype=np.int64), "x": np.float32(2.5)},
            "a": np.zeros((2, 2), np.int32), "c": np.asarray(True)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree, extra_meta={"step_is": step})
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest() == 3
    jtree, _ = JaxCheckpointManager(str(tmp_path)).restore_tree()
    _assert_tree(jtree, tree)
    jref = str(tmp_path / "jax")
    JaxCheckpointManager(jref, async_write=False).save(3, tree,
                                                       {"step_is": 3})
    with open(os.path.join(jref, "step_3", "manifest.json")) as f:
        want = json.load(f)
    with open(tmp_path / "step_3" / "manifest.json") as f:
        got = json.load(f)
    assert {k: v for k, v in got.items() if k != "treedef"} == \
        {k: v for k, v in want.items() if k != "treedef"}
    restored, man = mgr.restore({"a": 0, "b": {"x": 0, "y": 0}, "c": 0})
    _assert_tree(restored, tree)
    assert man["meta"] == {"step_is": 3}
    mine, _ = CheckpointManager(jref).restore_tree()
    _assert_tree(mine, tree)

    bad = CheckpointManager(str(tmp_path / "bad"))
    os.rmdir(bad.dir)
    open(bad.dir, "w").close()           # a file where the directory was
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()


@pytest.mark.parametrize("R,C", [(1, 1), (2, 2), (1, 3), (3, 2)])
def test_global_layout_views(R, C):
    """The import's views of a global-order vector: every local row holds
    its vertex (`rows_to_global`, JAX's index map), and the owned blocks
    invert `global_order`."""
    from repro.algos.program import rows_to_global as jax_rows_to_global
    from repro.core.types import Grid2D as JaxGrid2D
    from repro_torch.algos import program as PR
    from repro_torch.core.types import Grid2D

    grid = Grid2D.for_vertices(50, R, C)
    g = torch.arange(grid.n, dtype=torch.int32) * 7 + 3
    rows = PR.rows_from_global(g, grid)
    for i in range(R):
        want = PR.rows_to_global(grid, i)
        assert np.array_equal(want, jax_rows_to_global(
            JaxGrid2D(R, C, grid.n), i))
        for j in range(C):
            assert torch.equal(rows[i, j], g[torch.from_numpy(want)])
    assert torch.equal(PR.global_order(PR.owned_from_global(g, grid)), g)


def test_shrink_grid_and_reshard_state():
    for R, C, failed in ((2, 2, 1), (2, 2, 2), (2, 4, 2), (4, 4, 1),
                         (1, 4, 1), (3, 3, 4)):
        assert shrink_grid(R, C, failed) == jax_shrink_grid(R, C, failed)
    assert shrink_grid(2, 2, 1) == (1, 3)
    with pytest.raises(ValueError, match="no devices left"):
        shrink_grid(1, 2, 2)
    placed = reshard_state({"a": np.arange(4, dtype=np.int32),
                            "b": {"c": np.asarray(True)}}, "cpu")
    assert torch.equal(placed["a"], torch.arange(4, dtype=torch.int32))
    assert placed["b"]["c"].dtype == torch.bool and bool(placed["b"]["c"])


# ----------------------------------------------------------------------------
# Elastic shrink-and-resume
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ELASTIC_CASES, ids=lambda c: c["tag"])
def test_elastic_shrink_2x2_to_1x3(gdata, graphs, ref_2x2, case):
    """A persistent loss at level 2 on 2x2 shrinks to 1x3 (twice for the
    repeated loss: 1x3, then 1x2) and resumes: every grid-independent field
    equals the uninterrupted run, BFS preds pass the Graph500 rules and
    equal JAX's elastic run of the same query (the port matches JAX on
    each grid); grids and stats equal JAX's."""
    edges, w, roots = gdata
    q, tag = case["query"], case["tag"]
    losses = 2 if case["kind"] == "repeated" else 1
    policy = RetryPolicy(max_retries=2, backoff_s=1e-4, jitter_s=1e-4,
                         seed=1)
    plan = RecoveryPlan(injector=DeviceLossInjector(
        2, fires=(policy.max_retries + 1) * losses), policy=policy)
    coord = ElasticCoordinator(edges, BFSConfig(
        grid=(2, 2), edge_chunk=512, fault_tolerance=True, ckpt_every=1),
        weights=w, n=N, device="cpu", max_shrinks=losses + 1)
    out = coord.run(METHODS[q], _arg(q, roots), plan=plan)
    ref = ref_2x2["ref"]
    want_grids = [tuple(g) for g in ref[f"el_2x2_{tag}_grids"].tolist()]
    assert coord.grids == want_grids
    assert coord.grids == ([(2, 2), (1, 3)] if losses == 1
                           else [(2, 2), (1, 3), (1, 2)])
    assert coord.shrinks == losses
    assert [plan.stats["resumes"], plan.stats["segments"],
            plan.stats["retries"], plan.stats["resumed_from_level"]] == \
        ref[f"el_2x2_{tag}_stats"].tolist()
    _assert_ref(out, ref, f"el_2x2_{tag}", q, n=N)
    base = _run(_session(graphs, (2, 2)), q, roots)
    for f in FIELDS[q]:
        if f == "pred":
            continue
        a, b = getattr(out, f), getattr(base, f)
        assert torch.equal(a[..., :N] if a.dim() else a,
                           b[..., :N] if b.dim() else b), f
    assert out.edges_scanned == base.edges_scanned
    if q == "bfs":
        e = torch.from_numpy(edges.astype(np.int32))
        for b, root in enumerate(roots[:2]):
            validate_bfs(e, out.level[b][:N], out.pred[b][:N], int(root))
