"""The port across a real `torch.distributed` process group: every rank's
session outputs equal the JAX package's, bit for bit.

Each layout spawns its ranks on the CPU under gloo
(`tests/dist/torch_run_multihost.py`, a `file://` store under the test's
temporary directory) and plans the graph of `tests/dist/run_multihost.py`
(`np.random.default_rng(7)`, SCALE 9, EF 8, symmetrised, uint8 weights)
with `DistGraph.from_edges(..., mesh=multihost.global_mesh(...))`, each rank
building only its blocks:

  * 1x4 over 4 ranks, one processor each;
  * 1x4 over 2 ranks of (1, 2) -- JAX's `run_multihost.py 2 2`;
  * 2x2 over 4 ranks;
  * 2x2 over 2 ranks, each holding a grid row (the row gather crosses
    ranks, the fold does not).

Every rank runs bfs(3), bfs([1, 5, 3]), connected_components(), sssp(3)
and multi_bfs([1, 5, 3]) under the flat and the butterfly exchange, for
top-down under the list codec and direction-optimised (adaptive) under the
bitmap and the delta codec -- the adaptive searches run top-down levels as
well, so every codec's set and value folds cross the group, the bitmap's
32-bit and the delta codec's 16-bit words included.  Every field (levels,
preds, n_levels, exact edges_scanned, labels, distances, multi-BFS levels
and sources, the directions trace) of every rank is held to one JAX run of
the same queries (`tests/dist/torch_parity_ref.py --multihost --cover`,
forced host devices, flat exchange, whose outputs the JAX butterfly
equals), which runs while the first group does.  Every group launch has
its own deadline and kills its ranks on expiry.

The features of the search's contract across the group (ROADMAP A13 part
2), on the same graph with edge_chunk 512, held to the JAX package:

  * telemetry: the `LevelTrace` of every query, top-down under list and
    adaptive under bitmap, at 1x4 over 4 ranks and 2x2 over 2 ranks of
    two processors, field for field equal to JAX's
    (`torch_parity_ref.py --multihost --telemetry --traced`);
  * at 2x2 over 4 ranks (`torch_run_multihost.py --mode features`):
    `bfs(validate=True | edges)` passing, six corruptions of one output
    each failing the same rule on every rank, with JAX's message, under
    both shares, and "released" after `release_edges()`; every query
    segmented with ckpt_every 1 and 2 equal to the unsegmented group run
    and to JAX's; a transient loss retried once; the loss snapshots of six
    cases (every program, direction-optimised, telemetry) equal to JAX's
    array for array and meta for meta, written as checkpoint directories
    by rank 0 and read back by every rank; each package resuming the
    other's directories to equal outputs (`torch_parity_ref.py --ft`, then
    `--mode resume`); the elastic shrink 2x2 -> 1x3 of BFS and CC equal to
    JAX's `ElasticCoordinator` (grids, stats, outputs) on every rank, the
    rank outside the survivor grid included;
  * at 2x2 over 2 ranks of two processors: the shrink to 1x3 refused with
    the same ValueError on both ranks.
"""
import json
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

DIST = os.path.join(os.path.dirname(__file__), "dist")
spec = importlib.util.spec_from_file_location(
    "torch_run_multihost", os.path.join(DIST, "torch_run_multihost.py"))
TMH = importlib.util.module_from_spec(spec)
spec.loader.exec_module(TMH)

LAYOUTS = {"1x4-4ranks": ("4", "1", "--grid", "1x4"),
           "1x4-2ranks": ("2", "2", "--grid", "1x4"),
           "2x2-4ranks": ("4", "1", "--grid", "2x2"),
           "2x2-2ranks": ("2", "2", "--grid", "2x2")}
GROUP_TIMEOUT = 120        # seconds a group launch may take
REF_TIMEOUT = 300          # seconds the JAX reference may take


def _child(args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen(
        [sys.executable, os.path.join(DIST, "torch_parity_ref.py"), *args],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _waiter(proc, out_path):
    """A function waiting for a JAX child and returning its outputs."""
    box = {}

    def wait():
        if "ref" not in box:
            try:
                out, _ = proc.communicate(timeout=REF_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                raise AssertionError("the JAX reference did not finish in "
                                     f"{REF_TIMEOUT} s")
            assert proc.returncode == 0, f"the JAX reference failed:\n{out}"
            box["ref"] = dict(np.load(out_path))
        return box["ref"]
    return wait


def _inputs(d):
    n, edges, w = TMH.make_inputs(9)
    src = str(d / "edges.npz")
    np.savez(src, edges=edges, roots=np.asarray(TMH.BATCH, np.int32), n=n,
             weights=w)
    return src


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX outputs of both grids, computed in two children that start
    at the first use and run beside the first groups: "cover" (the
    LAYOUTS configs) and "traced" (top-down under list and adaptive under
    bitmap with telemetry).  Returns a function that waits for the named
    child and gives its .npz."""
    td = tmp_path_factory.mktemp("jax_ref")
    src = _inputs(td)
    refs = {name: str(td / f"{name}.npz") for name in ("cover", "traced")}
    procs = {
        "cover": _child([src, refs["cover"], "1x4", "2x2", "--multihost",
                         "--cover"]),
        "traced": _child([src, refs["traced"], "1x4", "2x2", "--multihost",
                          "--telemetry", "--traced"])}
    waits = {k: _waiter(p, refs[k]) for k, p in procs.items()}

    def wait(name="cover"):
        waits[name]()
        return refs[name]

    yield wait
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_group_outputs_equal_jax(layout, jax_ref, tmp_path):
    """Every output field on every rank equals the JAX package's, under
    the flat and the butterfly exchange."""
    argv = list(LAYOUTS[layout]) + ["both", "--configs", "cover",
                                    "--timeout", str(GROUP_TIMEOUT)]
    a, _ = TMH.run_group(argv, str(tmp_path))
    n_keys = TMH.compare(a, jax_ref(), str(tmp_path))
    # 3 configs x 5 queries x >= 4 fields x 2 exchanges x every rank
    assert n_keys >= 3 * 5 * 4 * 2 * a.nproc


def test_block_shapes_and_refusals():
    """A world whose runs of processors are not rectangles is refused with
    a ValueError; the blocks of the rectangular ones are JAX's
    device-to-process assignment (row-major runs)."""
    from repro_torch.dist.multihost import block_shape
    assert block_shape(2, 2, 4) == (1, 1)
    assert block_shape(2, 2, 2) == (1, 2)
    assert block_shape(1, 4, 2) == (1, 2)
    assert block_shape(4, 2, 2) == (2, 2)
    assert block_shape(2, 4, 1) == (2, 4)
    assert block_shape(2, 3, 2) == (1, 3)
    with pytest.raises(ValueError, match="not a rectangle"):
        block_shape(3, 4, 2)            # runs of 6 on rows of 4
    with pytest.raises(ValueError, match="not a multiple"):
        block_shape(2, 2, 3)


# ----------------------------------------------------------------------------
# Telemetry, validation, fault tolerance and the elastic shrink in a group
# ----------------------------------------------------------------------------

TRACE_LAYOUTS = {"1x4-4ranks": ("4", "1", "--grid", "1x4"),
                 "2x2-2ranks": ("2", "2", "--grid", "2x2")}
FEATURES_GRID = "2x2"
N = 1 << 9


@pytest.fixture(scope="module")
def features(tmp_path_factory):
    """The features group at 2x2 over 4 ranks, then JAX's `--ft` run in a
    child (its unsegmented and elastic outputs, its loss snapshots as
    checkpoint directories, its resume of the group's), whose outputs
    `ft_ref()` waits for, and `resumed()`: the group resuming JAX's
    directories (after the child)."""
    d = tmp_path_factory.mktemp("features")
    g1 = d / "g1"
    g1.mkdir()
    TMH.run_group(["4", "1", "--grid", FEATURES_GRID, "--mode", "features",
                   "--ftdir", str(d), "--timeout", str(GROUP_TIMEOUT)],
                  str(g1))
    ranks = [dict(np.load(g1 / f"rank{k}.npz")) for k in range(4)]
    msgs = [json.loads((g1 / f"rank{k}.json").read_text())
            for k in range(4)]
    with open(d / "cases.json", "w") as f:
        json.dump({"configs": TMH.FT_CONFIGS, "snapshots": TMH.SNAP_CASES,
                   "elastic": TMH.ELASTIC_CASES}, f)
    ref = str(d / "ref.npz")
    proc = _child([_inputs(d), ref, FEATURES_GRID, "--ft", str(d)])
    ft_ref = _waiter(proc, ref)
    box = {}

    def resumed():
        if "ranks" not in box:
            ft_ref()
            g2 = d / "g2"
            g2.mkdir()
            TMH.run_group(["4", "1", "--grid", FEATURES_GRID, "--mode",
                           "resume", "--ftdir", str(d), "--timeout",
                           str(GROUP_TIMEOUT)], str(g2))
            box["ranks"] = [dict(np.load(g2 / f"rank{k}.npz"))
                            for k in range(4)]
        return box["ranks"]

    yield {"dir": d, "ranks": ranks, "msgs": msgs, "ft_ref": ft_ref,
           "resumed": resumed}
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _held(ranks, ref, ref_prefix, prefix):
    """Every rank's arrays under `prefix` equal the reference's under
    `ref_prefix`, key for key."""
    keys = [k for k in ref if k.startswith(ref_prefix)]
    assert keys, ref_prefix
    for r, got in enumerate(ranks):
        mine = [k for k in got if k.startswith(prefix)]
        assert len(mine) == len(keys), (r, prefix)
        for k in keys:
            g, w = got[prefix + k[len(ref_prefix):]], ref[k]
            assert g.shape == w.shape and (g == w).all(), (r, k)


@pytest.mark.parametrize("kind", TMH.CORRUPTIONS)
def test_group_validate_fails_together(kind, features):
    """One corrupted output fails the same Graph500 rule on every rank,
    under the blocks' share (validate=True) and the array's slices
    (validate=edges), with the JAX package's message."""
    from repro.core.validate import validate_bfs as jax_validate_bfs
    n, edges, _ = TMH.make_inputs(9)
    got = features["ranks"][0]
    root = TMH.BATCH[0]
    bl, bp = TMH.corrupt(kind, got["validate_level"],
                         got["validate_pred"], root, edges)
    with pytest.raises(AssertionError) as ei:
        jax_validate_bfs(edges, bl, bp, root)
    for share in ("blocks", "slice"):
        said = [m[f"corrupt:{kind}:{share}"] for m in features["msgs"]]
        assert said == [str(ei.value)] * 4, (share, said)


def test_group_elastic_refuses_partial_ranks(tmp_path):
    """Over 2 ranks of two processors the 1x3 survivor grid is not a whole
    number of ranks: both ranks raise the same ValueError naming it."""
    TMH.run_group(["2", "2", "--grid", "2x2", "--mode", "features",
                   "--sections", "refusal", "--ftdir", str(tmp_path),
                   "--timeout", str(GROUP_TIMEOUT)], str(tmp_path))
    said = [json.loads((tmp_path / f"rank{k}.json").read_text())
            ["elastic_error:bfs"] for k in range(2)]
    assert said[0] == said[1]
    assert "1x3" in said[0] and "not a multiple of the 2" in said[0]


@pytest.mark.parametrize("layout", sorted(TRACE_LAYOUTS))
def test_group_traces_equal_jax(layout, jax_ref, tmp_path):
    """With telemetry=True every query's outputs and `LevelTrace` (every
    channel, per processor and global) equal JAX's on every rank."""
    argv = list(TRACE_LAYOUTS[layout]) + [
        "flat", "--configs", "traced", "--telemetry", "--timeout",
        str(GROUP_TIMEOUT)]
    a, _ = TMH.run_group(argv, str(tmp_path))
    n_keys = TMH.compare(a, jax_ref("traced"), str(tmp_path))
    got = np.load(tmp_path / "rank0.npz")
    assert sum("_trace0_" in k for k in got.files) >= 2 * 5 * 15
    assert n_keys >= 2 * 5 * (4 + 15) * a.nproc


def test_group_validate_passes_and_refuses_released(features):
    """bfs(validate=True | edges) pass on every rank (the output validated
    equals JAX's), and validate=True after release_edges() raises
    "released" on every rank."""
    ref = features["ft_ref"]()
    for got in features["ranks"]:
        np.testing.assert_array_equal(got["validate_level"],
                                      ref["ft_2x2_td_list_bfs_level"][0])
        np.testing.assert_array_equal(got["validate_pred"],
                                      ref["ft_2x2_td_list_bfs_pred"][0])
    said = {m["released"] for m in features["msgs"]}
    assert len(said) == 1 and "released" in said.pop()


@pytest.mark.parametrize("K", [1, 2])
def test_group_segmented_equals_jax(K, features):
    """Every query segmented at ckpt_every=K (each rank also held it to
    its unsegmented run) equals JAX's unsegmented output, field for
    field, top-down under list and adaptive under bitmap."""
    ref = features["ft_ref"]()
    for direction, codec in TMH.FT_CONFIGS:
        ctag = f"{TMH.dtag(direction)}_{codec}"
        for q in TMH.FIELDS:
            _held(features["ranks"], ref, f"ft_2x2_{ctag}_{q}_",
                  f"seg{K}_{ctag}_{q}_")


def test_group_transient_loss_retried(features):
    """A transient loss crossing level 3 is retried once on every rank,
    with the same delay, and the output equals JAX's."""
    ref = features["ft_ref"]()
    stats = [m["transient"] for m in features["msgs"]]
    assert stats[0]["retries"] == 1 and stats == [stats[0]] * 4
    _held(features["ranks"], ref, "ft_2x2_td_list_bfs_", "transient_bfs_")


@pytest.mark.parametrize("case", TMH.SNAP_CASES, ids=lambda c: c["tag"])
def test_group_snapshots_equal_jax(case, features):
    """The loss snapshot every rank exports equals JAX's array for array
    (dtypes, shapes, values) and meta for meta; the checkpoint directory
    rank 0 wrote is read back by every rank."""
    from repro.runtime import TraversalCheckpointer as JaxCheckpointer
    features["ft_ref"]()
    tag = case["tag"]
    jsnap = JaxCheckpointer(str(features["dir"] / f"jax_2x2_{tag}"),
                            tag).load()
    want = {}
    TMH.flat_tree(want, f"snap_{tag}", jsnap["arrays"])
    for got, msgs in zip(features["ranks"], features["msgs"]):
        mine = {k: v for k, v in got.items() if k.startswith(f"snap_{tag}/")}
        assert sorted(mine) == sorted(want)
        for k, v in want.items():
            assert mine[k].dtype == v.dtype and mine[k].shape == v.shape, k
            np.testing.assert_array_equal(mine[k], v, err_msg=k)
        assert msgs[f"snap_meta:{tag}"] == jsnap["meta"]
        assert msgs[f"snap_loaded:{tag}"] == jsnap["meta"]


@pytest.mark.parametrize("case", TMH.SNAP_CASES, ids=lambda c: c["tag"])
def test_group_checkpoints_resume_across_packages(case, features):
    """JAX resumes the group's checkpoint directory, and the group resumes
    JAX's, to equal outputs (traces included), which equal the
    uninterrupted JAX run (a direction-optimised BFS resumed on more than
    one processor counts fewer bottom-up edges, in both packages: ROADMAP
    C notes)."""
    ref = features["ft_ref"]()
    tag, q = case["tag"], case["query"]
    ranks = features["resumed"]()
    _held(ranks, ref, f"ftx_2x2_{tag}_", f"ftx_{tag}_")
    base = f"ft_2x2_{TMH.dtag(case['direction'])}_{case['codec']}_{q}_"
    for f in TMH.FIELDS[q]:
        for got in ranks:
            np.testing.assert_array_equal(got[f"ftx_{tag}_{f}"],
                                          ref[base + f], err_msg=f)


@pytest.mark.parametrize("tag", [c["tag"] for c in TMH.ELASTIC_CASES])
def test_group_elastic_2x2_to_1x3(tag, features):
    """A persistent loss at level 2 shrinks the group's 2x2 grid to 1x3
    over ranks 0-2 and resumes from the snapshot; every rank (rank 3
    through rank 0's hand-over) returns JAX's elastic output, grids and
    stats."""
    ref = features["ft_ref"]()
    keys = [k for k in ref if k.startswith(f"el_2x2_{tag}_")
            and not k.endswith(("_grids", "_stats"))]
    for got in features["ranks"]:
        for k in keys:
            g = got[f"el_{tag}_" + k[len(f"el_2x2_{tag}_"):]]
            w = ref[k]
            np.testing.assert_array_equal(g[..., :N] if g.ndim else g,
                                          w[..., :N] if w.ndim else w,
                                          err_msg=k)
    for m in features["msgs"]:
        el = m[f"elastic:{tag}"]
        assert [tuple(g) for g in el["grids"]] == [(2, 2), (1, 3)]
        assert el["grids"] == ref[f"el_2x2_{tag}_grids"].tolist()
        assert el["stats"] == ref[f"el_2x2_{tag}_stats"].tolist()
