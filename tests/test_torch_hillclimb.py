"""The port's hillclimb and experiments report (scripts/torch_hillclimb.py,
scripts/torch_gen_experiments.py) against the JAX package's
(scripts/hillclimb.py, scripts/gen_experiments.py), on the CPU:

  * the experiment table equals JAX's: scripts/hillclimb.py is read with
    `ast` (never imported or run) and every `lm_cell`, `sage_cell` and
    `bfs_cell` call's literal arguments, `multi` flag included, equal the
    port's `EXPS`, name for name and in order;
  * every LM and GraphSAGE experiment's spec has JAX's argument leaves
    and per-device shards (tests/dist/torch_dryrun_ref.py's VARIANTS,
    built with `eval_shape` only in a child on 512 forced host devices),
    and the child's VARIANTS are JAX's experiments;
  * on a 4x4 meta mesh (Table 1's scale 25): the traced BFS level scans
    one chunk of its engine's own `edge_chunk` (2^18 counts fewer bytes
    than 2^20), `dedup="sort"` sorts where the scatter claim's
    `scatter_reduce` amin was, the bitmap codec's fold wire is below the
    list codec's, and the default cell's counts are the dry run's as
    they were before the chunk repair;
  * `main` records JAX's keys (`lower_s` for `compile_s`), skips names
    already in the file, records an experiment that raises and runs the
    next one;
  * the report from a pair of result files made here: every section,
    numbers equal to the records', "(failed)" for a missing or failed
    row, no TPU figure; neither script imports JAX or the JAX package.
"""
import ast
import collections
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.bfs_rmat import build_bfs_dryrun
from repro_torch.configs.common import MeshAxes, leaf_splits, shard_shape
from repro_torch.core import frontier as F
from repro_torch.dist.compat import make_mesh
from repro_torch.launch import roofline as R

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCRIPTS = os.path.join(ROOT, "scripts")
JAX_HILLCLIMB = os.path.join(SCRIPTS, "hillclimb.py")
REF_SCRIPT = os.path.join(HERE, "dist", "torch_dryrun_ref.py")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


HC = _load("torch_hillclimb")
GEN = _load("torch_gen_experiments")
LM_SAGE = [n for n, (cell, _, _) in HC.EXPS.items() if cell != "bfs_cell"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# (a) the experiment table against scripts/hillclimb.py, read with ast
# ---------------------------------------------------------------------------

def _literal(node):
    """A literal of the JAX script: constants, dicts, tuples and `a << b`."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift):
        return _literal(node.left) << _literal(node.right)
    if isinstance(node, ast.Dict):
        return {_literal(k): _literal(v)
                for k, v in zip(node.keys, node.values)}
    if isinstance(node, ast.Tuple):
        return tuple(_literal(e) for e in node.elts)
    return ast.literal_eval(node)


@functools.lru_cache(maxsize=None)
def _jax_source():
    with open(JAX_HILLCLIMB) as f:
        return ast.parse(f.read())


def jax_table() -> dict:
    """name -> (cell, positional arguments, keyword arguments) of every
    entry of the JAX script's EXPS, in its order."""
    exps = next(n for n in ast.walk(_jax_source())
                if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "EXPS")
    out = {}
    for k, v in zip(exps.value.keys, exps.value.values):
        assert isinstance(v, ast.Lambda) and isinstance(v.body, ast.Call)
        call = v.body
        out[_literal(k)] = (call.func.id,
                            tuple(_literal(a) for a in call.args),
                            {kw.arg: _literal(kw.value)
                             for kw in call.keywords})
    return out


def jax_record_keys() -> set:
    """The keys of the JAX script's ok record: its dict(status="ok", ...)
    and the variant the cells add."""
    rec = next(n for n in ast.walk(_jax_source())
               if isinstance(n, ast.Call) and getattr(n.func, "id", "")
               == "dict" and any(kw.arg == "status" and getattr(
                   kw.value, "value", None) == "ok" for kw in n.keywords))
    return {kw.arg for kw in rec.keywords if kw.arg} | {"variant"}


def test_experiment_table_equals_jax():
    want = jax_table()
    got = {n: (cell, tuple(args), dict(kw))
           for n, (cell, args, kw) in HC.EXPS.items()}
    assert list(got) == list(want)
    assert len(got) == 15
    for name in want:
        assert got[name] == want[name], name


def test_scripts_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from) (repro|jax)\b")
    for name in ("torch_hillclimb.py", "torch_gen_experiments.py"):
        with open(os.path.join(SCRIPTS, name)) as f:
            bad = [line for line in f if pat.match(line)]
        assert bad == [], (name, bad)


# ---------------------------------------------------------------------------
# (b) the LM and GraphSAGE experiments' specs against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def jax_specs_child(tmp_path_factory):
    """The JAX child, started when the module starts so that it runs
    beside the in-process tests: (Popen, its output path)."""
    out = tmp_path_factory.mktemp("hillclimb_ref") / "ref.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.Popen([sys.executable, REF_SCRIPT, str(out)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    yield p, out
    if p.poll() is None:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def jax_specs(jax_specs_child):
    p, out = jax_specs_child
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    with open(out) as f:
        return json.load(f)


def _rows(spec, mesh):
    """[path, shape, dtype, per-device shard shape] of every argument leaf,
    as tests/dist/torch_dryrun_ref.py writes JAX's."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    assert all(leaf.device.type == "meta"
               for _, leaf, _ in leaf_splits(spec.args, spec.in_splits))
    return [[list(p), list(leaf.shape), str(leaf.dtype).replace("torch.", ""),
             list(shard_shape(leaf.shape, s, sizes))]
            for p, leaf, s in leaf_splits(spec.args, spec.in_splits)]


def test_the_childs_variants_are_the_jax_experiments(jax_specs):
    """The child builds each LM experiment's `build_lm_dryrun(module,
    shape, variant)` on its mesh and the sage cell at its dtype."""
    table = jax_table()
    for name in LM_SAGE:
        mod, shape, variant, kind = jax_specs["variant_args"][name]
        cell, args, kw = table[name]
        if cell == "lm_cell":
            assert [mod, shape, variant] == list(args) + [None] * (
                3 - len(args)), name
            assert kind == ("multi" if kw.get("multi") else "single")
        else:
            assert (mod, shape, kind) == ("graphsage_reddit", "ogb_products",
                                          "single")
            assert variant == {"dtype": args[0]}


@pytest.mark.parametrize("name", LM_SAGE)
def test_experiment_arguments_and_shards_equal_jax(jax_specs, name):
    spec, mesh, extra = HC.build(name)
    assert _rows(spec, mesh) == jax_specs["variants"][name]
    cell, args, _ = HC.EXPS[name]
    want = args[2] if cell == "lm_cell" and len(args) > 2 else (
        None if cell == "lm_cell" else {"dtype": args[0]})
    assert extra == {"variant": want}


def test_bf16_cast_makes_every_float32_leaf_bfloat16():
    spec, _, _ = HC.build("sage_products/bf16")
    dtypes = {leaf.dtype for _, leaf, _ in leaf_splits(spec.args, None)}
    assert torch.float32 not in dtypes and torch.bfloat16 in dtypes
    assert torch.int32 in dtypes                  # the graph stays int32


# ---------------------------------------------------------------------------
# (c) the BFS level on a 4x4 meta mesh
# ---------------------------------------------------------------------------

MESH44 = make_mesh((4, 4), ("data", "model"), device="meta")
AXES44 = MeshAxes(dp=("data",), tp="model")
# build_bfs_dryrun's counts on MESH44 (Table 1: scale 25) before the chunk
# repair: one 2^20-edge chunk a processor, stacked totals
PR27_BYTES = 131072019700.0
PR27_WIRE = {"all-reduce": 120.0, "all-gather": 402653376.0,
             "reduce-scatter": 0.0, "all-to-all": 805306560.0,
             "collective-permute": 0.0}
PR27_PEAK = 4152361960.0


class _Ops(TorchDispatchMode):
    """How often each aten op ran (scatter_reduce by its reduction)."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name.startswith("scatter_reduce"):
            name = "scatter_reduce:" + next(
                a for a in (*args, kwargs.get("reduce")) if isinstance(a, str))
        self.n[name] += 1
        return func(*args, **kwargs)


def _trace(spec):
    """(count, the ops of every processor's CSC scan) of one traced step."""
    scan = collections.Counter()
    expand = F.expand_frontier

    def counted(*a, **kw):
        with _Ops() as ops:
            out = expand(*a, **kw)
        scan.update(ops.n)
        return out
    F.expand_frontier = counted
    try:
        count = R.count_step(spec.fn, *spec.args)
    finally:
        F.expand_frontier = expand
    return count, scan


@functools.lru_cache(maxsize=None)
def _bfs44(kw):
    """(count, ops) of the hillclimb's bfs_cell(**kw) on MESH44."""
    saved = HC.production_mesh
    HC.production_mesh = lambda multi=False: (MESH44, AXES44)
    try:
        spec, mesh, extra = HC.bfs_cell(**dict(kw))
    finally:
        HC.production_mesh = saved
    assert mesh is MESH44
    return _trace(spec) + (extra,)


def test_default_cell_counts_equal_the_dry_runs_before_the_repair():
    spec = build_bfs_dryrun(None, "rmat_weak", MESH44, AXES44)
    assert "one 1048576-edge chunk a processor" in spec.note
    count, _ = _trace(spec)
    assert count.bytes == PR27_BYTES
    assert dict(count.wire.bytes) == PR27_WIRE
    assert count.peak_bytes == PR27_PEAK
    assert count.flops == 0
    # the hillclimb's bfs/base is the dry run's cell
    base, _, extra = _bfs44(())
    assert (base.bytes, dict(base.wire.bytes), base.peak_bytes) == \
        (PR27_BYTES, PR27_WIRE, PR27_PEAK)
    assert extra == {"variant": {}}


def test_one_level_scans_the_engines_own_chunk():
    base, ops, _ = _bfs44(())
    small, small_ops, extra = _bfs44((("edge_chunk", 1 << 18),))
    assert small.bytes < base.bytes
    assert dict(small.wire.bytes) == dict(base.wire.bytes)
    # one chunk each: the same number of chunk scans, not four at 2^18
    assert small_ops == ops
    assert extra == {"variant": {}}     # JAX pops edge_chunk off the variant


def test_sort_dedup_sorts_where_the_scatter_claim_was():
    """In each processor's CSC scan: the claim's scatter_reduce amin under
    "scatter", a sort in its place under "sort" (the frontier update keeps
    its own scatter claim under both, as in JAX)."""
    _, ops, _ = _bfs44(())
    _, sort_ops, extra = _bfs44((("dedup", "sort"),))
    assert ops["scatter_reduce:amin"] == 16
    assert sort_ops["scatter_reduce:amin"] == 0
    assert sort_ops["sort"] == ops["sort"] + 16
    assert extra == {"variant": {"dedup": "sort"}}


def test_bitmap_fold_wire_is_below_the_lists():
    base, _, _ = _bfs44(())
    bm, _, _ = _bfs44((("fold_bitmap", True),))
    assert bm.wire.bytes["all-to-all"] < base.wire.bytes["all-to-all"]
    assert bm.wire.bytes["all-gather"] == base.wire.bytes["all-gather"]
    assert bm.wire.total < base.wire.total


# ---------------------------------------------------------------------------
# (d) the hillclimb's records, reruns and errors
# ---------------------------------------------------------------------------

def test_main_records_skips_and_survives_an_error(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    HC.main(["gemma_decode/base"])
    with open(tmp_path / HC.OUT) as f:
        first = json.load(f)
    rec = first["gemma_decode/base"]
    want = (jax_record_keys() - {"compile_s"}) | {"lower_s"}
    assert set(rec) == want
    assert rec["status"] == "ok" and rec["variant"] is None
    assert rec["lower_s"] >= 0 and rec["dominant"] == "memory"
    assert rec["memory_s"] == rec["hbm_bytes"] / R.HBM_BW
    assert rec["compute_s"] == rec["flops"] / R.PEAK_FLOPS
    assert rec["collective_s"] == rec["wire_bytes"] / R.ICI_BW
    assert set(rec["detail"]) == set(R.COLLECTIVES)
    assert rec["arg_gib"] > 0 and rec["temp_gib"] > 0

    monkeypatch.setitem(HC.EXPS, "no_such/arch",
                        ("lm_cell", ("no_such_arch", "train_4k"), {}))
    capsys.readouterr()
    HC.main(["gemma_decode/base", "no_such/arch", "gemma_decode/seqshard"])
    printed = capsys.readouterr().out
    assert "[skip] gemma_decode/base" in printed
    assert "[FAIL] no_such/arch" in printed
    with open(tmp_path / HC.OUT) as f:
        recs = json.load(f)
    assert list(recs) == ["gemma_decode/base", "no_such/arch",
                          "gemma_decode/seqshard"]
    assert recs["gemma_decode/base"] == rec
    bad = recs["no_such/arch"]
    assert bad["status"] == "error"
    assert bad["error"].startswith("ModuleNotFoundError")
    assert "Traceback" in bad["tb"] and len(bad["tb"]) <= 1500
    seq = recs["gemma_decode/seqshard"]
    assert seq["status"] == "ok"
    assert seq["variant"] == {"cache_seq_shard": True}
    assert seq["arg_gib"] < rec["arg_gib"]


# ---------------------------------------------------------------------------
# (e) the report
# ---------------------------------------------------------------------------

def _hc(c, m, w, arg, temp, a2a=0.0, ag=0.0, variant=None):
    return {"status": "ok", "lower_s": 1.0, "compute_s": c, "memory_s": m,
            "collective_s": w, "dominant": max(
                (("compute", c), ("memory", m), ("collective", w)),
                key=lambda t: t[1])[0],
            "flops": c * R.PEAK_FLOPS, "hbm_bytes": m * R.HBM_BW,
            "wire_bytes": w * R.ICI_BW, "arg_gib": arg, "temp_gib": temp,
            "detail": {"all-reduce": 0.0, "all-gather": ag,
                       "reduce-scatter": 0.0, "all-to-all": a2a,
                       "collective-permute": 0.0}, "variant": variant}


def _dr(c, m, w, arg_b, temp_b, detail=None, useful=None):
    dom = max((("compute", c), ("memory", m), ("collective", w)),
              key=lambda t: t[1])[0]
    return {"status": "ok", "note": "", "lower_s": 2.5,
            "memory": {"argument_bytes": arg_b, "output_bytes": 0,
                       "temp_bytes": temp_b, "alias_bytes": None,
                       "code_bytes": None},
            "roofline": {"compute_s": c, "memory_s": m, "collective_s": w,
                         "dominant": dom, "useful_ratio": useful,
                         "collective_detail": detail or {}}}


DR_FILE = {
    "kimi-k2-1t-a32b|train_4k|single": _dr(4.0, 6.0, 0.5, 150 * 2**30,
                                           30 * 2**30, useful=0.31),
    "gemma2-2b|decode_32k|single": _dr(1e-5, 6e-3, 0.0, 26 * 2**30, 2**28),
    "graphsage-reddit|ogb_products|single": _dr(
        3e-6, 2.5e-2, 9e-4, 2**20, 2**28,
        detail={"all-gather": 3 * 2**30, "reduce-scatter": 2**30,
                "all-to-all": 3 * 2**30}),
    "bfs-rmat|rmat_weak|single": _dr(0.0, 7.5e-3, 8e-4, 128 * 2**30,
                                     2**29, detail={"all-gather": 2**30,
                                                    "all-to-all": 2**31}),
    "bfs-rmat|rmat_weak|multi": _dr(0.0, 8e-3, 1e-3, 2**30, 2**29),
    "glm4-9b|long_500k|single": {"status": "skipped",
                                 "reason": "full attention"},
}
HC_FILE = {
    "kimi_train/base": _hc(4.0, 6.0, 0.45, 152.5, 32.5, a2a=2e11),
    "kimi_train/fsdp": _hc(4.0, 6.0, 1.25, 40.0, 32.5, a2a=2e11),
    "kimi_train/fsdp+cap1.0": _hc(3.2, 5.4, 1.1, 40.0, 32.5, a2a=1.6e11),
    "kimi_train/fsdp+cap1.0+quant": _hc(3.2, 5.8, 0.9, 40.0, 32.5,
                                        a2a=5e10),
    "kimi_train/fsdp+cap1.0+quant+mb4": _hc(3.2, 7.0, 3.5, 40.0, 48.0),
    "kimi_train/fsdp+cap1.0+quant@2pods": {"status": "error",
                                           "error": "RuntimeError: x",
                                           "tb": ""},
    "gemma_decode/base": _hc(6e-6, 5.8e-3, 0.0, 26.25, 0.25),
    "gemma_decode/seqshard": _hc(6e-6, 5.8e-3, 0.0, 1.75, 0.25),
    "sage_products/base": _hc(3e-6, 2.5e-2, 9e-4, 0.01, 0.3),
    "sage_products/bf16": _hc(3e-6, 1.25e-2, 4.5e-4, 0.01, 0.2),
    "bfs/base": _hc(0.0, 8e-3, 8e-4, 128.0, 0.8, a2a=4e8, ag=2e8),
    "bfs/sort_dedup": _hc(0.0, 7.8e-3, 8e-4, 128.0, 0.8, a2a=4e8, ag=2e8),
    "bfs/fold_bitmap": _hc(0.0, 9e-3, 6e-4, 128.0, 1.4, a2a=2e8, ag=2e8),
    # bfs/sort+bitmap missing
    "bfs/chunk_256k": _hc(0.0, 7.9e-3, 8e-4, 128.0, 0.8, a2a=4e8, ag=2e8),
}
TPU_FIGURES = ["v5e", "819 GB/s", "197 TFLOP/s", "109 s", "413×", "TPU",
               "16 GiB"]


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    d = tmp_path_factory.mktemp("report")
    for name, obj in (("dryrun_results.json", DR_FILE),
                      ("hillclimb_results.json", HC_FILE)):
        with open(d / name, "w") as f:
            json.dump(obj, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable,
                          os.path.join(SCRIPTS, "torch_gen_experiments.py")],
                         cwd=d, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("wrote EXPERIMENTS_torch.md")
    assert not os.path.exists(d / "EXPERIMENTS.md")
    with open(d / GEN.OUT) as f:
        return f.read()


@pytest.mark.parametrize("section", [
    "## §Dry-run", "## §Roofline — single-pod 16×16, per device",
    "### Method", "### Reading the table", "## §Perf",
    "### Cell A: kimi-k2-1t-a32b × train_4k",
    "### Cell B: gemma2-2b × decode_32k",
    "### Cell C: graphsage-reddit × ogb_products",
    "### The paper's workload: BFS", "## §Paper-claims validation"])
def test_report_has_every_section(report, section):
    assert section in report


def test_report_hardware_line_is_the_h100s(report):
    assert (f"{R.PEAK_FLOPS / 1e12:g} TFLOP/s dense bf16 a card, "
            f"{R.HBM_BW / 1e12:g} TB/s HBM, {R.ICI_BW / 1e9:g} GB/s") \
        in report
    assert "not a measurement" in report or "none is a measurement" in report


def test_report_has_no_tpu_figure(report):
    for s in TPU_FIGURES:
        assert s not in report, s


def test_report_rows_are_the_records(report):
    for name, v in HC_FILE.items():
        if v["status"] != "ok":
            continue
        assert (f"| {name} | {v['compute_s']:.2e} | {v['memory_s']:.2e} | "
                f"{v['collective_s']:.2e} | {v['dominant'][:4]} |") \
            in report, name
    dr = DR_FILE["kimi-k2-1t-a32b|train_4k|single"]
    assert "| kimi-k2-1t-a32b × train_4k | 4.00e+00 | 6.00e+00 | " \
        "5.00e-01 | memo | 150.0 | 30.0 | 0.31 |" in report
    assert "| glm4-9b × long_500k | — | — | — | skip |" in report
    assert dr["roofline"]["useful_ratio"] == 0.31
    assert "**5 traced ok, 1 documented skips, 0 failures**" in report
    assert "Skipped (full attention): glm4-9b × long_500k × single." \
        in report


def test_report_marks_missing_and_failed_rows(report):
    assert "| kimi_train/fsdp+cap1.0+quant@2pods | (failed) |" in report
    assert "| bfs/sort+bitmap | (failed) |" in report
    assert report.count("(failed) |") == 2
    for name in ("kimi_train/base", "gemma_decode/seqshard",
                 "sage_products/bf16", "bfs/chunk_256k"):
        assert f"| {name} | (failed)" not in report


def test_report_findings_are_computed_from_the_records(report):
    # cell A: FSDP's argument cut, capacity's all-to-all, microbatching
    assert "arguments 152.5 → 40.0 GiB (3.81× less)" in report
    assert "dispatch all-to-all -20.0%" in report
    assert "temp 32.5 → 48.0 GiB (1.48× more)" in report
    assert "H3 does not hold" in report and "H1 holds" in report
    assert "6 s → 5.4 s (1.11×) on one pod." in report
    assert "kimi_train/fsdp+cap1.0+quant@2pods missing or failed" in report
    # cell B: the cache's arguments; cell C: the wire halves
    assert "arguments 26.2 → 1.8 GiB/device (15× less)" in report
    assert "wire 0.0009 → 0.00045 s (2× less)" in report
    assert ": H holds." in report
    # the BFS log: memory terms against bfs/base, the fold wire
    assert "memory term 0.008 → 0.0078 s a level (-2.5%)" in report
    assert "fold wire 2× less, collective term -25.0%" in report
    assert "memory term 0.008 → 0.0079 s a level (-1.2%" in report
    assert "Stopping rule: 2 of 4 variants" in report
    # the table's readings
    assert "150.0 GiB/device of arguments, which does not fit" in report
    assert "expand 4 GiB/device, fold 3 GiB/device (1.33×): holds" \
        in report
    assert "expand (all-gather) 1 GiB/device against fold (all-to-all) 2: " \
        "the fold is the larger" in report
    # no CSV: the paper-claims sections name A20
    assert report.count("come with ROADMAP A20") >= 7
