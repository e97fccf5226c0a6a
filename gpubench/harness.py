"""One run of one benchmark cell: the inputs, set-up, the measured window,
the comparison with the reference, the metrics.

Everything particular to a cell is data the harness finds by name:
`BENCHMARK.json` names the cell's configuration (its `file`), its traffic
mix (`traffic/<name>.json`) and its metrics (`metrics/<name>.py`, one
reader each); the mix names its query (`queries/<name>.py`).

The program under test is the port, `repro_torch`, driven through its
session API (`Port`); `Control` puts the reference's control searches in
its place.  Nothing here imports `jax` or the JAX package `repro`.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

from gpubench.reference import graph as RG
from gpubench.reference import profile as RP
from gpubench.reference.rmat import rmat_edges, symmetric_weights

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a traced run profiles a window of at most this many seconds (to its first
# query boundary past them): reading the trace costs ~8 s a traced second
TRACE_SECONDS = 8.0


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    query: object               # the queries/<name>.py module
    chips: int
    end_to_end: list            # BENCHMARK.json entries that apply
    per_layer: list


def load_cell(manifest: dict, workload: str, root: Path) -> Cell:
    """The cell `workload` of a parsed BENCHMARK.json, its files resolved."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    query = importlib.import_module(f"gpubench.queries.{traffic['query']}")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(workload, config, traffic, query, w["chips"],
                [m for m in manifest["end_to_end"] if applies(m)],
                [m for m in manifest["per_layer"] if applies(m)])


def metric_reader(name: str):
    """The `read(run)` of `metrics/<name>.py` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Inputs:
    edges: torch.Tensor
    weights: torch.Tensor | None
    n: int
    digest: tuple


def make_inputs(config: dict, device) -> Inputs:
    """The configuration's graph and its weights, on the device, from its
    `graph_seed`: one graph for every run of a configuration (graphs from
    other seeds search to other depths, and the seed would change the
    work)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(config["graph_seed"])
    scale = config["scale"]
    edges = rmat_edges(scale, config["edgefactor"], config["rmat_abcd"], gen,
                       device)
    weights = None
    if "weights" in config:
        lo, hi = config["weights"]["range"]
        weights = symmetric_weights(edges.shape[1] // 2, lo, hi, gen, device)
    n = 1 << scale
    return Inputs(edges, weights, n, digest(edges, weights))


def digest(edges, weights) -> tuple:
    """A sum over the inputs that any change to them moves (int64 sums
    wrap, in any order alike)."""
    s = 0
    for _, u, v in RG.edge_pieces(edges):
        s += int((u * 1000003 + v).sum())
    w = 0 if weights is None else int(weights.long().sum())
    return (edges.shape[1], s, w)


def draw_roots(deg, traffic: dict, seed: int) -> list:
    """The mix's roots: `roots` vertices of degree >= `min_degree` drawn
    from the mix's `root_seed` (one set for every run, so that runs with
    other seeds do the same work), in an order drawn from `seed`."""
    cand = torch.nonzero(deg >= traffic["min_degree"]).flatten()
    gen = torch.Generator(device=cand.device)
    gen.manual_seed(traffic["root_seed"])
    pick = torch.randperm(cand.numel(), generator=gen,
                          device=cand.device)[:traffic["roots"]]
    order = torch.randperm(pick.numel(), generator=torch.Generator()
                           .manual_seed(seed % 2**63))
    return cand[pick].cpu()[order].tolist()


class Port:
    """The program under test: `repro_torch`'s DistGraph and session."""

    def __init__(self, cell: Cell, device):
        self.cell, self.device = cell, device

    def plan(self, inp: Inputs) -> None:
        from repro_torch import BFSConfig, DistGraph
        c = self.cell.config
        cfg = BFSConfig(grid=tuple(c["grid"]), **c["bfs_config"])
        self.graph = DistGraph.from_edges(inp.edges, cfg, device=self.device,
                                          n=inp.n, weights=inp.weights)
        if c.get("csr"):
            self.graph.ensure_csr()
        self.session = self.graph.session()
        self.n = inp.n

    def query(self, root: int) -> dict:
        q = self.cell.query
        return q.host(q.call(self.session, root), self.n)

    def free(self) -> None:
        self.session = self.graph = None


class Control:
    """The reference's control search in the program's place."""

    def __init__(self, cell: Cell, device):
        self.cell, self.device = cell, device

    def plan(self, inp: Inputs) -> None:
        self.ref = Reference(inp, labels=False)

    def query(self, root: int) -> dict:
        return self.cell.query.control(self.ref, root)

    def free(self) -> None:
        self.ref = None


class Reference:
    """The reference's view of the inputs: CSR, components."""

    def __init__(self, inp: Inputs, labels: bool = True):
        self.edges, self.weights, self.n = inp.edges, inp.weights, inp.n
        self.device = inp.edges.device
        self.graph = RG.RefGraph(inp.edges, inp.weights, inp.n)
        self.answers = {}       # (query, root) -> the reference's answer
        if labels:
            self.labels = RG.component_labels(inp.edges, inp.n)
            self.comp_edges = RG.component_edges(inp.edges, self.labels)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""
    setup_s: float
    plan_s: float
    window_s: float
    traversed: list          # Graph500 edge count of each window query
    peak_bytes: int
    profile: dict | None     # reference.profile.summarise of the trace


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def forbidden_modules(modules=None) -> list:
    """Top-level names (the part before the first dot, whole) of loaded
    modules that the run must not hold."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[gpubench] {msg}", file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, program: str = "port") -> dict:
    """One run, its roots from the seed; returns the result line's object.
    t_start:
    the process's start on `time.perf_counter`'s clock (setup_s counts
    from it); program: "port", or "control" for the reference's control."""
    cuda = torch.device(device).type == "cuda"
    inp = make_inputs(cell.config, device)
    deg = RG.out_degrees(inp.edges, inp.n)
    roots = draw_roots(deg, cell.traffic, seed)
    warm_root = int(torch.argmax(deg))
    del deg
    sync(device)
    gen_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log(f"inputs: {inp.edges.shape[1]} directed edges, n {inp.n}, "
        f"{len(roots)} roots, at {time.perf_counter() - t_start:.2f} s")

    prog = (Port if program == "port" else Control)(cell, device)
    t0 = time.perf_counter()
    prog.plan(inp)
    sync(device)
    plan_s = time.perf_counter() - t0
    inp.edges = inp.weights = None      # the program holds what it keeps
    t0 = time.perf_counter()
    try:
        prog.query(warm_root)
        sync(device)
    except Exception:           # the window's answers will say so
        log(f"warm-up query raised:\n{traceback.format_exc()}")
    log(f"plan {plan_s:.3f} s, warm-up query "
        f"{time.perf_counter() - t0:.3f} s")
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        seconds = min(seconds, TRACE_SECONDS)
    answers, ends, window_s = window(prog, roots, seconds, device)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window {window_s:.3f} s, {len(answers)} queries, setup "
        f"{setup_s:.3f} s, peak {peak / 2**30:.3f} GiB")
    prog.free()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    summary = None
    if prof is not None:
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        summary = RP.summarise(prof.events(), window_s, DeviceType.CUDA)
        del prof
        log(f"trace read in {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    again = make_inputs(cell.config, device)
    ref = Reference(again)
    checks, failed, traversed = judge(cell, ref, answers)
    checks["inputs_replayed"] = int(again.digest != inp.digest)
    log(f"reference {time.perf_counter() - t0:.3f} s; queries (root, s, "
        f"edges, levels): " + ", ".join(
            f"({r}, {e - b:.4f}, {m}, {(got or {}).get('n_levels')})"
            for (r, got), b, e, m in
            zip(answers, ends[:-1], ends[1:], traversed)))
    limits = dict(cell.query.LIMITS, unanswered=0, inputs_replayed=0)

    record = RunRecord(setup_s, plan_s, window_s, traversed, peak, summary)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(peak, gen_peak)}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": bool(answers) and all(
                  checks[k] <= limits[k] for k in checks),
              "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": limits[k]}
                        for k, v in checks.items()}
    return result


def window(prog, roots: list, seconds: float, device):
    """The measured window: one client's queries back to back, roots in
    order and cycled, closing at the first query boundary past `seconds`.
    Returns [(root, answer or None)], the clock at the start and at each
    completion, and the window's length (start to the last completion)."""
    answers, ends = [], [time.perf_counter()]
    while True:
        r = roots[len(answers) % len(roots)]
        try:
            got = prog.query(r)
            sync(device)
        except Exception:       # an answer that never comes: judged failed
            if all(a is not None for _, a in answers):
                log(f"query from root {r} raised:\n{traceback.format_exc()}")
            got = None
        answers.append((r, got))
        ends.append(time.perf_counter())
        if ends[-1] - ends[0] >= seconds:
            return answers, ends, ends[-1] - ends[0]


def judge(cell: Cell, ref: Reference, answers: list):
    """Every answer against the reference: the largest reading of each
    compared number, the failed answers, and each answer's Graph500 edge
    count."""
    q = cell.query
    checks = {k: 0 for k in q.LIMITS}
    checks["unanswered"] = sum(got is None for _, got in answers)
    failed = 0
    traversed = []
    for r, got in answers:
        if got is None:
            failed += 1
            traversed.append(0)
            continue
        traversed.append(int(ref.comp_edges[ref.labels[r]]))
        bad = False
        for name, value in q.judge(ref, r, got).items():
            checks[name] = max(checks[name], value)
            bad |= value > q.LIMITS[name]
        failed += bad
    return checks, failed, traversed
