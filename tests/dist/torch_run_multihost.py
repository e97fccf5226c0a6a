"""The port's session API across a REAL `torch.distributed` process group,
held to the JAX package (the port's `tests/dist/run_multihost.py`).

    torch_run_multihost.py NPROC LOCAL [EXCHANGE] [--grid RxC]
                           [--mode queries|collectives|surface|features|
                                   resume|spmm|moe]
                           [--configs all|td|adaptive|cover|traced]
                           [--telemetry] [--ft] [--sections S,...]
                           [--ftdir DIR] [--ref REF.npz]
                           [--device cpu|cuda] [--scale S] [--timeout S]

NPROC ranks, LOCAL processors each, join a gloo group (a `file://` store in
a temporary directory; `--device cuda` puts every rank on cuda:0, its
messages staged through the host).  The grid is 1 x NPROC*LOCAL unless
--grid gives another (R*C = NPROC*LOCAL); rank p holds the row-major run
of processors [p*LOCAL, (p+1)*LOCAL).  EXCHANGE is "flat" (default),
"butterfly" or "both" (every query under each, in one group; the JAX
reference runs flat, whose outputs its butterfly equals).

--mode queries (default): every rank plans the run_multihost graph
(np.random.default_rng(7), SCALE 9, EF 8, symmetrised, uint8 weights) with
`DistGraph.from_edges(edges, cfg, weights=w, mesh=multihost.global_mesh(
...))` and runs, for every (direction, codec) of the chosen configs, the
queries of `tests/dist/torch_parity_ref.py --multihost`: bfs(3),
bfs([1, 5, 3]), connected_components(), sssp(3), multi_bfs([1, 5, 3]),
each with the codec.  --configs: "all" (default) is top-down and adaptive
under each codec; "cover" is top-down under list, adaptive under bitmap
and under delta (adaptive runs top-down levels too, so every codec's set
and value folds travel); "traced" is top-down under list and adaptive under
bitmap.  --telemetry runs every session with telemetry=True and adds every
query's `LevelTrace`, field by field ("{key}_trace{b}_{field}"); --ft runs
every query fault-tolerant (ckpt_every=2) under a transient loss crossing
level 3, its retries under "{key}_retries".  Every rank writes its outputs;
every field of every rank must equal the reference: the JAX package's
outputs (`torch_parity_ref.py --multihost [--telemetry]`, run in a child on
forced host devices, or read from --ref), or with `--device cuda` the
port's stacked session on the card.

--mode collectives: every rank holds `GroupTopology.row_gather`,
`col_all_to_all` (flat and butterfly), `psum_all` and `fetch` to
`StackedTopology`'s on random int32, int64, uint32, uint16 and bool
tensors, and counts the transfers: flat makes one all_to_all a fold, the
butterfly log2(C) stages a fold, of which the ones whose partner column
lies on another rank are pairwise exchanges.

--mode surface: `DistGraph.from_partition(..., mesh=)` keeps this rank's
blocks of a whole-grid partition and answers as the `from_edges` graph
does; in the group GraphServer raises NotImplementedError naming ROADMAP
A13 part 3.

--mode features (edge_chunk 512, the comma-separated --sections, each
rank writing its outputs to rank{k}.npz and its messages to rank{k}.json,
which the caller holds to the JAX package's `torch_parity_ref.py --ft`
run): "validate" -- bfs(validate=True | edges) passing, then every
CORRUPTIONS entry of one output checked against both shares, and "released"
after release_edges(); "segmented" -- every query of FT_CONFIGS with
fault_tolerance=True, ckpt_every 1 and 2, equal to the unsegmented group
run on the rank and written under "seg{K}_{config}_{query}_*" (the
unsegmented under "ft_{config}_{query}_*"), and a transient loss crossing
level 3 retried once; "snapshots" -- every SNAP_CASES query under a
persistent loss with a checkpoint directory FTDIR/torch_{RxC}_{tag} (rank
0 writes it), the UnrecoverableLoss snapshot under "snap_{tag}/..." and its
meta in the json; "elastic" -- ElasticCoordinator on the group for every
ELASTIC_CASES entry (grids and stats in the json); "refusal" -- the shrink
to 1x3 over ranks of two processors, whose ValueError message goes to the
json.

--mode spmm: every rank plans its blocks of the queries graph (with its
uint8 weights as `partition_2d_with_vals` lays them out) and runs
`core.spmm2d.make_spmm2d(grid, mesh)` on random and on integer-valued
features (`spmm_features`), unweighted and weighted; every rank's whole
(n, d) outputs must equal the port's stacked grid's on the CPU, bit for
bit (the same blocks summed in the same order).

--mode moe (the grid a ("data", "model") mesh): every rank runs
`models.moe.moe_apply` over the group's `ProcessMesh` on an MoE layer
(`moe_inputs`: 30 tokens, 8 experts of which 6 route, top-2; tokens over
both axes, experts over "model") for each (quant_dispatch, fsdp_axis) of
MOE_CASES -- output, aux and the gradients of sum(y * gy) + aux --
`data.shard_batch` of an (8, 6) batch for each SHARD_SPECS entry, and
one `train.make_train_step` step of a 2-layer MoE LM whose MoE runs over
the group, beside the same step over a stacked 2x2 mesh in the rank.  The
orchestrator holds them to `torch_parity_ref.py ... --moe` (the JAX
package on forced host devices): outputs and gradients within rtol 1e-4,
atol 1e-5 of each tensor's largest entry, aux rtol 1e-6, every rank's
shard equal to its processors' JAX shards (or refused where they do not
form one block), and the step's loss equal and parameters within rtol
1e-5, atol 1e-7 of the stacked step's.  It prints a "CHECK <name> ok" line
for each.  `--ref REF.npz` takes the JAX outputs of `moe_inputs()` from
REF.npz instead of a child.

--mode resume: every rank loads the JAX package's checkpoint directories
FTDIR/jax_{RxC}_{tag} of SNAP_CASES and resumes each in the group, under
"ftx_{tag}_*".

Every group launch has a deadline (--timeout, default 240 s): on expiry
every rank is killed and the script fails.  Prints "OK" on success.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))

ROOT, BATCH = 3, [1, 5, 3]
CONFIGS = {"td": [(False, c) for c in ("list", "bitmap", "delta")],
           "adaptive": [(True, c) for c in ("list", "bitmap", "delta")]}
CONFIGS["all"] = CONFIGS["td"] + CONFIGS["adaptive"]
CONFIGS["cover"] = [(False, "list"), (True, "bitmap"), (True, "delta")]
CONFIGS["traced"] = [(False, "list"), (True, "bitmap")]
FIELDS = {"bfs1": ("level", "pred", "n_levels"),
          "bfs": ("level", "pred", "n_levels"),
          "cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
          "mbfs": ("level", "src", "n_levels")}
A13_3 = "ROADMAP A13 part 3"
# --mode features: the queries of `torch_parity_ref.py --ft` (its
# QUERY_FIELDS and query_arg), the configs of the segmented runs, the
# snapshot and elastic cases (its cases.json) and the corruptions
METHODS = {"bfs1": "bfs", "bfs": "bfs", "cc": "connected_components",
           "sssp": "sssp", "mbfs": "multi_bfs"}
FT_CHUNK = 512
FT_CONFIGS = [(False, "list"), (True, "bitmap")]
SNAP_CASES = (
    [{"tag": f"{q}_td", "query": q, "direction": False, "codec": "list",
      "at": 3, "telemetry": False} for q in ("bfs", "cc", "sssp", "mbfs")]
    + [{"tag": "bfs_dir", "query": "bfs", "direction": True,
        "codec": "bitmap", "at": 4, "telemetry": False},
       {"tag": "cc_td_tel", "query": "cc", "direction": False,
        "codec": "list", "at": 3, "telemetry": True}])
ELASTIC_CASES = [{"tag": "bfs", "query": "bfs", "kind": "persistent"},
                 {"tag": "cc", "query": "cc", "kind": "persistent"}]
CORRUPTIONS = ("root", "visited", "level+1", "tree edge", "span",
               "incomplete")
SECTIONS = ("validate", "segmented", "snapshots", "elastic")


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("nproc", type=int)
    ap.add_argument("local", type=int)
    ap.add_argument("exchange", nargs="?", default="flat")
    ap.add_argument("--grid", default=None)
    ap.add_argument("--mode", default="queries",
                    choices=("queries", "collectives", "surface", "features",
                             "resume", "spmm", "moe"))
    ap.add_argument("--telemetry", action="store_true")
    ap.add_argument("--ft", action="store_true")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--ftdir", default=None)
    ap.add_argument("--configs", default="all", choices=sorted(CONFIGS))
    ap.add_argument("--ref", default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    P = a.nproc * a.local
    a.grid = (1, P) if a.grid is None \
        else tuple(int(x) for x in a.grid.lower().split("x"))
    if a.grid[0] * a.grid[1] != P:
        ap.error(f"--grid {a.grid} does not hold {a.nproc} x {a.local} "
                 f"processors")
    return a


def make_inputs(scale):
    """run_multihost.py's graph: (n, edges (2, E) int64, weights uint8)."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = 1 << scale
    m = 8 * n
    edges = np.stack([rng.integers(0, n, m), rng.integers(0, n, m)])
    edges = np.concatenate([edges, edges[::-1]], axis=1)   # symmetrised
    w = rng.integers(1, 64, edges.shape[1]).astype(np.uint8)
    return n, edges, w


def dtag(direction):
    return "adaptive" if direction else "td"


def exchanges(spec):
    return ("flat", "butterfly") if spec == "both" else (spec,)


def host(x):
    import numpy as np
    import torch
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def put_output(out, key, r, fields):
    """An output's fields (and edges, directions, traces) under `key`."""
    import dataclasses

    import numpy as np
    for f in fields:
        out[f"{key}_{f}"] = host(getattr(r, f))
    out[f"{key}_edges"] = np.asarray(r.edges_scanned, np.int64)
    if r.directions is not None:
        out[f"{key}_directions"] = host(r.directions)
    if r.trace is not None:
        traces = r.trace if isinstance(r.trace, tuple) else (r.trace,)
        for b, tr in enumerate(traces):
            for f in dataclasses.fields(tr):
                out[f"{key}_trace{b}_{f.name}"] = np.asarray(
                    getattr(tr, f.name))


def run_queries(graph, configs, grid, exchange, telemetry=False, ft=False):
    """Every config's queries through the session API -> {key: numpy}, the
    keys of `torch_parity_ref.py --multihost` after "{exchange}:"."""
    import numpy as np

    from repro_torch.api import BFSConfig
    from repro_torch.runtime import DeviceLossInjector, RecoveryPlan

    out = {}
    R, C = grid
    roots = np.asarray(BATCH, np.int32)
    for ex, (direction, codec) in ((e, c) for e in exchanges(exchange)
                                   for c in configs):
        s = graph.session(BFSConfig(grid=grid, direction=direction,
                                    fold_codec=codec, exchange=ex,
                                    telemetry=telemetry, fault_tolerance=ft,
                                    ckpt_every=2))
        tag = f"{ex}:{R}x{C}_{dtag(direction)}_{codec}"
        plans = {}

        def kw(q):
            if not ft:
                return {}
            plans[q] = RecoveryPlan(injector=DeviceLossInjector(
                3, transient=True))
            return {"recovery": plans[q]}
        res = {"bfs1": s.bfs(ROOT, **kw("bfs1")),
               "bfs": s.bfs(roots, **kw("bfs")),
               "cc": s.connected_components(fold_codec=codec, **kw("cc")),
               "sssp": s.sssp(ROOT, fold_codec=codec, **kw("sssp")),
               "mbfs": s.multi_bfs(roots, fold_codec=codec, **kw("mbfs"))}
        for q, r in res.items():
            put_output(out, f"{tag}_{q}", r, FIELDS[q])
        for q, plan in plans.items():
            out[f"{tag}_{q}_retries"] = np.asarray(plan.stats["retries"])
    return out


def query_arg(query):
    """A features-mode query's argument (`torch_parity_ref.py`'s
    query_arg over BATCH; None: none)."""
    import numpy as np
    roots = np.asarray(BATCH, np.int32)
    return {"bfs1": int(roots[0]), "bfs": roots[:2], "cc": None,
            "sssp": roots[:2], "mbfs": roots}[query]


def run_query(sess, query, **kw):
    arg = query_arg(query)
    return getattr(sess, METHODS[query])(*(() if arg is None else (arg,)),
                                         **kw)


def corrupt(kind, level, pred, root, edges):
    """A BFS output (numpy level, pred) broken so that Graph500 rule
    `kind` (a CORRUPTIONS entry) is the first to fail.  Deterministic, so
    every rank and the JAX check break it alike."""
    import numpy as np
    level, pred = level.copy(), pred.copy()
    vis = np.flatnonzero(level >= 0)
    vis = vis[vis != root]
    children = np.bincount(pred[pred >= 0], minlength=level.shape[0])
    leaves = [v for v in vis if children[v] == 0]
    u, v = edges
    if kind == "root":
        pred[root] = (root + 1) % level.shape[0]
    elif kind == "visited":
        pred[vis[0]] = -1
    elif kind == "level+1":
        w = vis[-1]
        pred[w] = next(x for x in vis if level[x] == level[w] and x != w)
    elif kind == "tree edge":
        w = vis[-1]
        nbrs = set(u[v == w].tolist())
        pred[w] = next(x for x in np.flatnonzero(level == level[w] - 1)
                       if x not in nbrs)
    elif kind == "span":
        # a leaf re-hung two levels deeper below a neighbour one level
        # under it: its tree edge holds, its old parent's edge spans 3
        for w in leaves:
            nbrs = u[v == w]
            deeper = [x for x in nbrs if level[x] == level[w] + 1]
            if deeper:
                pred[w] = deeper[0]
                level[w] += 2
                break
        else:
            raise AssertionError("no leaf with a deeper neighbour")
    elif kind == "incomplete":
        w = leaves[0]
        level[w] = pred[w] = -1
    else:
        raise ValueError(kind)
    return level, pred

# ----------------------------------------------------------------------------
# rank roles
# ----------------------------------------------------------------------------

def join(a):
    import torch

    from repro_torch.dist import multihost
    # the ranks share the host's cores: one thread each
    torch.set_num_threads(1)
    rank = int(os.environ["REPRO_TMH_RANK"])
    dev = multihost.initialize(
        "file://" + os.environ["REPRO_TMH_STORE"], a.nproc, rank,
        device="cuda:0" if a.device == "cuda" else "cpu", backend="gloo",
        timeout_s=a.timeout)
    mesh = multihost.global_mesh(a.grid, ("r", "c"))
    assert (mesh.Rl * mesh.Cl, mesh.world) == (a.local, a.nproc), mesh
    return rank, dev, mesh


def worker_queries(a):
    import numpy as np

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.dist import multihost

    rank, _, mesh = join(a)
    n, edges, w = make_inputs(a.scale)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=a.grid), weights=w,
                                 mesh=mesh, n=n)
    assert graph.csc.col_off.shape[:2] == (mesh.Rl, mesh.Cl)
    out = run_queries(graph, CONFIGS[a.configs], a.grid, a.exchange,
                      a.telemetry, a.ft)
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **out)
    multihost.shutdown()
    print(f"RANK {rank} DONE")


def worker_collectives(a):
    import torch

    from repro_torch.core.types import Grid2D
    from repro_torch.dist import multihost as MH
    from repro_torch.dist.strategy import ButterflyExchange
    from repro_torch.dist.topology import GroupTopology, StackedTopology

    rank, _, mesh = join(a)
    UNSIGNED = {torch.uint32: torch.int32, torch.uint16: torch.int16}
    R, C = a.grid
    grid = Grid2D(R, C, R * C * 8)
    stacked = StackedTopology(grid, torch.device("cpu"))
    flat = GroupTopology(grid, mesh)
    fly = flat.with_exchange(ButterflyExchange())
    assert fly.groups is flat.groups
    gen = torch.Generator().manual_seed(5)

    def rand(shape, dtype):
        x = torch.randint(-2**62, 2**62, shape, generator=gen,
                          dtype=torch.int64)
        if dtype == torch.bool:
            return x > 0
        if dtype in UNSIGNED:             # the same-size signed bits
            return x.to(UNSIGNED[dtype]).view(dtype)
        return x.to(dtype)

    def mine(x):
        return MH.put_dev(x, mesh)

    def same(what, got, want):
        if not torch.equal(got.cpu(), want.contiguous()):
            raise AssertionError(f"rank {rank}: {what} differs from the "
                                 f"stacked topology's")

    # count the transfers the topologies make
    counts = {"all_to_all": 0, "exchange_pair": 0, "stages": 0}
    for name in ("all_to_all", "exchange_pair"):
        fn = getattr(MH, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        setattr(MH, name, counted)
    swap = GroupTopology.butterfly_swap

    def counted_swap(self, part, s):
        counts["stages"] += 1
        return swap(self, part, s)
    GroupTopology.butterfly_swap = counted_swap

    for dtype in (torch.int32, torch.int64, torch.uint32, torch.uint16,
                  torch.bool):
        x = rand((R, C, 5, 3), dtype)
        same(f"row_gather {dtype}", flat.row_gather(mine(x)),
             stacked.row_gather(x)[mesh.i0:mesh.i0 + mesh.Rl,
                                   mesh.j0:mesh.j0 + mesh.Cl])
        same(f"fetch {dtype}", flat.fetch(mine(x)), x)
        m = rand((R, C, C, 4), dtype)
        want = stacked.col_all_to_all(m)[mesh.i0:mesh.i0 + mesh.Rl,
                                         mesh.j0:mesh.j0 + mesh.Cl]
        before = dict(counts)
        same(f"col_all_to_all flat {dtype}", flat.col_all_to_all(mine(m)),
             want)
        if counts["all_to_all"] - before["all_to_all"] != 1:
            raise AssertionError("flat made other than one all_to_all")
        if C & (C - 1) == 0:
            before = dict(counts)
            same(f"col_all_to_all butterfly {dtype}",
                 fly.col_all_to_all(mine(m)), want)
            stages = C.bit_length() - 1
            remote = sum(1 for s in range(stages) if (1 << s) >= mesh.Cl)
            got = (counts["stages"] - before["stages"],
                   counts["exchange_pair"] - before["exchange_pair"],
                   counts["all_to_all"] - before["all_to_all"])
            if got != (stages, remote, 0):
                raise AssertionError(
                    f"butterfly made (stages, pairwise exchanges, "
                    f"all_to_alls) {got}, expected ({stages}, {remote}, 0)")
    # psum_all wraps int32 as JAX's psum does
    big = torch.full((R, C), 2**31 - 7, dtype=torch.int32)
    same("psum_all int32", flat.psum_all(mine(big)), stacked.psum_all(big))
    cnt = rand((R, C), torch.int32) & 0xFFFF
    same("psum_all", flat.psum_all(mine(cnt)), stacked.psum_all(cnt))
    if flat.total(rank + 1) != a.nproc * (a.nproc + 1) // 2:
        raise AssertionError("total() is not the group's sum")
    MH.shutdown()
    print(f"RANK {rank} DONE {counts}")


def worker_surface(a):
    import numpy as np
    import torch

    from repro_torch.api import BFSConfig, DistGraph
    from repro_torch.core import partition as P
    from repro_torch.dist import multihost
    from repro_torch.serve import GraphServer

    rank, _, mesh = join(a)
    n, edges, w = make_inputs(a.scale)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=a.grid), weights=w,
                                 mesh=mesh, n=n)
    s = graph.session()
    # from_partition(mesh=): the whole grid's arrays in, this rank's out
    grid = graph.grid
    te, tw = torch.from_numpy(edges.astype(np.int32)), torch.from_numpy(w)
    pg = DistGraph.from_partition(
        grid, P.partition_2d(te, grid), BFSConfig(grid=a.grid), mesh=mesh,
        n=n, csr=P.partition_2d_csr(te, grid),
        weights=P.partition_edge_vals(te, tw, grid),
        csr_weights=P.partition_edge_vals_csr(te, tw, grid))
    assert pg.csc.row_idx.shape[:2] == (mesh.Rl, mesh.Cl)
    for k in ("row_off", "col_idx", "nnz"):
        assert torch.equal(pg.csr[k], graph.ensure_csr()[k]), k
    for direction in (False, True):
        cfg = BFSConfig(grid=a.grid, direction=direction)
        for q in ("bfs", "sssp"):
            x = getattr(pg.session(cfg), q)(ROOT)
            y = getattr(graph.session(cfg), q)(ROOT)
            f = "level" if q == "bfs" else "dist"
            assert torch.equal(getattr(x, f), getattr(y, f)), (q, direction)
            assert x.edges_scanned == y.edges_scanned, (q, direction)
    try:
        GraphServer({"g": graph})
    except NotImplementedError as e:
        if A13_3 not in str(e):
            raise AssertionError(f"GraphServer: the error does not name "
                                 f"{A13_3}: {e}")
    else:
        raise AssertionError("GraphServer did not refuse a process group")
    # the group still answers after the refusals
    out = s.bfs(ROOT)
    assert int(out.n_levels) > 1 and out.level.shape == (graph.grid.n,)
    multihost.shutdown()
    print(f"RANK {rank} DONE")


def spmm_features(n):
    """--mode spmm's features: (n, 8) float32 random and integer-valued."""
    import numpy as np
    rng = np.random.default_rng(9)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    return x, rng.integers(-8, 9, (n, 8)).astype(np.float32)


def spmm_outputs(a, mesh):
    """make_spmm2d's outputs on the queries graph over `mesh` (a rank's
    blocks of a ProcessMesh, or every block of a StackedMesh)."""
    import numpy as np
    import torch

    from repro_torch.core import partition as P
    from repro_torch.core.spmm2d import make_spmm2d
    from repro_torch.core.types import Grid2D
    from repro_torch.dist.topology import Topology
    n, edges, w = make_inputs(a.scale)
    grid = Grid2D.for_vertices(n, *a.grid)
    g, wb = P.partition_2d_with_vals(
        torch.from_numpy(edges.astype(np.int32)), torch.from_numpy(w), grid,
        local=Topology(grid, mesh).local, device=mesh.device)
    spmm = make_spmm2d(grid, mesh)
    out = {}
    for tag, x in zip(("x", "xi"), spmm_features(n)):
        x = torch.from_numpy(x)
        out[f"y_{tag}"] = host(spmm(g.col_off, g.row_idx, g.nnz, x))
        out[f"yw_{tag}"] = host(spmm(g.col_off, g.row_idx, g.nnz, x,
                                     edge_weight=wb))
    return out


def worker_spmm(a):
    """--mode spmm (see the module docstring)."""
    import numpy as np

    from repro_torch.dist import multihost
    import torch

    from repro_torch.core.spmm2d import make_spmm2d
    from repro_torch.core.types import Grid2D
    rank, _, mesh = join(a)
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **spmm_outputs(a, mesh))
    # the group's wire carries bytes: a tensor needing a gradient is refused
    n = 1 << a.scale
    spmm = make_spmm2d(Grid2D.for_vertices(n, *a.grid), mesh)
    x = torch.zeros((n, 2), requires_grad=True)
    try:
        spmm(None, None, None, x)
    except ValueError as e:
        assert "forward-only" in str(e), e
    else:
        raise AssertionError("spmm2d in a group took a tensor needing grad")
    multihost.shutdown()
    print(f"RANK {rank} DONE")


def compare_spmm(a, td):
    """Every rank's spmm outputs against the stacked grid's (this
    process, the CPU); returns the number of arrays compared."""
    import numpy as np

    from repro_torch.dist.compat import make_mesh
    ref = spmm_outputs(a, make_mesh(a.grid, ("r", "c"), device="cpu"))
    for rank in range(a.nproc):
        got = np.load(os.path.join(td, f"rank{rank}.npz"))
        for key, want in ref.items():
            if not np.array_equal(got[key], want):
                raise AssertionError(f"rank {rank}: spmm {key} differs from "
                                     f"the stacked grid's")
    return a.nproc * len(ref)


MOE_CASES = [(False, None), (True, None), (False, "data"), (True, "data")]
SHARD_SPECS = {"default": (("pod", "data"),), "data_model": (("data", "model"),),
               "model_data": (("model", "data"),), "model": ("model",),
               "rows_cols": ("data", "model")}


def moe_inputs():
    """--mode moe's layer (tests/test_torch_moe.py's EP layer) and batch."""
    import numpy as np
    rng = np.random.default_rng(4)
    N, d, f, E = 30, 12, 16, 8
    p = {"x": rng.standard_normal((N, d)).astype(np.float32),
         "router": (rng.standard_normal((d, E)) * 0.3).astype(np.float32),
         "w1": (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32),
         "w3": (rng.standard_normal((E, d, f)) * 0.2).astype(np.float32),
         "w2": (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)}
    p["gy"] = np.random.default_rng(5).standard_normal(
        (N, d)).astype(np.float32)
    p["batch"] = np.arange(8 * 6, dtype=np.int32).reshape(8, 6)
    return dict(p, top_k=2, n_experts=6, capacity_factor=1.25, cap_e_mult=4)


class MoECfg:
    n_experts, top_k, capacity_factor, cap_e_mult = 6, 2, 1.25, 4


def moe_train_step(shard, tokens):
    """One AdamW step of a 2-layer MoE LM (seeded weights) with its MoE
    over `shard`: (loss, the parameters after the step as numpy)."""
    import torch

    from repro_torch.models import lm as L
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, init_state,
                                              make_train_step)
    cfg = L.LMConfig(name="moe-group", n_layers=2, d_model=16, n_heads=2,
                     n_kv_heads=1, d_head=8, d_ff=32, vocab=64,
                     moe=L.MoESettings(n_experts=4, top_k=2, d_ff_expert=8,
                                       n_shared=1),
                     dtype=torch.float32, remat=False)
    model = L.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tc = TrainConfig(optimizer=AdamWConfig(warmup_steps=0))
    step = make_train_step(
        lambda p, b: model.loss(b[0], b[1], mesh=shard), tc)
    state = init_state(tc, dict(model.named_parameters())).tree()
    t = torch.from_numpy(tokens)
    _, info = step(state, (t, t))
    return float(info["loss"]), {k: v.detach().numpy().copy()
                                 for k, v in model.named_parameters()}


def worker_moe(a):
    """--mode moe (see the module docstring)."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import shard_batch
    from repro_torch.dist import multihost
    from repro_torch.dist.compat import make_mesh
    from repro_torch.models import moe as M
    torch.set_num_threads(1)
    rank = int(os.environ["REPRO_TMH_RANK"])
    multihost.initialize("file://" + os.environ["REPRO_TMH_STORE"],
                         a.nproc, rank, device="cpu", backend="gloo",
                         timeout_s=a.timeout)
    mesh = multihost.global_mesh(a.grid, ("data", "model"))
    data = np.load(os.path.join(a.out, "in.npz"))
    names = ("x", "router", "w1", "w3", "w2")
    out = {}
    for quant, fsdp in MOE_CASES:
        shard = M.MoEShard(mesh=mesh, token_axes=("data", "model"),
                           expert_axis="model", fsdp_axis=fsdp,
                           quant_dispatch=quant)
        args = {k: torch.from_numpy(data[k]).requires_grad_() for k in names}
        y, aux = M.moe_apply(args["x"], {k: args[k] for k in names[1:]},
                             MoECfg, mesh=shard)
        grads = torch.autograd.grad(
            torch.sum(y * torch.from_numpy(data["gy"])) + aux,
            [args[k] for k in names])
        tag = f"moe_{int(quant)}_{fsdp}"
        out[f"{tag}_y"] = y.detach().numpy()
        out[f"{tag}_aux"] = aux.detach().numpy()
        for k, g in zip(names, grads):
            out[f"{tag}_g{k}"] = g.numpy()
    for name, spec in SHARD_SPECS.items():
        try:
            out[f"shard_{name}"] = shard_batch(data["batch"], mesh,
                                               spec).numpy()
        except ValueError:
            out[f"shard_{name}_refused"] = np.asarray(True)
    tokens = np.random.default_rng(6).integers(0, 64, (4, 8)).astype(
        np.int32)
    kw = dict(token_axes=("data", "model"), expert_axis="model")
    loss, params = moe_train_step(M.MoEShard(mesh=mesh, **kw), tokens)
    sloss, sparams = moe_train_step(M.MoEShard(
        mesh=make_mesh(a.grid, ("data", "model"), device="cpu"), **kw),
        tokens)
    out["train_loss"], out["train_loss_stacked"] = loss, sloss
    for k in params:
        out[f"train_p_{k}"], out[f"train_ps_{k}"] = params[k], sparams[k]
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **out)
    multihost.shutdown()
    print(f"RANK {rank} DONE")


def _near(got, want, rtol, atol_frac):
    import numpy as np
    want = np.asarray(want)
    atol = atol_frac * max(float(np.abs(want).max()), 1e-30)
    return got.shape == want.shape and np.allclose(got, want, rtol=rtol,
                                                   atol=atol)


def _rank_shard(ref, name, a, rank):
    """The block of JAX's shards a rank's processors hold, or None where
    they do not form one block."""
    import numpy as np
    L = a.local
    ks = range(rank * L, (rank + 1) * L)
    blocks = {tuple(ref[f"shard_{name}_{k}_start"]): ref[f"shard_{name}_{k}"]
              for k in ks}
    lo = np.min(list(blocks), axis=0)
    shp = next(iter(blocks.values())).shape
    hi = np.max(list(blocks), axis=0) + shp
    box = np.zeros(hi - lo, ref[f"shard_{name}_{ks[0]}"].dtype)
    seen = np.zeros(hi - lo, bool)
    for start, blk in blocks.items():
        sl = tuple(slice(s - l, s - l + n) for s, l, n in zip(start, lo, shp))
        box[sl], seen[sl] = blk, True
    return box if seen.all() else None


def compare_moe(a, ref_path, td):
    """Every rank's --mode moe outputs against the JAX reference (and the
    train step against the rank's stacked step); prints a CHECK line for
    each item, raises on the first failure."""
    import numpy as np
    ref = np.load(ref_path)
    checks = []
    for rank in range(a.nproc):
        got = np.load(os.path.join(td, f"rank{rank}.npz"))
        for quant, fsdp in MOE_CASES:
            tag = f"moe_{int(quant)}_{fsdp}"
            ok = np.allclose(got[f"{tag}_aux"], ref[f"{tag}_aux"], rtol=1e-6)
            ok &= all(_near(got[f"{tag}_{k}"], ref[f"{tag}_{k}"], 1e-4, 1e-5)
                      for k in ("y", "gx", "grouter", "gw1", "gw3", "gw2"))
            checks.append((f"{tag}_rank{rank}", ok))
        for name in SHARD_SPECS:
            want = _rank_shard(ref, name, a, rank)
            if want is None:
                ok = f"shard_{name}_refused" in got.files
            else:
                ok = f"shard_{name}" in got.files and \
                    np.array_equal(got[f"shard_{name}"], want)
            checks.append((f"shard_{name}_rank{rank}", ok))
        ok = float(got["train_loss"]) == float(got["train_loss_stacked"])
        pk = [k[len("train_p_"):] for k in got.files
              if k.startswith("train_p_")]
        ok &= bool(pk) and all(np.allclose(
            got[f"train_p_{k}"], got[f"train_ps_{k}"], rtol=1e-5, atol=1e-7)
            for k in pk)
        checks.append((f"train_step_rank{rank}", ok))
    for name, ok in checks:
        print(f"CHECK {name} {'ok' if ok else 'FAILED'}")
    bad = [n for n, ok in checks if not ok]
    if bad:
        raise AssertionError(f"--mode moe: {bad} differ from the reference")
    return len(checks)


def moe_reference(td, ref=None):
    """--mode moe's inputs in td/in.npz and the JAX package's outputs (a
    child on forced host devices; `ref`, a path, when already made from
    the same inputs) -> path of its .npz."""
    import numpy as np
    np.savez(os.path.join(td, "in.npz"), **moe_inputs())
    if ref is not None:
        return ref
    ref = os.path.join(td, "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "torch_parity_ref.py"),
                        os.path.join(td, "in.npz"), ref, "2x2", "--moe"],
                       env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"the JAX reference failed:\n{r.stdout}\n"
                             f"{r.stderr}")
    return ref


def flat_tree(out, prefix, tree):
    """A nested dict of arrays into `out` under "{prefix}/{path}"."""
    import numpy as np
    for k, v in tree.items():
        if isinstance(v, dict):
            flat_tree(out, f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def ft_config(grid, direction=False, codec="list", **kw):
    from repro_torch.api import BFSConfig
    return BFSConfig(grid=grid, edge_chunk=FT_CHUNK, direction=direction,
                     fold_codec=codec, **kw)


def worker_features(a):
    """--mode features (see the module docstring)."""
    import json

    import numpy as np
    import torch

    from repro_torch.api import DistGraph
    from repro_torch.dist import multihost
    from repro_torch.runtime import (DeviceLossInjector, ElasticCoordinator,
                                     RecoveryPlan, RetryPolicy,
                                     TraversalCheckpointer,
                                     UnrecoverableLoss)

    rank, dev, mesh = join(a)
    n, edges, w = make_inputs(a.scale)
    R, C = a.grid
    gtag = f"{R}x{C}"
    sections = a.sections.split(",")
    graph = DistGraph.from_edges(edges, ft_config(a.grid), weights=w,
                                 mesh=mesh, n=n)
    out, msgs = {}, {}

    def same(x, y, what):
        for f in dataclasses.fields(x):
            if f.name == "trace":
                continue
            gx, gy = getattr(x, f.name), getattr(y, f.name)
            ok = torch.equal(gx, gy) if isinstance(gx, torch.Tensor) \
                else gx == gy
            if not ok:
                raise AssertionError(f"rank {rank}: {what}: {f.name} differs")

    if "validate" in sections:
        s = graph.session(ft_config(a.grid))
        roots = np.asarray(BATCH, np.int32)
        s.bfs(roots, validate=True)
        s.bfs(ROOT, validate=edges)
        base = s.bfs(roots)
        lv, pr = host(base.level[0])[:n], host(base.pred[0])[:n]
        out["validate_level"], out["validate_pred"] = lv, pr
        for kind in CORRUPTIONS:
            bl, bp = corrupt(kind, lv, pr, int(roots[0]), edges)
            bad = dataclasses.replace(
                base, level=torch.from_numpy(bl)[None].to(dev),
                pred=torch.from_numpy(bp)[None].to(dev))
            for share, v in (("blocks", True), ("slice", edges)):
                try:
                    s._validate(bad, roots[:1], v)
                    msgs[f"corrupt:{kind}:{share}"] = None
                except AssertionError as e:
                    msgs[f"corrupt:{kind}:{share}"] = str(e)
        g2 = DistGraph.from_edges(edges, ft_config(a.grid), mesh=mesh, n=n)
        g2.release_edges()
        try:
            g2.session().bfs(ROOT, validate=True)
            msgs["released"] = None
        except ValueError as e:
            msgs["released"] = str(e)

    if "segmented" in sections:
        for direction, codec in FT_CONFIGS:
            ctag = f"{dtag(direction)}_{codec}"
            plain = graph.session(ft_config(a.grid, direction, codec))
            for q in FIELDS:
                base = run_query(plain, q)
                put_output(out, f"ft_{ctag}_{q}", base, FIELDS[q])
                for K in (1, 2):
                    s = graph.session(ft_config(
                        a.grid, direction, codec, fault_tolerance=True,
                        ckpt_every=K))
                    got = run_query(s, q, recovery=RecoveryPlan())
                    same(got, base, f"K={K} {ctag} {q}")
                    put_output(out, f"seg{K}_{ctag}_{q}", got, FIELDS[q])
        plan = RecoveryPlan(injector=DeviceLossInjector(3, transient=True))
        s = graph.session(ft_config(a.grid, fault_tolerance=True,
                                    ckpt_every=1))
        got = run_query(s, "bfs", recovery=plan)
        put_output(out, "transient_bfs", got, FIELDS["bfs"])
        msgs["transient"] = {k: plan.stats[k] for k in
                             ("retries", "segments", "delays")}

    if "snapshots" in sections:
        for case in SNAP_CASES:
            tag = case["tag"]
            s = graph.session(ft_config(
                a.grid, case["direction"], case["codec"],
                fault_tolerance=True, ckpt_every=1,
                telemetry=case["telemetry"]))
            ck = TraversalCheckpointer(
                os.path.join(a.ftdir, f"torch_{gtag}_{tag}"), tag)
            plan = RecoveryPlan(checkpointer=ck,
                                injector=DeviceLossInjector(case["at"],
                                                            fires=1),
                                policy=RetryPolicy(max_retries=0))
            try:
                run_query(s, case["query"], recovery=plan)
                raise AssertionError(f"{tag}: the loss did not fire")
            except UnrecoverableLoss as e:
                flat_tree(out, f"snap_{tag}", e.snapshot["arrays"])
                msgs[f"snap_meta:{tag}"] = e.snapshot["meta"]
            loaded = ck.load()          # every rank reads rank 0's write
            msgs[f"snap_loaded:{tag}"] = loaded["meta"]

    if "elastic" in sections or "refusal" in sections:
        policy = RetryPolicy(max_retries=2, backoff_s=1e-4, jitter_s=1e-4,
                             seed=1)
        cfg = ft_config(a.grid, fault_tolerance=True, ckpt_every=1)
        cases = ELASTIC_CASES if "elastic" in sections else ELASTIC_CASES[:1]
        for case in cases:
            tag = case["tag"]
            plan = RecoveryPlan(injector=DeviceLossInjector(
                2, fires=policy.max_retries + 1), policy=policy)
            coord = ElasticCoordinator(edges, cfg, weights=w, n=n,
                                       max_shrinks=2)
            try:
                got = coord.run(METHODS[case["query"]],
                                query_arg(case["query"]), plan=plan)
            except ValueError as e:
                msgs[f"elastic_error:{tag}"] = str(e)
                continue
            put_output(out, f"el_{tag}", got, FIELDS[case["query"]])
            msgs[f"elastic:{tag}"] = {
                "grids": coord.grids, "stats": [
                    plan.stats[k] for k in ("resumes", "segments",
                                            "retries",
                                            "resumed_from_level")]}
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **out)
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(msgs, f)
    multihost.shutdown()
    print(f"RANK {rank} DONE")


def worker_resume(a):
    """--mode resume (see the module docstring)."""
    import numpy as np

    from repro_torch.api import DistGraph
    from repro_torch.dist import multihost
    from repro_torch.runtime import RecoveryPlan, TraversalCheckpointer

    rank, _, mesh = join(a)
    n, edges, w = make_inputs(a.scale)
    R, C = a.grid
    graph = DistGraph.from_edges(edges, ft_config(a.grid), weights=w,
                                 mesh=mesh, n=n)
    out = {}
    for case in SNAP_CASES:
        tag = case["tag"]
        snap = TraversalCheckpointer(
            os.path.join(a.ftdir, f"jax_{R}x{C}_{tag}"), tag).load()
        flat_tree(out, f"jaxsnap_{tag}", snap["arrays"])
        s = graph.session(ft_config(
            a.grid, case["direction"], case["codec"], fault_tolerance=True,
            ckpt_every=1, telemetry=case["telemetry"]))
        got = run_query(s, case["query"], recovery=RecoveryPlan(
            resume=snap))
        put_output(out, f"ftx_{tag}", got, FIELDS[case["query"]])
    np.savez(os.path.join(a.out, f"rank{rank}.npz"), **out)
    multihost.shutdown()
    print(f"RANK {rank} DONE")


# ----------------------------------------------------------------------------
# the orchestrator
# ----------------------------------------------------------------------------

def launch(cmds, envs, timeout):
    """Start every rank, wait for all with one deadline; on expiry (or a
    failed rank) kill the rest.  Returns (exit codes, outputs)."""
    procs = [subprocess.Popen(c, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c, e in zip(cmds, envs)]
    deadline = time.monotonic() + timeout
    outs = [None] * len(procs)
    try:
        for k, p in enumerate(procs):
            left = max(1.0, deadline - time.monotonic())
            outs[k], _ = p.communicate(timeout=left)
            if p.returncode != 0:
                break
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for k, p in enumerate(procs):
            o, _ = p.communicate()
            outs[k] = (outs[k] or "") + (o or "")
    return [p.returncode for p in procs], outs


def jax_reference(a, td):
    """The JAX package's outputs of every config (a child on forced host
    devices) -> path of its .npz."""
    import numpy as np
    n, edges, w = make_inputs(a.scale)
    src = os.path.join(td, "edges.npz")
    np.savez(src, edges=edges, roots=np.asarray(BATCH, np.int32), n=n,
             weights=w)
    ref = os.path.join(td, "ref.npz")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    R, C = a.grid
    ex = "flat" if a.exchange == "both" else a.exchange
    r = subprocess.run([sys.executable, os.path.join(HERE,
                                                     "torch_parity_ref.py"),
                        src, ref, f"{R}x{C}", "--multihost", "--exchange",
                        ex] + (["--telemetry"] if a.telemetry else [])
                       + ([f"--{a.configs}"] if a.configs in
                          ("cover", "traced") else []),
                       env=env, capture_output=True, text=True,
                       timeout=a.timeout)
    if r.returncode != 0:
        raise AssertionError(f"the JAX reference failed:\n{r.stdout}\n"
                             f"{r.stderr}")
    return ref


def stacked_reference(a, td):
    """The port's stacked session on the device, in this process."""
    import numpy as np
    import torch

    from repro_torch.api import BFSConfig, DistGraph
    n, edges, w = make_inputs(a.scale)
    graph = DistGraph.from_edges(edges, BFSConfig(grid=a.grid), weights=w,
                                 n=n, device=a.device)
    out = run_queries(graph, CONFIGS[a.configs], a.grid, "flat",
                      a.telemetry)
    out = {k.split(":", 1)[1]: v for k, v in out.items()}
    del graph
    if a.device == "cuda":
        torch.cuda.empty_cache()
    ref = os.path.join(td, "ref.npz")
    np.savez(ref, **out)
    return ref


def compare(a, ref_path, td):
    import numpy as np
    ref = np.load(ref_path)
    R, C = a.grid
    tags = tuple(f"{R}x{C}_{dtag(d)}_{c}_" for d, c in CONFIGS[a.configs])
    want_keys = [k for k in ref.files if k.startswith(tags)]
    n_keys = 0
    for rank in range(a.nproc):
        got = np.load(os.path.join(td, f"rank{rank}.npz"))
        for ex in exchanges(a.exchange):
            for key in want_keys:
                if f"{ex}:{key}" not in got.files:
                    raise AssertionError(f"rank {rank} did not write "
                                         f"{ex}:{key}")
                g, w = got[f"{ex}:{key}"], ref[key]
                if g.shape != w.shape or not (g == w).all():
                    raise AssertionError(
                        f"rank {rank}: {key} under exchange={ex} differs "
                        f"from the reference (grid {R}x{C}, {a.nproc} "
                        f"ranks)")
                n_keys += 1
            if a.ft:
                for t in tags:
                    for q in ("bfs1", "bfs"):
                        k = f"{ex}:{t}{q}_retries"
                        if int(got[k]) != 1:
                            raise AssertionError(
                                f"rank {rank}: {k} = {int(got[k])}, the "
                                f"transient loss not retried once")
    if not want_keys:
        raise AssertionError("the reference holds none of the configs")
    return n_keys


def run_group(argv, out_dir):
    """Launch the group of `argv` (this script's arguments) with its rank
    outputs in `out_dir`; raises with every rank's log unless all exit 0.
    Returns (parsed arguments, the ranks' outputs)."""
    a = parse(argv)
    cmd = [sys.executable, os.path.abspath(__file__)] + list(argv) \
        + ["--out", out_dir]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    envs = [dict(env, REPRO_TMH_ROLE=a.mode, REPRO_TMH_RANK=str(k),
                 REPRO_TMH_STORE=os.path.join(out_dir, "store"))
            for k in range(a.nproc)]
    codes, outs = launch([cmd] * a.nproc, envs, a.timeout)
    if codes != [0] * a.nproc:
        raise AssertionError(
            f"rank exit codes {codes} (timeout {a.timeout} s):\n"
            + "\n".join(f"--- rank {k} ---\n{o[-3000:]}"
                        for k, o in enumerate(outs)))
    a.out = out_dir
    return a, outs


def main(argv):
    with tempfile.TemporaryDirectory() as td:
        if "--ftdir" not in argv and ("features" in argv
                                      or "resume" in argv):
            argv = list(argv) + ["--ftdir", td]
        pa = parse(argv)
        moe_ref = moe_reference(td, pa.ref) if pa.mode == "moe" else None
        a, outs = run_group(argv, td)
        what = f"{a.nproc} ranks x {a.local}, grid {a.grid[0]}x{a.grid[1]}"
        if a.mode == "queries":
            if a.ref is not None:
                ref = a.ref
            elif a.device == "cpu":
                ref = jax_reference(a, td)
            else:
                ref = stacked_reference(a, td)
            n_keys = compare(a, ref, td)
            print(f"multihost {what} exchange={a.exchange}: {n_keys} "
                  f"outputs on every rank bit-identical to the reference")
        elif a.mode == "moe":
            print(f"multihost {what} moe: {compare_moe(a, moe_ref, td)} "
                  f"checks passed")
        elif a.mode == "spmm":
            print(f"multihost {what} spmm: {compare_spmm(a, td)} outputs "
                  f"bit-identical to the stacked grid's")
        else:
            print(f"multihost {what} {a.mode}: "
                  + " | ".join(o.strip().splitlines()[-1] for o in outs))
    print("OK")


ROLE = os.environ.get("REPRO_TMH_ROLE")
if __name__ == "__main__":
    if ROLE is None:
        main(sys.argv[1:])
    else:
        args = parse(sys.argv[1:])
        {"queries": worker_queries, "collectives": worker_collectives,
         "surface": worker_surface, "features": worker_features,
         "resume": worker_resume, "spmm": worker_spmm,
         "moe": worker_moe}[ROLE](args)
