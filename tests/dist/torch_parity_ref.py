"""JAX-side reference searches for the port's parity tests
(tests/test_torch_bfs.py, test_torch_direction.py, test_torch_algos.py,
test_torch_strategy.py, test_torch_obs.py), on forced host devices.

Runs `DistGraph.from_edges(edges, BFSConfig(grid=(R, C))).session().bfs`
of the JAX package for every requested grid: one scalar search from the
first root and one batched search over all roots, and writes levels, preds,
n_levels and edges_scanned to an .npz under keys "{RxC}_{scalar|batch}_*".

With --direction it also runs, per grid, one batched search over all roots
for each of DIRECTION_CONFIGS (direction x fold codec), under keys
"{RxC}_{direction}_{codec}_batch_*", with the `directions` trace.  The
batched search equals the scalar one root by root (the JAX package's own
contract), so a scalar port search is held to its batch row.

With --algos (EDGES.npz then also holds `weights` (E,) uint8) it plans the
graph with those weights and runs, per grid and per (direction, codec) of
ALGO_CONFIGS, `connected_components()` under "{tag}_cc_*", `sssp(roots)`
under "{tag}_sssp_*", `multi_bfs(roots)` under "{tag}_mbfs_*", for the
list codec `multi_bfs(roots, k=2)` under "{tag}_khop_*" and, for the delta
codec, `bfs(roots)` under "{tag}_bfs_*" (tag = "{RxC}_{direction}_{codec}").

With --exchange EX every session runs `BFSConfig(exchange=EX)` ("flat",
"butterfly" or "auto"); with --telemetry every session runs
`BFSConfig(telemetry=True)` and each result's `LevelTrace` is written too,
field by field, under "{prefix}_trace{b}_{field}" (b = 0 for a scalar
search, the batch row otherwise).

With --ft DIR (mid-traversal fault tolerance; EDGES.npz holds `weights`)
it reads DIR/cases.json, written by tests/test_torch_recovery.py, and per
grid runs, with `edge_chunk` 512:
  * "configs" [[direction, codec], ...]: every query of QUERIES
    unsegmented, under "ft_{RxC}_{dtag}_{codec}_{query}_*";
  * "snapshots" [{tag, query, direction, codec, at, telemetry}, ...]: the
    query in a fault-tolerant session (ckpt_every=1) under a persistent
    loss crossing level `at`; the UnrecoverableLoss snapshot is written to
    DIR/jax_{RxC}_{tag} through a `TraversalCheckpointer` (query_key = the
    tag); then the port's snapshot of the same case, read from
    DIR/torch_{RxC}_{tag}, is resumed in a fresh session, under
    "ftx_{RxC}_{tag}_*";
  * "elastic" [{tag, query, kind}, ...]: `ElasticCoordinator` from this
    grid with a persistent ("persistent") or twice-persistent
    ("repeated") loss crossing level 2, under "el_{RxC}_{tag}_*", its
    grid trajectory under "el_{RxC}_{tag}_grids" and its RecoveryPlan
    stats (resumes, segments, retries, resumed_from_level) under
    "el_{RxC}_{tag}_stats".
With --drills (EDGES.npz holds `weights`) it runs the standard fault-drill
matrix, `serve-drain` included, on the first grid (`repro.scenarios.
run_matrix`, edge_chunk 512) and writes the rows as JSON under "drills".

With --multihost (EDGES.npz holds `weights`) it runs, per grid and per
(direction, codec) of MULTIHOST_CONFIGS, the queries of
tests/dist/torch_run_multihost.py with the codec passed to every query:
`bfs(roots[-1])` under "{tag}_bfs1_*", `bfs(roots)` under "{tag}_bfs_*",
`connected_components()` under "{tag}_cc_*", `sssp(roots[-1])` under
"{tag}_sssp_*" and `multi_bfs(roots)` under "{tag}_mbfs_*" (tag =
"{RxC}_{direction}_{codec}").  With --cover only top-down under list and
adaptive under bitmap and delta; with --traced only top-down under list
and adaptive under bitmap (with --telemetry: the traces a process group
is held to).

With --shims it runs, per grid, the deprecated drivers and the engine on
the JAX package's `partition_2d` (edge_chunk 512) from the first root:
`BFS2D` under each fold codec under "{RxC}_bfs2d_{codec}_*",
`BFS2DDirection` under "{RxC}_dir_*", for a 1 x P grid `BFS1D` over a
("p",) mesh of P devices under "{RxC}_bfs1d_*", and `DistBFSEngine` with
the default step under "{RxC}_engine_*", with an identity `step_factory`
under "{RxC}_ident_*" and its `run_batch(roots)` under
"{RxC}_engine_batch_*".

With --spmm (EDGES.npz also holds `x` and `xi` (n, d) float32 features,
random and integer-valued, `gy` (n, d) an output gradient and `weights`
(E,) uint8) it runs, per grid, the 2D SpMM on the JAX package's
`partition_2d`: `make_spmm2d(grid, mesh)` on x under "{RxC}_spmm_y", on
xi under "{RxC}_spmm_yi", `spmm2d_device` under `shard_map` with the
`partition_edge_vals` weights on x under "{RxC}_spmm_yw", and the gradient
of sum(make_spmm2d(x) * gy) with respect to x under "{RxC}_spmm_gx".

With --moe (EDGES.npz then holds an MoE layer instead of a graph: `x`
(N, d) tokens, `router` (d, E), `w1`, `w3` (E, d, f), `w2` (E, f, d), `gy`
(N, d) an output gradient, and `top_k`, `n_experts`, `capacity_factor`,
`cap_e_mult`) it runs, on the first grid as a ("data", "model") mesh,
`repro.models.moe.moe_apply` under `shard_map` with tokens over both axes
and experts over "model", for each (quant_dispatch, fsdp_axis) of
MOE_CASES, under jax.jit: the output under "moe_{q}_{fsdp}_y", the aux
under "moe_{q}_{fsdp}_aux" and the gradients of sum(y * gy) + aux with
respect to x, router, w1, w3 and w2 under "moe_{q}_{fsdp}_g{name}".
When EDGES.npz also holds `batch`, each device's shard of
`repro.data.shard_batch(batch, mesh, P(*spec))` for every SHARD_SPECS
entry goes under "shard_{name}_{k}" (k the device's row-major index) and
its first index along each dim under "shard_{name}_{k}_start".

Usage: torch_parity_ref.py EDGES.npz OUT.npz GRID [GRID ...] [--direction]
[--algos] [--exchange EX] [--telemetry] [--ft DIR] [--drills]
[--multihost [--cover | --traced]] [--shims] [--spmm] [--moe] (GRID =
RxC).  EDGES.npz holds `edges` (2, E), `roots` (B,) and `n`.
"""
import dataclasses
import os
import sys

OPTS = sys.argv[3:]
EXCHANGE = OPTS[OPTS.index("--exchange") + 1] if "--exchange" in OPTS \
    else "flat"
FT_DIR = OPTS[OPTS.index("--ft") + 1] if "--ft" in OPTS else None
FLAGS = ("--direction", "--algos", "--telemetry", "--exchange", EXCHANGE,
         "--ft", FT_DIR, "--drills", "--multihost", "--cover", "--traced",
         "--shims", "--spmm", "--moe")
SHIMS = "--shims" in OPTS
MOE = "--moe" in OPTS
MOE_CASES = [(False, None), (True, None), (False, "data"), (True, "data")]
SPMM = "--spmm" in OPTS
MULTIHOST = "--multihost" in OPTS
MULTIHOST_CONFIGS = [(False, "list"), (True, "bitmap"), (True, "delta")] \
    if "--cover" in OPTS else [(False, "list"), (True, "bitmap")] \
    if "--traced" in OPTS else [(d, c) for d in (False, True)
                                for c in ("list", "bitmap", "delta")]
ARGS = [a for a in OPTS if a not in FLAGS]
DRILLS = "--drills" in OPTS
DIRECTION = "--direction" in OPTS
ALGOS = "--algos" in OPTS
TELEMETRY = "--telemetry" in OPTS
KNOBS = dict(exchange=EXCHANGE, telemetry=TELEMETRY)
DIRECTION_CONFIGS = [(False, "bitmap"), (True, "list"), (True, "bitmap"),
                     ("bottomup", "list"), ("bottomup", "bitmap")]
ALGO_CONFIGS = [(d, c) for d in (False, True, "bottomup")
                for c in ("list", "bitmap", "delta")]
GRIDS = [tuple(int(x) for x in g.split("x")) for g in ARGS]
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           f"{max(r * c for r, c in GRIDS)}")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import BFSConfig, DistGraph  # noqa: E402
from repro.dist.compat import make_mesh  # noqa: E402


def direction_tag(direction) -> str:
    return {False: "td", True: "adaptive"}.get(direction, direction)


def put(out, prefix, res, fields=("level", "pred", "n_levels")):
    for f in fields:
        out[f"{prefix}_{f}"] = np.asarray(getattr(res, f))
    out[f"{prefix}_edges"] = np.asarray(res.edges_scanned, np.int64)
    if res.directions is not None:
        out[f"{prefix}_directions"] = np.asarray(res.directions)
    if res.trace is not None:
        traces = res.trace if isinstance(res.trace, tuple) else (res.trace,)
        for b, tr in enumerate(traces):
            for f in dataclasses.fields(tr):
                out[f"{prefix}_trace{b}_{f.name}"] = np.asarray(
                    getattr(tr, f.name))


def put_algos(out, graph, grid, roots):
    """Every value program (and delta BFS) for every ALGO_CONFIGS entry."""
    R, C = grid
    for direction, codec in ALGO_CONFIGS:
        sess = graph.session(BFSConfig(grid=grid, direction=direction,
                                       fold_codec=codec, **KNOBS))
        tag = f"{R}x{C}_{direction_tag(direction)}_{codec}"
        put(out, f"{tag}_cc", sess.connected_components(),
            ("labels", "n_iters"))
        put(out, f"{tag}_sssp", sess.sssp(roots), ("dist", "n_iters"))
        put(out, f"{tag}_mbfs", sess.multi_bfs(roots),
            ("level", "src", "n_levels"))
        if codec == "list":
            put(out, f"{tag}_khop", sess.multi_bfs(roots, k=2),
                ("level", "src", "n_levels"))
        if codec == "delta":
            put(out, f"{tag}_bfs", sess.bfs(roots))


QUERY_FIELDS = {"bfs1": ("level", "pred", "n_levels"),
                "bfs": ("level", "pred", "n_levels"),
                "cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
                "mbfs": ("level", "src", "n_levels")}
METHODS = {"bfs1": "bfs", "bfs": "bfs", "cc": "connected_components",
           "sssp": "sssp", "mbfs": "multi_bfs"}


def query_arg(query, roots):
    """The positional argument of a QUERY_FIELDS query (None: none)."""
    return {"bfs1": int(roots[0]), "bfs": roots[:2], "cc": None,
            "sssp": roots[:2], "mbfs": roots}[query]


def run_query(sess, query, roots, **kw):
    arg = query_arg(query, roots)
    return getattr(sess, METHODS[query])(
        *(() if arg is None else (arg,)), **kw)


def put_ft(out, graph, grid, roots, weights):
    """The --ft outputs of one grid (see the module docstring)."""
    import json

    from repro.runtime import (DeviceLossInjector, ElasticCoordinator,
                               RecoveryPlan, RetryPolicy,
                               TraversalCheckpointer, UnrecoverableLoss)

    R, C = grid
    gtag = f"{R}x{C}"
    with open(os.path.join(FT_DIR, "cases.json")) as f:
        cases = json.load(f)
    base = dict(grid=grid, edge_chunk=512, **KNOBS)
    for direction, codec in cases["configs"]:
        sess = graph.session(BFSConfig(direction=direction,
                                       fold_codec=codec, **base))
        for query, fields in QUERY_FIELDS.items():
            put(out, f"ft_{gtag}_{direction_tag(direction)}_{codec}_{query}",
                run_query(sess, query, roots), fields)
    for case in cases["snapshots"]:
        cfg = BFSConfig(direction=case["direction"], fold_codec=case["codec"],
                        fault_tolerance=True, ckpt_every=1,
                        **dict(base, telemetry=case["telemetry"]))
        tag, query = case["tag"], case["query"]
        plan = RecoveryPlan(injector=DeviceLossInjector(case["at"], fires=1),
                            policy=RetryPolicy(max_retries=0))
        try:
            run_query(graph.session(cfg), query, roots, recovery=plan)
            raise AssertionError(f"{tag}: the loss did not fire")
        except UnrecoverableLoss as e:
            ck = TraversalCheckpointer(os.path.join(FT_DIR,
                                                    f"jax_{gtag}_{tag}"),
                                       tag)
            ck.save(e.snapshot)
            ck.join()
        snap = TraversalCheckpointer(
            os.path.join(FT_DIR, f"torch_{gtag}_{tag}"), tag).load()
        res = run_query(graph.session(cfg), query, roots,
                        recovery=RecoveryPlan(resume=snap))
        put(out, f"ftx_{gtag}_{tag}", res, QUERY_FIELDS[query])
    for case in cases["elastic"]:
        tag, query = case["tag"], case["query"]
        policy = RetryPolicy(max_retries=2, backoff_s=1e-4, jitter_s=1e-4,
                             seed=1)
        losses = 2 if case["kind"] == "repeated" else 1
        plan = RecoveryPlan(injector=DeviceLossInjector(
            2, fires=(policy.max_retries + 1) * losses), policy=policy)
        cfg = BFSConfig(fault_tolerance=True, ckpt_every=1, **base)
        coord = ElasticCoordinator(edges, cfg, weights=weights, n=n,
                                   max_shrinks=losses + 1)
        arg = query_arg(query, roots)
        res = coord.run(METHODS[query], arg, plan=plan)
        put(out, f"el_{gtag}_{tag}", res, QUERY_FIELDS[query])
        out[f"el_{gtag}_{tag}_grids"] = np.asarray(coord.grids, np.int64)
        out[f"el_{gtag}_{tag}_stats"] = np.asarray(
            [plan.stats["resumes"], plan.stats["segments"],
             plan.stats["retries"], plan.stats["resumed_from_level"]],
            np.int64)


def put_drills(out, grid, weights):
    """The drill matrix, serve-drain included, its rows as one JSON
    string."""
    import json

    from repro.scenarios import run_matrix, standard_matrix

    rows = [r.to_row() for r in run_matrix(
        edges, BFSConfig(grid=grid, edge_chunk=512), weights=weights, n=n,
        scenarios=standard_matrix())]
    out["drills"] = np.asarray(json.dumps(rows))


def put_multihost(out, grid):
    """The --multihost outputs of one grid (see the module docstring)."""
    R, C = grid
    mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
    graph = DistGraph.from_edges(edges, BFSConfig(grid=grid), mesh=mesh, n=n,
                                 weights=data["weights"])
    root = int(roots[-1])
    for direction, codec in MULTIHOST_CONFIGS:
        sess = graph.session(BFSConfig(grid=grid, direction=direction,
                                       fold_codec=codec, **KNOBS))
        tag = f"{R}x{C}_{direction_tag(direction)}_{codec}"
        put(out, f"{tag}_bfs1", sess.bfs(root))
        put(out, f"{tag}_bfs", sess.bfs(roots))
        put(out, f"{tag}_cc", sess.connected_components(fold_codec=codec),
            ("labels", "n_iters"))
        put(out, f"{tag}_sssp", sess.sssp(root, fold_codec=codec),
            ("dist", "n_iters"))
        put(out, f"{tag}_mbfs", sess.multi_bfs(roots, fold_codec=codec),
            ("level", "src", "n_levels"))


def put_shims(out, grid):
    """The --shims outputs of one grid (see the module docstring)."""
    import warnings

    import jax.numpy as jnp

    from repro.core import Grid2D, partition_2d
    from repro.core.bfs1d import BFS1D
    from repro.core.bfs2d import BFS2D
    from repro.core.direction import BFS2DDirection
    from repro.core.partition import partition_2d_csr
    from repro.core.types import LocalGraph2D
    from repro.dist import DistBFSEngine, Topology

    def as_graph(lg):
        return LocalGraph2D(jnp.asarray(lg.col_off), jnp.asarray(lg.row_idx),
                            jnp.asarray(lg.nnz))

    warnings.simplefilter("ignore", DeprecationWarning)
    R, C = grid
    tag, root = f"{R}x{C}", int(roots[0])
    devices = jax.devices()[:R * C]
    mesh = make_mesh((R, C), ("r", "c"), devices=devices)
    g2 = Grid2D.for_vertices(n, R, C)
    graph = as_graph(partition_2d(edges, g2))
    for codec in ("list", "bitmap", "delta"):
        put(out, f"{tag}_bfs2d_{codec}",
            BFS2D(g2, mesh, edge_chunk=512, fold_codec=codec).run(graph,
                                                                  root))
    csr = {k: jnp.asarray(v) for k, v in partition_2d_csr(edges, g2).items()}
    put(out, f"{tag}_dir",
        BFS2DDirection(g2, mesh, edge_chunk=512).run(graph, csr, root))
    if R == 1:
        bfs1 = BFS1D(n, make_mesh((C,), ("p",), devices=devices),
                     edge_chunk=512)
        put(out, f"{tag}_bfs1d",
            bfs1.run(as_graph(partition_2d(edges, bfs1.grid)), root))
    topo = Topology(g2, mesh)
    eng = DistBFSEngine(topo, edge_chunk=512)
    put(out, f"{tag}_engine", eng.run(graph, root))
    put(out, f"{tag}_engine_batch", eng.run_batch(graph, jnp.asarray(roots)))
    ident = DistBFSEngine(
        topo, edge_chunk=512,
        step_factory=lambda e, g, x, i, j, topdown: (
            lambda st, prev_total: topdown(st)))
    put(out, f"{tag}_ident", ident.run(graph, root))


def put_spmm(out, grid):
    """The --spmm outputs of one grid (see the module docstring)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import Grid2D, partition_2d
    from repro.core.partition import partition_edge_vals
    from repro.core.spmm2d import make_spmm2d, spmm2d_device
    from repro.core.types import LocalGraph2D
    from repro.dist.compat import shard_map

    R, C = grid
    tag = f"{R}x{C}_spmm"
    mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
    g2 = Grid2D.for_vertices(n, R, C)
    lg = partition_2d(edges, g2)
    co, ri, nz = (jnp.asarray(a) for a in (lg.col_off, lg.row_idx, lg.nnz))
    spmm = make_spmm2d(g2, mesh)
    out[f"{tag}_y"] = np.asarray(spmm(co, ri, nz, jnp.asarray(data["x"])))
    out[f"{tag}_yi"] = np.asarray(spmm(co, ri, nz, jnp.asarray(data["xi"])))
    out[f"{tag}_gx"] = np.asarray(jax.grad(
        lambda x: jnp.sum(spmm(co, ri, nz, x) * jnp.asarray(data["gy"])))(
            jnp.asarray(data["x"])))
    w = jnp.asarray(partition_edge_vals(edges, data["weights"], g2))

    def body(co, ri, nz, x, w):
        g = LocalGraph2D(col_off=co[0, 0], row_idx=ri[0, 0], nnz=nz[0, 0])
        return spmm2d_device(g, x, grid=g2, row_axes=("r",),
                             col_axes=("c",), edge_weight=w[0, 0])

    dev, xspec = P(("r",), ("c",)), P(("c", "r"))
    out[f"{tag}_yw"] = np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=(dev, dev, dev, xspec, dev),
        out_specs=xspec, check_vma=False))(co, ri, nz,
                                           jnp.asarray(data["x"]), w))


def put_moe(out, grid):
    """The --moe outputs (see the module docstring)."""
    import jax.numpy as jnp

    from repro.models.moe import MoEShard, moe_apply

    class Cfg:
        top_k = int(data["top_k"])
        n_experts = int(data["n_experts"])
        capacity_factor = float(data["capacity_factor"])
        cap_e_mult = int(data["cap_e_mult"])

    R, C = grid
    mesh = make_mesh((R, C), ("data", "model"), devices=jax.devices()[:R * C])
    names = ("x", "router", "w1", "w3", "w2")
    args = tuple(jnp.asarray(data[k]) for k in names)
    gy = jnp.asarray(data["gy"])
    for quant, fsdp in MOE_CASES:
        shard = MoEShard(mesh=mesh, token_axes=("data", "model"),
                         expert_axis="model", fsdp_axis=fsdp,
                         quant_dispatch=quant)

        def run(x, router, w1, w3, w2):
            return moe_apply(x, {"router": router, "w1": w1, "w3": w3,
                                 "w2": w2}, Cfg, mesh=shard)

        def objective(*a):
            y, aux = run(*a)
            return jnp.sum(y * gy) + aux

        y, aux = jax.jit(run)(*args)
        grads = jax.jit(jax.grad(objective, argnums=tuple(range(5))))(*args)
        tag = f"moe_{int(quant)}_{fsdp}"
        out[f"{tag}_y"], out[f"{tag}_aux"] = np.asarray(y), np.asarray(aux)
        for k, g in zip(names, grads):
            out[f"{tag}_g{k}"] = np.asarray(g)
    if "batch" in data.files:
        put_shards(out, mesh, data["batch"])


# --moe's shard_batch specs (name -> PartitionSpec entries)
SHARD_SPECS = {"default": (("pod", "data"),), "data_model": (("data", "model"),),
               "model_data": (("model", "data"),), "model": ("model",),
               "rows_cols": ("data", "model")}


def put_shards(out, mesh, batch):
    """`repro.data.shard_batch`'s shard on every device of the mesh (row-major
    order k) for each SHARD_SPECS entry: "shard_{name}_{k}" its data and
    "shard_{name}_{k}_start" its first index along each dim."""
    from jax.sharding import PartitionSpec as P

    from repro.data.pipeline import shard_batch
    for name, spec in SHARD_SPECS.items():
        arr = shard_batch(batch, mesh, P(*spec))
        by_dev = {s.device: s for s in arr.addressable_shards}
        for k, d in enumerate(mesh.devices.flat):
            sh = by_dev[d]
            out[f"shard_{name}_{k}"] = np.asarray(sh.data)
            out[f"shard_{name}_{k}_start"] = np.asarray(
                [sl.start or 0 for sl in sh.index], np.int64)


def put_grid(out, grid):
    """The parity outputs of one grid (the modes before --ft)."""
    R, C = grid
    mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
    graph = DistGraph.from_edges(
        edges, BFSConfig(grid=(R, C)), mesh=mesh, n=n,
        weights=data["weights"] if ALGOS else None)
    sess = graph.session(BFSConfig(grid=(R, C), **KNOBS))
    tag = f"{R}x{C}"
    put(out, f"{tag}_scalar", sess.bfs(int(roots[0])))
    put(out, f"{tag}_batch", sess.bfs(roots))
    if DIRECTION:
        for direction, codec in DIRECTION_CONFIGS:
            sess = graph.session(BFSConfig(grid=(R, C), direction=direction,
                                           fold_codec=codec, **KNOBS))
            put(out, f"{tag}_{direction_tag(direction)}_{codec}_batch",
                sess.bfs(roots))
    if ALGOS:
        put_algos(out, graph, (R, C), roots)


data = np.load(sys.argv[1])
out = {}
if MOE:
    put_moe(out, GRIDS[0])
    np.savez(sys.argv[2], **out)
    print("OK")
    sys.exit(0)
edges, roots, n = data["edges"], data["roots"], int(data["n"])
if DRILLS:
    put_drills(out, GRIDS[0], data["weights"])
elif MULTIHOST:
    for grid in GRIDS:
        put_multihost(out, grid)
elif SHIMS:
    for grid in GRIDS:
        put_shims(out, grid)
elif SPMM:
    for grid in GRIDS:
        put_spmm(out, grid)
elif FT_DIR is not None:
    for R, C in GRIDS:
        mesh = make_mesh((R, C), ("r", "c"), devices=jax.devices()[:R * C])
        put_ft(out, DistGraph.from_edges(edges, BFSConfig(grid=(R, C)),
                                         mesh=mesh, n=n,
                                         weights=data["weights"]),
               (R, C), roots, data["weights"])
else:
    for grid in GRIDS:
        put_grid(out, grid)
np.savez(sys.argv[2], **out)
print("OK")
