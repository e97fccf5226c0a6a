"""The port's session API across a REAL `torch.distributed` process group,
held to the JAX package (the port's `tests/dist/run_multihost.py`).

    torch_run_multihost.py NPROC LOCAL [EXCHANGE] [--grid RxC]
                           [--mode queries|collectives|surface]
                           [--configs all|td|adaptive|cover] [--ref REF.npz]
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
and value folds travel).  Every rank writes its outputs; every field of every
rank must equal the reference: the JAX package's outputs
(`torch_parity_ref.py --multihost`, run in a child on forced host devices,
or read from --ref), or with `--device cuda` the port's stacked session on
the card.

--mode collectives: every rank holds `GroupTopology.row_gather`,
`col_all_to_all` (flat and butterfly), `psum_all` and `fetch` to
`StackedTopology`'s on random int32, int64, uint32, uint16 and bool
tensors, and counts the transfers: flat makes one all_to_all a fold, the
butterfly log2(C) stages a fold, of which the ones whose partner column
lies on another rank are pairwise exchanges.

--mode surface: `DistGraph.from_partition(..., mesh=)` keeps this rank's
blocks of a whole-grid partition and answers as the `from_edges` graph
does; in the group, telemetry, fault tolerance, recovery=,
bfs(validate=...) and GraphServer raise NotImplementedError naming ROADMAP
A13 part 2.

Every group launch has a deadline (--timeout, default 240 s): on expiry
every rank is killed and the script fails.  Prints "OK" on success.
"""
import argparse
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
FIELDS = {"bfs1": ("level", "pred", "n_levels"),
          "bfs": ("level", "pred", "n_levels"),
          "cc": ("labels", "n_iters"), "sssp": ("dist", "n_iters"),
          "mbfs": ("level", "src", "n_levels")}
A13_2 = "ROADMAP A13 part 2"


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("nproc", type=int)
    ap.add_argument("local", type=int)
    ap.add_argument("exchange", nargs="?", default="flat")
    ap.add_argument("--grid", default=None)
    ap.add_argument("--mode", default="queries",
                    choices=("queries", "collectives", "surface"))
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


def run_queries(graph, configs, grid, exchange):
    """Every config's queries through the session API -> {key: numpy}, the
    keys of `torch_parity_ref.py --multihost` after "{exchange}:"."""
    import numpy as np
    import torch

    from repro_torch.api import BFSConfig

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    out = {}
    R, C = grid
    roots = np.asarray(BATCH, np.int32)
    for ex, (direction, codec) in ((e, c) for e in exchanges(exchange)
                                   for c in configs):
        s = graph.session(BFSConfig(grid=grid, direction=direction,
                                    fold_codec=codec, exchange=ex))
        tag = f"{ex}:{R}x{C}_{dtag(direction)}_{codec}"
        res = {"bfs1": s.bfs(ROOT), "bfs": s.bfs(roots),
               "cc": s.connected_components(fold_codec=codec),
               "sssp": s.sssp(ROOT, fold_codec=codec),
               "mbfs": s.multi_bfs(roots, fold_codec=codec)}
        for q, r in res.items():
            for f in FIELDS[q]:
                out[f"{tag}_{q}_{f}"] = host(getattr(r, f))
            out[f"{tag}_{q}_edges"] = np.asarray(r.edges_scanned, np.int64)
            if r.directions is not None:
                out[f"{tag}_{q}_directions"] = host(r.directions)
    return out


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
    out = run_queries(graph, CONFIGS[a.configs], a.grid, a.exchange)
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
    from repro_torch.runtime import RecoveryPlan
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
    cases = {
        "telemetry": lambda: graph.session(BFSConfig(
            grid=a.grid, telemetry=True)),
        "fault_tolerance": lambda: graph.session(BFSConfig(
            grid=a.grid, fault_tolerance=True, ckpt_every=2)),
        "recovery=": lambda: s.bfs(ROOT, recovery=RecoveryPlan()),
        "validate=True": lambda: s.bfs(ROOT, validate=True),
        "validate=edges": lambda: s.bfs(ROOT, validate=edges),
        "GraphServer": lambda: GraphServer({"g": graph}),
    }
    for what, fn in cases.items():
        try:
            fn()
        except NotImplementedError as e:
            if A13_2 not in str(e):
                raise AssertionError(f"{what}: the error does not name "
                                     f"{A13_2}: {e}")
            continue
        raise AssertionError(f"{what} did not raise in a process group")
    # the group still answers after the refusals
    out = s.bfs(ROOT)
    assert int(out.n_levels) > 1 and out.level.shape == (graph.grid.n,)
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
                        ex] + (["--cover"] if a.configs == "cover" else []),
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
    out = run_queries(graph, CONFIGS[a.configs], a.grid, "flat")
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
         "surface": worker_surface}[ROLE](args)
