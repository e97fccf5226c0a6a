"""Two-phase session API: plan/residency vs query (DESIGN.md sec. 7), the
port of `repro/api/session.py`.

Phase 1 -- `DistGraph.from_edges(edges, config)` resolves the grid and
partitions the graph on the device (or `DistGraph.from_partition` takes a
partition already built).  The result is a resident graph that answers
many queries.

Phase 2 -- `GraphSession.bfs(roots)` runs searches against it: a scalar
root returns one `BFSOutput`, a (B,) batch returns batched outputs equal to
the roots run one by one.  `connected_components()`, `sssp(roots)` (over
the weights planned with `from_edges(..., weights=)`) and
`multi_bfs(sources, k)` run the value programs through the same engine.
With `BFSConfig(telemetry=True)` every query also returns its per-level
`LevelTrace` (`output.trace`, `GraphSession.last_trace()`).  With
`BFSConfig(fault_tolerance=True, ckpt_every=K)` every query runs the
segmented level loop under `repro_torch.runtime.run_segmented` and takes
`recovery=RecoveryPlan(...)` (checkpointer, loss injector, retry policy,
a snapshot to resume from); outputs are bit-identical.

Every query that is not fault-tolerant goes through the graph's executable
cache (`AOTCache`, keyed as the JAX package keys its AOT executables:
engine key, graph array shapes, batch size or argument shape).  PyTorch
runs eagerly, so an entry is the engine's entry point bound to the graph's
arrays and the batch size, and a miss builds one (`FrontierEngine.
trace_count` counts them); `cache_stats()` equals the JAX graph's on the
same calls.  Capturing the level loop in CUDA graphs is later work.

The edge list, its (E,) weights and the Graph500 `EdgeIndex` stay on the
device only while the CSR twin is unplanned: `ensure_csr` drops them once
both layouts are resident, `release_edges()` drops them at once, and
`bfs(validate=True)` then asks for the edge array (`validate=edges`), as
in the JAX package.

Across a process group (`from_edges(..., mesh=multihost.global_mesh(...))`)
every rank plans and holds only its blocks of the grid, built from the host
edge list every rank holds (numpy, memory-mapped ones included, streamed to
the device a piece at a time), and the same queries on every rank return
the whole grid's outputs on every rank.  Telemetry, fault tolerance with
`recovery=` and `bfs(validate=...)` run there too, every rank taking each
decision from group-wide values; serving raises there (ROADMAP A13
part 3).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.algos.bfs import BFSLevelsProgram
from repro_torch.algos.cc import CCOutput, ConnectedComponentsProgram
from repro_torch.algos.direction import DirectionProgram
from repro_torch.algos.engine import FrontierEngine
from repro_torch.algos.multi_bfs import MultiBFSOutput, \
    MultiSourceBFSProgram
from repro_torch.algos.sssp import SSSPOutput, SSSPProgram
from repro_torch.api.config import BFSConfig
from repro_torch.core.partition import global_from_row, \
    partition_2d_csr_with_vals, partition_2d_with_vals
from repro_torch.core.types import BFSOutput, Grid2D, LocalGraph2D, \
    resolve_device
from repro_torch.core.validate import EDGE_PIECE, EdgeIndex, \
    validate_bfs, validate_bfs_group
from repro_torch.dist import multihost
from repro_torch.dist.topology import GroupTopology, StackedTopology


def check_vertex_ids(ids, n: int, what: str = "roots") -> None:
    """Session-boundary input validation (DESIGN.md sec. 12): raises
    ValueError naming the graph's n and the expected dtype; accepts anything
    integer-typed convertible to int32 (numpy, Python ints, torch)."""
    arr = ids.cpu().numpy() if isinstance(ids, torch.Tensor) \
        else np.asarray(ids)
    if not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{what} must be integer vertex ids (int32-convertible), got "
            f"dtype {arr.dtype}")
    if arr.size:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= n:
            bad = lo if lo < 0 else hi
            raise ValueError(
                f"{what} contain out-of-range vertex id {bad}; this graph "
                f"has n = {n} vertices, valid ids are 0 <= id < {n}")


def _host_ids(ids) -> np.ndarray:
    """Vertex ids (numpy, Python ints, torch) as an int64 numpy array."""
    return np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids,
                      dtype=np.int64)


def _edge_tensor(edges, device) -> torch.Tensor:
    """A (2, E) edge list (numpy or torch) as an int32 tensor on device."""
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.array(edges, dtype=np.int32))
    return edges.to(device=device, dtype=torch.int32)


def _value_tensor(vals, device) -> torch.Tensor:
    """Per-edge values (numpy or torch) as a tensor on device, dtype kept."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.array(vals))
    return vals.to(device=device)


class AOTCache:
    """Bounded LRU over the graph's executable-cache entries, with
    serve-grade stats (the JAX package's `AOTCache`, same behaviour).

    One entry per (engine key, graph shapes, batch size or argument
    shape).  Eviction rebuilds the entry on next use, so the bound trades
    rebuilds for memory, never correctness.  `hits` / `misses` /
    `evictions` feed `repro_torch.serve` accounting.
    """

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"AOTCache needs maxsize >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        try:
            value = self._entries[key]
        except KeyError:
            self.misses += 1
            return default
        self._entries.move_to_end(key)
        self.hits += 1
        return value

    def __setitem__(self, key, value):
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)
            self.evictions += 1

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):          # no stats: introspection only
        return key in self._entries

    def stats(self) -> dict:
        return {"size": len(self._entries), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


@dataclasses.dataclass(frozen=True, eq=False)
class Runnable:
    """One entry of the executable cache: an engine's entry point bound to
    the graph's arrays (`extra`: the CSR twin, weights) and, for a rooted
    program, a batch size B.  A batched entry runs a list of B roots
    through `run_batch` and a scalar root through `run` (the scalar query
    is the B = 1 entry, as in the JAX session); any other entry runs its
    argument through `run`."""
    engine: FrontierEngine
    graph: LocalGraph2D
    extra: tuple
    B: int | None = None

    def __repr__(self) -> str:
        return (f"Runnable({self.engine.program.name}, "
                f"B={self.B if self.B is not None else '-'})")

    def __call__(self, arg):
        if self.B is not None and isinstance(arg, list):
            return self.engine.run_batch(self.graph, arg, self.extra)
        return self.engine.run(self.graph, arg, self.extra)


def build_engine(topology: StackedTopology, config: BFSConfig) \
        -> FrontierEngine:
    """One engine per (topology, engine key): the BFS level loop with the
    config's codec, chunking, paths and direction baked in, independent of
    the graph's data."""
    program = BFSLevelsProgram()
    if config.direction_mode is not None:
        program = DirectionProgram(program, mode=config.direction_mode,
                                   alpha=config.alpha, beta=config.beta)
    return FrontierEngine(
        topology, program, fold_codec=config.fold_codec,
        edge_chunk=config.edge_chunk, max_levels=config.max_levels,
        expand=config.expand, expand_fn=config.expand_fn, fold=config.fold,
        dedup=config.dedup, bottomup=config.bottomup,
        exchange=config.exchange, telemetry=config.telemetry,
        fault_tolerance=config.fault_tolerance,
        ckpt_every=config.ckpt_every)


_NO_EDGES = ("this DistGraph holds no edge list: it is released once the "
             "CSR twin is planned or by release_edges(), and "
             "from_partition keeps only what it is given")


class DistGraph:
    """A resident, partitioned graph: plan once, query many.  On one
    device it holds the whole grid; across a process group, this rank's
    blocks of it (`topology.local`).

    Holds the stacked CSC blocks, the CSR twin once a direction-enabled
    session needs it, the per-edge weights in CSC order (and in CSR order
    beside the CSR twin) when planned with them, the topology, and the
    engine and executable caches every session over this graph shares.
    While the CSR twin is unplanned it also holds the edge list, its (E,)
    weights (what the CSR build lays out) and, once `bfs(validate=True)`
    ran, the Graph500 `EdgeIndex`; `ensure_csr` and `release_edges` drop
    all three, as the JAX graph drops its host edges."""

    def __init__(self, topology: StackedTopology, csc: LocalGraph2D, *,
                 csr: dict | None = None, edges=None, n: int | None = None,
                 config: BFSConfig = None, weights=None, csr_weights=None,
                 edge_weights=None, aot_cache_size: int = 32):
        self.topology = topology
        self.grid = topology.grid
        self.device = topology.device
        self.mesh = getattr(topology, "mesh", None)
        self.csc = csc
        self.csr = csr
        self.n = int(n) if n is not None else topology.grid.n
        self.config = config if config is not None else BFSConfig()
        self.weights = weights            # (R, C, e_max) in CSC order
        self.csr_weights = csr_weights    # (R, C, e_max) in CSR order
        # kept ONLY while the CSR twin may still have to be planned
        self.edges = edges if csr is None else None
        self.edge_weights = edge_weights if csr is None else None
        self._edge_index = None
        self._engines = {}           # engine key -> engine (BFS or value)
        # (engine key, shapes, B or arg shape) -> Runnable, a bounded LRU
        self._compiled = AOTCache(aot_cache_size)

    @classmethod
    def from_edges(cls, edges, config: BFSConfig = None, *, mesh=None,
                   device=None, n: int | None = None, weights=None,
                   aot_cache_size: int = 32) -> "DistGraph":
        """Plan a graph into residency: partition on the device.

        edges: (2, E) [src, dst] numpy array or torch tensor.  device: None
        = CUDA (raises without a card).  n defaults to max vertex id + 1;
        the grid pads it up to a multiple of R*C.  weights: optional (E,)
        per-edge values (uint8 for SSSP), numpy or tensor, laid out in the
        CSC order and kept resident beside the graph.  The CSR twin (and
        the CSR-ordered weights) is planned lazily, on the first
        direction-enabled session (`ensure_csr`), which then drops the edge
        list and its weights.  aot_cache_size: bound of the graph's
        executable cache (`AOTCache`).

        mesh: a `dist.multihost.ProcessMesh` -- plan this rank's blocks of
        the mesh's grid only, on the mesh's device, from `edges` /
        `weights` as given (the same host copy on every rank; a numpy array
        stays on the host and is streamed a piece at a time)."""
        config = config if config is not None else BFSConfig()
        if mesh is not None:
            return cls._from_edges_group(edges, config, mesh, device, n,
                                         weights, aot_cache_size)
        device = resolve_device(device)
        edges = _edge_tensor(edges, device)
        if n is None:
            n = int(edges.max()) + 1 if edges.numel() else 1
        grid = config.resolve_grid(n)
        w_edge = None if weights is None else _value_tensor(weights, device)
        csc, w = partition_2d_with_vals(edges, w_edge, grid)
        return cls(StackedTopology(grid, device), csc, edges=edges, n=n,
                   config=config, weights=w, edge_weights=w_edge,
                   aot_cache_size=aot_cache_size)

    @classmethod
    def _from_edges_group(cls, edges, config, mesh, device, n, weights,
                          aot_cache_size) -> "DistGraph":
        """`from_edges` over a process group: this rank's blocks only."""
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device={device} but the process mesh's rank "
                             f"runs on {mesh.device}")
        if n is None:
            n = int(edges.max()) + 1 if edges.shape[1] else 1
        grid = config.resolve_grid(n, mesh)
        topo = GroupTopology(grid, mesh)
        csc, w = partition_2d_with_vals(edges, weights, grid,
                                        local=topo.local, device=mesh.device)
        return cls(topo, csc, edges=edges, n=n, config=config, weights=w,
                   edge_weights=weights, aot_cache_size=aot_cache_size)

    @classmethod
    def from_partition(cls, grid: Grid2D, csc: LocalGraph2D,
                       config: BFSConfig = None, *, mesh=None,
                       n: int | None = None, edges=None,
                       csr: dict | None = None, weights=None,
                       csr_weights=None) -> "DistGraph":
        """A graph whose partition is already built (for example from the
        JAX package's `partition_2d` / `partition_2d_csr` /
        `partition_edge_vals(_csr)` through `repro_torch.convert`).  The
        device is the partition's; `edges` enables `bfs(validate=True)` and
        a lazy CSR build (and is dropped when `csr` is given), `csr`
        supplies the CSR twin directly; `weights` /
        `csr_weights` are the (R, C, e_max) per-edge values in CSC / CSR
        order.

        mesh: a `dist.multihost.ProcessMesh` -- the arrays are the whole
        grid's (host or device, the same on every rank) and this rank keeps
        its blocks of them (`multihost.put_dev`) on the mesh's device;
        `edges` stays as given, for a lazy CSR build of those blocks."""
        config = config if config is not None else BFSConfig()
        if config.grid is not None and config.resolve_grid(
                n if n is not None else grid.n) != grid:
            raise ValueError(f"config grid {config.grid} does not match the "
                             f"partition's {grid.R}x{grid.C}")
        if mesh is not None:
            def place(x):
                return None if x is None else multihost.put_dev(x, mesh)
            topo = GroupTopology(grid, mesh)
            csc = LocalGraph2D(*(place(getattr(csc, f.name))
                                 for f in dataclasses.fields(csc)))
            if csr is not None:
                csr = {k: place(v) for k, v in csr.items()}
            return cls(topo, csc, csr=csr, edges=edges, n=n, config=config,
                       weights=place(weights),
                       csr_weights=place(csr_weights))
        device = csc.col_off.device
        if edges is not None:
            edges = _edge_tensor(edges, device)
        return cls(StackedTopology(grid, device), csc, csr=csr,
                   edges=edges, n=n, config=config, weights=weights,
                   csr_weights=csr_weights)

    def ensure_csr(self) -> dict:
        """Plan the CSR twin on demand (the first direction-enabled
        session), block by block from the resident edge list; with weights,
        also their CSR-ordered copy (direction-optimised SSSP pulls over
        it).  Both layouts resident, the edge list, its weights and the
        `EdgeIndex` are dropped (`release_edges`)."""
        if self.csr is None:
            if self.edges is None:
                raise ValueError(
                    f"direction optimisation needs the CSR twin, but "
                    f"{_NO_EDGES}; pass csr= to from_partition, or plan "
                    f"with from_edges")
            self.csr, self.csr_weights = partition_2d_csr_with_vals(
                self.edges, self.edge_weights, self.grid,
                local=self.topology.local, device=self.device)
            self.release_edges()
        return self.csr

    def release_edges(self) -> None:
        """Drop the edge list, its (E,) weights and the `EdgeIndex` (a
        long-lived serving graph that will open no direction-enabled
        session and validates, if at all, against an edge array it is
        given)."""
        self.edges = None
        self.edge_weights = None
        self._edge_index = None

    def cache_stats(self) -> dict:
        """Hit / miss / eviction counters of the executable cache (what
        `repro_torch.serve` accounting and its metrics registry read)."""
        return self._compiled.stats()

    def aot_cache_stats(self) -> dict:
        """Deprecated spelling of `cache_stats()` (same dict)."""
        warnings.warn(
            "DistGraph.aot_cache_stats() is deprecated; use "
            "DistGraph.cache_stats() (same dict)", DeprecationWarning,
            stacklevel=2)
        return self.cache_stats()

    def engine_for(self, config: BFSConfig) -> FrontierEngine:
        key = config.engine_key
        eng = self._engines.get(key)
        if eng is None:
            eng = build_engine(self.topology, config)
            self._engines[key] = eng
        return eng

    def edge_index(self) -> EdgeIndex:
        """The sorted edge keys of rule 4, built once per graph (and
        dropped with the edge list).  Stacked graphs only: a rank of a
        process group checks its own blocks' edges instead
        (`_block_edge_pieces`)."""
        if self.topology.distributed:
            raise ValueError("a rank of a process group holds no EdgeIndex; "
                             "it validates over its blocks' edges")
        if self._edge_index is None:
            self._edge_index = EdgeIndex(self._edges_or_raise(), self.n)
        return self._edge_index

    def _edges_or_raise(self):
        """The planned edge list, or the ValueError `bfs(validate=True)`
        raises once it is released."""
        if self.edges is None:
            raise ValueError(
                f"bfs(validate=True) needs the edge list, but "
                f"{_NO_EDGES}; pass the edge array: bfs(roots, "
                f"validate=edges)")
        return self.edges

    def _block_edge_pieces(self):
        """This rank's blocks' directed edges (u, v) as int64 pieces of at
        most EDGE_PIECE / 2 edges (ranks may share a card), on the device:
        read back from the CSC blocks, which hold every edge of the planned
        list (self-loops and repeats included) that lands on the block, so
        the ranks' pieces together are the edge list.  Nothing is read from
        the host."""
        grid, blk = self.grid, self.topology.local
        csc = self.csc
        ncl = grid.n_cols_local
        piece = EDGE_PIECE // 2
        for i, j in blk.coords():
            li, lj = blk.loc(i, j)
            col_off = csc.col_off[li, lj]
            nnz = int(csc.nnz[li, lj])
            for a in range(0, nnz, piece):
                k = torch.arange(a, min(a + piece, nnz),
                                 device=col_off.device)
                col = torch.searchsorted(col_off, k, right=True) - 1
                yield (j * ncl + col,
                       global_from_row(csc.row_idx[li, lj, a:a + k.numel()]
                                       .long(), i, grid))

    def session(self, config: BFSConfig = None) -> "GraphSession":
        """Open a query session (defaults to the planning config)."""
        return GraphSession(self, config if config is not None
                            else self.config)


class GraphSession:
    """Query phase: many BFS searches over one resident DistGraph.

    engine: the BFS engine to run (None = the graph's engine for the
    config); the deprecated drivers pass theirs, built once per driver."""

    def __init__(self, graph: DistGraph, config: BFSConfig = None, *,
                 engine: FrontierEngine = None):
        self.graph = graph
        self.config = config if config is not None else graph.config
        # exchange="auto" resolves against the PLANNED grid and an explicit
        # strategy is validated here, so every engine below keys on the
        # concrete strategy and an impossible request fails now
        self.config = self.config.resolve_exchange(graph.grid)
        if self.config.grid is not None:
            want = self.config.resolve_grid(graph.n, graph.mesh)
            if want != graph.grid:
                raise ValueError(
                    f"session config asks for a {want.R}x{want.C} grid but "
                    f"the resident graph is planned {graph.grid.R}x"
                    f"{graph.grid.C}; re-plan with DistGraph.from_edges")
        self.extra = ()
        if self.config.direction_mode is not None:
            csr = graph.ensure_csr()
            self.extra = (csr["row_off"], csr["col_idx"])
        self.engine = engine if engine is not None \
            else graph.engine_for(self.config)
        # the last LevelTrace (scalar) / tuple of traces (batch) of THIS
        # session's queries; None until a telemetry=True query completes
        self._last_trace = None

    def last_trace(self):
        """The per-level `repro_torch.obs.LevelTrace` of this session's most
        recent query: one trace for a scalar query, a tuple of B for a
        batched one.  None unless the config has telemetry=True and a
        query has run."""
        return self._last_trace

    def _traced(self, out):
        """Keep a query's trace as `last_trace()`; returns the output."""
        if out.trace is not None:
            self._last_trace = out.trace
        return out

    def _run_recoverable(self, eng, arg, *extra, B=None, recovery=None):
        """Fault-tolerant query path: the segmented engine loop under the
        recovery driver (DESIGN.md sec. 15) instead of one whole search.
        Bit-identical outputs; `recovery` is the RecoveryPlan carrying
        checkpointer / injector / retry policy."""
        from repro_torch.runtime.recovery import run_segmented
        return run_segmented(eng, self.graph.csc, arg, *extra, B=B,
                             n=self.graph.n, plan=recovery)

    def _check_recovery(self, recovery) -> bool:
        if recovery is not None and not self.config.fault_tolerance:
            raise ValueError(
                "recovery= needs a fault-tolerant session; open it with "
                "BFSConfig(fault_tolerance=True)")
        return self.config.fault_tolerance

    def compiled_for(self, B: int) -> Runnable:
        """The executable-cache entry of a (B,)-roots BFS sweep, cached on
        the DistGraph keyed by (engine key, graph array shapes, B).

        Public capacity surface: `repro_torch.serve` warms its padding
        classes through this before admitting traffic.  Returns the entry
        (`bfs` is the ergonomic path)."""
        if B < 1:
            raise ValueError(f"batch capacity B must be >= 1, got {B}")
        g = self.graph.csc
        key = (self.config.engine_key, tuple(g.col_off.shape),
               tuple(g.row_idx.shape), B)
        entry = self.graph._compiled.get(key)
        if entry is None:
            entry = Runnable(self.engine, g, self.extra, B)
            self.engine.trace_count += 1
            self.graph._compiled[key] = entry
        return _bound(entry, g, self.extra)

    def _algo_compiled(self, eng, key, arg_shape: tuple, extra, *,
                       batched: bool = False) -> Runnable:
        """The executable-cache entry of one value program, cached on the
        DistGraph keyed by (engine key, graph array shapes, batched, arg
        shape)."""
        g = self.graph.csc
        ckey = (key, tuple(g.col_off.shape), tuple(g.row_idx.shape),
                batched, tuple(arg_shape))
        entry = self.graph._compiled.get(ckey)
        if entry is None:
            entry = Runnable(eng, g, extra, arg_shape[0] if batched else None)
            eng.trace_count += 1
            self.graph._compiled[ckey] = entry
        return _bound(entry, g, extra)

    def _run_roots(self, eng, roots_np, extra, recovery, entry_for):
        """A scalar-or-batch rooted query (BFS, SSSP) through the cache
        entry `entry_for(B)` (a scalar root is the B = 1 entry).  Under
        fault tolerance the query bypasses the cache, and a scalar root
        runs as a batch of one, as in the JAX package, so its snapshots
        carry JAX's batched schema."""
        if self._check_recovery(recovery):
            batch = np.atleast_1d(roots_np).tolist()
            out = self._run_recoverable(eng, batch, *extra, B=len(batch),
                                        recovery=recovery)
            return _first(out) if roots_np.ndim == 0 else out
        if roots_np.ndim == 0:
            return entry_for(1)(int(roots_np))
        return entry_for(roots_np.shape[0])(roots_np.tolist())

    def bfs(self, roots, validate=False, recovery=None) -> BFSOutput:
        """Search from a scalar root or a (B,) batch of roots.

        Scalar: global (n,) level/pred (plain global vertex ids, padded to
        the grid), () n_levels, exact int edges_scanned.  Batch: (B, n)
        level/pred, (B,) n_levels, tuple of B edges_scanned -- equal to
        running the roots one by one.  A direction-enabled session also
        returns `directions`, the per-level trace ((max_levels,) or
        (B, max_levels) int32: -1 unused, 0 top-down, 1 bottom-up).

        validate: False (default) | True | (2, E) edge array (numpy or
        tensor).  Either of the last two runs the Graph500 rules
        (`core.validate.validate_bfs`) on every root's output and raises
        AssertionError on any violation: True against the graph's own
        edge list and its cached `EdgeIndex`, an array against that array,
        moved to the graph's device, with an `EdgeIndex` of its own that
        is not cached.  Across a process group every rank checks its
        share -- its blocks' edges for True, an equal contiguous slice of
        the array's columns otherwise -- and all raise the same message
        together (`core.validate.validate_bfs_group`).

        recovery: optional `repro_torch.runtime.RecoveryPlan` (checkpointer
        / loss injector / retry policy / snapshot to resume) for a
        fault_tolerance=True session; the query then runs the segmented
        level loop and can resume.  An FT session runs that loop with or
        without it."""
        check_vertex_ids(roots, self.graph.n, "roots")
        roots_np = _host_ids(roots)
        if roots_np.ndim > 1:
            raise ValueError(f"roots must be a scalar or 1D batch, got "
                             f"shape {roots_np.shape}")
        out = self._run_roots(self.engine, roots_np, self.extra, recovery,
                              self.compiled_for)
        if validate is not False and validate is not None:
            self._validate(out, roots_np, validate)
        return self._traced(out)

    def _validate(self, out: BFSOutput, roots_np, validate) -> None:
        """Graph500 rule check of a query's output (see `bfs(validate=)`;
        roots_np: its host root or roots)."""
        g = self.graph
        n = g.n
        if roots_np.ndim == 0:
            levels, preds = [out.level], [out.pred]
        else:
            levels, preds = list(out.level), list(out.pred)
        roots = np.atleast_1d(roots_np)
        if g.topology.distributed:
            if isinstance(validate, bool):
                g._edges_or_raise()
                pieces = g._block_edge_pieces
            else:
                pieces = _slice_pieces(validate, g.mesh)
            for root, lv, pr in zip(roots, levels, preds):
                validate_bfs_group(pieces, lv[:n], pr[:n], int(root),
                                   g.mesh.group)
            return
        if isinstance(validate, bool):
            edges, index = g.edges, g.edge_index()
        else:
            edges = _edge_tensor(validate, g.device)
            index = EdgeIndex(edges, n)
        for root, lv, pr in zip(roots, levels, preds):
            validate_bfs(edges, lv[:n], pr[:n], int(root), index=index)

    # ------------------------------------------------------------------
    # Frontier programs beyond BFS (DESIGN.md sec. 8)
    # ------------------------------------------------------------------

    def _algo_engine(self, program, fold_codec, max_levels: int):
        """The engine of a value program (see `_keyed_algo_engine`)."""
        return self._keyed_algo_engine(program, fold_codec, max_levels)[0]

    def _keyed_algo_engine(self, program, fold_codec, max_levels: int):
        """(engine, its key) of a value program, cached on the DistGraph
        like the BFS engines (the config's chunking and paths apply; the
        codec is the call's, else the program's hint).  A direction-enabled
        session wraps the program in `DirectionProgram`."""
        codec = fold_codec if fold_codec is not None else program.codec_hint
        codec_name = codec if isinstance(codec, str) \
            else getattr(codec, "name", repr(codec))
        cfg = self.config
        if cfg.direction_mode is not None:
            self.graph.ensure_csr()
            program = DirectionProgram(program, mode=cfg.direction_mode,
                                       alpha=cfg.alpha, beta=cfg.beta)
        key = cfg.algo_engine_key(program.key, codec_name, max_levels)
        eng = self.graph._engines.get(key)
        if eng is None:
            eng = FrontierEngine(
                self.graph.topology, program, fold_codec=codec,
                edge_chunk=cfg.edge_chunk, max_levels=max_levels,
                expand=cfg.expand, expand_fn=cfg.expand_fn, fold=cfg.fold,
                dedup=cfg.dedup, bottomup=cfg.bottomup,
                exchange=cfg.exchange, telemetry=cfg.telemetry,
                fault_tolerance=cfg.fault_tolerance,
                ckpt_every=cfg.ckpt_every)
            self.graph._engines[key] = eng
        return eng, key

    def _algo_csr_extra(self, *, weights: bool = False) -> tuple:
        """The CSR-twin arrays a direction-enabled value program appends
        after its regular extras (empty when direction is off)."""
        if self.config.direction_mode is None:
            return ()
        csr = self.graph.ensure_csr()
        if not weights:
            return (csr["row_off"], csr["col_idx"])
        if self.graph.csr_weights is None:
            raise ValueError(
                "direction-optimised sssp needs the CSR-ordered weight "
                "copy; plan the graph with DistGraph.from_edges(edges, "
                "config, weights=w) so ensure_csr can lay it out")
        return (csr["row_off"], csr["col_idx"], self.graph.csr_weights)

    def connected_components(self, fold_codec=None,
                             recovery=None) -> CCOutput:
        """Labels of every vertex's connected component (min member id).

        Assumes the planned edge list is symmetrised; on a directed list
        the label is the smallest vertex id with a directed path to each
        vertex.  fold_codec: None = the program's hint ("bitmap"); every
        codec gives the same labels.  recovery: see `bfs`."""
        max_levels = self.graph.grid.n + 1     # diameter bound
        eng, key = self._keyed_algo_engine(ConnectedComponentsProgram(),
                                     fold_codec, max_levels)
        extra = self._algo_csr_extra()
        if self._check_recovery(recovery):
            return self._traced(self._run_recoverable(
                eng, None, *extra, recovery=recovery))
        return self._traced(self._algo_compiled(eng, key, (), extra)(None))

    def sssp(self, roots, fold_codec=None, recovery=None) -> SSSPOutput:
        """Shortest distances over the planned per-edge uint8 weights.

        Scalar root -> (n,) int32 distances (-1 unreachable); a (B,) batch
        -> (B, n), equal to the roots run one by one.  Requires
        `DistGraph.from_edges(..., weights=)`.  recovery: see `bfs`."""
        if self.graph.weights is None:
            raise ValueError(
                "sssp needs resident per-edge weights; plan the graph with "
                "DistGraph.from_edges(edges, config, weights=w)")
        check_vertex_ids(roots, self.graph.n, "roots")
        roots_np = _host_ids(roots)
        if roots_np.ndim > 1:
            raise ValueError(f"roots must be a scalar or 1D batch, got "
                             f"shape {roots_np.shape}")
        max_levels = self.graph.grid.n + 1     # Bellman-Ford round bound
        eng, key = self._keyed_algo_engine(SSSPProgram(), fold_codec, max_levels)
        extra = (self.graph.weights,) + self._algo_csr_extra(weights=True)
        return self._traced(self._run_roots(
            eng, roots_np, extra, recovery,
            lambda B: self._algo_compiled(eng, key, (B,), extra,
                                          batched=True)))

    def multi_bfs(self, sources, k: int | None = None,
                  fold_codec=None, recovery=None) -> MultiBFSOutput:
        """Simultaneous BFS from a (K,) source set (ONE shared frontier).

        Returns per-vertex hops to the nearest source and the claiming
        source's index (same-wave ties -> minimum index).  k bounds the
        sweep to k hops: `level >= 0` is then the union k-hop neighbourhood
        of the sources.  Contrast `bfs(roots)`, which runs K independent
        searches.  recovery: see `bfs`."""
        check_vertex_ids(sources, self.graph.n, "sources")
        sources_np = _host_ids(sources)
        if sources_np.ndim != 1 or sources_np.shape[0] == 0:
            raise ValueError(f"sources must be a non-empty 1D array, got "
                             f"shape {sources_np.shape}")
        max_levels = int(k) if k is not None else self.config.max_levels
        eng, key = self._keyed_algo_engine(MultiSourceBFSProgram(), fold_codec,
                                     max_levels)
        extra = self._algo_csr_extra()
        if self._check_recovery(recovery):
            return self._traced(self._run_recoverable(
                eng, sources_np, *extra, recovery=recovery))
        return self._traced(self._algo_compiled(
            eng, key, sources_np.shape, extra)(sources_np))


def _bound(entry: Runnable, graph: LocalGraph2D, extra) -> Runnable:
    """A cache entry bound to this graph's arrays.  The entry of another
    graph of the same shapes (the deprecated drivers share one cache over
    every graph they run, as JAX's share data-independent executables) is
    its engine rebound, still a hit."""
    if entry.graph is graph and len(entry.extra) == len(extra) and all(
            a is b for a, b in zip(entry.extra, extra)):
        return entry
    return dataclasses.replace(entry, graph=graph, extra=extra)


def _slice_pieces(edges, mesh):
    """An equal, contiguous slice of a (2, E) edge array's columns for this
    rank of `mesh` (rank r takes [r*E/world, (r+1)*E/world)), as a callable
    returning its int64 (u, v) pieces on the mesh's device."""
    E = edges.shape[1]
    a0 = mesh.rank * E // mesh.world
    a1 = (mesh.rank + 1) * E // mesh.world

    def pieces():
        for a in range(a0, a1, EDGE_PIECE):
            b = min(a + EDGE_PIECE, a1)
            yield tuple(_edge_tensor(edges[k, a:b], mesh.device).long()
                        for k in range(2))
    return pieces


def _first(out):
    """A batch-of-one output as the scalar query's: every batched field's
    first entry (None stays None)."""
    return dataclasses.replace(out, **{
        f.name: None if getattr(out, f.name) is None
        else getattr(out, f.name)[0] for f in dataclasses.fields(out)})
