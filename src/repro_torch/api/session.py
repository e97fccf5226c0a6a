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
PyTorch runs eagerly, so there is no compiled executable cache; capturing
the level loop in CUDA graphs is later work.
"""
from __future__ import annotations

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
from repro_torch.core.partition import partition_2d, partition_2d_csr, \
    partition_edge_vals, partition_edge_vals_csr
from repro_torch.core.types import BFSOutput, Grid2D, LocalGraph2D, \
    resolve_device
from repro_torch.core.validate import EdgeIndex, validate_bfs
from repro_torch.dist.topology import StackedTopology


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


class DistGraph:
    """A resident, partitioned graph on one device: plan once, query many.

    Holds the stacked CSC blocks, the CSR twin once a direction-enabled
    session needs it, the per-edge weights in CSC order (and in CSR order
    beside the CSR twin) when planned with them, the topology, the engines
    every session over this graph shares and, for `bfs(validate=True)`,
    SSSP's checks and the CSR build, the edge list, its (E,) weights and
    its `EdgeIndex` (built on the first validated query).  Unlike the JAX
    package, the edge list and weights stay after the CSR exists:
    validation needs them."""

    def __init__(self, topology: StackedTopology, csc: LocalGraph2D, *,
                 csr: dict | None = None, edges=None, n: int | None = None,
                 config: BFSConfig = None, weights=None, csr_weights=None,
                 edge_weights=None):
        self.topology = topology
        self.grid = topology.grid
        self.device = topology.device
        self.csc = csc
        self.csr = csr
        self.n = int(n) if n is not None else topology.grid.n
        self.config = config if config is not None else BFSConfig()
        self.edges = edges
        self.weights = weights            # (R, C, e_max) in CSC order
        self.csr_weights = csr_weights    # (R, C, e_max) in CSR order
        self.edge_weights = edge_weights  # (E,) aligned with `edges`
        self._edge_index = None
        self._engines = {}

    @classmethod
    def from_edges(cls, edges, config: BFSConfig = None, *, device=None,
                   n: int | None = None, weights=None) -> "DistGraph":
        """Plan a graph into residency: partition on the device.

        edges: (2, E) [src, dst] numpy array or torch tensor.  device: None
        = CUDA (raises without a card).  n defaults to max vertex id + 1;
        the grid pads it up to a multiple of R*C.  weights: optional (E,)
        per-edge values (uint8 for SSSP), numpy or tensor, laid out in the
        CSC order and kept resident beside the graph.  The CSR twin (and
        the CSR-ordered weights) is planned lazily, on the first
        direction-enabled session (`ensure_csr`)."""
        config = config if config is not None else BFSConfig()
        device = resolve_device(device)
        edges = _edge_tensor(edges, device)
        if n is None:
            n = int(edges.max()) + 1 if edges.numel() else 1
        grid = config.resolve_grid(n)
        csc = partition_2d(edges, grid)
        w = w_edge = None
        if weights is not None:
            w_edge = _value_tensor(weights, device)
            w = partition_edge_vals(edges, w_edge, grid)
        return cls(StackedTopology(grid, device), csc, edges=edges, n=n,
                   config=config, weights=w, edge_weights=w_edge)

    @classmethod
    def from_partition(cls, grid: Grid2D, csc: LocalGraph2D,
                       config: BFSConfig = None, *, n: int | None = None,
                       edges=None, csr: dict | None = None, weights=None,
                       csr_weights=None) -> "DistGraph":
        """A graph whose partition is already built (for example from the
        JAX package's `partition_2d` / `partition_2d_csr` /
        `partition_edge_vals(_csr)` through `repro_torch.convert`).  The
        device is the partition's; `edges` enables `bfs(validate=True)` and
        a lazy CSR build, `csr` supplies the CSR twin directly; `weights` /
        `csr_weights` are the (R, C, e_max) per-edge values in CSC / CSR
        order."""
        config = config if config is not None else BFSConfig()
        if config.grid is not None and config.resolve_grid(
                n if n is not None else grid.n) != grid:
            raise ValueError(f"config grid {config.grid} does not match the "
                             f"partition's {grid.R}x{grid.C}")
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
        it)."""
        if self.csr is None:
            if self.edges is None:
                raise ValueError(
                    "direction optimisation needs the CSR twin, but this "
                    "DistGraph has no edge list; pass csr= or edges= to "
                    "from_partition, or use from_edges")
            self.csr = partition_2d_csr(self.edges, self.grid)
            if self.edge_weights is not None:
                self.csr_weights = partition_edge_vals_csr(
                    self.edges, self.edge_weights, self.grid)
        return self.csr

    def engine_for(self, config: BFSConfig) -> FrontierEngine:
        key = config.engine_key
        eng = self._engines.get(key)
        if eng is None:
            program = BFSLevelsProgram()
            if config.direction_mode is not None:
                program = DirectionProgram(program,
                                           mode=config.direction_mode,
                                           alpha=config.alpha,
                                           beta=config.beta)
            eng = FrontierEngine(
                self.topology, program,
                fold_codec=config.fold_codec, edge_chunk=config.edge_chunk,
                max_levels=config.max_levels, expand=config.expand,
                fold=config.fold, dedup=config.dedup,
                bottomup=config.bottomup, exchange=config.exchange)
            self._engines[key] = eng
        return eng

    def edge_index(self) -> EdgeIndex:
        """The sorted edge keys of rule 4, built once per graph."""
        if self._edge_index is None:
            if self.edges is None:
                raise ValueError(
                    "bfs(validate=True) needs the edge list; plan with "
                    "from_edges or pass edges= to from_partition")
            self._edge_index = EdgeIndex(self.edges, self.n)
        return self._edge_index

    def session(self, config: BFSConfig = None) -> "GraphSession":
        """Open a query session (defaults to the planning config)."""
        return GraphSession(self, config if config is not None
                            else self.config)


class GraphSession:
    """Query phase: many BFS searches over one resident DistGraph."""

    def __init__(self, graph: DistGraph, config: BFSConfig = None):
        self.graph = graph
        self.config = config if config is not None else graph.config
        if self.config.grid is not None:
            want = self.config.resolve_grid(graph.n)
            if want != graph.grid:
                raise ValueError(
                    f"session config asks for a {want.R}x{want.C} grid but "
                    f"the resident graph is planned {graph.grid.R}x"
                    f"{graph.grid.C}; re-plan with DistGraph.from_edges")
        self.extra = ()
        if self.config.direction_mode is not None:
            csr = graph.ensure_csr()
            self.extra = (csr["row_off"], csr["col_idx"])
        self.engine = graph.engine_for(self.config)

    def bfs(self, roots, validate=False) -> BFSOutput:
        """Search from a scalar root or a (B,) batch of roots.

        Scalar: global (n,) level/pred (plain global vertex ids, padded to
        the grid), () n_levels, exact int edges_scanned.  Batch: (B, n)
        level/pred, (B,) n_levels, tuple of B edges_scanned -- equal to
        running the roots one by one.  A direction-enabled session also
        returns `directions`, the per-level trace ((max_levels,) or
        (B, max_levels) int32: -1 unused, 0 top-down, 1 bottom-up).
        validate=True runs the Graph500 rules
        (`core.validate.validate_bfs`) on every root's output against the
        graph's edge list and raises AssertionError on any violation."""
        check_vertex_ids(roots, self.graph.n, "roots")
        roots_np = _host_ids(roots)
        if roots_np.ndim > 1:
            raise ValueError(f"roots must be a scalar or 1D batch, got "
                             f"shape {roots_np.shape}")
        if roots_np.ndim == 0:
            out = self.engine.run(self.graph.csc, int(roots_np), self.extra)
            levels, preds = [out.level], [out.pred]
        else:
            out = self.engine.run_batch(self.graph.csc, roots_np.tolist(),
                                        self.extra)
            levels, preds = list(out.level), list(out.pred)
        if validate:
            n = self.graph.n
            index = self.graph.edge_index()
            for root, lv, pr in zip(np.atleast_1d(roots_np), levels, preds):
                validate_bfs(self.graph.edges, lv[:n], pr[:n], int(root),
                             index=index)
        return out

    # ------------------------------------------------------------------
    # Frontier programs beyond BFS (DESIGN.md sec. 8)
    # ------------------------------------------------------------------

    def _algo_engine(self, program, fold_codec, max_levels: int):
        """The engine of a value program, cached on the DistGraph like the
        BFS engines (the config's chunking and paths apply; the codec is
        the call's, else the program's hint).  A direction-enabled session
        wraps the program in `DirectionProgram`."""
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
                expand=cfg.expand, fold=cfg.fold, dedup=cfg.dedup,
                bottomup=cfg.bottomup, exchange=cfg.exchange)
            self.graph._engines[key] = eng
        return eng

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

    def connected_components(self, fold_codec=None) -> CCOutput:
        """Labels of every vertex's connected component (min member id).

        Assumes the planned edge list is symmetrised; on a directed list
        the label is the smallest vertex id with a directed path to each
        vertex.  fold_codec: None = the program's hint ("bitmap"); every
        codec gives the same labels."""
        max_levels = self.graph.grid.n + 1     # diameter bound
        eng = self._algo_engine(ConnectedComponentsProgram(), fold_codec,
                                max_levels)
        return eng.run(self.graph.csc, None, self._algo_csr_extra())

    def sssp(self, roots, fold_codec=None) -> SSSPOutput:
        """Shortest distances over the planned per-edge uint8 weights.

        Scalar root -> (n,) int32 distances (-1 unreachable); a (B,) batch
        -> (B, n), equal to the roots run one by one.  Requires
        `DistGraph.from_edges(..., weights=)`."""
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
        eng = self._algo_engine(SSSPProgram(), fold_codec, max_levels)
        extra = (self.graph.weights,) + self._algo_csr_extra(weights=True)
        if roots_np.ndim == 0:
            return eng.run(self.graph.csc, int(roots_np), extra)
        return eng.run_batch(self.graph.csc, roots_np.tolist(), extra)

    def multi_bfs(self, sources, k: int | None = None,
                  fold_codec=None) -> MultiBFSOutput:
        """Simultaneous BFS from a (K,) source set (ONE shared frontier).

        Returns per-vertex hops to the nearest source and the claiming
        source's index (same-wave ties -> minimum index).  k bounds the
        sweep to k hops: `level >= 0` is then the union k-hop neighbourhood
        of the sources.  Contrast `bfs(roots)`, which runs K independent
        searches."""
        check_vertex_ids(sources, self.graph.n, "sources")
        sources_np = _host_ids(sources)
        if sources_np.ndim != 1 or sources_np.shape[0] == 0:
            raise ValueError(f"sources must be a non-empty 1D array, got "
                             f"shape {sources_np.shape}")
        max_levels = int(k) if k is not None else self.config.max_levels
        eng = self._algo_engine(MultiSourceBFSProgram(), fold_codec,
                                max_levels)
        return eng.run(self.graph.csc, sources_np, self._algo_csr_extra())
