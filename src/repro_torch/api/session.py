"""Two-phase session API: plan/residency vs query (DESIGN.md sec. 7), the
port of `repro/api/session.py`.

Phase 1 -- `DistGraph.from_edges(edges, config)` resolves the grid and
partitions the graph on the device (or `DistGraph.from_partition` takes a
partition already built).  The result is a resident graph that answers
many queries.

Phase 2 -- `GraphSession.bfs(roots)` runs searches against it: a scalar
root returns one `BFSOutput`, a (B,) batch returns batched outputs equal to
the roots run one by one.  PyTorch runs eagerly, so there is no compiled
executable cache; capturing the level loop in CUDA graphs is later work.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.algos.bfs import BFSLevelsProgram
from repro_torch.algos.direction import DirectionProgram
from repro_torch.algos.engine import FrontierEngine
from repro_torch.api.config import BFSConfig
from repro_torch.core.partition import partition_2d, partition_2d_csr
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


def _edge_tensor(edges, device) -> torch.Tensor:
    """A (2, E) edge list (numpy or torch) as an int32 tensor on device."""
    if not isinstance(edges, torch.Tensor):
        edges = torch.from_numpy(np.array(edges, dtype=np.int32))
    return edges.to(device=device, dtype=torch.int32)


class DistGraph:
    """A resident, partitioned graph on one device: plan once, query many.

    Holds the stacked CSC blocks, the CSR twin once a direction-enabled
    session needs it, the topology, the engines every session over this
    graph shares and, for `bfs(validate=True)` and the CSR build, the edge
    list and its `EdgeIndex` (built on the first validated query).  Unlike
    the JAX package, the edge list stays after the CSR exists: validation
    needs it."""

    def __init__(self, topology: StackedTopology, csc: LocalGraph2D, *,
                 csr: dict | None = None, edges=None, n: int | None = None,
                 config: BFSConfig = None):
        self.topology = topology
        self.grid = topology.grid
        self.device = topology.device
        self.csc = csc
        self.csr = csr
        self.n = int(n) if n is not None else topology.grid.n
        self.config = config if config is not None else BFSConfig()
        self.edges = edges
        self._edge_index = None
        self._engines = {}

    @classmethod
    def from_edges(cls, edges, config: BFSConfig = None, *, device=None,
                   n: int | None = None) -> "DistGraph":
        """Plan a graph into residency: partition on the device.

        edges: (2, E) [src, dst] numpy array or torch tensor.  device: None
        = CUDA (raises without a card).  n defaults to max vertex id + 1;
        the grid pads it up to a multiple of R*C.  The CSR twin is planned
        lazily, on the first direction-enabled session (`ensure_csr`)."""
        config = config if config is not None else BFSConfig()
        device = resolve_device(device)
        edges = _edge_tensor(edges, device)
        if n is None:
            n = int(edges.max()) + 1 if edges.numel() else 1
        grid = config.resolve_grid(n)
        csc = partition_2d(edges, grid)
        return cls(StackedTopology(grid, device), csc, edges=edges, n=n,
                   config=config)

    @classmethod
    def from_partition(cls, grid: Grid2D, csc: LocalGraph2D,
                       config: BFSConfig = None, *, n: int | None = None,
                       edges=None, csr: dict | None = None) -> "DistGraph":
        """A graph whose partition is already built (for example from the
        JAX package's `partition_2d` / `partition_2d_csr` through
        `repro_torch.convert`).  The device is the partition's; `edges`
        enables `bfs(validate=True)` and a lazy CSR build, `csr` supplies
        the CSR twin directly."""
        config = config if config is not None else BFSConfig()
        if config.grid is not None and config.resolve_grid(
                n if n is not None else grid.n) != grid:
            raise ValueError(f"config grid {config.grid} does not match the "
                             f"partition's {grid.R}x{grid.C}")
        device = csc.col_off.device
        if edges is not None:
            edges = _edge_tensor(edges, device)
        return cls(StackedTopology(grid, device), csc, csr=csr,
                   edges=edges, n=n, config=config)

    def ensure_csr(self) -> dict:
        """Plan the CSR twin on demand (the first direction-enabled
        session), block by block from the resident edge list."""
        if self.csr is None:
            if self.edges is None:
                raise ValueError(
                    "direction optimisation needs the CSR twin, but this "
                    "DistGraph has no edge list; pass csr= or edges= to "
                    "from_partition, or use from_edges")
            self.csr = partition_2d_csr(self.edges, self.grid)
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
        roots_np = np.asarray(roots.cpu() if isinstance(roots, torch.Tensor)
                              else roots, dtype=np.int64)
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
