"""BFSConfig: the one config object of the session API (DESIGN.md sec. 7),
the port of `repro/api/config.py`.

Same fields and defaults as the JAX config.  `expand` / `fold` take the port's
spellings: "auto" (the CUDA kernel on a card, the plain torch formulas on
the CPU), "kernel" or "reference" (`repro_torch.kernels.select`).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

from repro_torch.core.types import Grid2D
from repro_torch.dist.strategy import get_exchange
from repro_torch.kernels.select import check_path


def resolve_fold_codec(fold_codec=None, fold_bitmap=None):
    """Route the legacy `fold_bitmap` kwarg into the `fold_codec` spelling.

    `fold_bitmap` is deprecated: passing it (either value) warns and, when no
    explicit fold_codec is given, maps True -> "bitmap" / False -> "list".
    """
    if fold_bitmap is not None:
        warnings.warn(
            "fold_bitmap is deprecated; spell the wire format as "
            "BFSConfig(fold_codec='bitmap')", DeprecationWarning,
            stacklevel=3)
        if fold_codec is None:
            fold_codec = "bitmap" if fold_bitmap else "list"
    return "list" if fold_codec is None else fold_codec


@dataclasses.dataclass(frozen=True)
class BFSConfig:
    """All knobs of a BFS query plan (see the JAX `BFSConfig` for each).

    grid:        Grid2D | (R, C) | "RxC" | None (None = 1 x 1: the port
                 stacks the grid on one device).
    fold_codec:  "list" | "bitmap" | "delta" (needs S <= 65536) | a
                 FoldCodec.
    edge_chunk:  CSC scan chunk size of the expand phase.  Results do not
                 depend on it; on a card a large chunk (2^22) amortises the
                 per-chunk claim array of the scatter dedup.
    dedup:       winner-selection method ("scatter" | "sort").
    max_levels:  level-loop bound.
    expand:      "auto" | "kernel" | "reference" for the chunk scan.
    fold:        "auto" | "kernel" | "reference" for the compaction and
                 the bitmap and delta codecs' encode / decode.
    exchange:    fold exchange strategy (`dist/strategy.py`): "flat" (one
                 all-to-all a fold), "butterfly" (log2(C) XOR-paired stages
                 over the column axis), "auto" (butterfly on power-of-two
                 C >= 4 over one column axis, flat otherwise; resolved by
                 `GraphSession` against the planned grid) or an
                 ExchangeStrategy instance.  Outputs are identical across
                 strategies.
    direction:   False | None (top-down) | True | "adaptive" | "bottomup";
                 needs the CSR twin, planned on the first such session.
    alpha, beta: enter bottom-up above n / alpha frontier vertices, leave
                 it below n / beta.
    bottomup:    "auto" | "kernel" | "reference" for the bottom-up scan.
    expand_fn:   a custom chunk hook for the top-down scan, with the
                 signature of `kernels.expand.make_expand_fn`'s hooks;
                 it wins over `expand`, and the value programs then run
                 the plain value scan (as in JAX).
    telemetry:   when True every search also returns a
                 `repro_torch.obs.LevelTrace` (per level: global and
                 per-processor frontier, scanned edges, folded entries, fold
                 wire bytes and messages, direction) as `output.trace` and
                 `GraphSession.last_trace()`.  Part of every engine key;
                 outputs are identical either way.
    fault_tolerance:  mid-traversal recovery (DESIGN.md sec. 15).  When
                 True, sessions run the level loop in checkpoint-bounded
                 segments (`ckpt_every` levels per segment) so a traversal
                 can snapshot its carry between segments, survive injected
                 device loss, and resume -- same grid or shrunken -- through
                 a `repro_torch.runtime.RecoveryPlan` (`recovery=` of every
                 query).  Cache-keyed like `telemetry`: the off path is
                 exactly the unsegmented loop, and segmented outputs are
                 bit-identical to it.
    ckpt_every:  levels per resumable segment when fault_tolerance=True
                 (the K of "checkpoint every K levels"), >= 1.
    row_axes / col_axes name mesh axes, which the stacked grid does not
    use, except that the butterfly routes over one column axis (as in
    JAX).
    """
    grid: Any = None
    fold_codec: Any = "list"
    edge_chunk: int = 8192
    dedup: str = "scatter"
    max_levels: int = 64
    direction: Any = False
    alpha: int = 24
    beta: int = 64
    row_axes: tuple = ("r",)
    col_axes: tuple = ("c",)
    expand_fn: Any = None
    expand: str = "auto"
    fold: str = "auto"
    bottomup: str = "auto"
    exchange: Any = "flat"
    telemetry: bool = False
    fault_tolerance: bool = False
    ckpt_every: int = 1

    def __post_init__(self):
        for f in ("row_axes", "col_axes"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        self.direction_mode             # raises on a bad spelling
        if int(self.ckpt_every) < 1:
            raise ValueError(f"ckpt_every must be >= 1, got "
                             f"{self.ckpt_every}")
        for knob in ("expand", "fold", "bottomup"):
            check_path(getattr(self, knob), knob=knob)
        if self.dedup not in ("scatter", "sort"):
            raise ValueError(f"dedup={self.dedup!r}: expected 'scatter' or "
                             f"'sort'")
        if self.edge_chunk < 1:
            raise ValueError(f"edge_chunk must be >= 1, got "
                             f"{self.edge_chunk}")

    @property
    def codec_name(self) -> str:
        """The fold codec's name ("list" for "list" and for a `ListFold()`
        instance alike): the codec's component of every engine key."""
        fc = self.fold_codec
        return fc if isinstance(fc, str) else getattr(fc, "name", repr(fc))

    @property
    def direction_mode(self):
        """The direction spelling normalised: None (pure top-down),
        "adaptive" or "bottomup"."""
        d = self.direction
        if d is False or d is None:
            return None
        if d is True:
            return "adaptive"
        if d in ("adaptive", "bottomup"):
            return d
        raise ValueError(
            f"direction={d!r}: expected False | True | 'adaptive' | "
            f"'bottomup'")

    @property
    def exchange_name(self) -> str:
        """The exchange spelling as a cache-key component ("auto" until
        `resolve_exchange` normalises it against a planned grid)."""
        ex = self.exchange
        return ex if isinstance(ex, str) else getattr(ex, "name", repr(ex))

    def resolve_exchange(self, grid: Grid2D) -> "BFSConfig":
        """This config with exchange="auto" resolved against the planned
        grid (butterfly on power-of-two C >= 4 over one column axis, flat
        otherwise) and an explicit strategy validated against it: a
        butterfly request on a grid it cannot route raises the ValueError
        here, at session construction, naming the strategy that works."""
        strat = get_exchange(self.exchange, grid, self.col_axes or ())
        if isinstance(self.exchange, str) and self.exchange != strat.name:
            return dataclasses.replace(self, exchange=strat.name)
        return self

    @property
    def engine_key(self) -> tuple:
        """What makes two configs share one engine, and with the graph's
        shapes and the batch size one entry of the graph's executable
        cache: every knob that changes the engine, the codec and the
        exchange by name (`GraphSession` resolves "auto" before any engine
        is keyed)."""
        return (self.codec_name, self.direction_mode, self.edge_chunk,
                self.dedup, self.max_levels, self.alpha, self.beta,
                self.expand_fn, self.expand, self.fold, self.bottomup,
                self.exchange_name, self.telemetry, self.fault_tolerance,
                self.ckpt_every)

    def algo_engine_key(self, program_key: tuple, codec_name: str,
                        max_levels: int) -> tuple:
        """Cache key of a value-program engine (CC, SSSP, multi-source
        BFS): the program's identity (direction mode, alpha and beta ride
        in the direction wrapper's key) plus the knobs the engine bakes in;
        the codec and `max_levels` are per call."""
        return ("algo", program_key, codec_name, self.edge_chunk, self.dedup,
                max_levels, self.expand_fn, self.expand, self.fold,
                self.bottomup, self.exchange_name, self.telemetry,
                self.fault_tolerance, self.ckpt_every)

    def resolve_grid(self, n: int, mesh=None) -> Grid2D:
        """Concretise the `grid` spelling against n vertices (padding up).
        mesh: a `dist.multihost.ProcessMesh`; with grid=None the grid is
        the mesh's shape (JAX's `resolve_grid(n, mesh)`), and a grid given
        beside it must match it."""
        g = self.grid
        if isinstance(g, Grid2D):
            grid = g
        else:
            if g is None:
                R, C = (1, 1) if mesh is None else mesh.shape
            elif isinstance(g, str):
                R, C = (int(x) for x in g.lower().split("x"))
            else:
                R, C = g
            grid = Grid2D.for_vertices(n, R, C)
        if mesh is not None and (grid.R, grid.C) != tuple(mesh.shape):
            raise ValueError(
                f"config grid {grid.R}x{grid.C} does not match the process "
                f"mesh's {mesh.shape[0]}x{mesh.shape[1]}")
        return grid
