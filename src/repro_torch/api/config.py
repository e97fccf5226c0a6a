"""BFSConfig: the one config object of the session API (DESIGN.md sec. 7),
the port of `repro/api/config.py`.

Same fields and defaults as the JAX config.  A knob whose path is not
ported yet raises a ValueError at construction, naming the ROADMAP item
that brings it.  `expand` / `fold` take the port's spellings: "auto" (the
CUDA kernel on a card, the plain torch formulas on the CPU), "kernel" or
"reference" (`repro_torch.kernels.select`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.types import Grid2D
from repro_torch.kernels.select import PATHS


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
    exchange:    "flat" (butterfly / auto: ROADMAP A9).
    direction:   False | None (top-down) | True | "adaptive" | "bottomup";
                 needs the CSR twin, planned on the first such session.
    alpha, beta: enter bottom-up above n / alpha frontier vertices, leave
                 it below n / beta.
    bottomup:    "auto" | "kernel" | "reference" for the bottom-up scan.
    telemetry: ROADMAP A10; fault_tolerance, ckpt_every: ROADMAP A11;
    expand_fn: a custom chunk hook (ROADMAP A17); row_axes / col_axes name
    mesh axes, which the stacked grid does not use.
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
    exchange: str = "flat"
    telemetry: bool = False
    fault_tolerance: bool = False
    ckpt_every: int = 1

    def __post_init__(self):
        for f in ("row_axes", "col_axes"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        self.direction_mode             # raises on a bad spelling
        unsupported = (
            ("telemetry", bool(self.telemetry), "A10"),
            ("fault_tolerance", bool(self.fault_tolerance), "A11"),
            ("exchange", self.exchange != "flat", "A9"),
            ("expand_fn", self.expand_fn is not None, "A17"),
        )
        for knob, asked, item in unsupported:
            if asked:
                raise ValueError(
                    f"BFSConfig({knob}={getattr(self, knob)!r}) is not "
                    f"ported to repro_torch yet (ROADMAP {item})")
        for knob in ("expand", "fold", "bottomup"):
            if getattr(self, knob) not in PATHS:
                raise ValueError(f"{knob}={getattr(self, knob)!r}: expected "
                                 f"one of {PATHS}")
        if self.dedup not in ("scatter", "sort"):
            raise ValueError(f"dedup={self.dedup!r}: expected 'scatter' or "
                             f"'sort'")
        if self.edge_chunk < 1:
            raise ValueError(f"edge_chunk must be >= 1, got "
                             f"{self.edge_chunk}")

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
    def engine_key(self) -> tuple:
        """What makes two configs share one engine: every knob that changes
        the engine."""
        return (self.fold_codec, self.direction_mode, self.edge_chunk,
                self.dedup, self.max_levels, self.alpha, self.beta,
                self.expand, self.fold, self.bottomup, self.exchange)

    def algo_engine_key(self, program_key: tuple, codec_name: str,
                        max_levels: int) -> tuple:
        """Cache key of a value-program engine (CC, SSSP, multi-source
        BFS): the program's identity (direction mode, alpha and beta ride
        in the direction wrapper's key) plus the knobs the engine bakes in;
        the codec and `max_levels` are per call."""
        return ("algo", program_key, codec_name, self.edge_chunk, self.dedup,
                max_levels, self.expand, self.fold, self.bottomup,
                self.exchange)

    def resolve_grid(self, n: int) -> Grid2D:
        """Concretise the `grid` spelling against n vertices (padding up)."""
        g = self.grid
        if isinstance(g, Grid2D):
            return g
        if g is None:
            R, C = 1, 1
        elif isinstance(g, str):
            R, C = (int(x) for x in g.lower().split("x"))
        else:
            R, C = g
        return Grid2D.for_vertices(n, R, C)
