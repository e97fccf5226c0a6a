"""Core datatypes of the 2D-partitioned BFS (paper sec. 2.2 / 3.1).

Same conventions as the JAX package (DESIGN.md sec. 2):
  * adjacency A is N x N; an edge u -> v is the non-zero A[v, u], i.e. column
    u of A is u's adjacency list;
  * the processor grid is R rows x C cols; processor P_ij handles the edge
    blocks (m*R + i, j), m = 0..C-1, each of size S x (N/C), S = N/(R*C);
  * vertex block b = j*R + i (size S) is OWNED by P_ij;
  * every P_ij stores an (N/R) x (N/C) local matrix in CSC.

The port stacks the whole grid on one device: every per-processor array
carries leading (R, C) dims.  Per-vertex search state additionally carries
ONE trailing sink slot per block (`n_rows_local + 1` entries): the JAX code
drops masked scatters with `mode="drop"` on the index `n_rows`, which torch
rejects, so the port scatters masked lanes into the sink instead and never
reads it.
"""
from __future__ import annotations

import dataclasses

import torch

NOT_VISITED = -1
INVALID = -1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a card and without an explicit device it raises --
    it never falls back to the CPU quietly."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the port "
            "on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """Static description of the processor grid and padded vertex space."""
    R: int          # processor-grid rows
    C: int          # processor-grid cols
    n: int          # padded global vertex count; divisible by R*C

    def __post_init__(self):
        if self.n % (self.R * self.C) != 0:
            raise ValueError(f"n={self.n} not divisible by R*C={self.R * self.C}")

    @property
    def P(self) -> int:
        return self.R * self.C

    @property
    def S(self) -> int:
        """Vertex-block size N/(RC) (owned vertices per processor)."""
        return self.n // (self.R * self.C)

    @property
    def n_rows_local(self) -> int:
        return self.n // self.R

    @property
    def n_cols_local(self) -> int:
        return self.n // self.C

    @staticmethod
    def for_vertices(n_raw: int, R: int, C: int) -> "Grid2D":
        """Pad the vertex space up to a multiple of R*C (isolated vertices)."""
        rc = R * C
        return Grid2D(R, C, ((n_raw + rc - 1) // rc) * rc)


@dataclasses.dataclass
class LocalGraph2D:
    """The local CSC blocks of the 2D-partitioned adjacency matrix, stacked
    over the grid.  Row indices are LOCAL rows and offsets are int32 -- 32
    bits on the wire as in the paper."""
    col_off: torch.Tensor   # (R, C, n_cols_local + 1) int32
    row_idx: torch.Tensor   # (R, C, e_max) int32, padded with -1
    nnz: torch.Tensor       # (R, C) int32 valid entries of row_idx


@dataclasses.dataclass
class BFSState:
    """Stacked per-processor BFS state (paper Alg. 2 requires).

    level/pred/visited span ALL local rows (n/R) plus the trailing sink slot:
    the bitmap covering remotely-owned rows is what guarantees each remote
    vertex is folded at most once per search (paper sec. 3.4).  The level
    loop updates them in place.
    """
    level: torch.Tensor      # (R, C, n_rows_local + 1) int32, -1 = unvisited
    pred: torch.Tensor       # (R, C, n_rows_local + 1) int32 global parent;
                             #   -(col+2) = deferred (fold sender column)
    visited: torch.Tensor    # (R, C, n_rows_local + 1) bool
    front: torch.Tensor      # (R, C, S) int32 local col indices, padded -1
    front_cnt: torch.Tensor  # (R, C) int32
    lvl: int                 # current level, the same on every processor


@dataclasses.dataclass
class BFSOutput:
    """Global (gathered) BFS result, on the search's device."""
    level: torch.Tensor      # (n,) int32, or (B, n) for a batch
    pred: torch.Tensor       # (n,) int32 global parent ids, or (B, n)
    n_levels: torch.Tensor   # () int32, or (B,)
    edges_scanned: object = None  # exact Python int, or a tuple of B ints
    directions: object = None     # (max_levels,) int32 per-level direction
                                  #   trace (-1 unused / 0 top-down / 1
                                  #   bottom-up), (B, max_levels) for a
                                  #   batch; None without direction
                                  #   optimisation
    trace: object = None          # obs.LevelTrace when telemetry ran (a
                                  #   tuple of B for a batch), else None
