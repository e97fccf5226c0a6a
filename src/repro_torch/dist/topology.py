"""The processor grid's topologies (DESIGN.md sec. 5 + 14).

The JAX package binds the R x C grid to a device mesh and runs the level
loop under `shard_map`.  The port keeps every per-processor array with
leading block dims: a topology holds a rectangular block of the grid --
rows i0 .. i0 + Rl - 1, columns j0 .. j0 + Cl - 1 (its `local`
description) -- and every per-processor array has leading (Rl, Cl) dims,
processor (i, j) at `local.loc(i, j)`.  The three collectives:

  row_gather      (paper line 13)  all_gather within a processor-column:
                  (Rl, Cl, ...) -> (Rl, Cl, R, ...), out[li, lj, r] =
                  x[r, j] -- processor (i, j) receives x[:, j] from every
                  grid row;
  col_all_to_all  (paper line 17)  the all_to_all within a processor-row:
                  (Rl, Cl, C, ...) -> recv[li, lj, m] = x[i, m, j], what
                  column m sent to j -- exactly the JAX package's
                  `emulate_exchange(x, "flat")`; routed by the bound
                  exchange strategy;
  psum_all        a sum over the grid (int32 wrapping, as JAX's psum).

`StackedTopology` holds the whole grid on one device (the block is the
grid) and the collectives are tensor operations.  `GroupTopology` holds one
rank's block of a `torch.distributed` group (`dist.multihost`) and the
collectives are real transfers within the row and column groups of its mesh;
`fetch` gathers the grid-wide outputs to every rank.

`Topology(grid, mesh, row_axes, col_axes)` and `Topology.one_d(n, mesh,
axes)` are the JAX package's constructors over the port's meshes: a
`dist.compat.StackedMesh` gives the stacked topology, a
`multihost.ProcessMesh` the group topology.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.core.types import Grid2D
from repro_torch.dist import multihost as MH
from repro_torch.dist import wire
from repro_torch.dist.strategy import ExchangeStrategy, FlatExchange


@dataclasses.dataclass(frozen=True)
class LocalBlock:
    """A topology's block of the grid: origin (i0, j0), shape (Rl, Cl)."""
    i0: int
    j0: int
    Rl: int
    Cl: int

    def loc(self, i: int, j: int) -> tuple:
        """Global processor (i, j) -> its index in the leading block
        dims."""
        return i - self.i0, j - self.j0

    def coords(self) -> list:
        """The block's global (i, j), row-major."""
        return [(i, j) for i in range(self.i0, self.i0 + self.Rl)
                for j in range(self.j0, self.j0 + self.Cl)]

    def owns(self, i: int, j: int) -> bool:
        return (self.i0 <= i < self.i0 + self.Rl
                and self.j0 <= j < self.j0 + self.Cl)

    def rows(self, device) -> torch.Tensor:
        """(Rl,) int32 global grid rows of the block."""
        return torch.arange(self.i0, self.i0 + self.Rl, dtype=torch.int32,
                            device=device)

    def cols(self, device) -> torch.Tensor:
        """(Cl,) int32 global grid columns of the block."""
        return torch.arange(self.j0, self.j0 + self.Cl, dtype=torch.int32,
                            device=device)


@dataclasses.dataclass(frozen=True)
class StackedTopology:
    """The whole processor grid as leading (R, C) dims on one device.

    `exchange` binds an `ExchangeStrategy` (`dist/strategy.py`, flat by
    default): `col_all_to_all` routes through it, so every fold codec and
    the predecessor resolution pick the strategy up without knowing it
    exists."""
    grid: Grid2D
    device: torch.device
    exchange: ExchangeStrategy = dataclasses.field(
        default_factory=FlatExchange)
    distributed = False

    @property
    def local(self) -> LocalBlock:
        return LocalBlock(0, 0, self.grid.R, self.grid.C)

    def coords(self):
        """Every processor's (i, j) grid coordinates, row-major."""
        return self.local.coords()

    def row_gather(self, x):
        """(R, C, ...) -> (R, C, R, ...): out[i, j, r] = x[r, j], a
        broadcast view (every grid row of a column receives the same
        gather)."""
        R = self.grid.R
        x = wire.mark(x, "all-gather", R * x.nbytes, R)
        return x.transpose(0, 1).unsqueeze(0).expand((R,) + x.transpose(
            0, 1).shape)

    def col_all_to_all(self, x):
        """(R, C, C, ...) with x[i, j, d] = processor (i, j)'s payload for
        column d -> recv[i, j, m] = x[i, m, j] (what column m sent to j),
        routed by the bound exchange strategy (on the stacked grid every
        strategy routes by flat's copy)."""
        x = wire.mark(x, "all-to-all", x.nbytes, self.grid.C)
        return self.exchange.all_to_all(x)

    def with_exchange(self, strategy) -> "StackedTopology":
        """This topology with an `ExchangeStrategy` bound (the engine binds
        its resolved strategy here so every exchange routes through it)."""
        return dataclasses.replace(self, exchange=strategy)

    def psum_all(self, x):
        """Sum of a per-processor (R, C) quantity over the grid."""
        x = wire.mark(x, "all-reduce", x.nbytes, self.grid.P)
        return x.sum(dim=(0, 1), dtype=x.dtype)

    def total(self, value: int) -> int:
        """A per-block Python int summed over the grid (the block is the
        grid)."""
        return int(value)

    def totals(self, values) -> list:
        return [int(v) for v in values]

    def fetch(self, x):
        """Per-processor (R, C, ...) blocks -> the whole grid's (the
        identity here)."""
        return x


@dataclasses.dataclass(frozen=True, eq=False)
class GroupTopology:
    """One rank's block of the grid over a `torch.distributed` group.

    mesh: the `multihost.ProcessMesh` (grid shape, rank, world, the rank's
    block, its process group and its row and column groups, built with the
    mesh and shared by every topology over it).  Every collective goes
    through its group even when the group has one member, so a world of
    one rank takes the path a multi-card run takes."""
    grid: Grid2D
    mesh: Any
    exchange: ExchangeStrategy = dataclasses.field(
        default_factory=FlatExchange)
    distributed = True

    def __post_init__(self):
        R, C = self.mesh.shape
        if (self.grid.R, self.grid.C) != (R, C):
            raise ValueError(f"grid {self.grid.R}x{self.grid.C} does not "
                             f"match the process mesh's {R}x{C}")

    @property
    def groups(self):
        return self.mesh.groups

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def local(self) -> LocalBlock:
        m = self.mesh
        return LocalBlock(m.i0, m.j0, m.Rl, m.Cl)

    def coords(self):
        """This rank's processors' global (i, j), row-major."""
        return self.local.coords()

    @property
    def row_group(self):
        return self.groups.rows[self.mesh.block_of(self.mesh.rank)[0]]

    def row_gather(self, x):
        """(Rl, Cl, ...) -> (Rl, Cl, R, ...): out[li, lj, r] = x[r, j], an
        all_gather of the blocks within the column group."""
        return MH.axis_all_gather(x, self.mesh, 0)

    def col_all_to_all(self, x):
        """(Rl, Cl, C, ...) -> recv[li, lj, m] = x[i, m, j], routed by the
        bound exchange strategy."""
        return self.exchange.all_to_all(x, self)

    def flat_all_to_all(self, x):
        """One all_to_all within the row group: member k (columns
        k*Cl .. k*Cl + Cl - 1) receives x[:, :, k*Cl:(k+1)*Cl]."""
        return MH.axis_all_to_all(x, self.mesh, 1)

    def butterfly_swap(self, part, s: int):
        """One butterfly stage: (Rl, Cl, ...) rows of every column j ->
        those of partner column j XOR 2^s.  A local copy when the partner
        lies in this block, else one pairwise exchange with the rank
        holding it."""
        m = self.mesh
        step = 1 << s
        if step < m.Cl:
            perm = torch.arange(m.Cl, device=part.device) ^ step
            return part[:, perm]
        bi, bj = m.block_of(m.rank)
        peer = m.global_rank(m.rank_of(bi, bj ^ (step // m.Cl)))
        return MH.exchange_pair(part, peer, self.row_group)

    def with_exchange(self, strategy) -> "GroupTopology":
        return dataclasses.replace(self, exchange=strategy)

    def psum_all(self, x):
        """Sum of a per-processor (Rl, Cl) quantity over the whole grid: an
        int64 all_reduce over the world, wrapped to x's dtype as JAX's
        psum wraps int32."""
        s = MH.all_reduce_i64(x.sum(dtype=torch.int64), self.mesh.group)
        return s[0].to(x.device).to(x.dtype)

    def total(self, value: int) -> int:
        """A per-rank Python int summed over the group (exact, int64)."""
        return self.totals([value])[0]

    def totals(self, values) -> list:
        """Per-rank Python ints summed over the group, one all_reduce."""
        return MH.all_reduce_i64([int(v) for v in values],
                                 self.mesh.group).tolist()

    def fetch(self, x):
        """This rank's (Rl, Cl, ...) blocks -> the whole (R, C, ...) array,
        on every rank."""
        return MH.fetch(x, self.mesh)


def _axes(a) -> tuple:
    if a is None:
        return ()
    return tuple(a) if isinstance(a, (tuple, list)) else (a,)


def mesh_axis_sizes(mesh) -> dict:
    """A mesh's axis name -> size (a `StackedMesh` or a `ProcessMesh`)."""
    return dict(zip(mesh.axis_names, mesh.shape))


class Topology:
    """The JAX package's `Topology` constructors on the port: binding a
    grid to a mesh's axes returns the topology that runs it --
    `StackedTopology` on a `dist.compat.StackedMesh` (the grid's rows span
    `row_axes`, its columns `col_axes`, as in JAX, which checks the sizes),
    `GroupTopology` on a `multihost.ProcessMesh` (the mesh's shape is the
    grid's)."""

    def __new__(cls, grid: Grid2D, mesh, row_axes=("r",), col_axes=("c",)):
        if isinstance(mesh, MH.ProcessMesh):
            return GroupTopology(grid, mesh)
        row_axes, col_axes = _axes(row_axes), _axes(col_axes)
        sizes = mesh_axis_sizes(mesh)
        R = math.prod(sizes[a] for a in row_axes)
        C = math.prod(sizes[a] for a in col_axes)
        if (R, C) != (grid.R, grid.C):
            raise ValueError(
                f"mesh axes give a {R}x{C} grid but Grid2D is "
                f"{grid.R}x{grid.C} (row_axes={row_axes}, "
                f"col_axes={col_axes})")
        return StackedTopology(grid, mesh.device)

    @classmethod
    def one_d(cls, n: int, mesh, axes=("p",)):
        """The 1D baseline as the degenerate 1 x P grid (n padded to P),
        P the product of the `axes` sizes."""
        axes = _axes(axes)
        sizes = mesh_axis_sizes(mesh)
        P = math.prod(sizes[a] for a in axes)
        return cls(Grid2D.for_vertices(n, 1, P), mesh, row_axes=(),
                   col_axes=axes)
