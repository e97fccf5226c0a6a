"""The port's counterpart of the JAX package's mesh constructor
(`repro/dist/compat.py`'s `make_mesh`).

The JAX package binds its processor grid to a device mesh with named axes.
The port stacks the whole grid on one device, so its mesh is a descriptor
only: the named axes, their sizes and the device every processor lives on.
`dist.topology.Topology(grid, mesh, row_axes, col_axes)` binds a grid to
it as JAX's `Topology` binds one to a JAX mesh, so code written against
the JAX package ports line for line.  A process group's mesh is
`dist.multihost.global_mesh` (a `ProcessMesh`), which the same
constructors accept.

`shard_map` and `axis_types_kwargs`, the rest of the JAX module, have no
counterpart: the port runs no `shard_map` program (the stacked grid's
collectives are tensor operations, a group's are `torch.distributed`
calls) and torch has no mesh axis types.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.types import resolve_device


@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """Named mesh axes of the given sizes, every processor stacked on one
    device.  `shape` holds the sizes in axis order, as a `ProcessMesh`'s
    does."""
    shape: tuple
    axis_names: tuple
    device: torch.device

    @property
    def size(self) -> int:
        """The number of processors the mesh spans."""
        return math.prod(self.shape)


def make_mesh(axis_shapes, axis_names, *, device=None) -> StackedMesh:
    """The JAX package's `make_mesh(axis_shapes, axis_names)` on the port:
    a `StackedMesh` on `device` (None = CUDA; raises without a card)."""
    axis_shapes = tuple(int(s) for s in axis_shapes)
    axis_names = tuple(axis_names)
    if len(axis_shapes) != len(axis_names):
        raise ValueError(f"{len(axis_shapes)} axis sizes for "
                         f"{len(axis_names)} axis names")
    return StackedMesh(axis_shapes, axis_names, resolve_device(device))
