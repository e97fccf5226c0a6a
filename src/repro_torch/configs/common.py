"""Shared config plumbing, the port of `repro/configs/common.py`: the
mesh-axis descriptor and the architecture record.  The JAX module's
`DryrunSpec` and `abstract` describe an XLA lowering; their counterpart
comes with the port's dry run (`launch/dryrun.py`, ROADMAP A16 part 2)."""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: tuple            # data-parallel axes, e.g. ("pod", "data")
    tp: str = "model"    # tensor/expert-parallel axis

    @property
    def all(self):
        return (*self.dp, self.tp)


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str
    shapes: tuple
    build_dryrun: Callable        # (shape, mesh, axes: MeshAxes) -> a dry run
    smoke: Callable               # (device=None) -> None, raises on failure
    skip_shapes: dict = dataclasses.field(default_factory=dict)
    source: str = ""
