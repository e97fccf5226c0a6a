"""Production mesh definition, the port of `repro/launch/mesh.py`.

The JAX package builds the 16x16 (or 2x16x16) mesh over placeholder host
devices for its dry run.  The port's counterpart is a `StackedMesh`
descriptor on the meta device: the dry run traces over it, and nothing is
allocated or run.  Importing this module touches no device.
"""
from __future__ import annotations

from repro_torch.configs.common import MeshAxes
from repro_torch.dist.compat import StackedMesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> StackedMesh:
    """16x16 = 256 chips per pod ("data", "model"); 2 pods = 512 chips
    ("pod", "data", "model") multi-pod.  On `device` (the meta device by
    default: a descriptor to trace over, not 256 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_axes(mesh) -> MeshAxes:
    """MeshAxes descriptor for a production mesh."""
    if "pod" in mesh.axis_names:
        return MeshAxes(dp=("pod", "data"), tp="model")
    return MeshAxes(dp=("data",), tp="model")
