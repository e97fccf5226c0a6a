"""Architecture configs and their smokes (the port of `repro.configs`).
The JAX package's `ARCHS`, `get_arch` (`configs/registry.py`) and
`DryrunSpec` come with the next slice (ROADMAP A16 part 2)."""
from repro_torch.configs.common import MeshAxes
