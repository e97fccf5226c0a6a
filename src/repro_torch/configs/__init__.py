"""Architecture configs, their smokes and dry-run specs (the port of
`repro.configs`)."""
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.configs.common import MeshAxes, DryrunSpec
