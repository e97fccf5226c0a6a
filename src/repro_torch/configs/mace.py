"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, higher-order (ACE) equivariant message passing
via repeated self-tensor-products."""
from repro_torch.models.gnn.equivariant import EquivConfig

CONFIG = EquivConfig(name="mace", n_layers=2, d_hidden=128, n_rbf=8,
                     cutoff=5.0, correlation_order=3)
SKIP_SHAPES = {}
