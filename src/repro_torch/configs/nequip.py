"""nequip [arXiv:2101.03164]: n_layers=5 d_hidden=32 l_max=2 n_rbf=8
cutoff=5, E(3) tensor-product message passing (Cartesian l<=2 basis here;
DESIGN.md sec. 3)."""
from repro_torch.models.gnn.equivariant import EquivConfig

CONFIG = EquivConfig(name="nequip", n_layers=5, d_hidden=32, n_rbf=8,
                     cutoff=5.0, correlation_order=1)
SKIP_SHAPES = {}
