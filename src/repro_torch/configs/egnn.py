"""egnn [arXiv:2102.09844]: 4 layers d_hidden=64, E(n)-equivariant."""
from repro_torch.models.gnn.egnn import EGNNConfig

CONFIG = EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=8)
SKIP_SHAPES = {}
