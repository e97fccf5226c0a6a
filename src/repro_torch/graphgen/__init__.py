"""Graph generation."""
from repro_torch.graphgen.rmat import rmat_edges
