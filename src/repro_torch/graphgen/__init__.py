"""Graph generation and CSR / CSC construction (the port of
`repro.graphgen`)."""
from repro_torch.graphgen.rmat import rmat_edges, make_undirected, \
    permute_labels
from repro_torch.graphgen.build import build_csc, build_csr, degrees
from repro_torch.graphgen.datasets import realworld_analog, REALWORLD_SPECS

__all__ = ["rmat_edges", "make_undirected", "permute_labels", "build_csc",
           "build_csr", "degrees", "realworld_analog", "REALWORLD_SPECS"]
