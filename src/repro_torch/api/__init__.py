"""Session API: `BFSConfig`, `DistGraph`, `GraphSession`."""
from repro_torch.api.config import BFSConfig
from repro_torch.api.session import DistGraph, GraphSession, check_vertex_ids
