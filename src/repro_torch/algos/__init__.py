"""Frontier programs and their driver (DESIGN.md sec. 8), the port of
`repro.algos`.

    from repro_torch.algos import FrontierEngine, ConnectedComponentsProgram

Most callers go through the session instead: `GraphSession
.connected_components()`, `.sssp(root)`, `.multi_bfs(sources)`
(`repro_torch.api.session`), which add residency, engine reuse and the
executable cache.
"""
from repro_torch.algos.program import (FrontierProgram, I32_MAX, ValueState,
                                       owned_to_front, pack_blocks,
                                       scan_relax, scatter_min_received)
from repro_torch.algos.engine import FrontierEngine, wide_add, wide_total
from repro_torch.algos.bfs import BFSLevelsProgram
from repro_torch.algos.direction import DirectionProgram, DirState
from repro_torch.algos.cc import CCOutput, ConnectedComponentsProgram
from repro_torch.algos.sssp import SSSPOutput, SSSPProgram
from repro_torch.algos.multi_bfs import (MultiBFSOutput, MultiBFSState,
                                         MultiSourceBFSProgram)
from repro_torch.algos.reference import (cc_reference, k_hop_neighborhood,
                                         multi_bfs_reference, sssp_reference)

PROGRAMS = {
    "bfs": BFSLevelsProgram,
    "cc": ConnectedComponentsProgram,
    "sssp": SSSPProgram,
    "multi_bfs": MultiSourceBFSProgram,
}

__all__ = [
    "FrontierProgram", "FrontierEngine", "ValueState", "I32_MAX",
    "scan_relax", "pack_blocks", "scatter_min_received", "owned_to_front",
    "wide_add", "wide_total", "BFSLevelsProgram", "DirectionProgram",
    "DirState",
    "ConnectedComponentsProgram", "CCOutput", "SSSPProgram", "SSSPOutput",
    "MultiSourceBFSProgram", "MultiBFSOutput", "MultiBFSState",
    "cc_reference", "sssp_reference", "multi_bfs_reference",
    "k_hop_neighborhood", "PROGRAMS",
]
