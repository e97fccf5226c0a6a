"""hbm_roofline.sssp (%): `hbm_roofline.bfs` over SSSP queries, each
directed adjacency entry a 4-byte id and its 1-byte weight (10 bytes an
undirected edge)."""
from gpubench.reference.profile import hbm_share

BYTES_PER_EDGE = 2 * 5


def read(run):
    if run.profile is None or run.profile["busy_s"] <= 0:
        return None
    return hbm_share(BYTES_PER_EDGE * sum(run.traversed),
                     run.profile["busy_s"])
