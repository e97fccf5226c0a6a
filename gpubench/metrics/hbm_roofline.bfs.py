"""hbm_roofline.bfs (%): the least time HBM needs at its published rate
to read each directed adjacency entry of every searched component once
(a 4-byte id: 8 bytes an undirected edge), over the device's busy time
in the window's BFS queries, from the profiler's trace."""
from gpubench.reference.profile import hbm_share

BYTES_PER_EDGE = 2 * 4


def read(run):
    if run.profile is None or run.profile["busy_s"] <= 0:
        return None
    return hbm_share(BYTES_PER_EDGE * sum(run.traversed),
                     run.profile["busy_s"])
