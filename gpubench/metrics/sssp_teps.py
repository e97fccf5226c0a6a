"""sssp_teps (TEPS): `bfs_teps`' arithmetic over SSSP queries."""
from gpubench.reference.graph500 import teps


def read(run):
    return teps(sum(run.traversed), run.window_s)
