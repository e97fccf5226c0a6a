"""bfs_teps (TEPS): Graph500's edges of each completed BFS query (the
undirected input edges of the root's component, counted by the
reference), summed over the window, over the window's length.  Host
clock."""
from gpubench.reference.graph500 import teps


def read(run):
    return teps(sum(run.traversed), run.window_s)
