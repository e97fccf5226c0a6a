"""device_idle.bfs (%): share of the window in which no operation ran on
the device, from the profiler's trace of the window (BFS cells)."""


def read(run):
    if run.profile is None or run.profile["busy_s"] <= 0:
        return None
    return 100.0 * run.profile["idle_share"]
