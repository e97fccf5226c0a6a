"""Command-line drivers (the port of `repro.launch`): `bfs_run`, `train`."""
