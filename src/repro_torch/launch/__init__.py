"""Command-line entry points (the port of `repro.launch`): `bfs_run`,
`train`, `dryrun` (with its `mesh` and `roofline`)."""
