"""plan_s (s): `DistGraph.from_edges` and, where the configuration asks,
`ensure_csr`, synchronised.  Host clock."""


def read(run):
    return run.plan_s
