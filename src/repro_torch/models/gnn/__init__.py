"""GraphSAGE, NequIP / MACE on the Cartesian l <= 2 algebra, and EGNN (the
port of `repro.models.gnn`)."""
