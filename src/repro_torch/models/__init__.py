"""The graph-learning and recsys models (the port of `repro.models`)."""
