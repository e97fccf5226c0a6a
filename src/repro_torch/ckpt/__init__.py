"""Checkpoints with atomic commit and the elastic grid shrink."""
