"""Checkpoints with atomic commit and the elastic grid shrink."""
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.ckpt.elastic import reshard_state, shrink_grid

__all__ = ["CheckpointManager", "reshard_state", "shrink_grid"]
