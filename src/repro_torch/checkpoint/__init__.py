"""Checkpoint manager over the paper's two cache designs."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
