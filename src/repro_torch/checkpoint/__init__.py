"""Checkpoints in the JAX package's on-disk format (``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
