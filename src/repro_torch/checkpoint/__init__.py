"""Atomic, async checkpoints of trees of tensors."""
from repro_torch.checkpoint.ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
