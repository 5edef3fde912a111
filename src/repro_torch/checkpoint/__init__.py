"""Atomic, asynchronous checkpoints of nested dicts of tensors."""
from repro_torch.checkpoint.manager import CheckpointManager, restore_tree  # noqa: F401
