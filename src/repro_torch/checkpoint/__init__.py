"""Atomic, asynchronous checkpoints of nested dicts of tensors."""
