"""Synthetic causal data generators."""
