"""Replicate inference: intervals and the delete-fold jackknife."""
