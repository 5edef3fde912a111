"""Estimation core: moments, nuisances, cross-fitting, final stage, DML."""
