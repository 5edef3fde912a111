"""The fused segmented Gram ``G[s] = Σ_{seg_n = s} w_n L_n ⊗ R_n``."""
