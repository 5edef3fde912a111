"""The fused segmented Gram ``G[s] = Σ_{seg_n = s} w_n L_n ⊗ R_n``: one
CUDA source (``csrc/seg_gram.cu``, bound in ``kernel.py``), the dispatch
(``ops.py``) and the plain version (``ref.py``) behind
``row_block_strategy="pallas"``."""
from repro_torch.kernels.seg_gram import ops  # noqa: F401
