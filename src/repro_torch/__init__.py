"""repro_torch — the PyTorch/CUDA port of the ``repro`` causal-inference
package, for an NVIDIA H100 (Hopper).

The layout mirrors ``repro`` so each module has an obvious counterpart:
``core/`` (moments, nuisances, cross-fitting, final stage, DML),
``inference/`` (intervals, the delete-fold jackknife), ``data/`` (the
synthetic DGPs) and ``kernels/<name>/{ref,kernel,ops}.py``.  Every
kernel is written by hand for ``sm_90a`` and built from the sources in
this package at first use; its plain PyTorch version serves tensors
that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).  The package imports nothing of the JAX
framework or of ``repro``: state from the JAX package crosses over as numpy arrays
(``repro_torch.convert``).
"""
