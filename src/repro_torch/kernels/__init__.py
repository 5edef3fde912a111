"""Hand-written Hopper kernels of the port.

Each kernel directory ships ``ref.py`` (the plain PyTorch version, which
CPU tensors take), ``kernel.py`` (the ctypes binding of a CUDA source in
``csrc/``, built at first use by ``kernels/build.py``) and ``ops.py``
(the dispatch: CUDA tensor -> kernel, CPU tensor -> plain version).
"""
