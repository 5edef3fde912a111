"""LM backbones of the port, every family of the registry (dense GQA,
MLA, MoE, RWKV-6, the Mamba2 hybrid, the encoder-decoder and the vlm):
schemas and init (``params``), layers, attention, the layer stack and
``Model``."""
from repro_torch.models.model import Model, build_model  # noqa: F401
