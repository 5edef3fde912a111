"""Architecture registry: ``get_config("<arch-id>")`` -> ModelConfig.

The port carries every configuration of the JAX package's registry;
an arch id ending in ``-smoke`` gives the reduced CPU variant
(``config.smoke_variant``).
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.config import ModelConfig, smoke_variant

_MODULES: Dict[str, str] = {
    "granite-3-2b": "granite_3_2b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "yi-34b": "yi_34b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "chatglm3-6b": "chatglm3_6b",
    "arctic-480b": "arctic_480b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "pixtral-12b": "pixtral_12b",
    "whisper-tiny": "whisper_tiny",
}
# the reference's registry order (``repro.configs.ARCH_IDS``)
ARCH_IDS = ("yi-34b", "granite-3-2b", "phi4-mini-3.8b", "chatglm3-6b",
            "pixtral-12b", "zamba2-1.2b", "arctic-480b", "deepseek-v3-671b",
            "whisper-tiny", "rwkv6-3b")


def get_config(arch: str) -> ModelConfig:
    """The port's config for ``arch`` (``-smoke`` suffix: the reduced
    variant)."""
    name = arch[:-len("-smoke")] if arch.endswith("-smoke") else arch
    if name not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    cfg: ModelConfig = mod.CONFIG
    return smoke_variant(cfg) if arch.endswith("-smoke") else cfg


def all_configs() -> Dict[str, ModelConfig]:
    """Every registry config, keyed in ``ARCH_IDS`` order."""
    return {a: get_config(a) for a in ARCH_IDS}
