"""Architecture registry: ``get_arch("<id>")`` -> ArchConfig.

One module per assigned architecture; ids match the assignment list.  A
copy of ``repro/configs`` (the config modules are data), kept in the port
so that it imports nothing of the JAX package.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

_ARCH_MODULES: Dict[str, str] = {
    "xlstm-1.3b": "xlstm_1_3b",
    "minicpm-2b": "minicpm_2b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "minitron-8b": "minitron_8b",
    "hubert-xlarge": "hubert_xlarge",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
}

ARCH_IDS: List[str] = list(_ARCH_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_arch(name[: -len("-smoke")]).reduced()
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def get_schedule(name: str) -> str:
    """Per-arch LR schedule hint (MiniCPM ships WSD; others cosine)."""
    if name not in _ARCH_MODULES:
        return "cosine"
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return getattr(mod, "SCHEDULE", "cosine")
