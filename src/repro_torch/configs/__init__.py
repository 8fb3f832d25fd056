"""Configurations copied from ``repro.configs``: the paper's workloads and
the architecture registry (``get_config("<arch-id>")`` / ``--arch <id>``).
They are plain data, so ``get_config`` works for every arch, including
the families whose model code the port does not have yet."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, MoECfg, MLACfg, SSMCfg,
                                      ShapeCfg, SHAPES, supports_shape,
                                      reduce_config)
from repro_torch.configs.paper_nam import OLAP, OLTP, OLAPWorkload, OLTPWorkload

_ARCH_MODULES = {
    "jamba-1.5-large-398b":      "repro_torch.configs.jamba_1_5_large_398b",
    "starcoder2-15b":            "repro_torch.configs.starcoder2_15b",
    "glm4-9b":                   "repro_torch.configs.glm4_9b",
    "granite-34b":               "repro_torch.configs.granite_34b",
    "granite-20b":               "repro_torch.configs.granite_20b",
    "whisper-base":              "repro_torch.configs.whisper_base",
    "mamba2-370m":               "repro_torch.configs.mamba2_370m",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "deepseek-v2-236b":          "repro_torch.configs.deepseek_v2_236b",
    "llama-3.2-vision-90b":      "repro_torch.configs.llama_3_2_vision_90b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch]).CONFIG


__all__ = ["ModelConfig", "MoECfg", "MLACfg", "SSMCfg", "ShapeCfg", "SHAPES",
           "ARCH_IDS", "get_config", "supports_shape", "reduce_config",
           "OLTP", "OLAP", "OLTPWorkload", "OLAPWorkload"]
